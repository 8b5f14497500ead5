"""--relight in the port: the Radiance RGBE reader (utils/hdr.py) against
OpenCV's decode, bit for bit, on flat, run-length and mixed files;
latlong_to_cubemap and load_envlight_from_hdr against the JAX package from
the same float latlong (the JAX side reads it through imageio, which this
test hands the port's decode: imageio's own .hdr read gives uint8 here);
and scripts/eval_torch.py --relight on a tiny checkpoint. Cubemaps are held
to rtol 1e-5 / atol 1e-5 (float32 trigonometry and the sRGB curve)."""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from materialrefgs_tpu.models import env_light as jenv  # noqa: E402
from materialrefgs_tpu.ops import cubemap as jcm  # noqa: E402

from materialrefgs_torch import config as tcfg  # noqa: E402
from materialrefgs_torch.models import convert  # noqa: E402
from materialrefgs_torch.models import env_light as tenv  # noqa: E402
from materialrefgs_torch.models import gaussian_io as tio  # noqa: E402
from materialrefgs_torch.ops import cubemap as tcm  # noqa: E402
from materialrefgs_torch.render.renderers import RenderOptions, render_surfel  # noqa: E402
from materialrefgs_torch.utils import hdr  # noqa: E402
from materialrefgs_torch.utils import png  # noqa: E402
from test_torch_envgs import _jax_texel_grid, _models  # noqa: E402
from test_torch_train import _load_script, _write_blender_scene  # noqa: E402


def _sky(H, W, seed=0):
    """Radiance over 2^-10..2^6: a gradient sky, a sun disc, noise, runs of
    equal pixels (for the run-length encoder) and a few black pixels."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W] / np.array([H, W], np.float32)[:, None, None]
    rgb = np.stack([0.3 + 0.7 * yy, 0.4 + 0.5 * yy, 0.9 - 0.3 * yy], -1)
    rgb = rgb * np.exp(rng.normal(size=(H, W, 1)) * 0.8)
    sun = ((xx - 0.3) ** 2 + (yy - 0.25) ** 2 < 0.003)[..., None]
    rgb = np.where(sun, 40.0, rgb)
    rgb[H // 2 :, : W // 3] = [0.05, 0.06, 0.07]
    rgb[0, :5] = 0.0
    return rgb.astype(np.float32)


def _rgbe(H, W, seed=0):
    rgbe = hdr.float_to_rgbe(_sky(H, W, seed))
    # A flat scanline that starts like a run-length header would be read as
    # one by every reader: keep the first pixel's bytes off (2, 2).
    rgbe[rgbe[:, 0, 0] == 2, 0, 0] = 3
    return rgbe


@pytest.mark.parametrize("layout", ["flat", "rle", "rle_then_flat", "narrow"])
def test_rgbe_reader_equals_opencv(tmp_path, layout):
    cv2 = pytest.importorskip("cv2")
    H, W = (12, 6) if layout == "narrow" else (24, 70)
    rgbe = _rgbe(H, W)
    rle = {"flat": False, "rle": True, "rle_then_flat": np.arange(H) < H // 2, "narrow": True}[layout]
    path = str(tmp_path / "sky.hdr")
    hdr.write_hdr_rgbe(path, rgbe, rle=rle)
    np.testing.assert_array_equal(hdr.read_hdr_rgbe(path), rgbe)
    ours = hdr.read_hdr(path)
    theirs = cv2.imread(path, cv2.IMREAD_ANYDEPTH | cv2.IMREAD_COLOR)
    assert theirs.dtype == np.float32 and theirs.shape == (H, W, 3)
    np.testing.assert_array_equal(ours, theirs[..., ::-1])
    e = rgbe[..., 3:].astype(np.int32)
    np.testing.assert_array_equal(ours, np.where(e > 0, rgbe[..., :3] * np.exp2(e - 136.0), 0.0).astype(np.float32))
    if layout == "rle":
        assert os.path.getsize(path) < 0.9 * 4 * H * W  # the runs were encoded


def test_rgbe_reader_refuses_other_layouts(tmp_path):
    path = str(tmp_path / "x.hdr")
    hdr.write_hdr_rgbe(path, _rgbe(8, 8))
    data = open(path, "rb").read()
    for bad, match in ((data.replace(b"-Y 8 +X 8", b"+Y 8 +X 8"), "orientation"),
                       (data.replace(b"32-bit_rle_rgbe", b"32-bit_rle_xyze"), "format"),
                       (b"P6\n" + data, "Radiance")):
        with open(path, "wb") as f:
            f.write(bad)
        with pytest.raises(ValueError, match=match):
            hdr.read_hdr(path)


def test_latlong_to_cubemap_matches_jax(monkeypatch):
    monkeypatch.setattr(tcm, "face_dirs", _jax_texel_grid)
    lat = np.random.default_rng(1).normal(size=(16, 32, 3)).astype(np.float32)
    for res in (8, 16):
        np.testing.assert_allclose(tcm.latlong_to_cubemap(torch.from_numpy(lat), res).numpy(),
                                   np.asarray(jcm.latlong_to_cubemap(jnp.asarray(lat), res)), rtol=1e-5, atol=1e-5)
    # The longitude wraps: a latlong constant per row gives a cubemap with
    # no seam, and the wrap reads the last and first columns together.
    rows = np.repeat(np.linspace(0, 1, 16, dtype=np.float32)[:, None, None], 32, 1).repeat(3, 2)
    cube = tcm.latlong_to_cubemap(torch.from_numpy(rows), 8).numpy()
    np.testing.assert_allclose(cube, np.asarray(jcm.latlong_to_cubemap(jnp.asarray(rows), 8)), rtol=1e-5, atol=1e-6)


def test_load_envlight_from_hdr_matches_jax(tmp_path, monkeypatch):
    import imageio.v2

    monkeypatch.setattr(tcm, "face_dirs", _jax_texel_grid)
    path = str(tmp_path / "sky.hdr")
    hdr.write_hdr_rgbe(path, _rgbe(32, 64, seed=2))
    decoded = hdr.read_hdr(path)
    monkeypatch.setattr(imageio.v2, "imread", lambda p, *a, **k: decoded.copy())
    for res, scale in ((16, 1.0), (8, 0.7)):
        j = np.asarray(jenv.load_envlight_from_hdr(path, res=res, scale=scale).base)
        t = tenv.load_envlight_from_hdr(path, res=res, scale=scale, device="cpu").base.detach().numpy()
        assert t.shape == (6, res, res, 3)
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5)
        assert float(t.max()) > 4.0 and float(t.min()) < -1.0  # the sun clips, the shade is dim
        # A JAX EnvLightParams from the HDR carries across as it is.
        np.testing.assert_array_equal(convert.env_light_from_numpy(j, device="cpu").base.detach().numpy(), j)


def test_eval_relight_on_a_tiny_checkpoint(tmp_path):
    """scripts/eval_torch.py --relight serves the views under the HDR's
    cubemap (what render_surfel gives with it) and dumps it as env1.png."""
    scene, run = str(tmp_path / "scene"), str(tmp_path / "run")
    _write_blender_scene(scene)
    (_, tm), _, env_base = _models(P=64)
    ply = os.path.join(run, "point_cloud", "iteration_4000", "point_cloud.ply")
    tio.save_ply(tm, ply, env1=tenv.EnvLightParams(torch.from_numpy(env_base)))
    m, p, o = tcfg.preset_refnerf()
    m = dataclasses.replace(m, envmap_max_res=16)
    tcfg.dump_config(run, m, p, o, extra={"pair_capacity": 1 << 14})
    sky = str(tmp_path / "sky.hdr")
    hdr.write_hdr_rgbe(sky, _rgbe(32, 64, seed=3), rle=np.arange(32) < 20)
    eval_torch = _load_script("eval_torch")
    base = eval_torch.main(["-m", run, "-s", scene, "--skip_train", "--device", "cpu"])["test"]
    plain = png.read_png(os.path.join(run, "eval_4000", "test", "renders", "00000.png"))
    env_png = png.read_png(os.path.join(run, "env1.png"))
    relit = eval_torch.main(["-m", run, "-s", scene, "--skip_train", "--device", "cpu", "--relight", sky])["test"]
    out = png.read_png(os.path.join(run, "eval_4000", "test", "renders", "00000.png"))
    assert np.isfinite(relit["psnr"]) and relit["psnr"] != base["psnr"]
    assert np.abs(out.astype(int) - plain.astype(int)).mean() > 1.0
    assert np.abs(png.read_png(os.path.join(run, "env1.png")).astype(int) - env_png.astype(int)).mean() > 5.0
    # The served view is render_surfel's under the HDR's cubemap.
    env = tenv.load_envlight_from_hdr(sky, res=m.envmap_max_res, device="cpu")
    mips = tenv.EnvLightMips.build(env, min_roughness=m.envmap_min_roughness, max_roughness=m.envmap_max_roughness)
    loaded, _, _ = tio.load_ply(ply, device="cpu")
    from materialrefgs_torch.models.scene import Scene

    cam = Scene.load(dataclasses.replace(m, source_path=scene, model_path=run), device="cpu").test_cameras[0]
    with torch.no_grad():
        ref = render_surfel(loaded, cam, torch.ones(3) if m.white_background else torch.zeros(3), mips,
                            RenderOptions(srgb=o.srgb, unbiased_depth=p.unbiased_depth))["render"]
    expect = (np.clip(ref.numpy(), 0, 1) * 255 + 0.5).astype(np.uint8)
    assert np.abs(out.astype(int) - expect.astype(int)).max() <= 1
