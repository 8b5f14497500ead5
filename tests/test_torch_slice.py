"""The port's serving slice against the JAX package: render_initial and
render_surfel on a small model carried across by models/convert.py, and
eval end to end (Blender scene on disk -> PLY -> scripts/eval_torch.py vs
scripts/eval.py)."""
import importlib.util
import json
import os
import shutil
import sys

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from materialrefgs_tpu.cameras import look_at_camera as jax_camera  # noqa: E402
from materialrefgs_tpu.models import gaussian_io as jio  # noqa: E402
from materialrefgs_tpu.models import gaussian_model as jgm  # noqa: E402
from materialrefgs_tpu.models.env_light import EnvLightMips as JMips  # noqa: E402
from materialrefgs_tpu.models.env_light import EnvLightParams as JEnv  # noqa: E402
from materialrefgs_tpu.ops import cubemap as jcm  # noqa: E402
from materialrefgs_tpu.ops.rasterize.api import RasterizeConfig as JRaster  # noqa: E402
from materialrefgs_tpu.render import renderers as jrend  # noqa: E402

from materialrefgs_torch.cameras import look_at_camera as torch_camera  # noqa: E402
from materialrefgs_torch.models import convert  # noqa: E402
from materialrefgs_torch.models.env_light import EnvLightMips as TMips  # noqa: E402
from materialrefgs_torch.models.gaussian_model import PARAM_SHAPES  # noqa: E402
from materialrefgs_torch.ops import cubemap as tcm  # noqa: E402
from materialrefgs_torch.ops.rasterize.api import RasterizeConfig as TRaster  # noqa: E402
from materialrefgs_torch.render import renderers as trend  # noqa: E402
from materialrefgs_torch.utils import png  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H = 48, 40
DEPTH_MAPS = {"surf_depth", "render_depth_expected", "render_depth_median", "surf_normal", "rend_dist"}


@pytest.fixture
def same_texel_grid(monkeypatch):
    """JAX's texel-center directions for the port's prefilter (the grids
    differ by one float32 ulp, which flips the face of samples on cube
    edges; see test_torch_shading.py)."""
    monkeypatch.setattr(
        tcm, "face_dirs", lambda res, device=None: torch.tensor(np.asarray(jcm.face_dirs(res)), device=device)
    )


def jax_model(seed=0, P=200, cap=256):
    """A fixed-capacity JAX model with every material leaf non-trivial."""
    rng = np.random.default_rng(seed)
    K = 16
    leaves = {
        name: np.zeros((cap,) + shape(K), np.float32) for name, shape in PARAM_SHAPES.items()
    }
    leaves["xyz"][:P] = rng.normal(size=(P, 3)) * 0.5
    leaves["scaling"][:] = -10.0
    leaves["scaling"][:P] = rng.normal(size=(P, 2)) * 0.4 - 1.7
    leaves["rotation"][:, 0] = 1.0
    leaves["rotation"][:P] = rng.normal(size=(P, 4))
    leaves["opacity"][:] = -15.0
    leaves["opacity"][:P] = rng.normal(size=(P, 1)) + 0.5
    for name in ("refl_strength", "roughness", "ori_color", "metalness", "diffuse_color"):
        leaves[name][:P] = rng.normal(size=leaves[name][:P].shape)
    for name in ("features_dc", "indirect_dc"):
        leaves[name][:P] = rng.normal(size=(P, 1, 3)) * 0.8
    for name in ("features_rest", "indirect_rest"):
        leaves[name][:P] = rng.normal(size=(P, K - 1, 3)) * 0.2
    params = jgm.GaussianParams(**{k: jnp.asarray(v) for k, v in leaves.items()})
    return jgm.GaussianModel(
        params=params,
        alive=jnp.arange(cap) < P,
        max_radii2d=jnp.zeros(cap),
        xyz_gradient_accum=jnp.zeros(cap),
        denom=jnp.zeros(cap),
        active_sh_degree=jnp.int32(3),
        max_sh_degree=3,
        capacity=cap,
    ), rng.normal(size=(6, 32, 32, 3)).astype(np.float32)


def _assert_maps_close(ref: dict, out: dict):
    assert int(out["overflow"]) == int(ref["overflow"]) == 0
    checked = 0
    for key, val in ref.items():
        if key == "overflow":
            continue
        a = np.asarray(val)
        b = out[key].numpy()
        if a.dtype == bool or a.dtype.kind in "iu":
            assert np.array_equal(a, b), key
        else:
            atol = 1e-3 if key in DEPTH_MAPS else 3e-4
            np.testing.assert_allclose(b, a, atol=atol, rtol=1e-3, err_msg=key)
        checked += 1
    assert checked == len(out) - 1


@pytest.mark.parametrize("stage", ["initial", "surfel"])
def test_render_matches_jax(stage, same_texel_grid):
    jm, env_base = jax_model()
    tm = convert.gaussian_model_from_numpy(
        {k: np.asarray(getattr(jm.params, k)) for k in PARAM_SHAPES},
        np.asarray(jm.alive), int(jm.active_sh_degree), device="cpu",
    )
    kw = dict(eye=np.array([0.4, -0.5, -3.5]), target=np.zeros(3),
              up=np.array([0.0, 1.0, 0.0]), fovx=0.9, fovy=0.75, width=W, height=H)
    jc, tc = jax_camera(**kw), torch_camera(**kw, device="cpu")
    bg = np.ones(3, np.float32)
    jopts = jrend.RenderOptions(raster=JRaster(pair_capacity=1 << 14, interpret=True))
    topts = trend.RenderOptions(raster=TRaster(pair_capacity=1 << 14))
    with torch.no_grad():
        if stage == "initial":
            ref = jrend.render_initial(jm, jc, jnp.asarray(bg), jopts)
            out = trend.render_initial(tm, tc, torch.from_numpy(bg), topts)
        else:
            jmips = JMips.build(JEnv(base=jnp.asarray(env_base)))
            tmips = TMips.build(convert.env_light_from_numpy(env_base, device="cpu"))
            ref = jrend.render_surfel(jm, jc, jnp.asarray(bg), jmips, jopts)
            out = trend.render_surfel(tm, tc, torch.from_numpy(bg), tmips, topts)
    assert set(out) == set(ref)
    assert float(out["rend_alpha"].max()) > 0.5  # the model covers the view
    _assert_maps_close(ref, out)


def _write_blender_scene(root, n_views=2):
    """A Blender-layout scene: cameras on a ring looking at the origin,
    smooth synthetic RGBA ground truth."""
    os.makedirs(os.path.join(root, "test"))
    rng = np.random.default_rng(7)
    frames = []
    for i in range(n_views):
        ang = 0.6 * i
        eye = np.array([3.5 * np.sin(ang), 0.4, -3.5 * np.cos(ang)])
        fwd = -eye / np.linalg.norm(eye)
        right = np.cross(fwd, [0.0, 1.0, 0.0])
        right /= np.linalg.norm(right)
        up = np.cross(right, fwd)
        c2w = np.eye(4)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, up, -fwd, eye  # OpenGL axes
        frames.append({"file_path": f"./test/r_{i}", "transform_matrix": c2w.tolist()})
        yy, xx = np.mgrid[0:H, 0:W] / np.array([H, W])[:, None, None]
        rgb = 0.5 + 0.4 * np.sin(6 * xx + i)[..., None] * np.array([1.0, 0.6, 0.3])
        rgb = rgb + 0.05 * rng.normal(size=rgb.shape)
        alpha = (((xx - 0.5) ** 2 + (yy - 0.5) ** 2) < 0.16)[..., None] * 1.0
        img = np.clip(np.concatenate([rgb, alpha], -1), 0, 1)
        png.write_png(os.path.join(root, "test", f"r_{i}.png"), (img * 255 + 0.5).astype(np.uint8))
    for split in ("train", "test"):
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": 0.9, "frames": frames}, f)


def test_eval_end_to_end_matches_jax(tmp_path, monkeypatch, same_texel_grid):
    scene = str(tmp_path / "scene")
    _write_blender_scene(scene)
    jm, env_base = jax_model(seed=1)
    runs = {}
    for side in ("jax", "torch"):
        model_dir = tmp_path / side
        ply = model_dir / "point_cloud" / "iteration_7000" / "point_cloud.ply"
        jio.save_ply(jm, str(ply), env1=JEnv(base=jnp.asarray(env_base)))
        runs[side] = str(model_dir)

    argv = ["-s", scene, "--skip_train", "--device", "cpu"]
    spec = importlib.util.spec_from_file_location("jax_eval", os.path.join(REPO, "scripts", "eval.py"))
    jax_eval = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_eval)
    monkeypatch.setattr(sys, "argv", ["eval.py", "-m", runs["jax"], *argv])
    jax_eval.main()
    with open(os.path.join(runs["jax"], "eval_7000", "metric.txt")) as f:
        ref = {k: v.strip() for k, v in (line.split(":", 1) for line in f)}

    spec = importlib.util.spec_from_file_location("eval_torch", os.path.join(REPO, "scripts", "eval_torch.py"))
    eval_torch = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(eval_torch)
    m = eval_torch.main(["-m", runs["torch"], *argv])["test"]

    assert abs(m["psnr"] - float(ref["psnr"])) < 0.01, (m["psnr"], ref["psnr"])
    assert abs(m["ssim"] - float(ref["ssim"])) < 1e-4, (m["ssim"], ref["ssim"])
    assert m["lpips"] is None and ref["lpips"] == "None"
    assert len(m["per_view_psnr"]) == 2
    for sub in ("renders", "gt", "normal", "depth", "albedo", "roughness", "metallic"):
        assert os.path.exists(os.path.join(runs["torch"], "eval_7000", "test", sub, "00000.png")), sub
    shutil.rmtree(tmp_path / "jax")


@pytest.mark.parametrize("photo_format", ["PNG", "JPEG"])
def test_eval_colmap_scene_matches_jax(tmp_path, monkeypatch, same_texel_grid, photo_format):
    """A COLMAP scene (PINHOLE, fx != fy, off-centre principal point) of
    106x74 photos served at the run's -r 2 (53x37, no side a multiple of 16)
    through scripts/eval_torch.py and scripts/eval.py from the same PLY and a
    refreal cfg_args.json: equal PSNR and SSIM, as
    test_eval_end_to_end_matches_jax holds the Blender path; for JPEG photos
    the port's decoder (host entropy decode, the kernel's plain version on
    the CPU) stands where the JAX side has Pillow."""
    import dataclasses

    from PIL import Image

    from materialrefgs_tpu import config as jcfg
    from materialrefgs_torch import config as tcfg
    from test_torch_colmap import ring_eyes, write_colmap

    scene = str(tmp_path / "scene")
    write_colmap(scene, [e * 3.5 / 3.2 for e in ring_eyes(3)], (106, 74))
    os.makedirs(os.path.join(scene, "images"))
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[0:74, 0:106] / 74.0
    for i in range(3):
        rgb = 0.5 + 0.4 * np.sin(6 * xx + 2 * yy + i)[..., None] * np.array([1.0, 0.6, 0.3])
        img = (np.clip(rgb + 0.05 * rng.normal(size=rgb.shape), 0, 1) * 255 + 0.5).astype(np.uint8)
        Image.fromarray(img).save(os.path.join(scene, "images", f"view_{i:03d}.png"), format=photo_format)
    jm, env_base = jax_model(seed=1)
    runs = {}
    for side, cfg in (("jax", jcfg), ("torch", tcfg)):
        model_dir = tmp_path / side
        jio.save_ply(jm, str(model_dir / "point_cloud" / "iteration_7000" / "point_cloud.ply"),
                     env1=JEnv(base=jnp.asarray(env_base)))
        m, p, o = cfg.preset_refreal()
        cfg.dump_config(str(model_dir), dataclasses.replace(m, resolution=2), p, o, extra={"pair_capacity": 1 << 14})
        runs[side] = str(model_dir)
    argv = ["-s", scene, "--skip_train", "--device", "cpu"]
    spec = importlib.util.spec_from_file_location("eval_torch", os.path.join(REPO, "scripts", "eval_torch.py"))
    eval_torch = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(eval_torch)
    spec = importlib.util.spec_from_file_location("jax_eval", os.path.join(REPO, "scripts", "eval.py"))
    jax_eval = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_eval)
    monkeypatch.setattr(sys, "argv", ["eval.py", "-m", runs["jax"], *argv])
    jax_eval.main()
    with open(os.path.join(runs["jax"], "eval_7000", "metric.txt")) as f:
        ref = {k: v.strip() for k, v in (line.split(":", 1) for line in f)}
    m = eval_torch.main(["-m", runs["torch"], *argv])["test"]
    assert abs(m["psnr"] - float(ref["psnr"])) < 0.01, (m["psnr"], ref["psnr"])
    assert abs(m["ssim"] - float(ref["ssim"])) < 1e-4, (m["ssim"], ref["ssim"])
    assert len(m["per_view_psnr"]) == 1 and m["overflow"] == 0  # llffhold 8: view 0 is the test view
    out = png.read_png(os.path.join(runs["torch"], "eval_7000", "test", "renders", "00000.png"))
    assert out.shape == (37, 53, 3) and float(out.std()) > 5  # the model is in view
    assert float(png.read_png(os.path.join(runs["torch"], "eval_7000", "test", "gt", "00000.png")).std()) > 10


def _setup_volume_stage(root):
    import dataclasses

    from materialrefgs_torch import config as cfg

    m, p, o = cfg.preset_refnerf()
    cfg.dump_config(str(root), m, p, dataclasses.replace(o, initial=0, volume_render_until_iter=100))
    (root / "point_cloud" / "iteration_50").mkdir(parents=True)
    return []


@pytest.mark.parametrize(
    "setup,match",
    [
        (_setup_volume_stage, "volume"),
    ],
)
def test_eval_refuses_what_the_slice_lacks(tmp_path, setup, match):
    """A volume-stage checkpoint raises NotImplementedError naming the
    volume slice; nothing else is rendered in its place. (--relight and
    --export_material_mesh run now: tests/test_torch_relight.py,
    tests/test_torch_mesh_material.py.)"""
    spec = importlib.util.spec_from_file_location("eval_torch", os.path.join(REPO, "scripts", "eval_torch.py"))
    eval_torch = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(eval_torch)
    extra = setup(tmp_path)
    with pytest.raises(NotImplementedError, match=match):
        eval_torch.main(["-m", str(tmp_path), "-s", str(tmp_path), "--device", "cpu", *extra])
