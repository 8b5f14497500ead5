"""PyTorch port vs the JAX package: cameras, transforms, SH, depth normals,
PNG codec, PLY round trips, weight conversion, package hygiene."""
import os
import subprocess
import sys
import zlib

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from materialrefgs_tpu import cameras as jcams  # noqa: E402
from materialrefgs_tpu.models import gaussian_io as jio  # noqa: E402
from materialrefgs_tpu.models import gaussian_model as jgm  # noqa: E402
from materialrefgs_tpu.models.env_light import EnvLightParams as JEnv  # noqa: E402
from materialrefgs_tpu.utils import point as jpoint  # noqa: E402
from materialrefgs_tpu.utils import sh as jsh  # noqa: E402
from materialrefgs_tpu.utils import transforms as jtf  # noqa: E402

from materialrefgs_torch import cameras as tcams  # noqa: E402
from materialrefgs_torch import resolve_device  # noqa: E402
from materialrefgs_torch.models import convert  # noqa: E402
from materialrefgs_torch.models import gaussian_io as tio  # noqa: E402
from materialrefgs_torch.models.env_light import EnvLightParams as TEnv  # noqa: E402
from materialrefgs_torch.models.gaussian_model import PARAM_SHAPES  # noqa: E402
from materialrefgs_torch.utils import png  # noqa: E402
from materialrefgs_torch.utils import point as tpoint  # noqa: E402
from materialrefgs_torch.utils import sh as tsh  # noqa: E402
from materialrefgs_torch.utils import transforms as ttf  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-6


def close(a, b, atol=ATOL, rtol=1e-6):
    np.testing.assert_allclose(
        np.asarray(b.detach().cpu() if isinstance(b, torch.Tensor) else b),
        np.asarray(a),
        atol=atol,
        rtol=rtol,
    )


def _cams(W=40, H=30):
    kw = dict(
        eye=np.array([0.3, -0.2, -4.0]), target=np.array([0.1, 0.0, 0.2]),
        up=np.array([0.0, 1.0, 0.0]), fovx=0.9, fovy=0.7, width=W, height=H,
    )
    return jcams.look_at_camera(**kw), tcams.look_at_camera(**kw, device="cpu")


@pytest.mark.parametrize("with_K", [False, True])
def test_cameras_match_jax(with_K):
    R = np.linalg.qr(np.random.default_rng(0).normal(size=(3, 3)))[0]
    T = np.array([0.2, -0.4, 3.5])
    K = np.array([[50.0, 0, 19.0], [0, 48.0, 16.5], [0, 0, 1]]) if with_K else None
    jc = jcams.make_camera(R, T, 0.9, 0.7, 40, 30, K=K)
    tc = tcams.make_camera(R, T, 0.9, 0.7, 40, 30, K=K, device="cpu")
    for f in ("world_view", "full_proj", "camera_center"):
        close(getattr(jc, f), getattr(tc, f))
    for f in ("fx", "fy", "cx", "cy"):
        assert float(getattr(jc, f)) == getattr(tc, f)
    close(jc.get_rays(), tc.get_rays())
    assert tcams.fov2focal(0.9, 40) == jcams.fov2focal(0.9, 40)
    assert tcams.focal2fov(50.0, 40) == jcams.focal2fov(50.0, 40)


def test_transforms_and_sh_match_jax():
    rng = np.random.default_rng(1)
    q = rng.normal(size=(64, 4)).astype(np.float32)
    v = rng.normal(size=(64, 3)).astype(np.float32)
    n = rng.normal(size=(64, 3)).astype(np.float32)
    x = rng.uniform(-0.1, 1.2, size=(64, 3)).astype(np.float32)
    p = rng.uniform(0.01, 0.99, size=(64,)).astype(np.float32)
    t = torch.from_numpy
    close(jtf.normalize(jnp.asarray(v)), ttf.normalize(t(v)))
    close(jtf.normalize(jnp.zeros((2, 3))), ttf.normalize(torch.zeros(2, 3)))
    close(jtf.quat_to_rotmat(jnp.asarray(q)), ttf.quat_to_rotmat(t(q)))
    close(jtf.inverse_sigmoid(jnp.asarray(p)), ttf.inverse_sigmoid(t(p)))
    close(jtf.linear_to_srgb(jnp.asarray(x)), ttf.linear_to_srgb(t(x)))
    close(jtf.srgb_to_linear(jnp.asarray(x)), ttf.srgb_to_linear(t(x)))
    jf, jm = jtf.flip_align_view(jnp.asarray(n), jnp.asarray(v))
    tf_, tm = ttf.flip_align_view(t(n), t(v))
    close(jf, tf_)
    assert np.array_equal(np.asarray(jm), tm.numpy())
    close(jtf.reflect(jnp.asarray(v), jnp.asarray(n)), ttf.reflect(t(v), t(n)))

    d = v / np.linalg.norm(v, axis=-1, keepdims=True)
    sh = rng.normal(size=(64, 3, 25)).astype(np.float32)
    for deg in range(5):
        close(jsh.eval_sh(deg, jnp.asarray(sh), jnp.asarray(d)), tsh.eval_sh(deg, t(sh), t(d)))
    close(
        jsh.sh_to_rgb(3, jnp.asarray(sh[..., :16]), jnp.asarray(v)),
        tsh.sh_to_rgb(3, t(sh[..., :16]), t(v)),
    )
    close(jsh.rgb_to_sh(jnp.asarray(x)), tsh.rgb_to_sh(t(x)))


def test_depth_to_normal_matches_jax():
    jc, tc = _cams()
    depth = 3.0 + np.random.default_rng(2).uniform(-0.3, 0.3, size=(30, 40)).astype(np.float32)
    depth[:5] = 0.0  # background rows: zero normals, no NaN
    close(
        jpoint.depth_to_normal(jc, jnp.asarray(depth)),
        tpoint.depth_to_normal(tc, torch.from_numpy(depth)),
    )


# ---------------------------------------------------------------- PNG codec --


def _png_with_filters(img: np.ndarray, ftypes) -> bytes:
    """Encode uint8 (H, W, C) with the given filter type per row (PNG spec
    section 9.2), as an independent encoder for the decoder's tests."""
    H, W, C = img.shape
    color = {1: 0, 3: 2, 4: 6}[C]
    raw = img.reshape(H, W * C).astype(np.int32)
    out = bytearray()
    for y in range(H):
        ft = ftypes[y % len(ftypes)]
        cur = raw[y]
        up = raw[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(C, np.int32), cur[:-C]])
        ul = np.concatenate([np.zeros(C, np.int32), up[:-C]])
        if ft == 0:
            pred = np.zeros_like(cur)
        elif ft == 1:
            pred = left
        elif ft == 2:
            pred = up
        elif ft == 3:
            pred = (left + up) >> 1
        else:
            p = left + up - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
        out.append(ft)
        out += ((cur - pred) & 0xFF).astype(np.uint8).tobytes()

    def chunk(t, b):
        return len(b).to_bytes(4, "big") + t + b + (zlib.crc32(t + b) & 0xFFFFFFFF).to_bytes(4, "big")

    ihdr = W.to_bytes(4, "big") + H.to_bytes(4, "big") + bytes([8, color, 0, 0, 0])
    return (
        b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(bytes(out))) + chunk(b"IEND", b"")
    )


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_codec_matches_pillow(tmp_path, channels):
    from PIL import Image

    rng = np.random.default_rng(channels)
    img = rng.integers(0, 256, size=(13, 17, channels), dtype=np.uint8)
    # Every filter type, each on several rows.
    path = tmp_path / "filters.png"
    path.write_bytes(_png_with_filters(img, [0, 1, 2, 3, 4]))
    pil = np.asarray(Image.open(path))
    pil = pil[..., None] if pil.ndim == 2 else pil
    assert np.array_equal(pil, img)
    assert np.array_equal(png.read_png(str(path)), img)
    assert png.read_png_size(str(path)) == (17, 13)
    # Pillow's own (adaptive-filter) encoding decodes the same.
    mode = {1: "L", 3: "RGB", 4: "RGBA"}[channels]
    Image.fromarray(img[..., 0] if channels == 1 else img, mode).save(tmp_path / "pil.png")
    assert np.array_equal(png.read_png(str(tmp_path / "pil.png")), img)
    # The port's encoder, read back by Pillow.
    if channels > 1:
        png.write_png(str(tmp_path / "port.png"), img)
        assert np.array_equal(np.asarray(Image.open(tmp_path / "port.png")), img)


# ------------------------------------------------------------ PLY / weights --


def _jax_model(rng, P=50, cap=64):
    pts = rng.normal(size=(P, 3)).astype(np.float32)
    cols = rng.uniform(size=(P, 3)).astype(np.float32)
    m = jgm.create_from_points(pts, cols, capacity=cap, rng=np.random.default_rng(5))
    # Non-trivial values in every leaf, so a layout slip shows.
    leaves = {
        name: np.asarray(getattr(m.params, name))
        + rng.normal(size=np.asarray(getattr(m.params, name)).shape).astype(np.float32) * 0.1
        for name in PARAM_SHAPES
    }
    return m.replace(
        params=m.params.replace(**{k: jnp.asarray(v) for k, v in leaves.items()}),
        active_sh_degree=jnp.int32(2),
    )


def test_jax_save_ply_loads_in_port(tmp_path):
    rng = np.random.default_rng(3)
    jm = _jax_model(rng)
    env = JEnv(base=jnp.asarray(rng.normal(size=(6, 8, 8, 3)).astype(np.float32)))
    path = str(tmp_path / "point_cloud.ply")
    jio.save_ply(jm, path, env1=env)

    tm, env1, env2 = tio.load_ply(path, device="cpu")
    jl, _, _ = jio.load_ply(path)
    assert tm.capacity == jl.capacity and env2 is None
    for name in PARAM_SHAPES:
        assert np.array_equal(
            getattr(tm, name).detach().numpy(), np.asarray(getattr(jl.params, name))
        ), name
    assert np.array_equal(tm.alive.numpy(), np.asarray(jl.alive))
    assert int(tm.active_sh_degree) == int(jl.active_sh_degree)
    assert np.array_equal(env1.base.detach().numpy(), np.asarray(env.base))

    # And back: the port's save_ply loads in the JAX package unchanged.
    path2 = str(tmp_path / "port.ply")
    tio.save_ply(tm, path2, env1=env1)
    jl2, jenv, _ = jio.load_ply(path2)
    for name in PARAM_SHAPES:
        assert np.array_equal(
            np.asarray(getattr(jl2.params, name)), np.asarray(getattr(jl.params, name))
        ), name
    assert np.array_equal(np.asarray(jenv.base), np.asarray(env.base))


def test_convert_matches_jax_model():
    rng = np.random.default_rng(4)
    jm = _jax_model(rng)
    tm = convert.gaussian_model_from_numpy(
        {k: np.asarray(getattr(jm.params, k)) for k in PARAM_SHAPES},
        np.asarray(jm.alive), int(jm.active_sh_degree), jm.max_sh_degree, device="cpu",
    )
    for k in PARAM_SHAPES:
        assert np.array_equal(getattr(tm, k).detach().numpy(), np.asarray(getattr(jm.params, k)))
    campos = np.array([0.5, -1.0, -3.0], np.float32)
    with torch.no_grad():
        close(jm.get_colors(jnp.asarray(campos)), tm.get_colors(torch.from_numpy(campos)))
        close(jm.get_world_normal(), tm.get_world_normal())
        close(jm.get_features(), tm.get_features())
        for prop in ("get_scaling", "get_rotation", "get_opacity", "get_refl",
                     "get_rough", "get_ori_color", "get_specular", "get_diffuse_color"):
            close(getattr(jm, prop), getattr(tm, prop))
    base = rng.normal(size=(6, 4, 4, 3)).astype(np.float32)
    assert np.array_equal(convert.env_light_from_numpy(base, device="cpu").base.detach().numpy(), base)


# ------------------------------------------------------------------ hygiene --

_HYGIENE = r"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "PIL", "imageio", "materialrefgs_tpu"):
    sys.modules[name] = None  # any import of these raises ImportError
import materialrefgs_torch
mods = [m.name for m in pkgutil.walk_packages(materialrefgs_torch.__path__, "materialrefgs_torch.")]
for m in mods:
    importlib.import_module(m)
import runpy
runpy.run_path("scripts/eval_torch.py", run_name="eval_torch_module")
print(len(mods))
"""


def test_port_imports_without_jax_flax_pillow():
    proc = subprocess.run(
        [sys.executable, "-c", _HYGIENE], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip().splitlines()[-1]) >= 20


def test_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    import importlib.util

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        tcams.look_at_camera(np.array([0.0, 0, -4]), np.zeros(3), np.array([0.0, 1, 0]), 0.9, 0.9, 8, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        TEnv.create(8)
    spec = importlib.util.spec_from_file_location("eval_torch", os.path.join(REPO, "scripts", "eval_torch.py"))
    eval_torch = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(eval_torch)
    (tmp_path / "point_cloud" / "iteration_7000").mkdir(parents=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        eval_torch.main(["-m", str(tmp_path), "-s", str(tmp_path)])
