"""The port's tile-sharded rasterization (parallel/tile_sharding.py) against
the JAX package's: `_tile_local_render` block by block in one process
against JAX rasterize_tile_sharded on 4 virtual devices (forward maps and
gradients), rasterize_tile_sharded itself over a gloo group, and
dp_tp_render_grads on a 2 x 2 grid of gloo processes against the JAX
function on a (2, 2) mesh. Tolerances are tests/test_tile_sharding.py's and
tests/test_data_parallel.py's."""
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from jax.sharding import Mesh  # noqa: E402

from materialrefgs_tpu.cameras import look_at_camera as jax_camera  # noqa: E402
from materialrefgs_tpu.ops.rasterize.api import RasterizeConfig as JRaster  # noqa: E402
from materialrefgs_tpu.parallel import tile_sharding as jts  # noqa: E402
from materialrefgs_tpu.parallel.data_parallel import stack_cameras  # noqa: E402

from materialrefgs_torch.cameras import look_at_camera as torch_camera  # noqa: E402
from materialrefgs_torch.ops.rasterize import api as tapi  # noqa: E402
from materialrefgs_torch.ops.rasterize.api import RasterizeConfig as TRaster  # noqa: E402
from materialrefgs_torch.parallel import tile_sharding as tts  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAPS = ["render", "feature", "normal", "depth", "alpha", "distortion"]


def scene(seed, P=64, S=4):
    rng = np.random.default_rng(seed)
    return [
        (rng.normal(size=(P, 3)) * 0.6).astype(np.float32),
        np.exp(rng.normal(size=(P, 2)) * 0.5 - 1.6).astype(np.float32),
        rng.normal(size=(P, 4)).astype(np.float32),
        rng.uniform(0.2, 0.9, size=(P,)).astype(np.float32),
        rng.uniform(size=(P, 3)).astype(np.float32),
        rng.uniform(size=(P, S)).astype(np.float32),
    ]


CAM = dict(eye=np.array([0.0, 0.0, -4.0]), target=np.zeros(3), up=np.array([0.0, 1.0, 0.0]), fovx=0.9, fovy=0.9)


def _loss(o, np_=jnp):
    return np_.mean((o["render"] - 0.3) ** 2) + 0.01 * np_.mean(o["depth"])


@pytest.fixture(scope="module")
def jax_ref():
    """JAX rasterize_tile_sharded on 4 virtual devices (one tile row each,
    48x64): forward maps and the gradients of a mixed loss."""
    mesh = Mesh(np.array(jax.devices()[:4]), ("tp",))
    cam = jax_camera(**CAM, width=48, height=64)
    args = [jnp.asarray(a) for a in scene(0)]
    bg = jnp.array([0.2, 0.1, 0.4])
    cfg = JRaster(pair_capacity=1 << 13, interpret=True)

    def loss(*a):
        out = jts.rasterize_tile_sharded(mesh, *a, camera=cam, bg_color=bg, config=cfg)
        return _loss(out), {k: out[k] for k in MAPS}

    # Jitted: eager shard_map dispatches the interpreted kernels op by op.
    (_, out), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2, 3, 4, 5), has_aux=True))(*args)
    return {k: np.asarray(out[k]) for k in MAPS}, [np.asarray(g) for g in grads]


def _blocks(args, cam, bg, world):
    """The sharded render in one process: every rank's block, joined."""
    grid_x, grid_y, rows_local = tts._grid(cam, world)
    blocks = [tts._tile_local_render(*args, cam, 1.0, TRaster(pair_capacity=1 << 13), r * rows_local,
                                     rows_local)[0] for r in range(world)]
    return tapi._unpack(torch.cat(blocks), args[5].shape[-1], grid_x, grid_y, cam.width, cam.height, bg)


def test_tile_local_blocks_match_jax(jax_ref):
    """The four row blocks joined equal the JAX sharded render (forward at
    tests/test_tile_sharding.py's tolerances) and its gradients (3e-3 x
    scale), and the port's unsharded render bit for bit."""
    jmaps, jgrads = jax_ref
    cam = torch_camera(**CAM, width=48, height=64, device="cpu")
    bg = torch.tensor([0.2, 0.1, 0.4])
    args = [torch.tensor(a, requires_grad=True) for a in scene(0)]
    out = _blocks(args, cam, bg, 4)
    for k in MAPS:
        np.testing.assert_allclose(out[k].detach().numpy(), jmaps[k], atol=2e-4, rtol=1e-3, err_msg=k)
    grads = torch.autograd.grad(_loss(out, torch), args)
    for name, a, b in zip(["means", "scales", "rots", "opac", "colors", "feats"], grads, jgrads):
        s = max(np.abs(b).max(), 1e-3)
        np.testing.assert_allclose(a.numpy(), b, atol=3e-3 * s + 1e-5, err_msg=name)
    # The blocks keep the view's pixel coordinates (row0): their forward maps
    # are the unsharded render's, bit for bit.
    with torch.no_grad():
        ref = tapi.rasterize(*args, cam, bg, config=TRaster(pair_capacity=1 << 13))
    for k in MAPS:
        assert torch.equal(out[k].detach(), ref[k]), k


def test_tile_sharded_over_a_gloo_group(tmp_path):
    """rasterize_tile_sharded in a one-rank gloo group (the whole view is
    one block) equals rasterize, forward and gradients."""
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        cam = torch_camera(**CAM, width=40, height=48, device="cpu")
        bg = torch.tensor([0.2, 0.1, 0.4])
        args = [torch.tensor(a, requires_grad=True) for a in scene(1)]
        out = tts.rasterize_tile_sharded(None, *args, cam, bg, config=TRaster(pair_capacity=1 << 13))
        ref = tapi.rasterize(*args, cam, bg, config=TRaster(pair_capacity=1 << 13))
        for k in MAPS:
            assert torch.equal(out[k], ref[k]), k
        assert int(out["overflow"]) == 0
        g1 = torch.autograd.grad(_loss(out, torch), args)
        g2 = torch.autograd.grad(_loss(ref, torch), args)
        for a, b in zip(g1, g2):
            assert torch.equal(a, b)
    finally:
        dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_dp_tp_grads_on_a_gloo_grid_match_jax(tmp_path):
    """dp_tp_render_grads on a 2 x 2 grid of gloo processes (cameras over
    dp, tile rows over tp; 32x56, whose last tile row is partial) against
    JAX dp_tp_render_grads on a (2, 2) mesh: loss rtol 1e-5, gradients
    3e-3 x scale + 1e-5."""
    Wd, Hd = 32, 56  # 4 tile rows, 2 per tp rank; rows 56-63 are padding
    args = scene(2, P=48, S=1)
    cams = [dict(eye=np.array([3.0 * np.sin(a), 0.4, -3.0 * np.cos(a)]), target=np.zeros(3),
                 up=np.array([0.0, 1.0, 0.0]), fovx=0.9, fovy=0.9) for a in (0.0, np.pi)]
    gt = np.random.default_rng(3).uniform(size=(2, Hd, Wd, 3)).astype(np.float32)
    np.savez(tmp_path / "in.npz", *args, gt=gt)
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _DPTP_WORKER, str(tmp_path), str(r), str(port), str(Wd), str(Hd)],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(4)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out[-3000:]}"

    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("dp", "tp"))
    jcams = stack_cameras([jax_camera(**c, width=Wd, height=Hd) for c in cams])
    ref = jax.jit(lambda *a: jts.dp_tp_render_grads(mesh, *a, JRaster(pair_capacity=1 << 12, interpret=True)))
    l_ref, g_ref = ref(*(jnp.asarray(a) for a in args), jcams, jnp.asarray(gt))
    results = [np.load(tmp_path / f"out{r}.npz") for r in range(4)]
    for r, res in enumerate(results):
        np.testing.assert_allclose(float(res["loss"]), float(l_ref), rtol=1e-5)
        for i, (name, b) in enumerate(zip(["means", "scales", "rots", "opac", "colors", "feats"], g_ref)):
            a, b = res[f"g{i}"], np.asarray(b)
            assert np.all(np.isfinite(a)), name
            s = max(np.abs(b).max(), 1e-3)
            np.testing.assert_allclose(a, b, atol=3e-3 * s + 1e-5, err_msg=f"rank {r} {name}")
        # Every rank holds the same reduced values.
        for k in res.files:
            assert np.array_equal(res[k], results[0][k]), (r, k)


_DPTP_WORKER = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from materialrefgs_torch.cameras import look_at_camera
from materialrefgs_torch.ops.rasterize.api import RasterizeConfig
from materialrefgs_torch.parallel import tile_sharding as tts

d, rank, port, W, H = sys.argv[1], int(sys.argv[2]), sys.argv[3], int(sys.argv[4]), int(sys.argv[5])
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=4, rank=rank)
dp_group, tp_group = tts.dp_tp_groups(2, 2)
z = np.load(f"{d}/in.npz")
args = [torch.from_numpy(z[f"arr_{i}"]) for i in range(6)]
a = (0.0, np.pi)[rank // 2]
cam = look_at_camera(np.array([3.0 * np.sin(a), 0.4, -3.0 * np.cos(a)]), np.zeros(3), np.array([0.0, 1.0, 0.0]),
                     0.9, 0.9, W, H, device="cpu")
loss, grads = tts.dp_tp_render_grads(dp_group, tp_group, *args, cam, torch.from_numpy(z["gt"][rank // 2]),
                                     RasterizeConfig(pair_capacity=1 << 12))
np.savez(f"{d}/out{rank}.npz", loss=loss.numpy(), **{f"g{i}": g.numpy() for i, g in enumerate(grads)})
dist.barrier()
dist.destroy_process_group()
"""
