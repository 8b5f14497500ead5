"""The port's hand-written CUDA kernels against their plain torch versions,
on the card. Marked `gpu`; each test skips where no CUDA card is present.

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch:
    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_kernels_gpu.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from materialrefgs_torch.cameras import look_at_camera  # noqa: E402
from materialrefgs_torch.ops.rasterize import api  # noqa: E402
from materialrefgs_torch.ops.rasterize import tiles_fwd  # noqa: E402
from materialrefgs_torch.ops.rasterize.layout import out_layout  # noqa: E402

# Per output group (tests/test_rasterize_pallas.py); contributor indices exact.
TOLS = {
    "color": 2e-4, "feature": 2e-4, "normal": 2e-4, "M1": 2e-4, "M2": 2e-4,
    "final_T": 2e-4, "depth": 1e-3, "median_depth": 1e-3, "distortion": 5e-4,
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _scene(seed, P, S, device):
    rng = np.random.default_rng(seed)
    arrays = (
        rng.normal(size=(P, 3)) * 0.6,
        np.exp(rng.normal(size=(P, 2)) * 0.5 - 2.0),
        rng.normal(size=(P, 4)),
        rng.uniform(0.2, 0.95, size=(P,)),
        rng.uniform(size=(P, 3)),
        rng.uniform(size=(P, S)),
    )
    return [torch.tensor(a, dtype=torch.float32, device=device) for a in arrays]


@pytest.mark.gpu
@pytest.mark.parametrize("S", [1, 9])
@pytest.mark.parametrize("size", [(256, 192), (201, 133)])
def test_rasterize_fwd_kernel_matches_plain(cuda_device, S, size):
    W, H = size
    cam = look_at_camera(
        np.array([0.0, 0.0, -4.0]), np.zeros(3), np.array([0.0, 1.0, 0.0]),
        0.9, 0.7, W, H, device=cuda_device,
    )
    ti = api.tile_inputs(
        *_scene(5, 6000, S, cuda_device), cam, config=api.RasterizeConfig(pair_capacity=1 << 19)
    )
    assert int(ti.bins.overflow) == 0
    assert int(ti.bins.tile_count.max()) > 256  # more than one shared-memory batch
    args = (ti.payload, ti.bins.tile_start, ti.bins.tile_count)
    kw = dict(S=S, grid_x=ti.grid_x, grid_y=ti.grid_y, W=W, H=H)
    before = tiles_fwd.rasterize_tiles_fwd.launches
    out = tiles_fwd.rasterize_tiles_fwd(*args, **kw)
    torch.cuda.synchronize()
    assert tiles_fwd.rasterize_tiles_fwd.launches == before + 1
    ref = tiles_fwd.rasterize_tiles_fwd_plain(*args, **kw)
    out, ref = out.cpu().numpy(), ref.cpu().numpy()
    lay = out_layout(S)
    for name, tol in TOLS.items():
        lo, hi = lay[name]
        np.testing.assert_allclose(out[..., lo:hi], ref[..., lo:hi], atol=tol, rtol=1e-3, err_msg=name)
    for name in ("n_contrib", "median_contrib"):
        lo, hi = lay[name]
        assert np.array_equal(out[..., lo:hi], ref[..., lo:hi]), name
    assert np.all(out[..., lay["_channels"]:] == 0.0)
