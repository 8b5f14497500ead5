"""The tile rasterizer's prefilter and tile order in the port's plain
versions (the CUDA kernels repeat both; tests/test_torch_kernels_gpu.py holds
them to these versions on the card).

- The forward's exact prefilter (tiles_fwd.prefilter_skip) drops only
  (pixel, pair) that the exact path drops too: with and without it the plain
  forward is bit-identical, on a random scene and on pairs built to put alpha
  and rho within 1e-7..1e-3 of the 1/255 cut, with NaN payloads and pz = 0.
- Both plain versions give the same bits in any tile order (the kernels'
  blocks take tiles longest first).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from materialrefgs_torch.cameras import look_at_camera  # noqa: E402
from materialrefgs_torch.ops.rasterize import api, tiles_bwd, tiles_fwd  # noqa: E402
from materialrefgs_torch.ops.rasterize.layout import (  # noqa: E402
    ALPHA_MIN,
    ROW_LIN,
    ROW_MEAN2D,
    ROW_OPACITY,
    ROW_TU,
    ROW_TV,
    ROW_TW,
    acc_channels,
    out_layout,
    payload_channels_padded,
)

S = 2


def _scene_inputs(seed, opacity=(0.2, 0.95)):
    rng = np.random.default_rng(seed)
    P = 300
    arrays = (
        rng.normal(size=(P, 3)) * 0.6, np.exp(rng.normal(size=(P, 2)) * 0.5 - 1.6),
        rng.normal(size=(P, 4)), rng.uniform(*opacity, size=(P,)),
        rng.uniform(size=(P, 3)), rng.uniform(size=(P, S)),
    )
    cam = look_at_camera(np.array([0.0, 0.0, -4.0]), np.zeros(3), np.array([0.0, 1.0, 0.0]),
                         0.9, 0.7, 48, 32, device="cpu")
    ti = api.tile_inputs(*[torch.tensor(a, dtype=torch.float32) for a in arrays], cam,
                         config=api.RasterizeConfig(pair_capacity=1 << 14))
    assert int(ti.bins.overflow) == 0
    kw = dict(S=S, grid_x=ti.grid_x, grid_y=ti.grid_y, W=ti.W, H=ti.H)
    return (ti.payload, ti.bins.tile_start, ti.bins.tile_count), kw


def _boundary_inputs(seed, n=512):
    """One 16x16 tile of n axis-aligned splats (Tw = (0, 0, 1), so at pixel
    (x, y) px, py, pz = sv (x - cx), su (y - cy), su sv and rho3d = ((x -
    cx)/su)^2 + ((y - cy)/sv)^2). Each pair's opacity puts alpha at a target
    pixel within a relative 0..1e-3 of 1/255; half of them also put rho2d
    there on the same cut. Pairs 0-7 have su = 0 (pz = 0), pairs 8-15 a NaN
    in one of Tu, Tw, mean2d, opacity or a linear channel."""
    rng = np.random.default_rng(seed)
    tx, ty = rng.integers(0, 16, n), rng.integers(0, 16, n)
    su, sv = rng.uniform(1.0, 4.0, n), rng.uniform(1.0, 4.0, n)
    cx, cy = tx + rng.uniform(-1.5, 1.5, n), ty + rng.uniform(-1.5, 1.5, n)
    rho = ((tx - cx) / su) ** 2 + ((ty - cy) / sv) ** 2
    delta = rng.choice([-1e-3, -1e-5, -1e-6, -1e-7, 0.0, 1e-7, 1e-6, 1e-5, 1e-3], n)
    opacity = np.exp(rho / 2.0) * ALPHA_MIN * (1.0 + delta)
    near = rng.uniform(size=n) < 0.5
    mx = np.where(near, tx + np.sqrt(rho / 2.0) * (1.0 + delta), tx + 40.0)
    su[:8] = 0.0
    pay = np.zeros((payload_channels_padded(S), n))
    pay[ROW_TU:ROW_TU + 3] = np.stack([su, np.zeros(n), cx])
    pay[ROW_TV:ROW_TV + 3] = np.stack([np.zeros(n), sv, cy])
    pay[ROW_TW:ROW_TW + 3] = np.stack([np.zeros(n), np.zeros(n), np.ones(n)])
    pay[ROW_MEAN2D:ROW_MEAN2D + 2] = np.stack([mx, ty.astype(np.float64)])
    pay[ROW_OPACITY] = opacity
    pay[ROW_LIN:ROW_LIN + acc_channels(S)] = rng.uniform(size=(acc_channels(S), n))
    for i, row in zip(range(8, 16), (ROW_TU, ROW_TU + 2, ROW_TW + 2, ROW_MEAN2D, ROW_MEAN2D + 1,
                                     ROW_OPACITY, ROW_LIN, ROW_LIN + 3)):
        pay[row, i] = np.nan
    payload = torch.tensor(pay, dtype=torch.float32)
    return (payload, torch.tensor([0, n], dtype=torch.int32), torch.tensor([n], dtype=torch.int32)), \
        dict(S=S, grid_x=1, grid_y=1, W=16, H=16)


def _same_bits(a, b):
    return np.array_equal(a.numpy(), b.numpy(), equal_nan=True)


@pytest.mark.parametrize("case", ["scene", "scene_low_opacity", "boundary", "boundary_b"])
def test_fwd_prefilter_changes_no_bit(case):
    if case.startswith("scene"):
        args, kw = _scene_inputs(3, (0.005, 0.02) if case == "scene_low_opacity" else (0.2, 0.95))
    else:
        args, kw = _boundary_inputs(7 if case == "boundary" else 8)
    with_pf = tiles_fwd.rasterize_tiles_fwd_plain(*args, **kw, prefilter=True)
    without = tiles_fwd.rasterize_tiles_fwd_plain(*args, **kw, prefilter=False)
    assert _same_bits(with_pf, without)
    lay = out_layout(S)
    assert float(with_pf[..., lay["n_contrib"][0]].max()) > 0  # pairs do contribute
    if case.startswith("boundary"):
        # The prefilter does skip here, and some pairs sit right on the cut.
        pay = args[0]
        ys, xs = torch.meshgrid(torch.arange(16.0), torch.arange(16.0), indexing="ij")
        x, y = xs.reshape(-1, 1), ys.reshape(-1, 1)
        k = [x * pay[ROW_TW + i] - pay[ROW_TU + i] for i in range(3)]
        l_ = [y * pay[ROW_TW + i] - pay[ROW_TV + i] for i in range(3)]
        px, py, pz = k[1] * l_[2] - k[2] * l_[1], k[2] * l_[0] - k[0] * l_[2], k[0] * l_[1] - k[1] * l_[0]
        rho2d = 2.0 * ((pay[ROW_MEAN2D] - x) ** 2 + (pay[ROW_MEAN2D + 1] - y) ** 2)
        skip = tiles_fwd.prefilter_skip(px, py, pz, rho2d, tiles_fwd.prefilter_bound(pay[ROW_OPACITY]))
        assert 0.5 < float(skip.float().mean()) < 1.0
        # pz = 0 and a NaN in the geometry or the opacity fall through (a
        # NaN in a linear channel, pairs 14-15, leaves the test as it is).
        assert not bool(skip[:, :14].any())


def test_prefilter_bound_is_safe_per_pair():
    """Where the prefilter skips, the forward's own alpha (computed as the
    kernels compute it) is below 1/255: checked per (pixel, pair) on the
    boundary pairs, whose alphas straddle the cut by 1e-7..1e-3."""
    (pay, _, _), _ = _boundary_inputs(9)
    ys, xs = torch.meshgrid(torch.arange(16.0), torch.arange(16.0), indexing="ij")
    x, y = xs.reshape(-1, 1), ys.reshape(-1, 1)
    k = [x * pay[ROW_TW + i] - pay[ROW_TU + i] for i in range(3)]
    l_ = [y * pay[ROW_TW + i] - pay[ROW_TV + i] for i in range(3)]
    px, py, pz = k[1] * l_[2] - k[2] * l_[1], k[2] * l_[0] - k[0] * l_[2], k[0] * l_[1] - k[1] * l_[0]
    rho2d = 2.0 * ((pay[ROW_MEAN2D] - x) ** 2 + (pay[ROW_MEAN2D + 1] - y) ** 2)
    pz_safe = torch.where(pz != 0, pz, torch.ones_like(pz))
    rho3d = (px / pz_safe) ** 2 + (py / pz_safe) ** 2
    alpha = torch.clamp(pay[ROW_OPACITY] * torch.exp(-0.5 * torch.minimum(rho3d, rho2d)), max=0.99)
    skip = tiles_fwd.prefilter_skip(px, py, pz, rho2d, tiles_fwd.prefilter_bound(pay[ROW_OPACITY]))
    assert bool(skip.any())
    assert not bool((alpha[skip] >= ALPHA_MIN).any())
    near_cut = (alpha > 0.999 * ALPHA_MIN) & (alpha < 1.001 * ALPHA_MIN)
    assert int(near_cut.sum()) > 20  # the cut is exercised from both sides


@pytest.mark.parametrize("seed", [4, 5])
def test_plain_versions_ignore_the_tile_order(seed):
    args, kw = _scene_inputs(seed)
    T = kw["grid_x"] * kw["grid_y"]
    perm = torch.from_numpy(np.random.default_rng(seed).permutation(T)).to(torch.int32)
    fwd = tiles_fwd.rasterize_tiles_fwd_plain(*args, **kw)
    assert _same_bits(fwd, tiles_fwd.rasterize_tiles_fwd_plain(*args, **kw, tile_order=perm))
    lay = out_layout(S)
    active = torch.amax(fwd[..., lay["n_contrib"][0]], dim=1).to(torch.int32)
    cot = torch.from_numpy(np.random.default_rng(seed + 10).normal(size=fwd.shape).astype(np.float32))
    cot[..., lay["_channels"]:] = 0.0
    bargs = (*args, active, fwd, cot)
    ref = tiles_bwd.rasterize_tiles_bwd_plain(*bargs, **kw)
    assert float(ref.abs().max()) > 0
    assert _same_bits(ref, tiles_bwd.rasterize_tiles_bwd_plain(*bargs, **kw, tile_order=perm))
    # The default order is the kernels': longest walk first.
    order = tiles_fwd.longest_first(active)
    assert bool((active[order.long()][1:] <= active[order.long()][:-1]).all())
