"""The port's hand-written CUDA kernels (tile rasterizer forward and
backward, bundle tracer forward and backward, the JPEG decoder's inverse
DCT and colour conversion) against their plain torch versions, on the card. Marked `gpu`; each test skips where no CUDA card is present.

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch:
    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_kernels_gpu.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from materialrefgs_torch.cameras import look_at_camera  # noqa: E402
from materialrefgs_torch.ops.rasterize import api  # noqa: E402
from materialrefgs_torch.ops.rasterize import tiles_bwd, tiles_fwd  # noqa: E402
from materialrefgs_torch.ops.rasterize.layout import out_layout  # noqa: E402
from materialrefgs_torch.ops.tracer import api as tracer_api  # noqa: E402
from materialrefgs_torch.ops.tracer import layout as tlay  # noqa: E402
from materialrefgs_torch.ops.tracer import trace_bwd, trace_fwd  # noqa: E402
from materialrefgs_torch.utils import jpeg  # noqa: E402

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
@pytest.mark.parametrize("S", [1, 9, 10])
@pytest.mark.parametrize("size", [(256, 192), (201, 133), (1236, 821)])
def test_rasterize_fwd_kernel_matches_plain(cuda_device, S, size):
    W, H = size
    cam = look_at_camera(
        np.array([0.0, 0.0, -4.0]), np.zeros(3), np.array([0.0, 1.0, 0.0]),
        0.9, 0.7, W, H, device=cuda_device,
    )
    ti = api.tile_inputs(
        *_scene(5, 6000, S, cuda_device), cam, config=api.RasterizeConfig(pair_capacity=1 << 22)
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


@pytest.mark.gpu
@pytest.mark.parametrize("S", [1, 9, 10])
@pytest.mark.parametrize("size", [(256, 192), (201, 133), (1236, 821)])
def test_rasterize_bwd_kernel_matches_plain(cuda_device, S, size):
    """Per-pair gradients for a random cotangent, every gradient value within
    1e-4 x (its own magnitude + the 99th percentile of its group's nonzero
    magnitudes, at most the group's largest magnitude) + 1e-7 (the sum over a tile's pixels is taken in another order
    than torch.sum's, so a sum that cancels may differ by more than 1e-4 of
    itself; an error at the group's typical magnitude fails)."""
    W, H = size
    cam = look_at_camera(
        np.array([0.0, 0.0, -4.0]), np.zeros(3), np.array([0.0, 1.0, 0.0]),
        0.9, 0.7, W, H, device=cuda_device,
    )
    ti = api.tile_inputs(
        *_scene(6, 6000, S, cuda_device), cam, config=api.RasterizeConfig(pair_capacity=1 << 22)
    )
    assert int(ti.bins.overflow) == 0
    kw = dict(S=S, grid_x=ti.grid_x, grid_y=ti.grid_y, W=W, H=H)
    fwd = tiles_fwd.rasterize_tiles_fwd(ti.payload, ti.bins.tile_start, ti.bins.tile_count, **kw)
    lay = out_layout(S)
    active = torch.amax(fwd[..., lay["n_contrib"][0]], dim=1).to(torch.int32)
    assert int(active.max()) > 32  # more than one shared-memory batch
    gen = torch.Generator(device=cuda_device).manual_seed(S)
    cot = torch.randn(fwd.shape, device=cuda_device, generator=gen)
    cot[..., lay["_channels"]:] = 0.0
    args = (ti.payload, ti.bins.tile_start, ti.bins.tile_count, active, fwd, cot)
    before = tiles_bwd.rasterize_tiles_bwd.launches
    out = tiles_bwd.rasterize_tiles_bwd(*args, **kw)
    torch.cuda.synchronize()
    assert tiles_bwd.rasterize_tiles_bwd.launches == before + 1
    ref = tiles_bwd.rasterize_tiles_bwd_plain(*args, **kw)
    out, ref = out.cpu().numpy(), ref.cpu().numpy()
    assert np.all(np.isfinite(out))
    for lo, hi in ((0, 9), (9, 11), (11, 12), (12, out.shape[1])):
        mag = np.abs(ref[:, lo:hi])
        p99 = float(np.quantile(mag[mag > 0], 0.99))
        tol = 1e-4 * np.minimum(mag + p99, mag.max()) + 1e-7
        err = np.abs(out[:, lo:hi] - ref[:, lo:hi])
        assert np.all(err <= tol), (lo, hi, float((err / tol).max()))


@pytest.mark.gpu
def test_rasterize_kernels_match_plain_on_a_block_grid(cuda_device):
    """A tile-sharded block (tile rows 9-17 of a 256x288 view, row0 = 9):
    the forward kernel against its plain version bit for bit, and both
    against the whole view's rows; the backward per value as above."""
    W, H = 256, 288
    cam = look_at_camera(
        np.array([0.0, 0.0, -4.0]), np.zeros(3), np.array([0.0, 1.0, 0.0]),
        0.9, 0.9, W, H, device=cuda_device,
    )
    S, row0, rows = 9, 9, 9
    args = _scene(7, 6000, S, cuda_device)
    cfg = api.RasterizeConfig(pair_capacity=1 << 22)
    si = api._sorted_inputs(*args, cam, 1.0, cfg, rows=(row0, rows))
    assert (si.grid_y, si.row0, int(si.bins.overflow)) == (rows, row0, 0)
    pp = api._gather_pairs(si.payload_g, si.bins.g_sorted)
    kw = dict(S=S, grid_x=si.grid_x, grid_y=rows, W=W, H=H, row0=row0)
    tiles = (pp, si.bins.tile_start, si.bins.tile_count)
    out = tiles_fwd.rasterize_tiles_fwd(*tiles, **kw)
    assert torch.equal(out, tiles_fwd.rasterize_tiles_fwd_plain(*tiles, **kw))
    whole = api.rasterize(*args, cam, torch.zeros(3, device=cuda_device), config=cfg)
    block = api._unpack(out, S, si.grid_x, rows, W, rows * 16, torch.zeros(3, device=cuda_device))
    # n_contrib counts positions in a tile's pair list, which the keep mask
    # may cut shorter for a block's clipped rects; the maps are the view's.
    for k in ("render", "feature", "normal", "depth", "alpha", "distortion"):
        assert torch.equal(block[k], whole[k][row0 * 16:(row0 + rows) * 16]), k
    lay = out_layout(S)
    active = torch.amax(out[..., lay["n_contrib"][0]], dim=1).to(torch.int32)
    cot = torch.randn(out.shape, device=cuda_device, generator=torch.Generator(device=cuda_device).manual_seed(1))
    cot[..., lay["_channels"]:] = 0.0
    got = tiles_bwd.rasterize_tiles_bwd(*tiles, active, out, cot, **kw).cpu().numpy()
    ref = tiles_bwd.rasterize_tiles_bwd_plain(*tiles, active, out, cot, **kw).cpu().numpy()
    for lo, hi in ((0, 9), (9, 11), (11, 12), (12, got.shape[1])):
        mag = np.abs(ref[:, lo:hi])
        p99 = float(np.quantile(mag[mag > 0], 0.99))
        tol = 1e-4 * np.minimum(mag + p99, mag.max()) + 1e-7
        err = np.abs(got[:, lo:hi] - ref[:, lo:hi])
        assert np.all(err <= tol), (lo, hi, float((err / tol).max()))


@pytest.mark.gpu
def test_rasterize_autograd_launches_both_kernels(cuda_device):
    """One forward and one backward launch per differentiated render."""
    cam = look_at_camera(
        np.array([0.0, 0.0, -4.0]), np.zeros(3), np.array([0.0, 1.0, 0.0]),
        0.9, 0.7, 128, 96, device=cuda_device,
    )
    arrays = _scene(7, 2000, 4, cuda_device)
    for a in arrays:
        a.requires_grad_(True)
    f0, b0 = tiles_fwd.rasterize_tiles_fwd.launches, tiles_bwd.rasterize_tiles_bwd.launches
    out = api.rasterize(*arrays, cam, torch.zeros(3, device=cuda_device))
    grads = torch.autograd.grad(out["render"].sum() + out["depth"].sum(), arrays)
    torch.cuda.synchronize()
    assert tiles_fwd.rasterize_tiles_fwd.launches == f0 + 1
    assert tiles_bwd.rasterize_tiles_bwd.launches == b0 + 1
    for g in grads:
        assert torch.isfinite(g).all()


def _hard_raster_inputs(case, device):
    """Inputs the redesigned rasterizer kernels must handle: one tile whose
    list is thousands of pairs long (splats piled on the image centre), or
    every splat at opacity 0.01 (after an opacity reset: no pixel stops, so
    every walk runs the whole list and nearly every test fails alpha)."""
    rng = np.random.default_rng(41 if case == "long_tile" else 42)
    P, S = 6000, 10
    means = rng.normal(size=(P, 3)) * (0.02 if case == "long_tile" else 0.6)
    opac = rng.uniform(0.01, 0.05, P) if case == "long_tile" else np.full(P, 0.01)
    arrays = (means, np.exp(rng.normal(size=(P, 2)) * 0.5 - 2.0), rng.normal(size=(P, 4)), opac,
              rng.uniform(size=(P, 3)), rng.uniform(size=(P, S)))
    cam = look_at_camera(np.array([0.0, 0.0, -4.0]), np.zeros(3), np.array([0.0, 1.0, 0.0]),
                         0.9, 0.7, 256, 192, device=device)
    ti = api.tile_inputs(*[torch.tensor(a, dtype=torch.float32, device=device) for a in arrays], cam,
                         config=api.RasterizeConfig(pair_capacity=1 << 20))
    assert int(ti.bins.overflow) == 0
    kw = dict(S=S, grid_x=ti.grid_x, grid_y=ti.grid_y, W=256, H=192)
    return (ti.payload, ti.bins.tile_start, ti.bins.tile_count), kw


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["long_tile", "post_reset"])
def test_rasterize_kernels_match_plain_on_long_walks(cuda_device, case):
    """Both rasterizer kernels against their plain versions where the walks
    are long: the forward bit for bit, the backward per value (the rule of
    test_rasterize_bwd_kernel_matches_plain)."""
    args, kw = _hard_raster_inputs(case, cuda_device)
    counts = args[2]
    if case == "long_tile":
        assert int(counts.max()) > 2000 and int(counts.max()) > 10 * float(counts.float().mean())
    out = tiles_fwd.rasterize_tiles_fwd(*args, **kw)
    ref = tiles_fwd.rasterize_tiles_fwd_plain(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)
    lay = out_layout(kw["S"])
    active = torch.amax(out[..., lay["n_contrib"][0]], dim=1).to(torch.int32)
    if case == "post_reset":
        assert int(active.max()) > 500 and bool((out[..., lay["final_T"][0]] > 1e-4).all())
    cot = torch.randn(out.shape, device=cuda_device, generator=torch.Generator(device=cuda_device).manual_seed(3))
    cot[..., lay["_channels"]:] = 0.0
    bargs = (*args, active, out, cot)
    got = tiles_bwd.rasterize_tiles_bwd(*bargs, **kw).cpu().numpy()
    want = tiles_bwd.rasterize_tiles_bwd_plain(*bargs, **kw).cpu().numpy()
    assert np.all(np.isfinite(got))
    for lo, hi in ((0, 9), (9, 11), (11, 12), (12, got.shape[1])):
        assert _per_value_ok(got[:, lo:hi], want[:, lo:hi]) <= 1.0, (lo, hi)


def _trace_scene(seed, device, P=4000, NB=12):
    """Surfels in front of 12 coherent ray bundles looking down +z; bundle 3
    is masked (an empty segment) and bundles 8-11 look into an opaque core
    (every ray stops, the bundle exits early)."""
    rng = np.random.default_rng(seed)
    means = np.concatenate([rng.uniform(-1.2, 1.2, (P, 3)), rng.normal(size=(P // 4, 3)) * 0.15])
    means[:, 2] = np.abs(means[:, 2]) + 0.2 * np.arange(len(means)) / len(means)
    n = len(means)
    opac = np.concatenate([rng.uniform(0.2, 0.9, P), np.full(P // 4, 0.98)])
    shs = rng.normal(size=(n, 16, 3)) * 0.3
    o = np.zeros((NB, 256, 3))
    o[..., :2] = rng.uniform(-0.3, 0.3, (NB, 256, 2)) + rng.uniform(-0.8, 0.8, (NB, 1, 2))
    o[8:, :, :2] *= 0.1
    o[..., 2] = -3.0
    d = np.zeros((NB, 256, 3))
    d[..., :2] = rng.uniform(-0.05, 0.05, (NB, 256, 2))
    d[..., 2] = 1.0
    arrays = (o.reshape(-1, 3), d.reshape(-1, 3), means, np.exp(rng.normal(size=(n, 2)) * 0.3 - 2.6),
              rng.normal(size=(n, 4)), opac, shs)
    mask = torch.ones(NB, dtype=torch.bool, device=device)
    mask[3] = False
    return [torch.tensor(a, dtype=torch.float32, device=device) for a in arrays], mask


@pytest.mark.gpu
@pytest.mark.parametrize("R", [2, 64], ids=["R2", "R64"])
@pytest.mark.parametrize("exact", [False, True], ids=["list", "exact"])
@pytest.mark.parametrize("n_sh", [1, 16])
def test_trace_fwd_kernel_matches_plain(cuda_device, n_sh, exact, R):
    """All 16 output channels and the residual (per-chunk log T, hit masks) bit for bit
    (the kernels repeat the plain version's operations in its order, built
    without FMA contraction), with ranges of R chunks: 2, below the longest
    walk, and 64, above it (every bundle one range)."""
    (o, d, means, scales, rots, opac, shs), mask = _trace_scene(3, cuda_device)
    captured = {}
    real = tracer_api.trace_bundles_fwd

    def capture(*args, **kw):
        captured["args"], captured["kw"] = args, kw
        return real(*args, **kw)

    tracer_api.trace_bundles_fwd = capture
    try:
        with torch.no_grad():
            res = tracer_api.trace(o, d, means, scales, rots, opac, shs,
                                   tracer_api.TracerConfig(pair_capacity=1 << 17, exact_order=exact),
                                   sh_degree=3 if n_sh == 16 else 0, bundle_mask=mask)
    finally:
        tracer_api.trace_bundles_fwd = real
    assert res["overflow"] == 0
    args, kw = captured["args"], captured["kw"]
    count = args[3]
    assert int(count[3]) == 0 and int(count.max()) > 3 * tlay.K_CHUNK
    kw = dict(kw, range_chunks=R)
    res_k, res_p = (trace_fwd.new_residual(args[0]).zero_() for _ in "kp")
    before = trace_fwd.trace_bundles_fwd.launches
    out = trace_fwd.trace_bundles_fwd(*args, **dict(kw, residual=res_k))
    torch.cuda.synchronize()
    assert trace_fwd.trace_bundles_fwd.launches == before + 1
    ref = trace_fwd.trace_bundles_fwd_plain(*args, **dict(kw, residual=res_p))
    out, ref = out.cpu().numpy(), ref.cpu().numpy()
    nproc = ref[:, 0, tlay.OUT_NPROC]
    n_chunks = (count.cpu().numpy() + tlay.K_CHUNK - 1) // tlay.K_CHUNK
    assert (nproc[8:] < n_chunks[8:]).any()  # an early exit
    assert (R < nproc.max()) == (R == 2)
    np.testing.assert_array_equal(out, ref)
    starts = args[2].cpu().numpy() // tlay.K_CHUNK
    for b in range(len(nproc)):  # the rows of the processed chunks
        rows = slice(int(starts[b]), int(starts[b] + nproc[b]))
        assert torch.equal(res_k[rows], res_p[rows]), b


def _per_value_ok(out, ref):
    """|out - ref| <= 1e-4 x min(|ref| + the group's p99 |ref|, the group's
    max |ref|) + 1e-7 (the rasterizer backward's rule: sums over a bundle's
    rays and a chunk's lanes are taken in another order)."""
    mag = np.abs(ref)
    nz = mag[mag > 0]
    p99 = float(np.quantile(nz, 0.99)) if nz.size else 0.0
    tol = 1e-4 * np.minimum(mag + p99, mag.max()) + 1e-7
    return float((np.abs(out - ref) / tol).max())


@pytest.mark.gpu
@pytest.mark.parametrize("R", [2, 64], ids=["R2", "R64"])
@pytest.mark.parametrize("exact", [False, True], ids=["list", "exact"])
@pytest.mark.parametrize("n_sh", [1, 16])
def test_trace_bwd_kernel_matches_plain(cuda_device, n_sh, exact, R):
    """Payload and ray gradients for a random cotangent on rgb, depth, normal
    and final_T, per value within _per_value_ok's rule for each payload row
    group and for ray origin and direction; columns outside the walked chunks
    zero."""
    (o, d, means, scales, rots, opac, shs), mask = _trace_scene(4, cuda_device)
    captured = {}
    real = tracer_api.trace_bundles_fwd

    def capture(*args, **kw):
        captured["args"], captured["kw"] = args, kw
        return real(*args, **kw)

    tracer_api.trace_bundles_fwd = capture
    try:
        with torch.no_grad():
            tracer_api.trace(o, d, means, scales, rots, opac, shs,
                             tracer_api.TracerConfig(pair_capacity=1 << 17, exact_order=exact),
                             sh_degree=3 if n_sh == 16 else 0, bundle_mask=mask)
    finally:
        tracer_api.trace_bundles_fwd = real
    payload, rays, start, count = captured["args"]
    kw = dict(captured["kw"], range_chunks=R)
    fwd = trace_fwd.trace_bundles_fwd(payload, rays, start, count, **kw)
    kw.pop("residual")
    if exact:
        active = torch.amax(fwd[..., tlay.OUT_NPROC], dim=1).to(torch.int32) * tlay.K_CHUNK
    else:
        active = torch.amax(fwd[..., tlay.OUT_NCONTRIB], dim=1).to(torch.int32)
    assert int(active.max()) > 3 * tlay.K_CHUNK  # a multi-chunk walk
    cot = torch.zeros_like(fwd)
    cot[..., :8] = torch.randn(fwd.shape[:2] + (8,), device=cuda_device,
                               generator=torch.Generator(device=cuda_device).manual_seed(n_sh + exact))
    args = (payload, rays, start, count, active, fwd, cot)
    before = trace_bwd.trace_bundles_bwd.launches
    dp, dr = trace_bwd.trace_bundles_bwd(*args, **kw)
    torch.cuda.synchronize()
    assert trace_bwd.trace_bundles_bwd.launches == before + 1
    rp, rr = trace_bwd.trace_bundles_bwd_plain(*args, **kw)
    dp, dr, rp, rr = (x.cpu().numpy() for x in (dp, dr, rp, rr))
    assert np.all(np.isfinite(dp)) and np.all(np.isfinite(dr))
    nrow = 13 + 3 * n_sh
    assert np.all(dp[nrow:] == 0.0)
    for lo, hi in ((0, 3), (3, 6), (6, 9), (9, 12), (12, 13), (13, nrow)):
        assert _per_value_ok(dp[lo:hi], rp[lo:hi]) <= 1.0, (lo, hi)
    for lo, hi in ((0, 3), (3, 6)):
        assert _per_value_ok(dr[..., lo:hi], rr[..., lo:hi]) <= 1.0, (lo, hi)
    assert np.all(dr[..., 6:] == 0.0)


@pytest.mark.gpu
def test_trace_autograd_launches_both_kernels(cuda_device):
    """One forward and one backward tracer launch per differentiated trace."""
    arrays, mask = _trace_scene(5, cuda_device)
    for a in arrays:
        a.requires_grad_(True)
    f0, b0 = trace_fwd.trace_bundles_fwd.launches, trace_bwd.trace_bundles_bwd.launches
    out = tracer_api.trace(*arrays, tracer_api.TracerConfig(pair_capacity=1 << 17, exact_order=True),
                           sh_degree=3, bundle_mask=mask)
    grads = torch.autograd.grad(out["rgb"].sum() + out["depth"].sum() + out["final_T"].sum(), arrays)
    torch.cuda.synchronize()
    assert trace_fwd.trace_bundles_fwd.launches == f0 + 1
    assert trace_bwd.trace_bundles_bwd.launches == b0 + 1
    for g in grads:
        assert torch.isfinite(g).all()
    assert float(grads[2].abs().sum()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("exact", [False, True], ids=["list", "exact"])
def test_trace_kernels_match_plain_on_partial_tile_bundles(cuda_device, exact):
    """Rays of a 37x21 frame in the renderer's 16x16 tile-bundle order
    (render/envgs.rays_to_bundles: the last bundle column and row are
    partial, their missing rays replicate the frame's edge), as refreal's
    1236x821 frames give them: the forward kernel bit for bit and the
    backward per value against their plain versions."""
    from materialrefgs_torch.render.envgs import rays_to_bundles

    (_, _, means, scales, rots, opac, shs), _ = _trace_scene(6, cuda_device)
    Hf, Wf = 21, 37
    yy, xx = torch.meshgrid(torch.linspace(-0.9, 0.9, Hf, device=cuda_device),
                            torch.linspace(-1.1, 1.1, Wf, device=cuda_device), indexing="ij")
    o = torch.stack([xx, yy, torch.full_like(xx, -3.0)], -1)
    d = torch.stack([0.03 * xx, 0.03 * yy, torch.ones_like(xx)], -1)
    o, d = rays_to_bundles(o, Hf, Wf), rays_to_bundles(d, Hf, Wf)
    assert o.shape[0] == 3 * 2 * 256  # 6 bundles, the last column and row partial
    captured = {}
    real = tracer_api.trace_bundles_fwd

    def capture(*args, **kw):
        captured["args"], captured["kw"] = args, kw
        return real(*args, **kw)

    tracer_api.trace_bundles_fwd = capture
    try:
        with torch.no_grad():
            res = tracer_api.trace(o, d, means, scales, rots, opac, shs,
                                   tracer_api.TracerConfig(pair_capacity=1 << 17, exact_order=exact), sh_degree=3)
    finally:
        tracer_api.trace_bundles_fwd = real
    assert res["overflow"] == 0
    payload, rays, start, count = captured["args"]
    kw = {k: v for k, v in captured["kw"].items() if k != "residual"}
    assert int(count.min()) > 0
    out = trace_fwd.trace_bundles_fwd(payload, rays, start, count, **kw)
    torch.cuda.synchronize()
    ref = trace_fwd.trace_bundles_fwd_plain(payload, rays, start, count, **kw)
    np.testing.assert_array_equal(out.cpu().numpy(), ref.cpu().numpy())
    if exact:
        active = torch.amax(out[..., tlay.OUT_NPROC], dim=1).to(torch.int32) * tlay.K_CHUNK
    else:
        active = torch.amax(out[..., tlay.OUT_NCONTRIB], dim=1).to(torch.int32)
    cot = torch.zeros_like(out)
    cot[..., :8] = torch.randn(out.shape[:2] + (8,), device=cuda_device,
                               generator=torch.Generator(device=cuda_device).manual_seed(7 + exact))
    args = (payload, rays, start, count, active, out, cot)
    dp, dr = trace_bwd.trace_bundles_bwd(*args, **kw)
    torch.cuda.synchronize()
    rp, rr = trace_bwd.trace_bundles_bwd_plain(*args, **kw)
    dp, dr, rp, rr = (x.cpu().numpy() for x in (dp, dr, rp, rr))
    nrow = 13 + 3 * 16
    for lo, hi in ((0, 3), (3, 6), (6, 9), (9, 12), (12, 13), (13, nrow)):
        assert _per_value_ok(dp[lo:hi], rp[lo:hi]) <= 1.0, (lo, hi)
    for lo, hi in ((0, 3), (3, 6)):
        assert _per_value_ok(dr[..., lo:hi], rr[..., lo:hi]) <= 1.0, (lo, hi)


@pytest.mark.gpu
@pytest.mark.parametrize("sampling,rgb", [((1, 1), False), ((2, 1), False), ((2, 2), False), ((1, 2), False),
                                          (None, False), ((1, 1), True), ((2, 2), True)],
                         ids=["444", "422", "420", "440", "gray", "rgb-444", "rgb-420"])
def test_jpeg_kernel_matches_plain(cuda_device, tmp_path, sampling, rgb):
    """idct_color's kernel against its plain version on the coefficients of
    chip_smoke_jpeg's files (odd sizes, a restart interval; YCbCr, gray and
    RGB stored untransformed): every byte equal, one launch per call."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke_jpeg

    rng = np.random.default_rng(3)
    for H, W in ((1, 1), (37, 53), (821, 1236)):
        img = rng.integers(0, 256, size=(H, W, 3)).astype(np.uint8)
        path = str(tmp_path / "p.jpg")
        chip_smoke_jpeg.write_jpeg(path, img[..., 0] if sampling is None else img, quality=95,
                                   sampling=sampling or (1, 1), restart_interval=5, rgb=rgb)
        co = jpeg.read_coefficients(path)
        assert co.color == (jpeg.GRAY if sampling is None else jpeg.RGB if rgb else jpeg.YCC)
        args = (torch.from_numpy(co.coef), torch.from_numpy(co.quant), co.comps, co.height, co.width, co.color)
        before = jpeg.idct_color.launches
        out = jpeg.idct_color(args[0].to(cuda_device), args[1].to(cuda_device), *args[2:])
        torch.cuda.synchronize()
        assert jpeg.idct_color.launches == before + 1
        np.testing.assert_array_equal(out.cpu().numpy(), jpeg.idct_color_plain(*args).numpy())
