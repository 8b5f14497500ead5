"""Tile rasterizer forward: the plain version only (a frozen copy of the port's plain
torch version, which the benchmark's reference runs on every device; the
CUDA kernel and its wrapper are left out)."""
from __future__ import annotations


import torch

from perfbench.reference.plain.ops.rasterize.layout import (
    ALPHA_MAX,
    ALPHA_MIN,
    DEAD,
    FAR_N,
    FILTER_INV_SQUARE,
    LOG_HALF,
    LOG_T_STOP,
    NEAR_N,
    PIX,
    ROW_LIN,
    ROW_MEAN2D,
    ROW_OPACITY,
    ROW_TU,
    ROW_TV,
    ROW_TW,
    TILE,
    acc_channels,
    out_channels_padded,
    out_layout,
)

PZ2_MIN = 1e-30  # below it the prefilter defers to the exact path
# Feature widths the kernels are instantiated for: 1..MAX_S (render_surfel2
# rasterizes 10: refl, rough, ori_color(3), indirect(3), blend, distance).
MAX_S = 10


# The benchmark's cost counts set this to a dict while they count.
WORK: dict | None = None


def longest_first(lengths: torch.Tensor) -> torch.Tensor:
    """int32 permutation of the tiles, longest pair walk first (stable): the
    kernels' block b takes tile order[b], so the longest walks start in the
    first wave. An argsort on the tensors' device, no host read."""
    return torch.argsort(lengths, descending=True, stable=True).to(torch.int32)


def prefilter_bound(opacity: torch.Tensor) -> torch.Tensor:
    """The prefilter's bound per pair, 1.001 x 2 ln(255 o) + 1e-3 (at least
    1e-3): rho above it provably gives alpha < 1/255 (csrc/rasterize_fwd.cu's
    header argues the margin); NaN for a NaN opacity. The kernels compute it
    as thr_of, once per staged pair."""
    tau = 2.0 * torch.log(255.0 * opacity)
    return torch.where(tau < 0.0, torch.zeros_like(tau), tau) * 1.001 + 1e-3


def prefilter_skip(px, py, pz, rho2d, thr):
    """The kernels' exact prefilter: True where alpha < 1/255 is certain from
    rho2d and px^2 + py^2 > thr pz^2 (rho3d without the divisions). NaN, pz =
    0 and pz^2 < 1e-30 are never skipped."""
    pz2 = pz * pz
    return (rho2d > thr) & (pz2 >= PZ2_MIN) & (px * px + py * py > thr * pz2)


def _check_inputs(payload, tile_start, tile_count, S, num_tiles):
    if payload.dtype != torch.float32 or payload.dim() != 2:
        raise ValueError(f"payload must be 2-D float32, got {payload.dtype} {tuple(payload.shape)}")
    if payload.shape[0] < ROW_LIN + acc_channels(S):
        raise ValueError(f"payload has {payload.shape[0]} rows, S={S} needs {ROW_LIN + acc_channels(S)}")
    if tile_start.dtype != torch.int32 or tile_count.dtype != torch.int32:
        raise ValueError("tile_start and tile_count must be int32")
    if tile_start.shape != (num_tiles + 1,) or tile_count.shape != (num_tiles,):
        raise ValueError(
            f"tile_start/tile_count shapes {tuple(tile_start.shape)}/{tuple(tile_count.shape)} "
            f"do not match {num_tiles} tiles"
        )
    if not (tile_start.device == tile_count.device == payload.device):
        raise ValueError("payload, tile_start and tile_count must be on one device")


def rasterize_tiles_fwd(payload, tile_start, tile_count, *, S, grid_x, grid_y, W, H, row0=0):
    """Per-tile forward outputs (T, 256, C_OUT): the plain version. While
    WORK is a dict, each call appends its contributing hits, S and view size
    to WORK["launches"] (the benchmark's cost counts)."""
    work = {} if WORK is not None else None
    out = rasterize_tiles_fwd_plain(payload, tile_start, tile_count, S=S, grid_x=grid_x, grid_y=grid_y,
                                    W=W, H=H, row0=row0, work=work)
    if work is not None:
        WORK.setdefault("launches", []).append(dict(work, S=S, W=W, H=H))
    return out


def rasterize_tiles_fwd_plain(
    payload: torch.Tensor,
    tile_start: torch.Tensor,
    tile_count: torch.Tensor,
    *,
    S: int,
    grid_x: int,
    grid_y: int,
    W: int,
    H: int,
    row0: int = 0,
    tile_order: torch.Tensor | None = None,
    prefilter: bool = True,
    work: dict | None = None,
) -> torch.Tensor:
    """The kernel's computation in plain torch on any device: vectorized over
    tiles and pixels, one step per position in the tiles' pair lists, with
    the kernel's arithmetic in the kernel's order. Row i of the work is tile
    tile_order[i] (default: longest_first, the kernel's blocks); the result
    is in tile order whatever the permutation. `prefilter` applies the
    kernel's prefilter, which changes no output. With `work`, the
    contributing (pixel, pair) hits are added to work["hits3d"] (the
    ray-splat intersection) and work["hits2d"] (the low-pass filter)."""
    dev = payload.device
    num_tiles = grid_x * grid_y
    _check_inputs(payload, tile_start, tile_count, S, num_tiles)
    ACC = acc_channels(S)
    lay = out_layout(S)
    f32 = dict(dtype=torch.float32, device=dev)
    order = (longest_first(tile_count) if tile_order is None else tile_order).to(torch.int64)

    t = order[:, None]
    pid = torch.arange(PIX, device=dev)[None, :]
    px_i = (t % grid_x) * TILE + pid % TILE
    py_i = (torch.div(t, grid_x, rounding_mode="floor") + row0) * TILE + torch.div(pid, TILE, rounding_mode="floor")
    pix_x = px_i.to(torch.float32)
    pix_y = py_i.to(torch.float32)
    inside = (px_i < W) & (py_i < H)

    shape = (num_tiles, PIX)
    acc = torch.zeros(shape + (ACC,), **f32)
    depth_acc, m1_acc, m2_acc, dist_acc = (torch.zeros(shape, **f32) for _ in range(4))
    w_sum, wm_sum, wm2_sum = (torch.zeros(shape, **f32) for _ in range(3))
    med_depth = torch.zeros(shape, **f32)
    med_idx = torch.full(shape, -1.0, **f32)
    n_contrib = torch.zeros(shape, **f32)
    final_logT = torch.zeros(shape, **f32)
    logT = torch.where(inside, torch.zeros(shape, **f32), torch.full(shape, DEAD, **f32))
    zero = torch.zeros((), **f32)
    one = torch.ones((), **f32)
    ndc_scale = FAR_N / (FAR_N - NEAR_N)

    start = tile_start[:num_tiles].to(torch.int64)[order]
    count = tile_count.to(torch.int64)[order]
    rows = payload[: ROW_LIN + ACC]
    n_max = int(count.max()) if num_tiles else 0
    hits3d = torch.zeros((), dtype=torch.int64, device=dev)
    hits2d = torch.zeros((), dtype=torch.int64, device=dev)
    last_col = max(payload.shape[1] - 1, 0)
    for j in range(n_max):
        if j % 64 == 0 and not bool(((logT >= LOG_T_STOP) & (j < count)[:, None]).any()):
            break  # every pixel has stopped or run out of pairs
        live = (j < count)[:, None]
        pay = rows[:, torch.clamp(start + j, max=last_col)][:, :, None]  # (NROW, T, 1)
        tux, tuy, tuz = pay[ROW_TU], pay[ROW_TU + 1], pay[ROW_TU + 2]
        tvx, tvy, tvz = pay[ROW_TV], pay[ROW_TV + 1], pay[ROW_TV + 2]
        twx, twy, twz = pay[ROW_TW], pay[ROW_TW + 1], pay[ROW_TW + 2]

        kx = pix_x * twx - tux
        ky = pix_x * twy - tuy
        kz = pix_x * twz - tuz
        lx = pix_y * twx - tvx
        ly = pix_y * twy - tvy
        lz = pix_y * twz - tvz
        px = ky * lz - kz * ly
        py = kz * lx - kx * lz
        pz = kx * ly - ky * lx
        pz_ok = pz != 0.0
        d1 = pay[ROW_MEAN2D] - pix_x
        d2 = pay[ROW_MEAN2D + 1] - pix_y
        rho2d = FILTER_INV_SQUARE * (d1 * d1 + d2 * d2)
        if prefilter:
            pz_ok = pz_ok & ~prefilter_skip(px, py, pz, rho2d, prefilter_bound(pay[ROW_OPACITY]))
        pz_safe = torch.where(pz_ok, pz, one)
        s1 = px / pz_safe
        s2 = py / pz_safe
        rho3d = s1 * s1 + s2 * s2
        use3d = rho3d <= rho2d
        rho = torch.minimum(rho3d, rho2d)
        depth = torch.where(use3d, s1 * twx + s2 * twy + twz, twz.expand_as(s1))
        power = -0.5 * rho
        alpha = torch.clamp(pay[ROW_OPACITY] * torch.exp(power), max=ALPHA_MAX)
        ok = live & pz_ok & (depth >= NEAR_N) & (power <= 0.0) & (alpha >= ALPHA_MIN)

        a = torch.where(ok, alpha, zero)
        logT_incl = logT + torch.log1p(-a)
        contrib = ok & (logT_incl >= LOG_T_STOP)
        w = torch.where(contrib, a * torch.exp(logT), zero)
        if work is not None:
            hits3d += (contrib & use3d).sum()
            hits2d += (contrib & ~use3d).sum()
        acc = acc + w[..., None] * pay[ROW_LIN : ROW_LIN + ACC].permute(1, 2, 0)
        depth_s = torch.where(ok, depth, one)
        depth_acc = depth_acc + w * depth_s
        m = ndc_scale * (1.0 - NEAR_N * torch.reciprocal(depth_s))
        wm = w * m
        wm2 = wm * m
        dist_acc = dist_acc + w * (m * m * w_sum + wm2_sum - 2.0 * m * wm_sum)
        m1_acc = m1_acc + wm
        m2_acc = m2_acc + wm2
        w_sum = w_sum + w
        wm_sum = wm_sum + wm
        wm2_sum = wm2_sum + wm2
        idx1 = float(j + 1)
        n_contrib = torch.where(contrib, idx1, n_contrib)
        med = contrib & (logT > LOG_HALF)
        med_depth = torch.where(med, depth_s, med_depth)
        med_idx = torch.where(med, idx1, med_idx)
        final_logT = torch.where(contrib, logT_incl, final_logT)
        logT = logT_incl

    if work is not None:
        work["hits3d"] = work.get("hits3d", 0) + int(hits3d)
        work["hits2d"] = work.get("hits2d", 0) + int(hits2d)
    out = torch.zeros((num_tiles, PIX, out_channels_padded(S)), **f32)
    acc, depth_acc, m1_acc, m2_acc, dist_acc, med_depth, final_logT, n_contrib, med_idx = (
        torch.empty_like(x).index_copy_(0, order, x) for x in (
            acc, depth_acc, m1_acc, m2_acc, dist_acc, med_depth, final_logT, n_contrib, med_idx))
    out[..., :ACC] = acc
    for name, val in (
        ("depth", depth_acc),
        ("M1", m1_acc),
        ("M2", m2_acc),
        ("distortion", dist_acc),
        ("median_depth", med_depth),
        ("final_T", torch.exp(final_logT)),
        ("n_contrib", n_contrib),
        ("median_contrib", med_idx),
    ):
        out[..., lay[name][0]] = val
    return out
