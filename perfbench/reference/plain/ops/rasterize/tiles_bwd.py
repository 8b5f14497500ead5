"""Tile rasterizer backward: the plain version only (a frozen copy of the port's plain
torch version, which the benchmark's reference runs on every device; the
CUDA kernel and its wrapper are left out)."""
from __future__ import annotations


import torch

from perfbench.reference.plain.ops.rasterize.layout import (
    ALPHA_MAX,
    ALPHA_MIN,
    FAR_N,
    FILTER_INV_SQUARE,
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
from perfbench.reference.plain.ops.rasterize.tiles_fwd import (
    MAX_S,
    _check_inputs,
    longest_first,
    prefilter_bound,
    prefilter_skip,
)

WARP = 32
NWARP = PIX // WARP
# Pair rows whose per-pixel weights the plain version holds at once before
# it sums their linear rows (256 floats a row).
LIN_ROWS_AT_ONCE = 1 << 18


def grad_rows(S: int) -> int:
    """Gradient values per pair: one per payload row the kernels read."""
    return ROW_LIN + acc_channels(S)


def _check_bwd_inputs(payload, tile_start, tile_count, tile_active, fwd_out, cotangent, S, num_tiles):
    _check_inputs(payload, tile_start, tile_count, S, num_tiles)
    if tile_active.dtype != torch.int32 or tile_active.shape != (num_tiles,):
        raise ValueError(f"tile_active must be ({num_tiles},) int32")
    want = (num_tiles, PIX, out_channels_padded(S))
    for name, x in (("fwd_out", fwd_out), ("cotangent", cotangent)):
        if x.dtype != torch.float32 or tuple(x.shape) != want:
            raise ValueError(f"{name} must be {want} float32, got {x.dtype} {tuple(x.shape)}")
    if not all(x.device == payload.device for x in (tile_active, fwd_out, cotangent)):
        raise ValueError("all inputs must be on one device")


def warp_order_sum(v: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (a tile's 256 pixels) in the CUDA kernel's
    order for the 12 geometric rows: within each warp of 32 lanes the
    butterfly of `reduce12`/`reduce4` (lane l plus lane l + 16, then the
    halves of 8, 4, 2 and 1), then the eight warp sums added in warp order
    starting from 0. Warps the kernel leaves out of a pair's sum hold zeros
    here, which add nothing."""
    x = v.reshape(*v.shape[:-1], NWARP, WARP)
    h = WARP // 2
    while h:
        x = x[..., :h] + x[..., h : 2 * h]
        h //= 2
    s = torch.zeros_like(x[..., 0, 0])
    for k in range(NWARP):
        s = s + x[..., k, 0]
    return s


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fmaf(a, b, c) of float32 values, rounded once, as `__fmaf_rn` does:
    a * b is exact in float64, the float64 sum is made round-to-odd from its
    exact error (TwoSum), and rounding that to float32 is the correct
    rounding of a * b + c (53 >= 24 + 2 bits)."""
    p = a.double() * b.double()
    c = c.double()
    t = p + c
    bp = t - p
    e = (p - (t - bp)) + (c - bp)
    bits = t.view(torch.int64)
    fix = (e != 0) & ((bits & 1) == 0) & torch.isfinite(t)
    bits = torch.where(fix, bits + torch.where((e > 0) == (t > 0), 1, -1), bits)
    return bits.view(torch.float64).float()


def pixel_order_dot(w: torch.Tensor, dlin: torch.Tensor, tiles: torch.Tensor) -> torch.Tensor:
    """The linear rows of R pairs in the CUDA kernel's order: for each pair
    row r and channel k, s = fmaf(w[r, p], dlin[tiles[r], p, k], s) over the
    pixels p = 0..255 in order, from s = 0. w (R, 256) holds each pixel's
    blend weight of the pair (0 where it does not count), dlin (T, 256, ACC)
    the tiles' cotangent; returns (R, ACC) float32. A pixel of weight 0
    leaves s as it is, so the warps the kernel skips change nothing."""
    s = torch.zeros((w.shape[0], dlin.shape[-1]), dtype=torch.float32, device=w.device)
    for p in range(PIX):
        s = fma_f32(w[:, p : p + 1], dlin[tiles, p], s)
    return s


def rasterize_tiles_bwd(payload, tile_start, tile_count, tile_active, fwd_out, cotangent, *, S, grid_x,
                        grid_y, W, H, row0=0):
    """Per-pair payload gradients (n_cols, 12+S+6): the plain version."""
    return rasterize_tiles_bwd_plain(payload, tile_start, tile_count, tile_active, fwd_out, cotangent,
                                     S=S, grid_x=grid_x, grid_y=grid_y, W=W, H=H, row0=row0)


def rasterize_tiles_bwd_plain(
    payload: torch.Tensor,
    tile_start: torch.Tensor,
    tile_count: torch.Tensor,
    tile_active: torch.Tensor,
    fwd_out: torch.Tensor,
    cotangent: torch.Tensor,
    *,
    S: int,
    grid_x: int,
    grid_y: int,
    W: int,
    H: int,
    row0: int = 0,
    work: dict | None = None,
    tile_order: torch.Tensor | None = None,
) -> torch.Tensor:
    """The kernel's computation in plain torch on any device: vectorized over
    tiles and pixels, one step per pair position walking back to front, with
    the JAX kernel's (and the CUDA kernel's) per-(pixel, pair) arithmetic.
    The gradient is derived by hand, not by autograd of the forward: the
    alpha clamp passes its gradient through, as the kernels' does. Row i of
    the work is tile tile_order[i] (default: longest_first, the kernel's
    blocks); the result does not depend on the permutation. The kernel's
    prefilter changes no value and is applied here too. A pair's rows sum
    the tile's 256 pixels in the kernel's order (`warp_order_sum` for the
    12 geometric rows, `pixel_order_dot` for the linear ones), so that a sum
    that cancels rounds as the kernel's does.

    `work`, when given, receives how many (pixel, pair) passed the hit test
    inside the pixel's contributor range, by branch: "pass3d" (ray-splat
    intersection) and "pass2d" (low-pass filter). Only these carry the chain
    rule; the rest need the hit test alone."""
    dev = payload.device
    num_tiles = grid_x * grid_y
    _check_bwd_inputs(payload, tile_start, tile_count, tile_active, fwd_out, cotangent, S, num_tiles)
    ACC = acc_channels(S)
    NG = grad_rows(S)
    lay = out_layout(S)
    f32 = dict(dtype=torch.float32, device=dev)
    dpair = torch.zeros((payload.shape[1], NG), **f32)
    if num_tiles == 0:
        return dpair

    order = (longest_first(tile_active) if tile_order is None else tile_order).to(torch.int64)
    t = order[:, None]
    pid = torch.arange(PIX, device=dev)[None, :]
    pix_x = ((t % grid_x) * TILE + pid % TILE).to(torch.float32)
    pix_y = ((torch.div(t, grid_x, rounding_mode="floor") + row0) * TILE
             + torch.div(pid, TILE, rounding_mode="floor")).to(torch.float32)

    fwd_out, cotangent = fwd_out[order], cotangent[order]

    def ch(x, name):
        return x[..., lay[name][0]]

    final_T = ch(fwd_out, "final_T")
    M1_tot = ch(fwd_out, "M1")
    M2_tot = ch(fwd_out, "M2")
    n_contrib = ch(fwd_out, "n_contrib")
    med_contrib = ch(fwd_out, "median_contrib")
    A_tot = 1.0 - final_T
    logT_fin = torch.log(torch.clamp(final_T, min=1e-30))
    dLin = cotangent[..., :ACC]  # (T, 256, ACC)
    dD = ch(cotangent, "depth")
    dM1 = ch(cotangent, "M1")
    dM2 = ch(cotangent, "M2")
    dReg = ch(cotangent, "distortion")
    dMed = ch(cotangent, "median_depth")
    dTfin = ch(cotangent, "final_T")

    start = tile_start[:num_tiles].to(torch.int64)[order]
    active = torch.minimum(tile_active, tile_count).to(torch.int64)[order]
    rows = payload[:NG]
    last_col = max(payload.shape[1] - 1, 0)
    zero = torch.zeros((), **f32)
    one = torch.ones((), **f32)
    ndc_scale = FAR_N / (FAR_N - NEAR_N)
    carry_gw = torch.zeros((num_tiles, PIX), **f32)
    carry_lg = torch.zeros((num_tiles, PIX), **f32)
    n3 = torch.zeros((), dtype=torch.int64, device=dev)
    n2 = torch.zeros((), dtype=torch.int64, device=dev)
    tile_ids = torch.arange(num_tiles, device=dev)
    # Each pair's per-pixel weights wait here until their linear rows are
    # summed, LIN_ROWS_AT_ONCE pairs at a time.
    pending = {"w": [], "tiles": [], "cols": [], "rows": 0}

    def flush_linear():
        if pending["rows"]:
            cat = {k: torch.cat(pending[k]) for k in ("w", "tiles", "cols")}
            dpair[cat["cols"], ROW_LIN:] = pixel_order_dot(cat["w"], dLin, cat["tiles"])
            pending.update(w=[], tiles=[], cols=[], rows=0)

    for j in range(int(active.max()) - 1, -1, -1):
        live = j < active  # (T,)
        col = torch.clamp(start + j, max=last_col)
        pay = rows[:, col][:, :, None]  # (NG, T, 1)
        tux, tuy, tuz = pay[ROW_TU], pay[ROW_TU + 1], pay[ROW_TU + 2]
        tvx, tvy, tvz = pay[ROW_TV], pay[ROW_TV + 1], pay[ROW_TV + 2]
        twx, twy, twz = pay[ROW_TW], pay[ROW_TW + 1], pay[ROW_TW + 2]
        opa = pay[ROW_OPACITY]

        kx = pix_x * twx - tux
        ky = pix_x * twy - tuy
        kz = pix_x * twz - tuz
        lx = pix_y * twx - tvx
        ly = pix_y * twy - tvy
        lz = pix_y * twz - tvz
        px = ky * lz - kz * ly
        py = kz * lx - kx * lz
        pz = kx * ly - ky * lx
        d1 = pay[ROW_MEAN2D] - pix_x
        d2 = pay[ROW_MEAN2D + 1] - pix_y
        rho2d = FILTER_INV_SQUARE * (d1 * d1 + d2 * d2)
        pz_ok = (pz != 0.0) & ~prefilter_skip(px, py, pz, rho2d, prefilter_bound(opa))
        pz_safe = torch.where(pz_ok, pz, one)
        s1 = px / pz_safe
        s2 = py / pz_safe
        rho3d = s1 * s1 + s2 * s2
        use3d = rho3d <= rho2d
        rho = torch.minimum(rho3d, rho2d)
        depth = torch.where(use3d, s1 * twx + s2 * twy + twz, twz.expand_as(s1))
        power = -0.5 * rho
        Gg = torch.exp(power)
        alpha = torch.clamp(opa * Gg, max=ALPHA_MAX)

        idx1 = float(j + 1)
        ok = (
            pz_ok & (depth >= NEAR_N) & (power <= 0.0) & (alpha >= ALPHA_MIN)
            & live[:, None] & (idx1 <= n_contrib)
        )
        a = torch.where(ok, alpha, zero)
        lg = torch.log1p(-a)
        T_i = torch.exp(logT_fin - (carry_lg + lg))
        w = a * T_i
        depth_safe = torch.where(ok, depth, one)
        # Divisions as the kernel takes them: a Python number over a tensor
        # is a reciprocal times the number in torch, which rounds otherwise.
        m = ndc_scale * (1.0 - torch.full_like(depth_safe, NEAR_N) / depth_safe)

        lin = pay[ROW_LIN:NG, :, 0]  # (ACC, T)
        G = zero
        for k in range(ACC):
            G = G + dLin[..., k] * lin[k][:, None]
        G = G + depth_safe * dD + m * dM1 + (m * m) * dM2
        G = G + (M2_tot + m * m * A_tot - 2.0 * m * M1_tot) * dReg
        gw = torch.where(ok, G * w, zero)
        one_m = torch.where(ok, 1.0 - a, one)
        dalpha = torch.where(ok, T_i * G - carry_gw / one_m - (final_T / one_m) * dTfin, zero)

        dmd_dd = torch.full_like(depth_safe, FAR_N * NEAR_N) / ((FAR_N - NEAR_N) * depth_safe * depth_safe)
        dz = w * dD
        dz = torch.where(idx1 == med_contrib, dz + dMed, dz)
        dz = dz + (2.0 * w * (m * A_tot - M1_tot) * dReg + w * dM1 + 2.0 * w * m * dM2) * dmd_dd
        dz = torch.where(ok, dz, zero)

        dG_g = opa * dalpha  # pass-through min clamp, as the kernels
        on3 = ok & use3d
        on2 = ok & ~use3d
        if work is not None:
            n3 += on3.sum()
            n2 += on2.sum()
        ds1 = torch.where(on3, dG_g * (-Gg) * s1 + dz * twx, zero)
        ds2 = torch.where(on3, dG_g * (-Gg) * s2 + dz * twy, zero)
        dp1 = ds1 / pz_safe
        dp2 = ds2 / pz_safe
        dp3 = -(dp1 * s1 + dp2 * s2)
        dk1 = ly * dp3 - lz * dp2
        dk2 = lz * dp1 - lx * dp3
        dk3 = lx * dp2 - ly * dp1
        dl1 = dp2 * kz - dp3 * ky
        dl2 = dp3 * kx - dp1 * kz
        dl3 = dp1 * ky - dp2 * kx
        dz3 = torch.where(on3, dz, zero)
        per_pixel = [
            -dk1, -dk2, -dk3,
            -dl1, -dl2, -dl3,
            pix_x * dk1 + pix_y * dl1 + dz3 * s1,
            pix_x * dk2 + pix_y * dl2 + dz3 * s2,
            torch.where(on2, dz, pix_x * dk3 + pix_y * dl3 + dz3),
            torch.where(on2, dG_g * (-Gg) * FILTER_INV_SQUARE * d1, zero),
            torch.where(on2, dG_g * (-Gg) * FILTER_INV_SQUARE * d2, zero),
            torch.where(ok, Gg * dalpha, zero),
        ]
        geo = warp_order_sum(torch.stack(per_pixel, dim=1))  # (T, 12)
        cols = (start + j)[live]
        dpair[cols, :ROW_LIN] = geo[live]
        pending["w"].append(w[live])
        pending["tiles"].append(tile_ids[live])
        pending["cols"].append(cols)
        pending["rows"] += len(cols)
        if pending["rows"] >= LIN_ROWS_AT_ONCE:
            flush_linear()

        carry_gw = carry_gw + gw
        carry_lg = carry_lg + lg
    flush_linear()
    if work is not None:
        work["pass3d"], work["pass2d"] = int(n3), int(n2)
    return dpair
