"""Tile rasterizer backward: the CUDA kernel's wrapper and its plain version.

`rasterize_tiles_bwd` replaces materialrefgs_tpu/ops/rasterize/pallas_bwd.py:
rasterize_tiles_bwd. On a CUDA tensor it launches the hand-written kernel in
`csrc/rasterize_bwd.cu` (built with nvcc for sm_90a at first use) or raises;
on a CPU tensor it runs `rasterize_tiles_bwd_plain`, the same computation in
plain torch. The kernel's design and its bound are described in the source:
blocks take tiles longest walk first, and the forward's exact prefilter
skips the tests that cannot pass.

Inputs: the forward's payload (C_PAD(S), n_cols), tile_start (T+1,) and
tile_count (T,) int32; tile_active (T,) int32, the largest n_contrib of each
tile; the forward's output and its cotangent, each (T, 256, C_OUT(S)).
Output: per-pair payload gradients (n_cols, 12+S+6) float32, one row per
pair, columns in the payload's row order (dTu, dTv, dTw, dmean2d, dopacity,
dlin); rows of no tile are zero. The JAX kernel's chunk-major layout with a
gaussian-id row is a TPU artefact: here the caller reduces the rows per
gaussian with one `index_add_` keyed by the pairs' gaussian ids.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from materialrefgs_torch.ops import nvcc
from materialrefgs_torch.ops.rasterize.layout import (
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
from materialrefgs_torch.ops.rasterize.tiles_fwd import (
    MAX_S,
    _check_inputs,
    longest_first,
    prefilter_bound,
    prefilter_skip,
)

SOURCE = nvcc.CSRC / "rasterize_bwd.cu"


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = nvcc.load(SOURCE)
    fn = lib.rasterize_tiles_bwd
    fn.argtypes = [
        ctypes.c_void_p,  # payload
        ctypes.c_longlong,  # payload row stride (columns) = dpair rows
        ctypes.c_void_p,  # tile_start
        ctypes.c_void_p,  # tile_count
        ctypes.c_void_p,  # tile_active
        ctypes.c_void_p,  # order (block -> tile)
        ctypes.c_void_p,  # fwd_out
        ctypes.c_void_p,  # cotangent
        ctypes.c_void_p,  # dpair
        ctypes.c_int,  # S
        ctypes.c_int,  # grid_x
        ctypes.c_int,  # grid_y
        ctypes.c_int,  # row0 (the grid's first tile row in the view)
        ctypes.c_void_p,  # stream
    ]
    fn.restype = ctypes.c_int
    return lib


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


def rasterize_tiles_bwd(
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
) -> torch.Tensor:
    """Per-pair payload gradients (n_cols, 12+S+6). Launches the CUDA kernel
    for CUDA tensors and counts the launch in `rasterize_tiles_bwd.launches`;
    runs the plain version for CPU tensors. row0 as in rasterize_tiles_fwd."""
    num_tiles = grid_x * grid_y
    _check_bwd_inputs(payload, tile_start, tile_count, tile_active, fwd_out, cotangent, S, num_tiles)
    if payload.device.type == "cpu":
        return rasterize_tiles_bwd_plain(
            payload, tile_start, tile_count, tile_active, fwd_out, cotangent,
            S=S, grid_x=grid_x, grid_y=grid_y, W=W, H=H, row0=row0,
        )
    if payload.device.type != "cuda":
        raise ValueError(f"unsupported device {payload.device}")
    if not 1 <= S <= MAX_S:
        raise ValueError(f"the CUDA kernel is built for S in 1..{MAX_S}, got {S}")
    payload = payload.contiguous()
    tile_start, tile_count, tile_active = (
        x.contiguous() for x in (tile_start, tile_count, tile_active)
    )
    fwd_out = fwd_out.contiguous()
    cotangent = cotangent.contiguous()
    dpair = torch.zeros(
        (payload.shape[1], grad_rows(S)), dtype=torch.float32, device=payload.device
    )
    order = longest_first(tile_active)
    stream = torch.cuda.current_stream(payload.device).cuda_stream
    err = _library().rasterize_tiles_bwd(
        payload.data_ptr(), payload.shape[1], tile_start.data_ptr(), tile_count.data_ptr(),
        tile_active.data_ptr(), order.data_ptr(), fwd_out.data_ptr(), cotangent.data_ptr(),
        dpair.data_ptr(), S, grid_x, grid_y, row0, stream,
    )
    if err != 0:
        raise RuntimeError(f"rasterize_tiles_bwd kernel launch failed with CUDA error {err}")
    rasterize_tiles_bwd.launches += 1
    return dpair


rasterize_tiles_bwd.launches = 0


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
    prefilter changes no value and is applied here too.

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
        m = ndc_scale * (1.0 - NEAR_N / depth_safe)

        lin = pay[ROW_LIN:NG, :, 0]  # (ACC, T)
        G = zero
        for k in range(ACC):
            G = G + dLin[..., k] * lin[k][:, None]
        G = G + depth_safe * dD + m * dM1 + (m * m) * dM2
        G = G + (M2_tot + m * m * A_tot - 2.0 * m * M1_tot) * dReg
        gw = torch.where(ok, G * w, zero)
        one_m = torch.where(ok, 1.0 - a, one)
        dalpha = torch.where(ok, T_i * G - carry_gw / one_m - (final_T / one_m) * dTfin, zero)

        dmd_dd = (FAR_N * NEAR_N) / ((FAR_N - NEAR_N) * depth_safe * depth_safe)
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
        per_pixel += [dLin[..., k] * w for k in range(ACC)]
        sums = torch.stack([torch.sum(v, dim=1) for v in per_pixel], dim=1)  # (T, NG)
        dpair[(start + j)[live]] = sums[live]

        carry_gw = carry_gw + gw
        carry_lg = carry_lg + lg
    if work is not None:
        work["pass3d"], work["pass2d"] = int(n3), int(n2)
    return dpair
