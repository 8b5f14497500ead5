"""Tile rasterizer forward: the CUDA kernel's wrapper and its plain version.

`rasterize_tiles_fwd` replaces materialrefgs_tpu/ops/rasterize/pallas_fwd.py:
rasterize_tiles_fwd. On a CUDA tensor it launches the hand-written kernel in
`csrc/rasterize_fwd.cu` (built with nvcc for sm_90a at first use) or raises;
on a CPU tensor it runs `rasterize_tiles_fwd_plain`, the same computation in
plain torch. The kernel's design and its bound are described in the source.

Inputs (the JAX kernel's): payload (C_PAD(S), n_cols) float32, one column per
depth-sorted (tile, gaussian) pair; tile_start (T+1,) int32 raw offsets;
tile_count (T,) int32. Output: (T, 256, C_OUT(S)) float32 in the layout of
layout.out_layout(S), padding channels zero.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from materialrefgs_torch.ops.rasterize.layout import (
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

_PKG_DIR = Path(__file__).resolve().parents[2]
SOURCE = _PKG_DIR / "csrc" / "rasterize_fwd.cu"
BUILD_DIR = _PKG_DIR.parent / "build" / "kernels"
MAX_S = 9  # feature widths the kernel is instantiated for: 1..MAX_S
# -fmad=false keeps every multiply and add separately rounded, as the plain
# torch version's elementwise ops are, so the two agree bit for bit except
# where libdevice and torch disagree.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    found = cand if os.path.exists(cand) else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin and on PATH)")
    return found


def build_library() -> tuple[Path, str]:
    """Compile csrc/rasterize_fwd.cu into BUILD_DIR (once per source/flags
    hash). Returns (library path, compiler output); the output holds ptxas's
    register/shared-memory report when this call compiled."""
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"librasterize_fwd_{tag}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
            capture_output=True,
            text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib, proc.stdout + proc.stderr


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    path, _ = build_library()
    lib = ctypes.CDLL(str(path))
    fn = lib.rasterize_tiles_fwd
    fn.argtypes = [
        ctypes.c_void_p,  # payload
        ctypes.c_longlong,  # payload row stride (columns)
        ctypes.c_void_p,  # tile_start
        ctypes.c_void_p,  # tile_count
        ctypes.c_void_p,  # out
        ctypes.c_int,  # S
        ctypes.c_int,  # grid_x
        ctypes.c_int,  # grid_y
        ctypes.c_int,  # W
        ctypes.c_int,  # H
        ctypes.c_void_p,  # stream
    ]
    fn.restype = ctypes.c_int
    return lib


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


def rasterize_tiles_fwd(
    payload: torch.Tensor,
    tile_start: torch.Tensor,
    tile_count: torch.Tensor,
    *,
    S: int,
    grid_x: int,
    grid_y: int,
    W: int,
    H: int,
) -> torch.Tensor:
    """Per-tile forward outputs (T, 256, C_OUT). Launches the CUDA kernel for
    CUDA tensors and counts the launch in `rasterize_tiles_fwd.launches`;
    runs the plain version for CPU tensors."""
    num_tiles = grid_x * grid_y
    _check_inputs(payload, tile_start, tile_count, S, num_tiles)
    if payload.device.type == "cpu":
        return rasterize_tiles_fwd_plain(
            payload, tile_start, tile_count, S=S, grid_x=grid_x, grid_y=grid_y, W=W, H=H
        )
    if payload.device.type != "cuda":
        raise ValueError(f"unsupported device {payload.device}")
    if not 1 <= S <= MAX_S:
        raise ValueError(f"the CUDA kernel is built for S in 1..{MAX_S}, got {S}")
    payload = payload.contiguous()
    tile_start = tile_start.contiguous()
    tile_count = tile_count.contiguous()
    if num_tiles and int(tile_start[-1]) > payload.shape[1]:
        raise ValueError("tile ranges reach past the payload's columns")
    out = torch.empty(
        (num_tiles, PIX, out_channels_padded(S)), dtype=torch.float32, device=payload.device
    )
    stream = torch.cuda.current_stream(payload.device).cuda_stream
    err = _library().rasterize_tiles_fwd(
        payload.data_ptr(), payload.shape[1], tile_start.data_ptr(), tile_count.data_ptr(),
        out.data_ptr(), S, grid_x, grid_y, W, H, stream,
    )
    if err != 0:
        raise RuntimeError(f"rasterize_tiles_fwd kernel launch failed with CUDA error {err}")
    rasterize_tiles_fwd.launches += 1
    return out


rasterize_tiles_fwd.launches = 0


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
) -> torch.Tensor:
    """The kernel's computation in plain torch on any device: vectorized over
    tiles and pixels, one step per position in the tiles' pair lists, with
    the kernel's arithmetic in the kernel's order."""
    dev = payload.device
    num_tiles = grid_x * grid_y
    _check_inputs(payload, tile_start, tile_count, S, num_tiles)
    ACC = acc_channels(S)
    lay = out_layout(S)
    f32 = dict(dtype=torch.float32, device=dev)

    t = torch.arange(num_tiles, device=dev)[:, None]
    pid = torch.arange(PIX, device=dev)[None, :]
    px_i = (t % grid_x) * TILE + pid % TILE
    py_i = torch.div(t, grid_x, rounding_mode="floor") * TILE + torch.div(pid, TILE, rounding_mode="floor")
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

    start = tile_start[:num_tiles].to(torch.int64)
    count = tile_count.to(torch.int64)
    rows = payload[: ROW_LIN + ACC]
    n_max = int(count.max()) if num_tiles else 0
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
        pz_safe = torch.where(pz_ok, pz, one)
        s1 = px / pz_safe
        s2 = py / pz_safe
        rho3d = s1 * s1 + s2 * s2
        d1 = pay[ROW_MEAN2D] - pix_x
        d2 = pay[ROW_MEAN2D + 1] - pix_y
        rho2d = FILTER_INV_SQUARE * (d1 * d1 + d2 * d2)
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

    out = torch.zeros((num_tiles, PIX, out_channels_padded(S)), **f32)
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
