"""The multi-view warp's bilinear sampler: the CUDA gather/splat pair's
wrappers, their plain versions and the autograd Function over them.

`grid_sample(img, coords)` is what train/warp.py and train/ref_score.py call.
On a CUDA tensor it runs `WarpSample`, whose forward launches the gather in
`csrc/warp_sample.cu` and whose backward launches the splat (both built with
nvcc for sm_90a at first use); on a CPU tensor it runs `grid_sample_plain`,
the plain torch expression, under autograd. The kernels' design and bound
are described in the source.

Memory: `WarpSample` saves only its two inputs, the map and the coordinates
(tensors the caller holds anyway), and nothing per corner; the backward
recomputes the corners and allocates only the gradients asked for, the
map's (H, W, C) and the coordinates' (M, 2). When neither input needs a
gradient, autograd builds no node and nothing is saved. The map is read
through its strides (a channel slice of the rasterizer's feature map is not
copied), and so are the coordinates and the output gradient.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from materialrefgs_torch.ops import nvcc
from materialrefgs_torch.utils.transforms import clip

SOURCE = nvcc.CSRC / "warp_sample.cu"


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = nvcc.load(SOURCE)
    head = [
        ctypes.c_void_p,  # map
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,  # map strides (H, W, C)
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # H, W, C
        ctypes.c_void_p,  # coords
        ctypes.c_longlong, ctypes.c_longlong,  # coords strides
        ctypes.c_longlong,  # M
    ]
    lib.warp_sample_fwd.argtypes = head + [ctypes.c_void_p, ctypes.c_void_p]  # out, stream
    lib.warp_sample_bwd.argtypes = head + [
        ctypes.c_void_p,  # grad
        ctypes.c_longlong, ctypes.c_longlong,  # grad strides
        ctypes.c_void_p,  # dmap or null
        ctypes.c_void_p,  # dcoords or null
        ctypes.c_void_p,  # stream
    ]
    lib.warp_sample_fwd.restype = ctypes.c_int
    lib.warp_sample_bwd.restype = ctypes.c_int
    return lib


def grid_sample_plain(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Bilinear sample. img (H, W, C); coords (..., 2) in [-1, 1] (x, y).
    Matches F.grid_sample(align_corners=True) in value, with zero padding
    (out-of-bounds taps vanish: the warp's foreground min-mask relies on it),
    but at an integer coordinate its weight takes jnp.clip's gradient, half
    of F.grid_sample's."""
    H, W = img.shape[:2]
    x, y = coords[..., 0], coords[..., 1]
    fx = (x + 1) * (W - 1) / 2
    fy = (y + 1) * (H - 1) / 2
    x0f = torch.floor(fx)
    y0f = torch.floor(fy)
    wx = clip(fx - x0f, 0.0, 1.0)[..., None]
    wy = clip(fy - y0f, 0.0, 1.0)[..., None]

    def tap(yf, xf):
        ok = (xf >= 0) & (xf < W) & (yf >= 0) & (yf < H)
        # A non-finite coordinate reads any texel: ok is False there, and the
        # JAX package's float -> int conversion differs from torch's.
        xi = torch.clamp(torch.nan_to_num(xf, nan=0.0), 0, W - 1).long()
        yi = torch.clamp(torch.nan_to_num(yf, nan=0.0), 0, H - 1).long()
        return img[yi, xi] * ok[..., None]

    c00 = tap(y0f, x0f)
    c01 = tap(y0f, x0f + 1)
    c10 = tap(y0f + 1, x0f)
    c11 = tap(y0f + 1, x0f + 1)
    return c00 * (1 - wx) * (1 - wy) + c01 * wx * (1 - wy) + c10 * (1 - wx) * wy + c11 * wx * wy


def _check(img: torch.Tensor, coords: torch.Tensor):
    if img.dim() != 3 or img.dtype != torch.float32:
        raise ValueError(f"img must be (H, W, C) float32, got {img.dtype} {tuple(img.shape)}")
    if coords.dim() != 2 or coords.shape[1] != 2 or coords.dtype != torch.float32:
        raise ValueError(f"coords must be (M, 2) float32, got {coords.dtype} {tuple(coords.shape)}")
    if coords.device != img.device:
        raise ValueError("img and coords must be on one device")
    if img.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {img.device}")


def _head(img: torch.Tensor, coords: torch.Tensor) -> tuple:
    H, W, C = img.shape
    return (img.data_ptr(), *img.stride(), H, W, C, coords.data_ptr(), *coords.stride(), coords.shape[0])


def warp_sample_fwd(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """(M, C) bilinear samples of img (H, W, C) at coords (M, 2), as
    grid_sample_plain gives them, bit for bit. Launches the CUDA gather for
    CUDA tensors and counts the launch in `warp_sample_fwd.launches`; runs
    grid_sample_plain without autograd for CPU tensors."""
    _check(img, coords)
    if img.device.type == "cpu":
        with torch.no_grad():
            return grid_sample_plain(img, coords)
    out = torch.empty((coords.shape[0], img.shape[2]), dtype=torch.float32, device=img.device)
    stream = torch.cuda.current_stream(img.device).cuda_stream
    err = _library().warp_sample_fwd(*_head(img, coords), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"warp_sample_fwd kernel launch failed with CUDA error {err}")
    warp_sample_fwd.launches += 1
    return out


warp_sample_fwd.launches = 0


def warp_sample_bwd(img: torch.Tensor, coords: torch.Tensor, grad: torch.Tensor, *, need_map: bool,
                    need_coords: bool) -> tuple:
    """The gradients of sum(grad * warp_sample_fwd(img, coords)): the map's
    (H, W, C) if `need_map`, the coordinates' (M, 2) if `need_coords`, else
    None in its place. Launches the CUDA splat for CUDA tensors and counts
    the launch in `warp_sample_bwd.launches`; gives grid_sample_plain_grads
    for CPU tensors."""
    _check(img, coords)
    if tuple(grad.shape) != (coords.shape[0], img.shape[2]) or grad.dtype != torch.float32:
        raise ValueError(f"grad must be ({coords.shape[0]}, {img.shape[2]}) float32, "
                         f"got {grad.dtype} {tuple(grad.shape)}")
    if img.device.type == "cpu":
        return grid_sample_plain_grads(img, coords, grad, need_map=need_map, need_coords=need_coords)
    f32 = dict(dtype=torch.float32, device=img.device)
    dmap = torch.zeros(img.shape, **f32) if need_map else None
    dcoords = torch.empty(coords.shape, **f32) if need_coords else None
    stream = torch.cuda.current_stream(img.device).cuda_stream
    err = _library().warp_sample_bwd(
        *_head(img, coords), grad.data_ptr(), *grad.stride(),
        None if dmap is None else dmap.data_ptr(), None if dcoords is None else dcoords.data_ptr(), stream,
    )
    if err != 0:
        raise RuntimeError(f"warp_sample_bwd kernel launch failed with CUDA error {err}")
    warp_sample_bwd.launches += 1
    return dmap, dcoords


warp_sample_bwd.launches = 0


def grid_sample_plain_grads(img: torch.Tensor, coords: torch.Tensor, grad: torch.Tensor, *, need_map: bool,
                            need_coords: bool) -> tuple:
    """The gradients of sum(grad * grid_sample_plain(img, coords)) by
    autograd, on any device, in warp_sample_bwd's form: what the splat is
    held to. With `grad.abs()` the map's gradient is, per texel, the sum of
    its terms' magnitudes (each term is g * w * ok, and w * ok >= 0)."""
    with torch.enable_grad():
        img_ = img.detach().requires_grad_(need_map)
        coords_ = coords.detach().requires_grad_(need_coords)
        wanted = [t for t in (img_, coords_) if t.requires_grad]
        got = iter(torch.autograd.grad(grid_sample_plain(img_, coords_), wanted, grad) if wanted else ())
    return (next(got) if need_map else None), (next(got) if need_coords else None)


class WarpSample(torch.autograd.Function):
    """warp_sample_fwd with its splat as the backward. Saves the two inputs
    and nothing else; the backward computes only the gradients that
    `ctx.needs_input_grad` asks for, and refuses create_graph=True."""

    @staticmethod
    def forward(ctx, img, coords):
        ctx.save_for_backward(img, coords)
        return warp_sample_fwd(img, coords)

    @staticmethod
    def backward(ctx, grad):
        if torch.is_grad_enabled():
            raise NotImplementedError(
                "the warp sampler supports first-order gradients only (its splat is not itself differentiable)"
            )
        img, coords = ctx.saved_tensors
        need_map, need_coords = ctx.needs_input_grad
        return warp_sample_bwd(img, coords, grad, need_map=need_map, need_coords=need_coords)


def grid_sample(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of img (H, W, C) at coords (..., 2) in [-1, 1] (x,
    y), with grid_sample_plain's values and gradient contract (zero padding,
    jnp.clip's tie gradient). CPU tensors take grid_sample_plain, CUDA
    tensors WarpSample (which builds no graph and saves nothing where no
    input needs a gradient)."""
    if img.device.type == "cpu":
        return grid_sample_plain(img, coords)
    out = WarpSample.apply(img, coords.reshape(-1, 2))
    return out.reshape(*coords.shape[:-1], img.shape[2])
