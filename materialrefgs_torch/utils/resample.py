"""Pillow's image resize on uint8 arrays, reproduced bit for bit.

The JAX package resizes through Pillow: `Image.resize(..., LANCZOS)` for
downscaled photos (data/readers.py), NEAREST for foreground masks
(scripts/train.py) and BILINEAR for GT normal maps (scripts/eval.py). The
card machines have no Pillow, so the port carries the same arithmetic
(Pillow's libImaging/Resample.c and Convert.c):

- LANCZOS and BILINEAR are separable: a horizontal pass, its result clipped
  and rounded to uint8, then a vertical pass. Each output sample is a sum
  over the input samples in the filter's support, scaled by the reduction
  factor (antialiased), with the double-precision weights normalized to sum
  to 1, then rounded to integers at PRECISION_BITS = 22 and accumulated in
  integers from half an output unit.
- NEAREST takes input index int(scale * (x + 0.5)) on each axis.
- RGBA (and LA) images are resized premultiplied (`RGBa`): the colour
  channels are multiplied by alpha first and divided by it after, in
  Pillow's integer arithmetic.

Images are (H, W) or (H, W, C) uint8 numpy arrays; the passes run as torch
float64 products on the CPU, exact for these integer sums.
"""
from __future__ import annotations

import math

import numpy as np
import torch

PRECISION_BITS = 32 - 8 - 2
NEAREST, BILINEAR, LANCZOS = "nearest", "bilinear", "lanczos"


def _bilinear(x: float) -> float:
    x = -x if x < 0.0 else x
    return 1.0 - x if x < 1.0 else 0.0


def _sinc(x: float) -> float:
    if x == 0.0:
        return 1.0
    x = x * math.pi
    return math.sin(x) / x


def _lanczos(x: float) -> float:
    return _sinc(x) * _sinc(x / 3) if -3.0 <= x < 3.0 else 0.0


_FILTERS = {BILINEAR: (_bilinear, 1.0), LANCZOS: (_lanczos, 3.0)}


def _coeffs(in_size: int, out_size: int, method: str, bpc16: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """precompute_coeffs + normalize_coeffs_8bpc: (first input index per
    output sample (out,), integer weights (out, ksize)) in Pillow's double
    arithmetic (math.sin is the C library's, as Pillow's). bpc16: the
    normalized double weights themselves (zero past each sample's support),
    which the 16-bit passes use."""
    fn, support = _FILTERS[method]
    filterscale = scale = float(in_size) / out_size
    if filterscale < 1.0:
        filterscale = 1.0
    support = support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    xmins = np.zeros(out_size, np.int64)
    kk = np.zeros((out_size, ksize), np.float64 if bpc16 else np.int64)
    ss = 1.0 / filterscale
    one = float(1 << PRECISION_BITS)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = [fn((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = _sum_in_order(w)
        if ww != 0.0:
            w = [v / ww for v in w]
        if bpc16:
            kk[xx, :xmax] = w
        else:
            kk[xx, :xmax] = [int(-0.5 + v * one) if v < 0 else int(0.5 + v * one) for v in w]
        xmins[xx] = xmin
    return xmins, kk


def _sum_in_order(values) -> float:
    """Left-to-right double sum (C's `ww += w`; Python's sum() compensates
    since 3.12)."""
    total = 0.0
    for v in values:
        total += v
    return total


def _pass(img: torch.Tensor, axis: int, out_size: int, method: str, block: int = 128) -> torch.Tensor:
    """One separable pass over `axis` (0 rows, 1 columns) of an (H, W, C)
    image of integers; returns the uint8-rounded result as int64. The sums
    are float64 products of a band of the input with the weights, block of
    outputs by block: every product and partial sum is an integer below
    2^53, so they are exact in any order."""
    in_size = img.shape[axis]
    xmins, kk = _coeffs(in_size, out_size, method)
    ksize = kk.shape[1]
    src = img.movedim(axis, -1)
    lead = src.shape[:-1]
    src = src.reshape(-1, in_size).to(torch.float64)
    dense = np.zeros((in_size + ksize, out_size), np.float64)
    rows = xmins[:, None] + np.arange(ksize)[None]
    dense[rows, np.arange(out_size)[:, None]] = kk
    dense = torch.as_tensor(dense[:in_size])
    out = torch.empty((src.shape[0], out_size), dtype=torch.float64)
    for j0 in range(0, out_size, block):
        j1 = min(j0 + block, out_size)
        lo, hi = int(xmins[j0]), min(int(xmins[j1 - 1]) + ksize, in_size)
        torch.mm(src[:, lo:hi], dense[lo:hi, j0:j1], out=out[:, j0:j1])
    acc = out.to(torch.int64) + (1 << (PRECISION_BITS - 1))
    # clip8: >= 255 units -> 255, <= 0 -> 0, else the integer part.
    acc = torch.clamp(acc, min=0, max=(255 << PRECISION_BITS)) >> PRECISION_BITS
    return acc.reshape(*lead, out_size).movedim(-1, axis)


def _pass_16bpc(img: np.ndarray, axis: int, out_size: int, method: str) -> np.ndarray:
    """ImagingResample{Horizontal,Vertical}_16bpc over `axis` of an (H, W)
    uint16 image: each output is the double sum, left to right, of sample x
    weight, rounded half away from zero; its low byte and its value >> 8 are
    each clipped to 0-255 (so a sum past 65535 keeps its low byte under a
    high byte of 255, and a negative one gives 0)."""
    in_size = img.shape[axis]
    xmins, kk = _coeffs(in_size, out_size, method, bpc16=True)
    src = np.moveaxis(img, axis, -1).astype(np.float64)
    idx = np.minimum(xmins[:, None] + np.arange(kk.shape[1])[None], in_size - 1)  # (out, ksize)
    ss = np.zeros(src.shape[:-1] + (out_size,), np.float64)
    for x in range(kk.shape[1]):
        # Past a sample's support the weight is 0 and the clamped index is
        # any valid one: ss + v * 0.0 leaves ss as it is.
        ss = ss + src[..., idx[:, x]] * kk[:, x]
    si = np.where(ss >= 0.0, ss + 0.5, ss - 0.5).astype(np.int64)  # C's (int) truncates
    lo = np.clip(np.fmod(si, 256), 0, 255)
    hi = np.clip(si >> 8, 0, 255)
    return np.moveaxis((lo | (hi << 8)).astype(np.uint16), -1, axis)


def resize_16bpc(img: np.ndarray, size: tuple[int, int], method: str) -> np.ndarray:
    """Pillow's resize of an "I;16" image, (H, W) uint16, with BILINEAR or
    LANCZOS: a horizontal 16-bit pass, then a vertical one."""
    out_w, out_h = int(size[0]), int(size[1])
    H, W = img.shape
    x = np.asarray(img, np.uint16)
    if out_w != W:
        x = _pass_16bpc(x, 1, out_w, method)
    if out_h != H:
        x = _pass_16bpc(x, 0, out_h, method)
    return x


def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    scale = float(in_size) / out_size
    return np.array([int(scale * (x + 0.5)) for x in range(out_size)], np.int64)


def _premultiply(img: torch.Tensor) -> torch.Tensor:
    """RGBA -> RGBa (rgbA2rgba: MULDIV255)."""
    a = img[..., -1:]
    t = img[..., :-1] * a + 128
    return torch.cat([((t >> 8) + t) >> 8, a], dim=-1)


def _unpremultiply(img: torch.Tensor) -> torch.Tensor:
    """RGBa -> RGBA (rgba2rgbA): 255 * c // alpha, clipped, where alpha is
    neither 0 nor 255."""
    a = img[..., -1:]
    div = torch.div(255 * img[..., :-1], torch.clamp(a, min=1), rounding_mode="floor")
    keep = (a == 0) | (a == 255)
    return torch.cat([torch.where(keep, img[..., :-1], torch.clamp(div, max=255)), a], dim=-1)


def resize(img: np.ndarray, size: tuple[int, int], method: str) -> np.ndarray:
    """Pillow's `Image.fromarray(img).resize(size, method)` for a uint8
    (H, W) or (H, W, C) array (C = 1, 2 LA, 3 RGB or 4 RGBA); size is
    (width, height), as Pillow takes it. NEAREST takes any dtype (a mode "1"
    bool image, "I;16", palette indices)."""
    arr = np.asarray(img)
    if arr.dtype != np.uint8 and method != NEAREST:
        raise ValueError(f"resize filters uint8 images, got {arr.dtype}")
    squeeze = arr.ndim == 2
    if squeeze:
        arr = arr[..., None]
    out_w, out_h = int(size[0]), int(size[1])
    H, W, C = arr.shape
    if (out_w, out_h) == (W, H):
        return np.array(img)
    x = torch.as_tensor(np.ascontiguousarray(arr))
    if method == NEAREST:
        rows = torch.as_tensor(_nearest_index(H, out_h))
        cols = torch.as_tensor(_nearest_index(W, out_w))
        out = x[rows][:, cols]
    elif method in _FILTERS:
        x = x.to(torch.int64)
        alpha = C in (2, 4)
        if alpha:
            x = _premultiply(x)
        if out_w != W:
            x = _pass(x, 1, out_w, method)
        if out_h != H:
            x = _pass(x, 0, out_h, method)
        if alpha:
            x = _unpremultiply(x)
        out = x.to(torch.uint8)
    else:
        raise ValueError(f"unknown resize method {method!r}; use nearest, bilinear or lanczos")
    out = out.numpy()
    return out[..., 0] if squeeze else out
