"""Tile binning: (gaussian, tile) pair expansion + sort + raw tile ranges.

Same algorithm and integer results as the JAX package's binning:
  - Gaussians are depth-sorted first, so pair expansion emits pairs in depth
    order and one stable sort by tile id gives per-tile front-to-back order.
  - Tile ranges are raw (unaligned) offsets into the sorted pair list.
  - Static shapes: the pair list has fixed capacity `pair_capacity`; pairs
    past it (the farthest gaussians', since expansion is depth-major) are
    dropped and reported via `overflow`.

Where torch's integer semantics differ from JAX's, this module reproduces
JAX's: int32 prefix sums wrap (torch promotes cumsum to int64, so results are
cast back), scatters drop out-of-range indices after NumPy-style wrapping of
negative ones, and popcount is a SWAR bit count.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from materialrefgs_torch.ops.rasterize.layout import FILTER_INV_SQUARE, K_CHUNK, TILE
from materialrefgs_torch.ops.rasterize.preprocess import PreprocessOut

INT32_MAX = 2**31 - 1


class BinningOut(NamedTuple):
    g_sorted: torch.Tensor  # (B,) int32 gaussian id per sorted pair (0 if invalid)
    tile_start: torch.Tensor  # (T+1,) int32 RAW start offsets (unaligned)
    tile_count: torch.Tensor  # (T,) int32 pairs per tile
    chunk_base: torch.Tensor  # (T+1,) int32 cumulative K-chunk windows per tile
    num_pairs: torch.Tensor  # () int32 valid pairs kept
    overflow: torch.Tensor  # () int64 pairs dropped due to capacity


def _cumsum_i32(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """int32 prefix sum with int32 wraparound (as jnp.cumsum on int32)."""
    return torch.cumsum(x, dim=dim, dtype=torch.int64).to(torch.int32)


def _broadcast_to_segments_multi(values: torch.Tensor, seg_starts: torch.Tensor, B: int):
    """values (M, S) int32 broadcast along segments with the given start
    offsets (sorted, may repeat for empty segments) -> (M, B) with
    out[m, k] = values[m, seg_of(k)]: one delta-scatter + prefix sum."""
    M = values.shape[0]
    deltas = torch.diff(values, dim=1, prepend=torch.zeros_like(values[:, :1]))
    idx = torch.where(seg_starts < B, seg_starts, torch.full_like(seg_starts, B)).to(torch.int64)
    # JAX's scatter wraps negative indices NumPy-style, then drops what is
    # still out of range; slot B collects the dropped deltas.
    idx = torch.where(idx < 0, idx + B, idx)
    idx = torch.where((idx < 0) | (idx >= B), torch.full_like(idx, B), idx)
    marks = torch.zeros((M, B + 1), dtype=torch.int64, device=values.device)
    marks.index_add_(1, idx, deltas.to(torch.int64))
    return _cumsum_i32(marks[:, :B], dim=1)


# Tight tile culling: rects up to MASK_W x MASK_W tiles get an exact
# per-tile keep bitmask (bits 0..24 in mask0, 25..48 in mask1).
MASK_W = 7
_MASK_LO_BITS = 25


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of non-negative 32-bit values (SWAR; torch has no popcount)."""
    x = x.to(torch.int64)
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.int32)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(a, b, dim=-1)


def tile_keep_mask(pre: PreprocessOut, opacities: torch.Tensor, row0: int = 0):
    """Exact, output-neutral per-tile culling masks (one bit per rect tile).

    A (gaussian, tile) pair is dropped only if the per-pixel test
    `alpha = opa*exp(-rho/2) >= 1/255` can never pass anywhere in the tile:
    the 3D branch is the conic F(x,y) = h1^2 + h2^2 - R*h3^2 <= 0 with
    h = adj(T) @ (x, y, 1) and R = 2*ln(255*opa), minimized exactly over the
    tile's pixel box when elliptic (kept otherwise), with a derived f32
    rounding bound; the 2D low-pass branch keeps any tile within
    rho2d <= R of mean2d.

    Returns (mask0, mask1, use_mask, tiles_kept), all (P,). Gaussians whose
    rect exceeds MASK_W^2 keep every tile (use_mask=False). The rects' tile
    rows count from the view's tile row row0 (a tile-sharded block)."""
    dev = opacities.device
    rmx = pre.rect_min[:, 0].to(torch.int32)
    rmy = pre.rect_min[:, 1].to(torch.int32)
    w = (pre.rect_max[:, 0] - pre.rect_min[:, 0]).to(torch.int32)
    h = (pre.rect_max[:, 1] - pre.rect_min[:, 1]).to(torch.int32)
    use_mask = pre.valid & (w >= 1) & (h >= 1) & (w <= MASK_W) & (h <= MASK_W)

    T = pre.T_rows.detach()
    # Rows of adj(T): cross products of T's columns (cyclic).
    c0, c1, c2 = T[:, :, 0], T[:, :, 1], T[:, :, 2]
    u = _cross(c1, c2)
    v = _cross(c2, c0)
    g3 = _cross(c0, c1)
    opa = opacities.detach()
    R = 2.0 * torch.log(torch.clamp(255.0 * opa, min=1e-12))
    # Normalize each (u, v, sqrt(R)*g3) triple to O(1): F scales by s^2 > 0,
    # so the sign of its box minimum is unchanged.
    scale = torch.sqrt(
        torch.sum(u * u, dim=1)
        + torch.sum(v * v, dim=1)
        + torch.clamp(R, min=0.0) * torch.sum(g3 * g3, dim=1)
    )
    s = 1.0 / torch.clamp(scale, min=1e-30)
    u = u * s[:, None]
    v = v * s[:, None]
    g3 = g3 * s[:, None]

    def q(i, j):
        return (u[:, i] * u[:, j] + v[:, i] * v[:, j] - R * g3[:, i] * g3[:, j])[:, None]

    q11, q12, q22 = q(0, 0), q(0, 1), q(1, 1)
    q13, q23, q33 = q(0, 2), q(1, 2), q(2, 2)

    # Rounding bound from the pre-cancellation magnitudes (|cross| terms).
    def _abs_cross(a, b):
        return torch.stack(
            [
                torch.abs(a[:, 1] * b[:, 2]) + torch.abs(a[:, 2] * b[:, 1]),
                torch.abs(a[:, 2] * b[:, 0]) + torch.abs(a[:, 0] * b[:, 2]),
                torch.abs(a[:, 0] * b[:, 1]) + torch.abs(a[:, 1] * b[:, 0]),
            ],
            dim=1,
        )

    uabs = _abs_cross(c1, c2) * s[:, None]
    vabs = _abs_cross(c2, c0) * s[:, None]
    gabs = _abs_cross(c0, c1) * s[:, None]
    k_eps = float(16.0 * np.finfo(np.float32).eps)
    Rmag = torch.abs(R)

    def qerr(i, j):
        return (
            k_eps
            * (uabs[:, i] * uabs[:, j] + vabs[:, i] * vabs[:, j] + Rmag * gabs[:, i] * gabs[:, j])
        )[:, None]

    e11, e12, e22 = qerr(0, 0), qerr(0, 1), qerr(1, 1)
    e13, e23, e33 = qerr(0, 2), qerr(1, 2), qerr(2, 2)

    NT = MASK_W * MASK_W
    i = torch.arange(NT, dtype=torch.int32, device=dev)[None, :]  # (1, 49)
    wg = torch.clamp(w, min=1)[:, None]
    ix = i % wg
    iy = torch.div(i, wg, rounding_mode="floor")
    in_rect = i < (w * h)[:, None]
    x0 = ((rmx[:, None] + ix) * TILE).to(torch.float32)
    y0 = ((rmy[:, None] + iy + row0) * TILE).to(torch.float32)
    x1 = x0 + (TILE - 1)
    y1 = y0 + (TILE - 1)

    det2 = q11 * q22 - q12 * q12
    elliptic = (q11 > 0.0) & (det2 > 0.0)
    one = torch.ones_like(q11)
    sq11 = torch.where(elliptic, q11, one)
    sq22 = torch.where(elliptic, q22, one)
    sdet2 = torch.where(elliptic, det2, one)

    def F(x, y):
        return (
            q11 * x * x + 2.0 * q12 * x * y + q22 * y * y
            + 2.0 * q13 * x + 2.0 * q23 * y + q33
        )

    def clip(a, lo, hi):
        return torch.minimum(torch.maximum(a, lo), hi)

    # Convex min over the box: unconstrained center if inside, else 4 edges.
    xc = (q12 * q23 - q22 * q13) / sdet2
    yc = (q12 * q13 - q11 * q23) / sdet2
    inside = (xc >= x0) & (xc <= x1) & (yc >= y0) & (yc <= y1)
    yx0 = clip(-(q12 * x0 + q23) / sq22, y0, y1)
    yx1 = clip(-(q12 * x1 + q23) / sq22, y0, y1)
    xy0 = clip(-(q12 * y0 + q13) / sq11, x0, x1)
    xy1 = clip(-(q12 * y1 + q13) / sq11, x0, x1)
    Fmin = torch.minimum(
        torch.minimum(F(x0, yx0), F(x1, yx1)), torch.minimum(F(xy0, y0), F(xy1, y1))
    )
    Fmin = torch.where(inside, torch.minimum(Fmin, F(xc, yc)), Fmin)
    xm = torch.maximum(torch.abs(x0), torch.abs(x1))
    ym = torch.maximum(torch.abs(y0), torch.abs(y1))
    tol = (
        e11 * xm * xm + 2.0 * e12 * xm * ym + e22 * ym * ym
        + 2.0 * e13 * xm + 2.0 * e23 * ym + e33
    )
    keep3d = Fmin <= tol

    cx = pre.mean2d[:, 0:1]
    cy = pre.mean2d[:, 1:2]
    zero = torch.zeros_like(x0)
    dx = torch.maximum(torch.maximum(x0 - cx, cx - x1), zero)
    dy = torch.maximum(torch.maximum(y0 - cy, cy - y1), zero)
    keep2d = FILTER_INV_SQUARE * (dx * dx + dy * dy) <= R[:, None]

    keep = in_rect & (keep2d | keep3d | ~elliptic)
    bit = keep.to(torch.int32)
    lo = _MASK_LO_BITS
    mask0 = torch.sum(bit[:, :lo] << i[0, :lo][None, :], dim=1, dtype=torch.int32)
    mask1 = torch.sum(bit[:, lo:] << i[0, : NT - lo][None, :], dim=1, dtype=torch.int32)
    zeros_p = torch.zeros_like(mask0)
    mask0 = torch.where(use_mask, mask0, zeros_p)
    mask1 = torch.where(use_mask, mask1, zeros_p)
    kept = _popcount32(mask0) + _popcount32(mask1)
    tiles_kept = torch.where(use_mask, kept, w * h)
    return mask0, mask1, use_mask, tiles_kept


def _popcount_below(m0, m1, n):
    """Number of set bits at positions < n (n in [0, 49]) of the split mask."""
    lo = _MASK_LO_BITS
    nlo = torch.clamp(n, max=lo)
    c = _popcount32(m0 & ((1 << nlo) - 1))
    nhi = torch.clamp(n - lo, 0, MASK_W * MASK_W - lo)
    return c + _popcount32(m1 & ((1 << nhi) - 1))


def bin_pairs(
    pre: PreprocessOut,
    grid_x: int,
    grid_y: int,
    pair_capacity: int,
    opacities: torch.Tensor | None = None,
    row0: int = 0,
) -> BinningOut:
    """`pre` must already be depth-sorted (see api.rasterize).

    With `opacities`, tight per-tile culling (tile_keep_mask) runs first and
    culled tiles never consume pair slots. row0: the grid's first tile row in
    the view (a tile-sharded block; its rects count from it)."""
    num_tiles = grid_x * grid_y
    K = K_CHUNK
    if pair_capacity % K:
        raise ValueError(f"pair_capacity must be a multiple of {K}")
    if grid_x >= 1024 or grid_y >= 1024:
        raise ValueError("tile grid exceeds the 10-bit rect packing (16k px per side)")
    dev = pre.depth.device
    counts_g = pre.tiles_touched.to(torch.int32)  # (P,)
    if opacities is not None:
        mask0, mask1, use_mask, tiles_kept = tile_keep_mask(pre, opacities, row0)
        counts_g = torch.minimum(counts_g, tiles_kept.to(torch.int32))
    cum64 = torch.cumsum(counts_g, dim=0, dtype=torch.int64)
    # A pair total past int32 (pathological scenes: millions of splats x
    # hundreds of tiles) is clamped to INT32_MAX so the reported overflow
    # stays loud and positive; offsets wrap exactly as JAX's int32 cumsum.
    wrapped = cum64[-1] > INT32_MAX
    total = torch.where(wrapped, torch.full_like(cum64[-1], INT32_MAX), cum64[-1])
    offsets = (cum64 - counts_g).to(torch.int32)

    B = pair_capacity
    k = torch.arange(B, dtype=torch.int32, device=dev)
    P = counts_g.shape[0]
    gauss_ids = torch.arange(P, dtype=torch.int32, device=dev)
    # Pack (rect_min_x, rect_min_y, rect_w) into one word, 10 bits each.
    rmx = pre.rect_min[:, 0].to(torch.int32)
    rmy = pre.rect_min[:, 1].to(torch.int32)
    rw = torch.clamp(pre.rect_max[:, 0] - pre.rect_min[:, 0], min=1).to(torch.int32)
    packed = rmx | (rmy << 10) | (rw << 20)
    chans = [gauss_ids, offsets, packed]
    if opacities is not None:
        # Bit 30 flags mask-culled gaussians; the keep masks ride along.
        packed = packed | (use_mask.to(torch.int32) << 30)
        chans = [gauss_ids, offsets, packed, mask0, mask1]
    bcast = _broadcast_to_segments_multi(torch.stack(chans), offsets, B)
    g, off_p, packed_p = bcast[0], bcast[1], bcast[2]
    rmx_p = packed_p & 0x3FF
    rmy_p = (packed_p >> 10) & 0x3FF
    # JAX leaves x // 0 undefined; rw >= 1 for every real segment, and the
    # clamp only guards garbage segments of the int32-wrap case.
    rw_p = torch.clamp((packed_p >> 20) & 0x3FF, min=1)
    raw_valid = k.to(torch.int64) < torch.clamp(total, max=B)

    local = k - off_p
    if opacities is not None:
        # Pair `local` is the local-th KEPT tile: its rect-local index is the
        # (local+1)-th set bit of the keep mask, by a binary climb over
        # prefix popcounts.
        m0_p, m1_p = bcast[3], bcast[4]
        j = torch.zeros_like(local)
        for step in (32, 16, 8, 4, 2, 1):
            cand = j + step
            ok = (cand <= MASK_W * MASK_W) & (
                _popcount_below(m0_p, m1_p, cand) <= local
            )
            j = torch.where(ok, cand, j)
        local = torch.where(((packed_p >> 30) & 1) == 1, j, local)
    ty = rmy_p + torch.div(local, rw_p, rounding_mode="floor")
    tx = rmx_p + torch.remainder(local, rw_p)
    tile = ty * grid_x + tx
    tile = torch.where(raw_valid, tile, torch.full_like(tile, num_tiles)).to(torch.int64)

    # Stable sort by tile keeps depth order within each tile.
    g_masked = torch.where(raw_valid, g, torch.zeros_like(g)).to(torch.int32)
    tile_sorted, perm = torch.sort(tile, stable=True)
    g_sorted = g_masked[perm]

    tile_start = torch.searchsorted(
        tile_sorted, torch.arange(num_tiles + 1, dtype=torch.int64, device=dev), right=False
    ).to(torch.int32)
    tile_count = tile_start[1:] - tile_start[:-1]

    # Per-tile K-aligned chunk windows (bookkeeping for the backward kernel).
    head = tile_start[:-1] - torch.div(tile_start[:-1], K, rounding_mode="floor") * K
    n_chunks = torch.where(
        tile_count > 0,
        torch.div(head + tile_count + K - 1, K, rounding_mode="floor"),
        torch.zeros_like(tile_count),
    )
    chunk_base = torch.cat(
        [torch.zeros(1, dtype=torch.int32, device=dev), _cumsum_i32(n_chunks, dim=0)]
    )

    num_kept = tile_start[-1]
    return BinningOut(
        g_sorted=g_sorted,
        tile_start=tile_start,
        tile_count=tile_count,
        chunk_base=chunk_base,
        num_pairs=num_kept,
        overflow=total - num_kept,
    )
