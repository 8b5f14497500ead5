"""Public rasterization API: preprocess + binning + the tile kernels.

Pipeline (the JAX package's api.rasterize):
  1. preprocess (plain torch over P)       — cull, transmat, AABB
  2. opacity cull + stable depth argsort    — front-to-back order
  3. bin_pairs (B = pair_capacity)          — pair expansion + tile sort
  4. _RenderPairs autograd Function         — pair gather + both tile kernels
  5. unpack per-tile outputs to (H, W, *) maps

Step 4 keeps the payload gather and both kernels under one autograd
boundary, as the JAX package's `_render_pairs` custom VJP does: the forward
gathers the (C_PAD, B) pair payload from the (C_PAD, P) per-gaussian table
and runs `tiles_fwd.rasterize_tiles_fwd`; the backward gathers the pair
payload again (it keeps the table, not the B-column payload: 2 GiB at a
16M-pair budget, held across the step's backward otherwise), runs
`tiles_bwd.rasterize_tiles_bwd` and reduces its per-pair gradients per
gaussian with one `index_add_` (the JAX package's scatter-add, the CUDA
reference's atomics). No sorted-pair cotangent reaches autograd.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from materialrefgs_torch.cameras import Camera
from materialrefgs_torch.ops.rasterize import binning
from materialrefgs_torch.ops.rasterize.layout import (
    TILE,
    out_layout,
    payload_channels_padded,
)
from materialrefgs_torch.ops.rasterize.preprocess import PreprocessOut, preprocess
from materialrefgs_torch.ops.rasterize.tiles_bwd import grad_rows, rasterize_tiles_bwd
from materialrefgs_torch.ops.rasterize.tiles_fwd import rasterize_tiles_fwd
from materialrefgs_torch.utils.logging_utils import span, spanned


@dataclass(frozen=True)
class RasterizeConfig:
    pair_capacity: int = 1 << 20


class TileInputs(NamedTuple):
    """Everything the tile kernels take for one view, plus what the caller
    reports per gaussian."""

    payload: torch.Tensor  # (C_PAD, B) pair columns
    bins: binning.BinningOut
    pre: PreprocessOut  # unsorted (per-gaussian order)
    S: int
    grid_x: int
    grid_y: int
    W: int
    H: int


class _Permute(torch.autograd.Function):
    """x[order] whose gradient is the inverse-permutation gather g[inv_order]
    (the JAX package's `_permute`). Autograd's default for an index gather is
    a scatter-add; on a permutation each slot receives exactly one value, so
    the two give the same numbers, and the gather needs no atomics."""

    @staticmethod
    def forward(ctx, x, order, inv_order):
        ctx.save_for_backward(inv_order)
        return x[order]

    @staticmethod
    def backward(ctx, g):
        (inv_order,) = ctx.saved_tensors
        return g[inv_order], None, None


def _build_payload(pre: PreprocessOut, opacities, colors, features, S: int):
    """(C_PAD, P) per-gaussian payload columns (already depth-sorted).
    Row layout.row_gid(S) carries (own index + 1) as f32, as the JAX
    package's payload does; the kernels do not read it."""
    C_PAD = payload_channels_padded(S)
    P = opacities.shape[0]
    gid = torch.arange(1, P + 1, dtype=torch.float32, device=opacities.device)
    cols = [
        pre.T_rows[:, 0, :],
        pre.T_rows[:, 1, :],
        pre.T_rows[:, 2, :],
        pre.mean2d,
        opacities[:, None],
        colors,
        features,
        pre.normal,
        gid[:, None],
    ]
    pay = torch.cat(cols, dim=-1)  # (P, C)
    pad = C_PAD - pay.shape[-1]
    if pad:
        pay = torch.cat([pay, pay.new_zeros((P, pad))], dim=-1)
    return pay.T.contiguous()  # (C_PAD, P)


def _gather_pairs(payload_g: torch.Tensor, g_sorted: torch.Tensor) -> torch.Tensor:
    """(C_PAD, B) sorted-pair payload columns by one gather from the
    (C_PAD, P) per-gaussian table. Invalid pairs (sorted to the end) point at
    column 0; no tile range covers them."""
    return payload_g[:, g_sorted.to(torch.int64)]


class _RenderPairs(torch.autograd.Function):
    """Pair gather + both tile kernels under one autograd boundary. Saves
    the per-gaussian table, not the pair payload gathered from it: the
    backward gathers the same columns again."""

    @staticmethod
    def forward(ctx, payload_g, g_sorted, tile_start, tile_count, S, grid_x, grid_y, W, H, row0=0):
        pp = _gather_pairs(payload_g, g_sorted)
        out = rasterize_tiles_fwd(
            pp, tile_start, tile_count, S=S, grid_x=grid_x, grid_y=grid_y, W=W, H=H, row0=row0
        )
        ctx.save_for_backward(payload_g, g_sorted, tile_start, tile_count, out)
        ctx.dims = (S, grid_x, grid_y, W, H, row0, payload_g.shape[1])
        return out

    @staticmethod
    def backward(ctx, g):
        if torch.is_grad_enabled():
            # create_graph=True: the hand-derived backward has no derivative
            # of its own, so a higher-order gradient would be silently wrong.
            raise NotImplementedError(
                "rasterize supports first-order gradients only (the tile "
                "backward kernel is not itself differentiable)"
            )
        payload_g, g_sorted, tile_start, tile_count, fwd_out = ctx.saved_tensors
        S, grid_x, grid_y, W, H, row0, P = ctx.dims
        n_contrib = fwd_out[..., out_layout(S)["n_contrib"][0]]  # (T, 256)
        tile_active = torch.amax(n_contrib, dim=1).to(torch.int32)
        dpair = rasterize_tiles_bwd(
            _gather_pairs(payload_g, g_sorted), tile_start, tile_count, tile_active, fwd_out, g.contiguous(),
            S=S, grid_x=grid_x, grid_y=grid_y, W=W, H=H, row0=row0,
        )
        acc = torch.zeros((P, grad_rows(S)), dtype=dpair.dtype, device=dpair.device)
        acc.index_add_(0, g_sorted.to(torch.int64), dpair)
        # (C_PAD, P): the row_gid row and the padding rows carry no gradient.
        dpg = torch.nn.functional.pad(acc, (0, payload_g.shape[0] - grad_rows(S))).T
        return dpg, None, None, None, None, None, None, None, None, None


class _SortedInputs(NamedTuple):
    payload_g: torch.Tensor  # (C_PAD, P) per-gaussian payload, depth order
    bins: binning.BinningOut
    pre: PreprocessOut  # unsorted (per-gaussian order), offset applied
    S: int
    grid_x: int
    grid_y: int
    W: int
    H: int
    row0: int  # the grid's first tile row in the view


def _sorted_inputs(
    means3d, scales, rotations, opacities, colors, features, camera: Camera,
    scale_modifier: float, config: RasterizeConfig, mean2d_offset=None,
    rows: tuple[int, int] | None = None,
) -> _SortedInputs:
    """Steps 1-3 of the pipeline and the per-gaussian payload.

    rows (row0, rows_local): bin and render only the tile rows [row0,
    row0 + rows_local) of the view (a block of the tile-sharded render,
    parallel/tile_sharding.py): the rects are clipped to the block and count
    from its first row, and the keep mask and the tile kernels take row0, so
    every pixel keeps the view's own coordinates and the block's maps are
    bit for bit the whole view's."""
    H, W = camera.height, camera.width
    grid_x = (W + TILE - 1) // TILE
    grid_y = (H + TILE - 1) // TILE
    S = features.shape[-1]

    with span("rasterize.preprocess"):
        pre = preprocess(means3d, scales, rotations, camera, scale_modifier)
        if mean2d_offset is not None:
            # Screen-space translation probe (the reference's screenspace_points
            # trick, api.py:237-250 of the JAX package). A +delta screen shift of
            # the splat homography is exactly Tu += dx*Tw, Tv += dy*Tw, and mean2d
            # feeds the low-pass branch, so the offset's gradient is the full
            # pixel-unit screen-translation gradient of both per-pixel branches.
            dx = mean2d_offset[:, 0:1]
            dy = mean2d_offset[:, 1:2]
            T = pre.T_rows
            T = torch.stack([T[:, 0, :] + dx * T[:, 2, :], T[:, 1, :] + dy * T[:, 2, :], T[:, 2, :]], dim=1)
            pre = pre._replace(mean2d=pre.mean2d + mean2d_offset, T_rows=T)
        valid = pre.valid
        row0 = 0
        if rows is not None:
            row0, grid_y = rows
            lo = pre.rect_min.clone()
            hi = pre.rect_max.clone()
            lo[:, 1] = torch.clamp(lo[:, 1] - row0, 0, grid_y)
            hi[:, 1] = torch.clamp(hi[:, 1] - row0, 0, grid_y)
            nxy = torch.clamp(hi - lo, min=0)
            tiles = (nxy[:, 0] * nxy[:, 1]).to(pre.tiles_touched.dtype)
            valid = valid & (tiles > 0)
            pre = pre._replace(rect_min=lo, rect_max=hi, tiles_touched=tiles)
        # Gaussians with opacity < 1/255 can never pass the per-pixel alpha test
        # (forward.cu:397); cull them so dead fixed-capacity slots cost no pairs.
        valid = valid & (opacities >= (1.0 / 255.0))
        pre = pre._replace(
            valid=valid,
            tiles_touched=torch.where(valid, pre.tiles_touched, torch.zeros_like(pre.tiles_touched)),
            radius=torch.where(valid, pre.radius, torch.zeros_like(pre.radius)),
        )

    with span("rasterize.sort"):
        # Depth sort over gaussians (stable: ties keep index order, like CUDA's
        # radix sort).
        order = torch.argsort(pre.depth, stable=True)
        inv_order = torch.argsort(order)

        def sort_by_depth(a):
            return _Permute.apply(a, order, inv_order) if a.is_floating_point() else a[order]

        pre_s = PreprocessOut(*(sort_by_depth(a) for a in pre))
        opac_s = sort_by_depth(opacities)
        bins = binning.bin_pairs(pre_s, grid_x, grid_y, config.pair_capacity, opacities=opac_s, row0=row0)
        payload_g = _build_payload(pre_s, opac_s, sort_by_depth(colors), sort_by_depth(features), S)
    return _SortedInputs(payload_g, bins, pre, S, grid_x, grid_y, W, H, row0)


def tile_inputs(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    rotations: torch.Tensor,
    opacities: torch.Tensor,
    colors: torch.Tensor,
    features: torch.Tensor,
    camera: Camera,
    scale_modifier: float = 1.0,
    config: RasterizeConfig = RasterizeConfig(),
) -> TileInputs:
    """Steps 1-3 and the pair gather: the forward kernel's inputs for one view."""
    si = _sorted_inputs(
        means3d, scales, rotations, opacities, colors, features, camera, scale_modifier, config
    )
    return TileInputs(_gather_pairs(si.payload_g, si.bins.g_sorted), *si[1:-1])


@spanned("rasterize.tiles")
def _render(si: _SortedInputs) -> torch.Tensor:
    """Step 4: (grid_y * grid_x, 256, C_OUT) tile outputs."""
    return _RenderPairs.apply(
        si.payload_g, si.bins.g_sorted, si.bins.tile_start, si.bins.tile_count,
        si.S, si.grid_x, si.grid_y, si.W, si.H, si.row0,
    )


def _unpack(tiles_out, S, grid_x, grid_y, W, H, bg_color):
    layout = out_layout(S)
    C_OUT = tiles_out.shape[-1]
    img = tiles_out.reshape(grid_y, grid_x, TILE, TILE, C_OUT)
    img = img.permute(0, 2, 1, 3, 4).reshape(grid_y * TILE, grid_x * TILE, C_OUT)
    img = img[:H, :W]

    def ch(name):
        a, b = layout[name]
        v = img[..., a:b]
        return v[..., 0] if b - a == 1 else v

    final_T = ch("final_T")
    return {
        "render": ch("color") + final_T[..., None] * bg_color[None, None, :],
        "feature": ch("feature"),
        "normal": ch("normal"),
        "depth": ch("depth"),
        "M1": ch("M1"),
        "M2": ch("M2"),
        "distortion": ch("distortion"),
        "median_depth": ch("median_depth"),
        "final_T": final_T,
        "alpha": 1.0 - final_T,
        "n_contrib": ch("n_contrib").detach().to(torch.int32),
        "median_contrib": ch("median_contrib").detach().to(torch.int32),
    }


@spanned("rasterize")
def rasterize(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    rotations: torch.Tensor,
    opacities: torch.Tensor,
    colors: torch.Tensor,
    features: torch.Tensor,
    camera: Camera,
    bg_color: torch.Tensor,
    scale_modifier: float = 1.0,
    config: RasterizeConfig = RasterizeConfig(),
    mean2d_offset: torch.Tensor | None = None,
) -> dict:
    """Differentiable rasterization; returns a dict of (H, W, *) maps plus
    per-gaussian 'radii' and screen-space 'mean2d', and the binning
    'overflow' (pairs dropped for capacity; 0 when nothing was dropped).

    mean2d_offset (P, 2): a zeros tensor whose gradient is the screen-space
    mean2D gradient (the reference's screenspace_points trick), used for the
    densification statistics."""
    si = _sorted_inputs(
        means3d, scales, rotations, opacities, colors, features, camera,
        scale_modifier, config, mean2d_offset,
    )
    out = _unpack(_render(si), si.S, si.grid_x, si.grid_y, si.W, si.H, bg_color)
    out["radii"] = si.pre.radius
    out["mean2d"] = si.pre.mean2d
    out["overflow"] = si.bins.overflow
    return out
