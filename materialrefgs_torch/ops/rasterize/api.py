"""Public rasterization API, forward only: preprocess + binning + tile kernel.

Pipeline (the JAX package's api.rasterize, forward half):
  1. preprocess (plain torch over P)       — cull, transmat, AABB
  2. opacity cull + stable depth argsort    — front-to-back order
  3. bin_pairs (B = pair_capacity)          — pair expansion + tile sort
  4. payload build + pair gather            — (C_PAD, B) column payload
  5. tiles_fwd.rasterize_tiles_fwd          — CUDA kernel on the card
  6. unpack per-tile outputs to (H, W, *) maps

The backward (rasterize_tiles_bwd and the per-gaussian reduction) is ported
with the training slice; until then a call that autograd would have to
differentiate raises NotImplementedError.
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
from materialrefgs_torch.ops.rasterize.tiles_fwd import rasterize_tiles_fwd


@dataclass(frozen=True)
class RasterizeConfig:
    pair_capacity: int = 1 << 20


class TileInputs(NamedTuple):
    """Everything the tile kernel takes for one view, plus what the caller
    reports per gaussian."""

    payload: torch.Tensor  # (C_PAD, B) pair columns
    bins: binning.BinningOut
    pre: PreprocessOut  # unsorted (per-gaussian order)
    S: int
    grid_x: int
    grid_y: int
    W: int
    H: int


def _build_payload(pre: PreprocessOut, opacities, colors, features, S: int):
    """(C_PAD, P) per-gaussian payload columns (already depth-sorted).
    Row layout.row_gid(S) carries (own index + 1) as f32 for the backward."""
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


def _gather_pairs(payload_g: torch.Tensor, bins: binning.BinningOut) -> torch.Tensor:
    """(C_PAD, B) sorted-pair payload columns by one gather from the
    (C_PAD, P) per-gaussian table. Invalid pairs (sorted to the end) point at
    column 0; no tile range covers them."""
    return payload_g[:, bins.g_sorted.to(torch.int64)]


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
    """Steps 1-4 of the pipeline: the kernel's inputs for one view."""
    H, W = camera.height, camera.width
    grid_x = (W + TILE - 1) // TILE
    grid_y = (H + TILE - 1) // TILE
    S = features.shape[-1]

    pre = preprocess(means3d, scales, rotations, camera, scale_modifier)
    # Gaussians with opacity < 1/255 can never pass the per-pixel alpha test
    # (forward.cu:397); cull them so dead fixed-capacity slots cost no pairs.
    valid = pre.valid & (opacities >= (1.0 / 255.0))
    pre = pre._replace(
        valid=valid,
        tiles_touched=torch.where(valid, pre.tiles_touched, torch.zeros_like(pre.tiles_touched)),
        radius=torch.where(valid, pre.radius, torch.zeros_like(pre.radius)),
    )

    # Depth sort over gaussians (stable: ties keep index order, like CUDA's
    # radix sort).
    order = torch.argsort(pre.depth, stable=True)
    pre_s = PreprocessOut(*(a[order] for a in pre))
    bins = binning.bin_pairs(
        pre_s, grid_x, grid_y, config.pair_capacity, opacities=opacities[order]
    )
    payload_g = _build_payload(pre_s, opacities[order], colors[order], features[order], S)
    return TileInputs(_gather_pairs(payload_g, bins), bins, pre, S, grid_x, grid_y, W, H)


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
        "n_contrib": ch("n_contrib").to(torch.int32),
        "median_contrib": ch("median_contrib").to(torch.int32),
    }


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
) -> dict:
    """Forward rasterization; returns a dict of (H, W, *) maps plus
    per-gaussian 'radii' and screen-space 'mean2d', and the binning
    'overflow' (pairs dropped for capacity; 0 when nothing was dropped)."""
    inputs = (means3d, scales, rotations, opacities, colors, features)
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        raise NotImplementedError(
            "rasterize has no backward yet: rasterize_tiles_bwd and the "
            "per-gaussian gradient reduction come with the training slice of "
            "the port; call under torch.no_grad() to render"
        )
    ti = tile_inputs(
        means3d, scales, rotations, opacities, colors, features, camera,
        scale_modifier, config,
    )
    tiles_out = rasterize_tiles_fwd(
        ti.payload, ti.bins.tile_start, ti.bins.tile_count,
        S=ti.S, grid_x=ti.grid_x, grid_y=ti.grid_y, W=ti.W, H=ti.H,
    )
    out = _unpack(tiles_out, ti.S, ti.grid_x, ti.grid_y, ti.W, ti.H, bg_color)
    out["radii"] = ti.pre.radius
    out["mean2d"] = ti.pre.mean2d
    out["overflow"] = ti.bins.overflow
    return out
