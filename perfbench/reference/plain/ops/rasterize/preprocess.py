"""Per-Gaussian preprocessing for the 2D surfel rasterizer (plain torch).

Vectorized preprocessCUDA (diff-surfel-rasterization forward.cu:164-266):
frustum cull, splat->pixel homography ("transmat"), view-space normal with
dual-visible flip, screen AABB and tile rect.

In row-vector form the transmat rows are
  T_rows = Npix^T @ P_full^T @ Hsplat,  where
  Hsplat (4x3) columns = [sx*tu; 0], [sy*tv; 0], [p; 1]
  Npix^T (3x4) = [[W/2,0,0,(W-1)/2],[0,H/2,0,(H-1)/2],[0,0,0,1]]
so that T_rows @ (u, v, 1)^T = (pix_x*w, pix_y*w, w) with w = view-space z.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from perfbench.reference.plain.cameras import Camera
from perfbench.reference.plain.ops.rasterize.layout import CUTOFF, NEAR_N, TILE
from perfbench.reference.plain.utils.transforms import quat_to_rotmat


class PreprocessOut(NamedTuple):
    T_rows: torch.Tensor  # (P, 3, 3) rows = Tu, Tv, Tw
    normal: torch.Tensor  # (P, 3) view-space normal (dual-visible flipped)
    depth: torch.Tensor  # (P,) view-space z of the splat center
    mean2d: torch.Tensor  # (P, 2) screen-space AABB center ("point_image")
    radius: torch.Tensor  # (P,) float radius in pixels (ceil applied)
    rect_min: torch.Tensor  # (P, 2) int32 tile rect (x, y), inclusive
    rect_max: torch.Tensor  # (P, 2) int32 tile rect (x, y), exclusive
    tiles_touched: torch.Tensor  # (P,) int32
    valid: torch.Tensor  # (P,) bool — survives culling


def compute_transmat(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    rotations: torch.Tensor,
    camera: Camera,
    scale_modifier: float = 1.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (T_rows (P,3,3), world_normal (P,3)). forward.cu:77-125."""
    R = quat_to_rotmat(rotations)  # (P, 3, 3); columns are tu, tv, tw
    tu = R[..., :, 0] * (scales[..., 0:1] * scale_modifier)
    tv = R[..., :, 1] * (scales[..., 1:2] * scale_modifier)
    tw = R[..., :, 2]  # unit normal

    W, H = camera.width, camera.height
    zeros = torch.zeros_like(tu[..., :1])
    ones = torch.ones_like(tu[..., :1])
    Hsplat = torch.stack(
        [
            torch.cat([tu, zeros], dim=-1),
            torch.cat([tv, zeros], dim=-1),
            torch.cat([means3d, ones], dim=-1),
        ],
        dim=-1,
    )  # (P, 4, 3)
    Npix_T = torch.tensor(
        [
            [W / 2.0, 0, 0, (W - 1) / 2.0],
            [0, H / 2.0, 0, (H - 1) / 2.0],
            [0, 0, 0, 1.0],
        ],
        dtype=torch.float32,
        device=means3d.device,
    )
    M = Npix_T @ camera.full_proj.T  # (3, 4)
    T_rows = torch.einsum("ij,pjk->pik", M, Hsplat)  # (P, 3, 3)
    return T_rows, tw


def compute_aabb(T_rows: torch.Tensor, cutoff: float = CUTOFF):
    """forward.cu:129-159. Returns (center (P,2), extent (P,2), ok (P,))."""
    Tu, Tv, Tw = T_rows[..., 0, :], T_rows[..., 1, :], T_rows[..., 2, :]
    temp_point = torch.tensor(
        [cutoff * cutoff, cutoff * cutoff, -1.0], dtype=torch.float32, device=T_rows.device
    )
    distance = torch.sum(Tw * Tw * temp_point, dim=-1)
    ok = distance != 0.0
    f = temp_point / torch.where(ok, distance, torch.ones_like(distance))[..., None]
    center = torch.stack(
        [torch.sum(f * Tu * Tw, dim=-1), torch.sum(f * Tv * Tw, dim=-1)], dim=-1
    )
    temp = torch.stack(
        [torch.sum(f * Tu * Tu, dim=-1), torch.sum(f * Tv * Tv, dim=-1)], dim=-1
    )
    half_extend = center * center - temp
    extent = torch.sqrt(torch.clamp(half_extend, min=1e-4))
    return center, extent, ok


def get_rect(center: torch.Tensor, radius: torch.Tensor, grid_x: int, grid_y: int):
    """auxiliary.h getRect: tile rect [rect_min, rect_max) per Gaussian."""
    gmin = torch.stack(
        [
            torch.trunc((center[..., 0] - radius) / TILE),
            torch.trunc((center[..., 1] - radius) / TILE),
        ],
        dim=-1,
    )
    gmax = torch.stack(
        [
            torch.trunc((center[..., 0] + radius + TILE - 1) / TILE),
            torch.trunc((center[..., 1] + radius + TILE - 1) / TILE),
        ],
        dim=-1,
    )
    lim = torch.tensor([grid_x, grid_y], dtype=torch.float32, device=center.device)
    rect_min = torch.minimum(torch.clamp(gmin, min=0), lim).to(torch.int32)
    rect_max = torch.minimum(torch.clamp(gmax, min=0), lim).to(torch.int32)
    return rect_min, rect_max


def preprocess(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    rotations: torch.Tensor,
    camera: Camera,
    scale_modifier: float = 1.0,
) -> PreprocessOut:
    P = means3d.shape[0]
    W, H = camera.width, camera.height
    grid_x = (W + TILE - 1) // TILE
    grid_y = (H + TILE - 1) // TILE

    # Frustum cull (auxiliary.h:192): view-space z must exceed NEAR_N.
    ones = torch.ones((P, 1), dtype=means3d.dtype, device=means3d.device)
    p_view = torch.cat([means3d, ones], dim=-1) @ camera.world_view
    depth = p_view[..., 2]
    in_front = depth > NEAR_N

    T_rows, world_normal = compute_transmat(
        means3d, scales, rotations, camera, scale_modifier
    )

    # View-space normal + dual-visible flip (forward.cu:224-229).
    normal_view = world_normal @ camera.world_view[:3, :3]
    cos = -torch.sum(p_view[..., :3] * normal_view, dim=-1)
    normal_view = torch.where((cos > 0)[..., None], normal_view, -normal_view)
    cos_ok = cos != 0.0

    center, extent, aabb_ok = compute_aabb(T_rows, CUTOFF)
    # Like the CUDA reference (forward.cu:245): the rect radius is the 3-sigma
    # projected extent with no low-pass-filter floor.
    radius = torch.ceil(torch.maximum(extent[..., 0], extent[..., 1]))
    rect_min, rect_max = get_rect(center, radius, grid_x, grid_y)
    nxy = torch.clamp(rect_max - rect_min, min=0)
    tiles = nxy[..., 0] * nxy[..., 1]

    valid = in_front & cos_ok & aabb_ok & (tiles > 0)
    tiles = torch.where(valid, tiles, torch.zeros_like(tiles))
    return PreprocessOut(
        T_rows=T_rows,
        normal=normal_view,
        depth=depth,
        mean2d=center,
        radius=torch.where(valid, radius, torch.zeros_like(radius)),
        rect_min=rect_min,
        rect_max=rect_max,
        tiles_touched=tiles.to(torch.int32),
        valid=valid,
    )
