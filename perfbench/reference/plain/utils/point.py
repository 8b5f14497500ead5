"""Depth map -> point cloud / pseudo-normals (reference utils/point_utils.py)."""
from __future__ import annotations

import torch

from perfbench.reference.plain.cameras import Camera


def depths_to_points(camera: Camera, depthmap: torch.Tensor) -> torch.Tensor:
    """(H, W) depth -> (H, W, 3) world points (point_utils.py:9-24).

    Uses the reference's intrinsics derivation (ndc2pix with a W/2 offset,
    half a pixel off the rasterizer's (W-1)/2 convention, as in the original)."""
    H, W = camera.height, camera.width
    dev = depthmap.device
    c2w = torch.linalg.inv(camera.world_view.T)
    ndc2pix = torch.tensor(
        [[W / 2, 0, 0, W / 2], [0, H / 2, 0, H / 2], [0, 0, 0, 1.0]],
        dtype=torch.float32,
        device=dev,
    ).T  # (4, 3)
    projection = c2w.T @ camera.full_proj
    intrins = (projection @ ndc2pix)[:3, :3].T
    gx = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(H, W)
    gy = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W)
    pts = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)
    rays_d = pts @ torch.linalg.inv(intrins).T @ c2w[:3, :3].T
    rays_o = c2w[:3, 3]
    return depthmap[..., None] * rays_d + rays_o


def depth_to_normal(camera: Camera, depthmap: torch.Tensor) -> torch.Tensor:
    """(H, W) depth -> (H, W, 3) normals from the cross product of finite
    differences (point_utils.py:26-40); border pixels are zero."""
    points = depths_to_points(camera, depthmap)
    dx = points[2:, 1:-1] - points[:-2, 1:-1]
    dy = points[1:-1, 2:] - points[1:-1, :-2]
    n = torch.linalg.cross(dx, dy, dim=-1)
    n2 = torch.sum(n * n, dim=-1, keepdim=True)
    n = n * torch.rsqrt(torch.clamp(n2, min=1e-24))
    out = torch.zeros_like(points)
    out[1:-1, 1:-1] = n
    return out
