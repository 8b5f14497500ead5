"""Reflection-score mining (the JAX package's train/ref_score.py; reference
train_refnerf.py:747-1010, under no_grad).

For each train view, with the rendered depth, normal and distance maps of
every train view cached: a wide neighbour set (20 neighbours, 5 deg < angle <
90 deg, 0.1 < dist < 1.5), then for each neighbour a depth-reprojection
occlusion test and a homography patch warp of the neighbour's RGB; a pixel
scores the mean absolute colour difference across the neighbours that see
it: "looks different across views => reflective". The scores drive the
ref-score material supervision (train_refreal.py:1237-1263).
"""
from __future__ import annotations

import numpy as np
import torch

from materialrefgs_torch.cameras import Camera
from materialrefgs_torch.train import warp


def neighbor_graph_wide(
    cameras: list[Camera],
    R_list: list[np.ndarray],
    num: int = 20,
    min_angle: float = 5.0,
    max_angle: float = 90.0,
    min_dis: float = 0.1,
    max_dis: float = 1.5,
) -> list[list[int]]:
    """get_multi_view_neighbor (train_refnerf.py:747-788)."""
    centers = np.stack([c.camera_center.cpu().numpy() for c in cameras])
    rays = np.stack([R @ np.array([0.0, 0.0, 1.0]) for R in R_list])
    rays /= np.maximum(np.linalg.norm(rays, axis=-1, keepdims=True), 1e-12)
    diss = np.linalg.norm(centers[:, None] - centers[None], axis=-1)
    ang = np.arccos(np.clip(np.sum(rays[:, None] * rays[None], -1), -1, 1)) * 180 / 3.14159
    out = []
    for i in range(len(cameras)):
        order = np.lexsort((ang[i], diss[i]))
        m = (
            (ang[i][order] < max_angle)
            & (ang[i][order] > min_angle)
            & (diss[i][order] > min_dis)
            & (diss[i][order] < max_dis)
        )
        out.append([int(j) for j in order[m][:num]])
    return out


def _patch_coords(H: int, W: int, patch_size: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(H*W, 2) pixels and their (H*W, P, 2) patches in pixel coordinates."""
    pixels = warp.pixel_grid(H, W, device)
    return pixels, pixels[:, None, :] + warp.patch_offsets(patch_size, device)


@torch.no_grad()
def _neighbor_warp(
    camera: Camera,
    nearest_camera: Camera,
    ref_depth: torch.Tensor,  # (H, W)
    ref_normal: torch.Tensor,  # (H, W, 3) world
    ref_distance: torch.Tensor,  # (H, W)
    nearest_depth: torch.Tensor,  # (H, W)
    nearest_rgb: torch.Tensor,  # (H, W, 3)
    pixel_noise_th: float,
    patch_size: int = 4,
):
    """One neighbour: the occlusion-tested homography warp of its RGB into
    the reference view. Returns (d_mask (HW,), warped_rgb (HW, P, 3))."""
    H, W = camera.height, camera.width
    total_patch = (2 * patch_size + 1) ** 2
    pixels, patches = _patch_coords(H, W, patch_size, ref_depth.device)
    noise, d_mask = warp.reprojection(camera, nearest_camera, ref_depth, nearest_depth, pixels, eps=0.0)
    d_mask = d_mask & (noise < pixel_noise_th)
    Hmat = warp.plane_homography(camera, nearest_camera, ref_normal.reshape(-1, 3), ref_distance.reshape(-1))
    grid = warp.norm_coords(warp.patch_warp(Hmat, patches), H, W)
    rgb = warp.grid_sample(nearest_rgb, grid.reshape(-1, 2)).reshape(-1, total_patch, 3)
    return d_mask, torch.where(d_mask[:, None, None], rgb, torch.zeros_like(rgb))


@torch.no_grad()
def compute_ref_scores(
    cameras: list[Camera],
    images: list[torch.Tensor],  # (H, W, 3)
    depth_maps: list[torch.Tensor],  # (H, W) surf_depth per view
    normal_maps: list[torch.Tensor],  # (H, W, 3) rend_normal per view
    distance_maps: list[torch.Tensor],  # (H, W) rend_distance per view
    neighbor_ids: list[list[int]],
    pixel_noise_th: float = 1.0,
    patch_size: int = 4,
) -> list[np.ndarray]:
    """A per-view (H, W) reflection-score map: the mean absolute difference
    across the occlusion-valid warped neighbours (train_refnerf.py:970-983).
    Neighbours are accumulated one at a time: at 800x800 one neighbour's
    warped patches are 640,000 x 81 x 3 floats (622 MB)."""
    scores = []
    for i, cam in enumerate(cameras):
        H, W = cam.height, cam.width
        total_patch = (2 * patch_size + 1) ** 2
        # Anchor patches from the reference image itself.
        _, patches = _patch_coords(H, W, patch_size, images[i].device)
        anchored = warp.grid_sample(images[i], warp.norm_coords(patches, H, W).reshape(-1, 2)).reshape(
            -1, total_patch, 3)
        del patches
        diff_sum = torch.zeros_like(anchored)
        mask_sum = torch.zeros((H * W,), dtype=torch.float32, device=anchored.device)
        for j in neighbor_ids[i]:
            d_mask, rgb = _neighbor_warp(cam, cameras[j], depth_maps[i], normal_maps[i], distance_maps[i],
                                         depth_maps[j], images[j], pixel_noise_th, patch_size)
            diff = torch.abs(rgb - anchored).masked_fill_(~d_mask[:, None, None], 0.0)
            diff_sum += diff
            mask_sum += d_mask.to(torch.float32)
            del rgb, diff
        val_mean = diff_sum / (mask_sum[:, None, None] + 1e-8)
        score = torch.where(mask_sum > 0, torch.mean(torch.sum(val_mean, -1), -1), torch.zeros_like(mask_sum))
        scores.append(score.reshape(H, W).cpu().numpy())
    return scores
