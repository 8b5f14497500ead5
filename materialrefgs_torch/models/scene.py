"""Scene: cameras + images + nearest-view graph (reference scene/__init__.py).

The nearest-view graph (scene/__init__.py:82-118) picks, per train camera,
the top multi_view_num neighbors by lexsort(angle, dist) filtered by
angle < max_angle and min_dis < dist < max_dis.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from materialrefgs_torch import resolve_device
from materialrefgs_torch.cameras import Camera, make_camera
from materialrefgs_torch.config import ModelParams
from materialrefgs_torch.data.readers import (
    CameraInfo,
    SceneInfo,
    load_image,
    load_scene_info,
)


def build_camera(
    info: CameraInfo, resolution_scale: int = 1, device: str | torch.device | None = None
) -> Camera:
    W = info.width // resolution_scale
    H = info.height // resolution_scale
    K = None
    if info.K is not None:
        K = info.K.copy() / resolution_scale
        K[2, 2] = 1.0
    return make_camera(info.R, info.T, info.FovX, info.FovY, W, H, K=K, device=device)


def nearest_view_graph(
    cameras: list[Camera],
    R_list: list[np.ndarray],
    multi_view_num: int = 8,
    max_angle: float = 30.0,
    min_dis: float = 0.01,
    max_dis: float = 1.5,
) -> list[list[int]]:
    """Per-camera neighbor ids (scene/__init__.py:82-118)."""
    centers = np.stack([c.camera_center.cpu().numpy() for c in cameras])
    rays = np.stack([R @ np.array([0.0, 0.0, 1.0]) for R in R_list])
    rays /= np.maximum(np.linalg.norm(rays, axis=-1, keepdims=True), 1e-12)
    diss = np.linalg.norm(centers[:, None] - centers[None], axis=-1)
    cosang = np.clip(np.sum(rays[:, None] * rays[None], axis=-1), -1, 1)
    angles = np.arccos(cosang) * 180 / 3.14159

    out = []
    for i in range(len(cameras)):
        order = np.lexsort((angles[i], diss[i]))
        mask = (
            (angles[i][order] < max_angle)
            & (diss[i][order] > min_dis)
            & (diss[i][order] < max_dis)
        )
        order = order[mask]
        out.append(list(order[: min(multi_view_num, len(order))]))
    return out


@dataclass
class Scene:
    """Loaded dataset: cameras, lazily-cached images, neighbor graph."""

    info: SceneInfo
    train_cameras: list[Camera]
    test_cameras: list[Camera]
    nearest_ids: list[list[int]]
    cameras_extent: float
    resolution_scale: int = 1
    device: torch.device | None = None  # where a JPEG photo's decode runs
    _image_cache: dict = field(default_factory=dict)

    @staticmethod
    def load(
        params: ModelParams,
        resolution_scale: int | None = None,
        device: str | torch.device | None = None,
    ) -> "Scene":
        dev = resolve_device(device)
        rs = resolution_scale or (params.resolution if params.resolution > 0 else 1)
        info = load_scene_info(
            params.source_path,
            white_background=params.white_background,
            eval_split=params.eval,
            images=params.images,
        )
        train = [build_camera(ci, rs, dev) for ci in info.train_cameras]
        test = [build_camera(ci, rs, dev) for ci in info.test_cameras]
        graph = nearest_view_graph(
            train,
            [ci.R for ci in info.train_cameras],
            params.multi_view_num,
            params.multi_view_max_angle,
            params.multi_view_min_dis,
            params.multi_view_max_dis,
        )
        return Scene(
            info=info,
            train_cameras=train,
            test_cameras=test,
            nearest_ids=graph,
            cameras_extent=info.nerf_normalization["radius"],
            resolution_scale=rs,
            device=dev,
        )

    def train_image(self, idx: int) -> np.ndarray:
        if ("train", idx) not in self._image_cache:
            self._image_cache[("train", idx)] = load_image(
                self.info.train_cameras[idx], self.resolution_scale, self.device
            )
        return self._image_cache[("train", idx)]

    def test_image(self, idx: int) -> np.ndarray:
        if ("test", idx) not in self._image_cache:
            self._image_cache[("test", idx)] = load_image(
                self.info.test_cameras[idx], self.resolution_scale, self.device
            )
        return self._image_cache[("test", idx)]
