"""Dataset readers (reference scene/dataset_readers.py), Blender layout.

Returns SceneInfo with CameraInfo lists; images are decoded lazily as float32
(H, W, 3) channel-last arrays by the numpy PNG codec (utils/png.py).
"""
from __future__ import annotations

import json
import os
from pathlib import Path
from typing import NamedTuple

import numpy as np

from materialrefgs_torch.cameras import focal2fov, fov2focal, world_to_view
from materialrefgs_torch.utils import png
from materialrefgs_torch.utils.ply import read_point_cloud_ply, write_point_cloud_ply


class BasicPointCloud(NamedTuple):
    points: np.ndarray
    colors: np.ndarray
    normals: np.ndarray


class CameraInfo(NamedTuple):
    uid: int
    R: np.ndarray  # cam-to-world rotation (stored transposed like reference)
    T: np.ndarray  # world-to-cam translation
    K: np.ndarray | None
    FovY: float
    FovX: float
    image_path: str
    image_name: str
    width: int
    height: int
    white_background: bool = False


class SceneInfo(NamedTuple):
    point_cloud: BasicPointCloud
    train_cameras: list
    test_cameras: list
    nerf_normalization: dict
    ply_path: str


def load_image(info: CameraInfo, resolution_scale: int = 1) -> np.ndarray:
    """(H, W, 3) float32 in [0,1]; alpha composited over the background."""
    if resolution_scale != 1:
        raise NotImplementedError(
            "downscaled image loading (resolution_scale != 1) needs a "
            "resampler and comes with the COLMAP/refreal slice"
        )
    arr = png.read_png(info.image_path).astype(np.float32) / 255.0
    if arr.shape[-1] == 1:  # gray -> RGB, opaque
        arr = np.repeat(arr, 3, axis=-1)
    if arr.shape[-1] == 3:
        return arr
    bg = 1.0 if info.white_background else 0.0
    return arr[..., :3] * arr[..., 3:4] + bg * (1 - arr[..., 3:4])


def get_nerfpp_norm(cam_infos) -> dict:
    centers = []
    for cam in cam_infos:
        W2C = world_to_view(cam.R, cam.T)
        centers.append(np.linalg.inv(W2C)[:3, 3])
    centers = np.stack(centers)
    center = centers.mean(axis=0)
    diagonal = np.max(np.linalg.norm(centers - center, axis=-1))
    return {"translate": -center, "radius": diagonal * 1.1}


def read_blender_scene(
    path: str, white_background: bool, eval_split: bool, extension: str = ".png"
) -> SceneInfo:
    """readNerfSyntheticInfo (dataset_readers.py:249-330)."""

    def read_transforms(fname):
        infos = []
        with open(os.path.join(path, fname)) as f:
            contents = json.load(f)
        fovx = contents["camera_angle_x"]
        for idx, frame in enumerate(contents["frames"]):
            cam_name = os.path.join(path, frame["file_path"] + extension)
            c2w = np.array(frame["transform_matrix"])
            c2w[:3, 1:3] *= -1  # OpenGL/Blender -> COLMAP axes
            w2c = np.linalg.inv(c2w)
            R = np.transpose(w2c[:3, :3])
            T = w2c[:3, 3]
            W, H = png.read_png_size(cam_name)
            fovy = focal2fov(fov2focal(fovx, W), H)
            infos.append(
                CameraInfo(
                    uid=idx, R=R, T=T, K=None, FovY=fovy, FovX=fovx,
                    image_path=cam_name, image_name=Path(cam_name).stem,
                    width=W, height=H, white_background=white_background,
                )
            )
        return infos

    train = read_transforms("transforms_train.json")
    test_file = os.path.join(path, "transforms_test.json")
    test = read_transforms("transforms_test.json") if os.path.exists(test_file) else []
    if not eval_split:
        train = train + test
        test = []

    norm = get_nerfpp_norm(train)
    ply_path = os.path.join(path, "points3d.ply")
    if not os.path.exists(ply_path):
        rng = np.random.default_rng(0)
        num_pts = 100_000
        xyz = rng.random((num_pts, 3)) * 2.6 - 1.3
        shs = rng.random((num_pts, 3)) / 255.0
        colors = shs * 0.28209479177387814 + 0.5
        try:
            write_point_cloud_ply(ply_path, xyz, colors)
        except OSError:
            pass
        pcd = BasicPointCloud(
            xyz.astype(np.float32), colors.astype(np.float32),
            np.zeros_like(xyz, dtype=np.float32),
        )
    else:
        pts, cols, nrm = read_point_cloud_ply(ply_path)
        pcd = BasicPointCloud(pts, cols, nrm)
    return SceneInfo(pcd, train, test, norm, ply_path)


def load_scene_info(path: str, white_background=False, eval_split=False, images="images") -> SceneInfo:
    """Dataset dispatch (scene/__init__.py:46-52)."""
    if os.path.exists(os.path.join(path, "sparse")):
        raise NotImplementedError(
            "COLMAP scenes are not ported yet; they come with the refreal "
            "(COLMAP) slice of the port"
        )
    if os.path.exists(os.path.join(path, "transforms_train.json")):
        return read_blender_scene(path, white_background, eval_split)
    raise ValueError(f"Could not recognize scene type at {path}")
