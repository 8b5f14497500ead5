"""Dataset readers (reference scene/dataset_readers.py): Blender + COLMAP.

Returns SceneInfo with CameraInfo lists; images are decoded lazily as float32
(H, W, 3) channel-last arrays, PNG by the numpy codec (utils/png.py), JPEG by
the port's decoder (utils/jpeg.py: host entropy decode, the rest on the
card), and downscaled as Pillow's LANCZOS does (utils/resample.py). Like
Pillow, the reader tells the format from the file's first bytes.
"""
from __future__ import annotations

import json
import os
from pathlib import Path
from typing import NamedTuple

import numpy as np

from materialrefgs_torch.cameras import focal2fov, fov2focal, world_to_view
from materialrefgs_torch.data import colmap_loader as cl
from materialrefgs_torch.data import native_io
from materialrefgs_torch.utils import jpeg, png, resample
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


def _format(path: str) -> str:
    with open(path, "rb") as f:
        head = f.read(8)
    if head == b"\x89PNG\r\n\x1a\n":
        return "png"
    if head[:2] == jpeg.SOI:
        return "jpeg"
    raise NotImplementedError(
        f"{path} is neither a PNG nor a JPEG image: the port reads those two formats "
        f"({jpeg.ROADMAP_ITEM}, the JPEG decoder)"
    )


def read_image(path: str, device=None) -> np.ndarray:
    """np.asarray(Image.open(path)) with a channel axis, (H, W, C): a PNG in
    its Pillow mode on the host (utils/png.read_png: palette indices for a
    palette file, bool for 1-bit gray, uint16 for 16-bit gray), a JPEG as
    uint8 gray or RGB with its inverse DCT and colour conversion on `device`
    (default: the card)."""
    if _format(path) == "png":
        return png.read_png(path)
    arr = jpeg.decode_jpeg(path, device).cpu().numpy()
    return arr[..., None] if arr.ndim == 2 else arr


def image_size(path: str) -> tuple[int, int]:
    """(width, height) from the file's header."""
    return png.read_png_size(path) if _format(path) == "png" else jpeg.read_jpeg_size(path)


def load_image(info: CameraInfo, resolution_scale: int = 1, device=None) -> np.ndarray:
    """(H, W, 3) float32 in [0,1]; alpha composited over the background.
    As the JAX package's `Image.open(p).resize(...).convert("RGBA")`: the
    file decodes in its own mode (a JPEG partly on `device`), resolution_scale
    != 1 resizes it in that mode to (width // scale, height // scale) with
    Pillow's LANCZOS (palette and 1-bit images take NEAREST, RGBA and LA
    are resized premultiplied), and then it converts to RGBA."""
    if _format(info.image_path) == "png":
        img = png.open_png(info.image_path)
    else:
        arr = read_image(info.image_path, device)
        img = png.PngImage(arr[..., 0], "L") if arr.shape[-1] == 1 else png.PngImage(arr, "RGB")
    if resolution_scale != 1:
        size = (info.width // resolution_scale, info.height // resolution_scale)
        img = png.resize(img, size, resample.LANCZOS)
    arr = png.to_rgba(img).astype(np.float32) / 255.0
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
            W, H = image_size(cam_name)
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


def _read_extrinsics_native(path: str) -> dict:
    """images.bin through native_io, as colmap_loader's images without their
    2D points (which nothing reads)."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    ids, qvec, tvec, camid, names = native_io.read_images(path)
    return {
        int(i): cl.Image(int(i), q, t, int(c), n, np.zeros((0, 2)), np.zeros(0, np.int64))
        for i, q, t, c, n in zip(ids, qvec, tvec, camid, names)
    }


def read_colmap_scene(
    path: str, images_dir: str = "images", eval_split: bool = False, llffhold: int = 8
) -> SceneInfo:
    """readColmapSceneInfo (dataset_readers.py:199-247): SIMPLE_PINHOLE and
    PINHOLE cameras with their intrinsics K, views sorted by name, every
    llffhold-th view held out for test, the sparse points cached as
    points3D.ply beside them. images.bin and points3D.bin are parsed by
    native code (data/native_io.py), as the JAX package's native loader
    does; text models by the pure parser."""
    sparse = os.path.join(path, "sparse", "0")
    if not os.path.isdir(sparse):
        sparse = os.path.join(path, "sparse")
    try:
        extr = _read_extrinsics_native(os.path.join(sparse, "images.bin"))
        intr = cl.read_intrinsics_binary(os.path.join(sparse, "cameras.bin"))
    except FileNotFoundError:
        extr = cl.read_extrinsics_text(os.path.join(sparse, "images.txt"))
        intr = cl.read_intrinsics_text(os.path.join(sparse, "cameras.txt"))

    infos = []
    for idx, key in enumerate(sorted(extr.keys(), key=lambda k: extr[k].name)):
        ext = extr[key]
        cam = intr[ext.camera_id]
        R = np.transpose(cl.qvec2rotmat(ext.qvec))
        T = np.array(ext.tvec)
        H, W = cam.height, cam.width
        if cam.model == "SIMPLE_PINHOLE":
            f, cx, cy = cam.params[:3]
            K = np.array([[f, 0, cx], [0, f, cy], [0, 0, 1]])
            fovx = focal2fov(f, W)
            fovy = focal2fov(f, H)
        elif cam.model == "PINHOLE":
            fx, fy, cx, cy = cam.params[:4]
            K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]])
            fovx = focal2fov(fx, W)
            fovy = focal2fov(fy, H)
        else:
            raise ValueError(f"Unsupported COLMAP camera model {cam.model}; undistort first.")
        img_path = os.path.join(path, images_dir, ext.name)
        infos.append(
            CameraInfo(
                uid=idx, R=R, T=T, K=K, FovY=fovy, FovX=fovx,
                image_path=img_path, image_name=Path(ext.name).stem,
                width=W, height=H,
            )
        )

    if eval_split:
        train = [c for i, c in enumerate(infos) if i % llffhold != 0]
        test = [c for i, c in enumerate(infos) if i % llffhold == 0]
    else:
        train, test = infos, []

    norm = get_nerfpp_norm(train)
    ply_path = os.path.join(sparse, "points3D.ply")
    bin_path = os.path.join(sparse, "points3D.bin")
    if not os.path.exists(ply_path):
        if os.path.exists(bin_path):
            xyz, rgb, _ = native_io.read_points3d(bin_path)
        else:
            xyz, rgb, _ = cl.read_points3D_text(os.path.join(sparse, "points3D.txt"))
        try:
            write_point_cloud_ply(ply_path, xyz, rgb / 255.0)
        except OSError:
            pass
        pcd = BasicPointCloud(
            xyz.astype(np.float32), (rgb / 255.0).astype(np.float32), np.zeros_like(xyz, dtype=np.float32)
        )
    else:
        pts, cols, nrm = read_point_cloud_ply(ply_path)
        pcd = BasicPointCloud(pts, cols, nrm)
    return SceneInfo(pcd, train, test, norm, ply_path)


def load_scene_info(path: str, white_background=False, eval_split=False, images="images") -> SceneInfo:
    """Dataset dispatch (scene/__init__.py:46-52)."""
    if os.path.exists(os.path.join(path, "sparse")):
        return read_colmap_scene(path, images, eval_split)
    if os.path.exists(os.path.join(path, "transforms_train.json")):
        return read_blender_scene(path, white_background, eval_split)
    raise ValueError(f"Could not recognize scene type at {path}")
