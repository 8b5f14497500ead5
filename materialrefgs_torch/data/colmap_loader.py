"""COLMAP binary/text model parsers (reference scene/colmap_loader.py).

Pure-numpy reader of the public COLMAP sparse-model format:
cameras.bin/images.bin/points3D.bin (+ .txt fallbacks). A copy of the JAX
package's numpy-only module (the port imports nothing of it).
"""
from __future__ import annotations

import struct
from typing import NamedTuple

import numpy as np


class CameraModel(NamedTuple):
    model_id: int
    model_name: str
    num_params: int


CAMERA_MODELS = {
    m.model_id: m
    for m in [
        CameraModel(0, "SIMPLE_PINHOLE", 3),
        CameraModel(1, "PINHOLE", 4),
        CameraModel(2, "SIMPLE_RADIAL", 4),
        CameraModel(3, "RADIAL", 5),
        CameraModel(4, "OPENCV", 8),
        CameraModel(5, "OPENCV_FISHEYE", 8),
        CameraModel(6, "FULL_OPENCV", 12),
        CameraModel(7, "FOV", 5),
        CameraModel(8, "SIMPLE_RADIAL_FISHEYE", 4),
        CameraModel(9, "RADIAL_FISHEYE", 5),
        CameraModel(10, "THIN_PRISM_FISHEYE", 12),
    ]
}
CAMERA_MODEL_NAMES = {m.model_name: m for m in CAMERA_MODELS.values()}


class Image(NamedTuple):
    id: int
    qvec: np.ndarray
    tvec: np.ndarray
    camera_id: int
    name: str
    xys: np.ndarray
    point3D_ids: np.ndarray


class Cam(NamedTuple):
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


def qvec2rotmat(qvec):
    w, x, y, z = qvec
    return np.array(
        [
            [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * w * z, 2 * x * z + 2 * w * y],
            [2 * x * y + 2 * w * z, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * w * x],
            [2 * x * z - 2 * w * y, 2 * y * z + 2 * w * x, 1 - 2 * x * x - 2 * y * y],
        ]
    )


def rotmat2qvec(R):
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = R.flat
    K = (
        np.array(
            [
                [Rxx - Ryy - Rzz, 0, 0, 0],
                [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
                [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
                [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz],
            ]
        )
        / 3.0
    )
    eigvals, eigvecs = np.linalg.eigh(K)
    qvec = eigvecs[[3, 0, 1, 2], np.argmax(eigvals)]
    if qvec[0] < 0:
        qvec *= -1
    return qvec


def _read(fid, n, fmt):
    return struct.unpack("<" + fmt, fid.read(n))


def read_extrinsics_binary(path) -> dict[int, Image]:
    images = {}
    with open(path, "rb") as f:
        num = _read(f, 8, "Q")[0]
        for _ in range(num):
            props = _read(f, 64, "idddddddi")
            image_id = props[0]
            qvec = np.array(props[1:5])
            tvec = np.array(props[5:8])
            camera_id = props[8]
            name = b""
            c = f.read(1)
            while c != b"\x00":
                name += c
                c = f.read(1)
            n_pts = _read(f, 8, "Q")[0]
            data = _read(f, 24 * n_pts, "ddq" * n_pts)
            xys = np.column_stack(
                [np.array(data[0::3]), np.array(data[1::3])]
            )
            ids = np.array(data[2::3])
            images[image_id] = Image(
                image_id, qvec, tvec, camera_id, name.decode("utf-8"), xys, ids
            )
    return images


def read_intrinsics_binary(path) -> dict[int, Cam]:
    cams = {}
    with open(path, "rb") as f:
        num = _read(f, 8, "Q")[0]
        for _ in range(num):
            props = _read(f, 24, "iiQQ")
            cam_id, model_id, w, h = props
            model = CAMERA_MODELS[model_id]
            params = np.array(_read(f, 8 * model.num_params, "d" * model.num_params))
            cams[cam_id] = Cam(cam_id, model.model_name, w, h, params)
    return cams


def read_points3D_binary(path):
    with open(path, "rb") as f:
        num = _read(f, 8, "Q")[0]
        xyzs = np.empty((num, 3))
        rgbs = np.empty((num, 3))
        errors = np.empty(num)
        for i in range(num):
            props = _read(f, 43, "QdddBBBd")
            xyzs[i] = props[1:4]
            rgbs[i] = props[4:7]
            errors[i] = props[7]
            track_len = _read(f, 8, "Q")[0]
            f.read(8 * track_len)
    return xyzs, rgbs, errors


def read_extrinsics_text(path) -> dict[int, Image]:
    images = {}
    with open(path) as f:
        while True:
            line = f.readline()
            if not line:
                break
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            e = line.split()
            image_id = int(e[0])
            qvec = np.array(tuple(map(float, e[1:5])))
            tvec = np.array(tuple(map(float, e[5:8])))
            camera_id = int(e[8])
            name = e[9]
            e2 = f.readline().split()
            xys = np.column_stack(
                [np.array(tuple(map(float, e2[0::3]))), np.array(tuple(map(float, e2[1::3])))]
            ) if e2 else np.zeros((0, 2))
            ids = np.array(tuple(map(int, e2[2::3]))) if e2 else np.zeros(0, int)
            images[image_id] = Image(image_id, qvec, tvec, camera_id, name, xys, ids)
    return images


def read_intrinsics_text(path) -> dict[int, Cam]:
    cams = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            e = line.split()
            cams[int(e[0])] = Cam(
                int(e[0]), e[1], int(e[2]), int(e[3]), np.array(tuple(map(float, e[4:])))
            )
    return cams


def read_points3D_text(path):
    xyzs, rgbs, errors = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            e = line.split()
            xyzs.append(tuple(map(float, e[1:4])))
            rgbs.append(tuple(map(float, e[4:7])))
            errors.append(float(e[7]))
    return np.array(xyzs), np.array(rgbs), np.array(errors)
