"""Fly-through camera paths (reference utils/video_utils.py extend_cameras +
utils/render_utils.py generate_path/generate_ellipse_path).

numpy poses, cameras on the input cameras' device: the paths that
scripts/render_video_torch.py renders to a PNG frame sequence (the reference
pipes frames through mediapy; no video encoder is assumed here). The JAX
package's utils/video.py, ported.
"""
from __future__ import annotations

import numpy as np

from materialrefgs_torch.cameras import Camera


def _quat_from_R(R: np.ndarray) -> np.ndarray:
    # Branch-on-largest-diagonal (Shepperd's method): the naive trace form
    # divides by 4*qw, which vanishes for near-180-degree rotations and
    # corrupts interpolated poses between opposing views.
    t = R[0, 0] + R[1, 1] + R[2, 2]
    if t > 0:
        s = np.sqrt(t + 1.0) * 2.0
        q = [s / 4, (R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s,
             (R[1, 0] - R[0, 1]) / s]
    elif R[0, 0] >= R[1, 1] and R[0, 0] >= R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2.0
        q = [(R[2, 1] - R[1, 2]) / s, s / 4, (R[0, 1] + R[1, 0]) / s,
             (R[0, 2] + R[2, 0]) / s]
    elif R[1, 1] >= R[2, 2]:
        s = np.sqrt(1.0 - R[0, 0] + R[1, 1] - R[2, 2]) * 2.0
        q = [(R[0, 2] - R[2, 0]) / s, (R[0, 1] + R[1, 0]) / s, s / 4,
             (R[1, 2] + R[2, 1]) / s]
    else:
        s = np.sqrt(1.0 - R[0, 0] - R[1, 1] + R[2, 2]) * 2.0
        q = [(R[1, 0] - R[0, 1]) / s, (R[0, 2] + R[2, 0]) / s,
             (R[1, 2] + R[2, 1]) / s, s / 4]
    return np.array(q)


def _R_from_quat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q / np.linalg.norm(q)
    return np.array(
        [
            [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * z * w, 2 * x * z + 2 * y * w],
            [2 * x * y + 2 * z * w, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * x * w],
            [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w, 1 - 2 * x * x - 2 * y * y],
        ]
    )


def _cam_R_T(camera: Camera):
    """Extract the reference's (R, T) convention from world_view (W2V^T):
    world_view[:3,:3] = R (cam-to-world rotation, stored transposed) and
    world_view[3,:3] = T."""
    wv = camera.world_view.detach().cpu().numpy().astype(np.float32)
    return wv[:3, :3], wv[3, :3]


def _with_pose(camera: Camera, R: np.ndarray, T: np.ndarray) -> Camera:
    """New pose, same intrinsics. R is the reference's cam-to-world rotation
    (== world_view[:3,:3] under the transposed convention), T the W2V
    translation row."""
    from materialrefgs_torch.cameras import make_camera

    return make_camera(
        R=np.asarray(R, np.float64),
        T=np.asarray(T, np.float64),
        fovx=float(camera.fovx), fovy=float(camera.fovy),
        width=int(camera.width), height=int(camera.height),
        znear=float(camera.znear), zfar=float(camera.zfar), device=camera.device,
    )


def interpolate_cameras(cameras: list[Camera], num: int = 6) -> list[Camera]:
    """extend_cameras (video_utils.py:28-59): insert `num-1` interpolated
    views between consecutive cameras — linear T, nlerp'd quaternion R
    (the reference lerps quaternion components then renormalizes via the
    rotation reconstruction)."""
    out: list[Camera] = []
    for cam0, cam1 in zip(cameras[:-1], cameras[1:]):
        R0, T0 = _cam_R_T(cam0)
        R1, T1 = _cam_R_T(cam1)
        q0, q1 = _quat_from_R(R0), _quat_from_R(R1)
        if np.dot(q0, q1) < 0:
            q1 = -q1  # short arc
        for j in range(1, num):
            t = j / num
            T = T0 + (T1 - T0) * t
            R = _R_from_quat(q0 + (q1 - q0) * t)
            out.append(_with_pose(cam0, R, T))
    out.append(cameras[-1])
    return out


def _viewmatrix(lookdir, up, position):
    z = lookdir / np.linalg.norm(lookdir)
    x = np.cross(up, z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    return np.stack([x, y, z, position], axis=1)  # (3, 4) c2w


def generate_ellipse_path(
    cameras: list[Camera], n_frames: int = 480, z_variation: float = 0.0
) -> list[Camera]:
    """generate_path (render_utils.py:121-195): an ellipse through the
    camera ring, looking at the scene focus point, PCA-aligned."""
    Rs, centers, dirs = [], [], []
    for cam in cameras:
        R, _ = _cam_R_T(cam)
        Rs.append(R)
        centers.append(cam.camera_center.detach().cpu().numpy().astype(np.float64))
        dirs.append(R[:, 2])  # optical axis in world
    centers = np.stack(centers)
    dirs = np.stack(dirs)

    mean = centers.mean(axis=0)
    X = centers - mean
    _, _, vt = np.linalg.svd(X, full_matrices=False)
    basis = vt  # rows: principal axes (up = least-variance axis)
    pts = X @ basis.T
    radii = np.percentile(np.abs(pts), 90, axis=0)
    radii[2] = max(radii[2], 1e-6)

    # Focus point (render_utils.py focus_point_fn): least-squares closest
    # point to all optical axes.
    A = np.zeros((3, 3))
    b = np.zeros(3)
    for o, d in zip(centers, dirs):
        M = np.eye(3) - np.outer(d, d)
        A += M
        b += M @ o
    focus = np.linalg.lstsq(A, b, rcond=None)[0]

    frames = []
    up_w = basis[2] if basis[2, 1] >= 0 else -basis[2]
    for theta in np.linspace(0, 2 * np.pi, n_frames, endpoint=False):
        offset = (
            radii[0] * np.cos(theta) * basis[0]
            + radii[1] * np.sin(theta) * basis[1]
            + z_variation * radii[2] * np.sin(2 * theta) * basis[2]
        )
        pos = mean + offset
        look = focus - pos
        c2w = _viewmatrix(look, up_w, pos)
        R = c2w[:, :3]  # columns x,y,z = cam axes in world = R (c2w)
        T = -pos @ R  # row-vector W2V translation
        frames.append(_with_pose(cameras[0], R, T))
    return frames
