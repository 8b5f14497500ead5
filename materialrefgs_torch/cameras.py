"""Camera model (row-vector convention, like the reference).

Conventions (reference scene/cameras.py + utils/graphics_utils.py):
  - `world_view` is the *transposed* world-to-view matrix: x_view_row =
    x_world_row @ world_view (scene/cameras.py:75).
  - `full_proj` = world_view @ projection (both transposed), so clip_row =
    x_world_row @ full_proj; clip.w equals view-space z.
  - R passed in is the CAM-TO-WORLD rotation; T is the world-to-cam
    translation (COLMAP convention).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace

import numpy as np
import torch

from materialrefgs_torch import resolve_device

ZNEAR = 0.01
ZFAR = 100.0


def fov2focal(fov: float, pixels: int) -> float:
    return pixels / (2 * math.tan(fov / 2))


def focal2fov(focal: float, pixels: int) -> float:
    return 2 * math.atan(pixels / (2 * focal))


def world_to_view(
    R: np.ndarray,
    t: np.ndarray,
    translate: np.ndarray | None = None,
    scale: float = 1.0,
) -> np.ndarray:
    """getWorld2View2 (utils/graphics_utils.py:38): 4x4 W2V (not transposed)."""
    Rt = np.zeros((4, 4))
    Rt[:3, :3] = R.transpose()
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    if translate is not None or scale != 1.0:
        translate = np.zeros(3) if translate is None else translate
        C2W = np.linalg.inv(Rt)
        cam_center = (C2W[:3, 3] + translate) * scale
        C2W[:3, 3] = cam_center
        Rt = np.linalg.inv(C2W)
    return Rt.astype(np.float32)


def projection_matrix(znear: float, zfar: float, fovx: float, fovy: float) -> np.ndarray:
    """getProjectionMatrix (utils/graphics_utils.py:51), NOT transposed."""
    tan_y = math.tan(fovy / 2)
    tan_x = math.tan(fovx / 2)
    top, bottom = tan_y * znear, -tan_y * znear
    right, left = tan_x * znear, -tan_x * znear
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = 2 * znear / (right - left)
    P[1, 1] = 2 * znear / (top - bottom)
    P[0, 2] = (right + left) / (right - left)
    P[1, 2] = (top + bottom) / (top - bottom)
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


def projection_matrix_from_K(
    znear: float, zfar: float, H: int, W: int, K: np.ndarray
) -> np.ndarray:
    """getProjectionMatrixCorrect (utils/graphics_utils.py:74): off-center-aware."""
    top = K[1, 2] / K[1, 1] * znear
    bottom = -(H - K[1, 2]) / K[1, 1] * znear
    right = K[0, 2] / K[0, 0] * znear
    left = -(W - K[0, 2]) / K[0, 0] * znear
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = 2 * znear / (right - left)
    P[1, 1] = 2 * znear / (top - bottom)
    P[0, 2] = (right + left) / (right - left)
    P[1, 2] = (top + bottom) / (top - bottom)
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


@dataclass(frozen=True)
class Camera:
    """Camera with its matrices on one device (transposed/row-vector form).
    Intrinsics are float32-rounded Python floats."""

    world_view: torch.Tensor  # (4,4): x_view_row = x_world_row @ world_view
    full_proj: torch.Tensor  # (4,4): clip_row = x_world_row @ full_proj
    camera_center: torch.Tensor  # (3,) world-space camera position
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int
    fovx: float = 0.0
    fovy: float = 0.0
    znear: float = ZNEAR
    zfar: float = ZFAR

    @property
    def device(self) -> torch.device:
        return self.world_view.device

    def to(self, device) -> "Camera":
        return replace(
            self,
            world_view=self.world_view.to(device),
            full_proj=self.full_proj.to(device),
            camera_center=self.camera_center.to(device),
        )

    def get_rays(self, scale: float = 1.0) -> torch.Tensor:
        """Unnormalized per-pixel camera-space ray directions (H, W, 3) at
        integer pixel coords (reference scene/cameras.py:96)."""
        W, H = int(self.width / scale), int(self.height / scale)
        dev = self.device
        ix = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
        iy = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
        x = (ix - _f32(self.cx / scale)) / self.fx * scale
        y = (iy - _f32(self.cy / scale)) / self.fy * scale
        x = x.expand(H, W)
        y = y.expand(H, W)
        return torch.stack([x, y, torch.ones_like(x)], dim=-1)

    def get_K(self, scale: float = 1.0) -> torch.Tensor:
        """(3, 3) intrinsics at 1/scale resolution (cameras.py:117-125),
        in float32 arithmetic as the JAX package's."""
        f, s = np.float32, np.float32(scale)
        return torch.tensor(
            [[f(self.fx) / s, 0.0, f(self.cx) / s], [0.0, f(self.fy) / s, f(self.cy) / s], [0.0, 0.0, 1.0]],
            dtype=torch.float32, device=self.device,
        )

    def get_inv_K(self, scale: float = 1.0) -> torch.Tensor:
        """(3, 3) inverse intrinsics (cameras.py:127-135)."""
        f, s = np.float32, np.float32(scale)
        return torch.tensor(
            [[s / f(self.fx), 0.0, -f(self.cx) / f(self.fx)], [0.0, s / f(self.fy), -f(self.cy) / f(self.fy)],
             [0.0, 0.0, 1.0]],
            dtype=torch.float32, device=self.device,
        )


def _f32(v) -> float:
    return float(np.float32(v))


def make_camera(
    R: np.ndarray,
    T: np.ndarray,
    fovx: float,
    fovy: float,
    width: int,
    height: int,
    trans: np.ndarray | None = None,
    scale: float = 1.0,
    K: np.ndarray | None = None,
    znear: float = ZNEAR,
    zfar: float = ZFAR,
    device: str | torch.device | None = None,
) -> Camera:
    """Build a Camera from COLMAP-style extrinsics (reference scene/cameras.py:17)."""
    dev = resolve_device(device)
    w2v = world_to_view(R, T, trans, scale)
    wvt = w2v.T  # transposed convention
    if K is None:
        proj = projection_matrix(znear, zfar, fovx, fovy).T
        fx, fy = fov2focal(fovx, width), fov2focal(fovy, height)
        cx, cy = 0.5 * width, 0.5 * height
    else:
        proj = projection_matrix_from_K(znear, zfar, height, width, K).T
        fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    full = wvt @ proj
    cam_center = np.linalg.inv(wvt)[3, :3]

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    return Camera(
        world_view=t(wvt),
        full_proj=t(full),
        camera_center=t(cam_center),
        fx=_f32(fx),
        fy=_f32(fy),
        cx=_f32(cx),
        cy=_f32(cy),
        width=int(width),
        height=int(height),
        fovx=float(fovx),
        fovy=float(fovy),
        znear=float(znear),
        zfar=float(zfar),
    )


def make_minicam(
    width: int,
    height: int,
    fovy: float,
    fovx: float,
    world_view: np.ndarray,
    full_proj: np.ndarray,
    znear: float = ZNEAR,
    zfar: float = ZFAR,
    device: str | torch.device | None = None,
) -> Camera:
    """MiniCam (scene/cameras.py:117; the JAX package's make_minicam): a
    camera from raw transposed transform matrices (the remote-viewer
    protocol)."""
    dev = resolve_device(device)
    cam_center = np.linalg.inv(np.asarray(world_view))[3, :3]
    fx, fy = fov2focal(fovx, width), fov2focal(fovy, height)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    return Camera(
        world_view=t(world_view),
        full_proj=t(full_proj),
        camera_center=t(cam_center),
        fx=_f32(fx),
        fy=_f32(fy),
        cx=_f32(0.5 * width),
        cy=_f32(0.5 * height),
        width=int(width),
        height=int(height),
        fovx=float(fovx),
        fovy=float(fovy),
        znear=float(znear),
        zfar=float(zfar),
    )


def look_at_camera(
    eye: np.ndarray,
    target: np.ndarray,
    up: np.ndarray,
    fovx: float,
    fovy: float,
    width: int,
    height: int,
    device: str | torch.device | None = None,
) -> Camera:
    """Camera at `eye` looking at `target` (OpenCV convention: +z forward,
    +y down)."""
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd], axis=1)  # cam-to-world rotation
    T = -R.T @ eye  # world-to-cam translation
    return make_camera(R, T, fovx, fovy, width, height, device=device)


def gen_virtual_cam(
    camera: Camera,
    rng: np.random.Generator,
    trans_noise: float = 1.5,
    deg_noise: float = 30.0,
) -> Camera:
    """Noise-perturbed virtual view (utils/camera_utils.py:126
    gen_virtul_cam): three xyz Euler angles, then three translations, drawn
    from `rng` in that order."""
    from scipy.spatial.transform import Rotation

    wv = camera.world_view.cpu().numpy().T  # W2V (column convention)
    Rw2c = wv[:3, :3]
    t = wv[:3, 3]
    ang = np.deg2rad(rng.uniform(-deg_noise, deg_noise, 3))
    Rn = Rotation.from_euler("xyz", ang).as_matrix()
    tn = rng.uniform(-trans_noise, trans_noise, 3) * 0.1
    R_new = Rn @ Rw2c
    t_new = t + tn
    # make_camera takes the cam-to-world rotation.
    return make_camera(R_new.T, t_new, camera.fovx, camera.fovy, camera.width, camera.height,
                       device=camera.device)
