"""Core transform math: quaternions, rotations, activations, color spaces.

Numerical contracts mirror the reference's utils/general_utils.py and
utils/graphics_utils.py:
  - quat_to_rotmat: utils/general_utils.py:78 (build_rotation), quaternion in
    (w, x, y, z) order, normalized first.
  - srgb <-> linear: utils/graphics_utils.py:102-119.
"""
from __future__ import annotations

import torch

_F32_EPS = float(torch.finfo(torch.float32).eps)


def normalize(v: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalize along `dim`, finite at zero (rsqrt of the clamped
    square-sum, so exactly-zero vectors map to zero, not NaN)."""
    n2 = torch.sum(v * v, dim=dim, keepdim=True)
    return v * torch.rsqrt(torch.clamp(n2, min=eps * eps))


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (..., 4) in (w, x, y, z) order -> rotation matrix (..., 3, 3)."""
    q = normalize(q, dim=-1)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r0 = torch.stack(
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], dim=-1
    )
    r1 = torch.stack(
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], dim=-1
    )
    r2 = torch.stack(
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], dim=-1
    )
    return torch.stack([r0, r1, r2], dim=-2)


def inverse_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x / (1 - x))


def linear_to_srgb(linear: torch.Tensor, eps: float = _F32_EPS) -> torch.Tensor:
    srgb0 = 323 / 25 * linear
    srgb1 = (211 * torch.clamp(linear, min=eps) ** (5 / 12) - 11) / 200
    return torch.where(linear <= 0.0031308, srgb0, srgb1)


def srgb_to_linear(srgb: torch.Tensor, eps: float = _F32_EPS) -> torch.Tensor:
    linear0 = 25 / 323 * srgb
    linear1 = torch.clamp((200 * srgb + 11) / 211, min=eps) ** (12 / 5)
    return torch.where(srgb <= 0.04045, linear0, linear1)


def flip_align_view(normal: torch.Tensor, viewdir: torch.Tensor):
    """Flip normals to face the viewer (utils/general_utils.py:184).
    Returns (flipped_normal, flip_mask)."""
    dotprod = torch.sum(normal * viewdir, dim=-1, keepdim=True)
    flipped = torch.where(dotprod < 0, -normal, normal)
    return flipped, dotprod < 0


def reflect(viewdir: torch.Tensor, normal: torch.Tensor) -> torch.Tensor:
    """r = 2(n.v)n - v for v pointing away from the surface."""
    dotp = torch.sum(viewdir * normal, dim=-1, keepdim=True)
    return 2 * dotp * normal - viewdir
