"""Core transform math: quaternions, rotations, activations, color spaces.

Numerical contracts mirror the reference's utils/general_utils.py and
utils/graphics_utils.py:
  - quat_to_rotmat: utils/general_utils.py:78 (build_rotation), quaternion in
    (w, x, y, z) order, normalized first.
  - expon_lr: utils/general_utils.py:29 (get_expon_lr_func).
  - srgb <-> linear: utils/graphics_utils.py:102-119.
"""
from __future__ import annotations

import math

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


def relu0(x: torch.Tensor) -> torch.Tensor:
    """max(x, 0) with jnp.maximum's gradient: half to each side at a tie
    (torch.clamp passes all of it), so exact zeros get the JAX package's
    gradient."""
    return torch.maximum(x, x.new_zeros(()))


def abs_(x: torch.Tensor) -> torch.Tensor:
    """|x| with jnp.abs's gradient: +1 at x == 0, where torch.abs gives 0.
    It matters where both sides of a difference are exactly equal: a
    masked-out pixel, or the target that max/min picked from the pair."""
    return torch.where(x >= 0, x, -x)


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """jnp.clip(x, lo, hi): min(max(x, lo), hi) with jnp.maximum/minimum's
    gradient, half to each side at a bound (torch.clamp passes all of it)."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def expon_lr(
    step: int,
    lr_init: float,
    lr_final: float,
    lr_delay_steps: int = 0,
    lr_delay_mult: float = 1.0,
    max_steps: int = 1000000,
) -> float:
    """Log-linear lr interpolation with optional delayed warmup, evaluated in
    float32 as the JAX package does (reference get_expon_lr_func, including
    the 0-lr behavior when step < 0 or lr_init == lr_final == 0)."""
    f32 = torch.float32
    st = torch.tensor(float(step), dtype=f32)
    if lr_init == 0.0 and lr_final == 0.0:
        return 0.0
    if lr_delay_steps > 0:
        delay_rate = lr_delay_mult + (1 - lr_delay_mult) * torch.sin(
            0.5 * math.pi * torch.clamp(st / lr_delay_steps, 0, 1)
        )
    else:
        delay_rate = torch.tensor(1.0, dtype=f32)
    t = torch.clamp(st / max_steps, 0, 1)
    log_lerp = torch.exp(
        math.log(max(lr_init, 1e-32)) * (1 - t) + math.log(max(lr_final, 1e-32)) * t
    )
    return 0.0 if step < 0 else float(delay_rate * log_lerp)


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


def rotation_between_z(vec: torch.Tensor) -> torch.Tensor:
    """Rotation matrices aligning +z to `vec` (..., 3) -> (..., 3, 3)
    (reference utils/graphics_utils.py:121), with its -I fallback for
    vec ~ -z."""
    v1 = -vec[..., 1]
    v2 = vec[..., 0]
    cos_p_1 = torch.clamp(vec[..., 2] + 1, min=1e-7)
    v11, v22 = v1 * v1, v2 * v2
    v12 = v1 * v2
    R = torch.stack(
        [
            torch.stack([1 + (-v22) / cos_p_1, v12 / cos_p_1, v2], dim=-1),
            torch.stack([v12 / cos_p_1, 1 + (-v11) / cos_p_1, -v1], dim=-1),
            torch.stack([-v2, v1, 1 + (-v22 - v11) / cos_p_1], dim=-1),
        ],
        dim=-2,
    )
    neg_eye = -torch.eye(3, dtype=vec.dtype, device=vec.device)
    return torch.where((vec[..., 2] + 1 > 0)[..., None, None], R, neg_eye.expand(R.shape))
