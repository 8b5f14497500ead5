"""Real spherical harmonics evaluation (degrees 0..4).

Constants and basis ordering mirror the reference utils/sh_utils.py (and the
CUDA computeColorFromSH, forward.cu:24-73).
"""
from __future__ import annotations

import torch

from materialrefgs_torch.utils.transforms import relu0

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)
C4 = (
    2.5033429417967046,
    -1.7701307697799304,
    0.9461746957575601,
    -0.6690465435572892,
    0.10578554691520431,
    -0.6690465435572892,
    0.47308734787878004,
    -1.7701307697799304,
    0.6258357354491761,
)


def eval_sh(deg: int, sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """sh: (..., C, (deg+1)**2) coefficients; dirs: (..., 3) unit directions.
    Returns (..., C)."""
    if not 0 <= deg <= 4 or sh.shape[-1] < (deg + 1) ** 2:
        raise ValueError(f"SH degree {deg} needs {(deg + 1) ** 2} coefficients")

    result = C0 * sh[..., 0]
    if deg > 0:
        x, y, z = dirs[..., 0:1], dirs[..., 1:2], dirs[..., 2:3]
        result = result - C1 * y * sh[..., 1] + C1 * z * sh[..., 2] - C1 * x * sh[..., 3]
        if deg > 1:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            result = (
                result
                + C2[0] * xy * sh[..., 4]
                + C2[1] * yz * sh[..., 5]
                + C2[2] * (2.0 * zz - xx - yy) * sh[..., 6]
                + C2[3] * xz * sh[..., 7]
                + C2[4] * (xx - yy) * sh[..., 8]
            )
            if deg > 2:
                result = (
                    result
                    + C3[0] * y * (3 * xx - yy) * sh[..., 9]
                    + C3[1] * xy * z * sh[..., 10]
                    + C3[2] * y * (4 * zz - xx - yy) * sh[..., 11]
                    + C3[3] * z * (2 * zz - 3 * xx - 3 * yy) * sh[..., 12]
                    + C3[4] * x * (4 * zz - xx - yy) * sh[..., 13]
                    + C3[5] * z * (xx - yy) * sh[..., 14]
                    + C3[6] * x * (xx - 3 * yy) * sh[..., 15]
                )
                if deg > 3:
                    result = (
                        result
                        + C4[0] * xy * (xx - yy) * sh[..., 16]
                        + C4[1] * yz * (3 * xx - yy) * sh[..., 17]
                        + C4[2] * xy * (7 * zz - 1) * sh[..., 18]
                        + C4[3] * yz * (7 * zz - 3) * sh[..., 19]
                        + C4[4] * (zz * (35 * zz - 30) + 3) * sh[..., 20]
                        + C4[5] * xz * (7 * zz - 3) * sh[..., 21]
                        + C4[6] * (xx - yy) * (7 * zz - 1) * sh[..., 22]
                        + C4[7] * xz * (xx - 3 * yy) * sh[..., 23]
                        + C4[8]
                        * (xx * (xx - 3 * yy) - yy * (3 * xx - yy))
                        * sh[..., 24]
                    )
    return result


def sh_basis(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor, n_sh: int) -> list:
    """Real SH basis values on unit-direction components, in eval_sh's
    ordering: a list of n_sh tensors shaped like x (n_sh in 1, 4, 9, 16).
    The bundle tracer evaluates each ray's color with these; its CUDA kernel
    repeats the expressions operation for operation."""
    if n_sh not in (1, 4, 9, 16):
        raise ValueError(f"n_sh must be 1, 4, 9 or 16, got {n_sh}")
    Y = [torch.full_like(x, C0)]
    if n_sh >= 4:
        Y += [-C1 * y, C1 * z, -C1 * x]
    if n_sh >= 9:
        xx, yy, zz = x * x, y * y, z * z
        Y += [
            C2[0] * x * y,
            C2[1] * y * z,
            C2[2] * (2.0 * zz - xx - yy),
            C2[3] * x * z,
            C2[4] * (xx - yy),
        ]
    if n_sh >= 16:
        Y += [
            C3[0] * y * (3.0 * xx - yy),
            C3[1] * x * y * z,
            C3[2] * y * (4.0 * zz - xx - yy),
            C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            C3[4] * x * (4.0 * zz - xx - yy),
            C3[5] * z * (xx - yy),
            C3[6] * x * (xx - 3.0 * yy),
        ]
    return Y


def sh_basis_grad(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor, n_sh: int) -> list:
    """The analytic Jacobian of sh_basis with respect to the unit direction
    (materialrefgs_tpu/ops/tracer/pallas_kernels.py:128-157): a list of n_sh
    (d/dx, d/dy, d/dz) triples of tensors shaped like x. The tracer's
    backward chains the ray-direction gradient through it; its CUDA kernel
    repeats the expressions operation for operation."""
    if n_sh not in (1, 4, 9, 16):
        raise ValueError(f"n_sh must be 1, 4, 9 or 16, got {n_sh}")
    zero = torch.zeros_like(x)
    one = torch.ones_like(x)
    G = [(zero, zero, zero)]
    if n_sh >= 4:
        G += [(zero, -C1 * one, zero), (zero, zero, C1 * one), (-C1 * one, zero, zero)]
    if n_sh >= 9:
        xx, yy, zz = x * x, y * y, z * z
        G += [
            (C2[0] * y, C2[0] * x, zero),
            (zero, C2[1] * z, C2[1] * y),
            (-2.0 * C2[2] * x, -2.0 * C2[2] * y, 4.0 * C2[2] * z),
            (C2[3] * z, zero, C2[3] * x),
            (2.0 * C2[4] * x, -2.0 * C2[4] * y, zero),
        ]
    if n_sh >= 16:
        G += [
            (6.0 * C3[0] * x * y, C3[0] * (3.0 * xx - 3.0 * yy), zero),
            (C3[1] * y * z, C3[1] * x * z, C3[1] * x * y),
            (-2.0 * C3[2] * x * y, C3[2] * (4.0 * zz - xx - 3.0 * yy), 8.0 * C3[2] * y * z),
            (-6.0 * C3[3] * x * z, -6.0 * C3[3] * y * z, C3[3] * (6.0 * zz - 3.0 * xx - 3.0 * yy)),
            (C3[4] * (4.0 * zz - 3.0 * xx - yy), -2.0 * C3[4] * x * y, 8.0 * C3[4] * x * z),
            (2.0 * C3[5] * x * z, -2.0 * C3[5] * y * z, C3[5] * (xx - yy)),
            (C3[6] * (3.0 * xx - 3.0 * yy), -6.0 * C3[6] * x * y, zero),
        ]
    return G


def sh_to_rgb(deg: int, sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """SH -> clamped RGB as the rasterizer does: +0.5 then clamp to >= 0.
    sh: (..., 3, K), dirs: (..., 3) (need not be normalized)."""
    d = dirs / torch.clamp(torch.linalg.vector_norm(dirs, dim=-1, keepdim=True), min=1e-12)
    return relu0(eval_sh(deg, sh, d) + 0.5)


def rgb_to_sh(rgb: torch.Tensor) -> torch.Tensor:
    """Inverse of the DC term mapping: (rgb - 0.5) / C0."""
    return (rgb - 0.5) / C0
