"""Anisotropic spherical gaussian (ASG) indirect-light lobes
(materialrefgs_tpu/utils/asg.py; reference init_predefined_omega,
utils/graphics_utils.py:196-229, and the ASG evaluation inlined in
render_surfel, gaussian_renderer/__init__.py:318-338).

The activations keep the JAX package's gradients: softplus is
logaddexp(x, 0) (torch's softplus turns into the identity above 20), relu
gives 0 at 0, and the final max(., 0) splits its gradient at a tie
(utils/transforms.relu0).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from materialrefgs_torch.utils.transforms import relu0, rotation_between_z


@functools.lru_cache(maxsize=4)
def init_predefined_omega(n_theta: int = 4, n_phi: int = 8):
    """(omega, omega_lambda, omega_mu) as float32 numpy, each
    (n_theta * n_phi, 3)."""
    theta = np.arange(n_theta) * 0.5 * np.pi / n_theta + 0.5 * np.pi / (2 * n_theta)
    phi = np.arange(n_phi) * 2 * np.pi / n_phi + 2 * np.pi / (2 * n_phi)
    th, ph = np.meshgrid(theta, phi, indexing="ij")
    th, ph = th.reshape(-1), ph.reshape(-1)

    def sph(t, p):
        return np.stack([np.cos(p) * np.sin(t), np.sin(p) * np.sin(t), np.cos(t)], axis=-1)

    omega = sph(th, ph)
    omega_la = sph(th + np.pi / 2, ph)
    # omega_la rotated by pi/2 about omega (they are orthogonal): the cross.
    omega_mu = np.cross(omega, omega_la)
    return omega.astype(np.float32), omega_la.astype(np.float32), omega_mu.astype(np.float32)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros_like(x))


def eval_asg_indirect(
    asg: torch.Tensor,  # (P, 32, 5) raw params [ep(3), la(1), mu(1)]
    normals: torch.Tensor,  # (P, 3) world, flipped toward the viewer
    reflection: torch.Tensor,  # (P, 3) reflected view directions, world
) -> torch.Tensor:
    """The ASG indirect light per gaussian, (P, 3) >= 0."""
    omega, omega_la, omega_mu = (torch.as_tensor(a, device=asg.device) for a in init_predefined_omega(4, 8))
    rot = rotation_between_z(normals).transpose(-1, -2)  # (P, 3, 3)
    refl_local = torch.einsum("pij,pj->pi", rot, reflection)

    ep, la, mu = asg[..., :3], asg[..., 3:4], asg[..., 4:5]
    smooth = torch.relu(torch.sum(refl_local[:, None, :] * omega[None], dim=-1, keepdim=True))
    ep = torch.exp(ep - 3.0)
    la = _softplus(la - 1.0)
    mu = _softplus(mu - 1.0)
    dla = torch.sum(omega_la[None] * refl_local[:, None, :], dim=-1, keepdim=True)
    dmu = torch.sum(omega_mu[None] * refl_local[:, None, :], dim=-1, keepdim=True)
    out = ep * smooth * torch.exp(-la * dla**2 - mu * dmu**2)
    return relu0(out.sum(dim=1))
