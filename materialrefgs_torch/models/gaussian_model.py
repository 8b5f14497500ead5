"""Gaussian surfel parameter store (reference scene/gaussian_model.py).

Fixed-capacity design with an `alive` mask, slot for slot the same as the JAX
package's model: every per-gaussian tensor is (CAP, ...), dead slots have
alive=False (and raw opacity -15) so the rasterizer culls them. Raw
parameters are `nn.Parameter`s; `alive`, `active_sh_degree` and the
densification statistics are buffers. Densify/prune come with the training
slice of the port.

Activations (gaussian_model.py:47-77): exp scaling, sigmoid for opacity /
refl (metallic) / metalness (EnvGS blend) / roughness / colors, normalized
quaternions.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from materialrefgs_torch import resolve_device
from materialrefgs_torch.utils import sh as sh_utils
from materialrefgs_torch.utils.transforms import quat_to_rotmat

# Raw parameter names and their trailing shapes; K = (max_sh_degree + 1)^2.
PARAM_SHAPES = {
    "xyz": lambda K: (3,),
    "scaling": lambda K: (2,),
    "rotation": lambda K: (4,),
    "opacity": lambda K: (1,),
    "refl_strength": lambda K: (1,),
    "metalness": lambda K: (1,),
    "roughness": lambda K: (1,),
    "ori_color": lambda K: (3,),
    "diffuse_color": lambda K: (3,),
    "features_dc": lambda K: (1, 3),
    "features_rest": lambda K: (K - 1, 3),
    "indirect_dc": lambda K: (1, 3),
    "indirect_rest": lambda K: (K - 1, 3),
    "indirect_asg": lambda K: (32, 5),
    "normal1": lambda K: (3,),
    "normal2": lambda K: (3,),
}


class GaussianModel(nn.Module):
    """Raw (pre-activation) per-gaussian parameters, leading dim CAP."""

    xyz: nn.Parameter
    scaling: nn.Parameter
    rotation: nn.Parameter
    opacity: nn.Parameter
    refl_strength: nn.Parameter
    metalness: nn.Parameter
    roughness: nn.Parameter
    ori_color: nn.Parameter
    diffuse_color: nn.Parameter
    features_dc: nn.Parameter
    features_rest: nn.Parameter
    indirect_dc: nn.Parameter
    indirect_rest: nn.Parameter
    indirect_asg: nn.Parameter
    normal1: nn.Parameter
    normal2: nn.Parameter

    def __init__(
        self,
        capacity: int,
        max_sh_degree: int = 3,
        device: str | torch.device | None = None,
    ):
        super().__init__()
        dev = resolve_device(device)
        self.capacity = int(capacity)
        self.max_sh_degree = int(max_sh_degree)
        K = (max_sh_degree + 1) ** 2
        for name, shape in PARAM_SHAPES.items():
            t = torch.zeros((self.capacity,) + shape(K), dtype=torch.float32, device=dev)
            self.register_parameter(name, nn.Parameter(t))
        with torch.no_grad():
            self.scaling.fill_(-10.0)
            self.opacity.fill_(-15.0)
            self.rotation[:, 0] = 1.0
        self.register_buffer("alive", torch.zeros(self.capacity, dtype=torch.bool, device=dev))
        self.register_buffer("active_sh_degree", torch.zeros((), dtype=torch.int32, device=dev))
        for name in ("max_radii2d", "xyz_gradient_accum", "denom"):
            self.register_buffer(name, torch.zeros(self.capacity, dtype=torch.float32, device=dev))

    @classmethod
    def from_arrays(
        cls,
        arrays: dict[str, np.ndarray],
        alive: np.ndarray,
        active_sh_degree: int,
        max_sh_degree: int = 3,
        device: str | torch.device | None = None,
    ) -> "GaussianModel":
        """Model whose raw parameters are the given (CAP, ...) arrays, one per
        name of PARAM_SHAPES."""
        alive = np.array(alive, bool)  # writable copies for torch.from_numpy
        model = cls(alive.shape[0], max_sh_degree, device)
        K = (max_sh_degree + 1) ** 2
        with torch.no_grad():
            for name, shape in PARAM_SHAPES.items():
                a = np.array(arrays[name], np.float32)
                want = (model.capacity,) + shape(K)
                if a.shape != want:
                    raise ValueError(f"{name}: shape {a.shape}, expected {want}")
                getattr(model, name).copy_(torch.from_numpy(a))
            model.alive.copy_(torch.from_numpy(alive))
            model.active_sh_degree.fill_(int(active_sh_degree))
        return model

    @property
    def device(self) -> torch.device:
        return self.xyz.device

    # ---------- activations ----------
    @property
    def get_xyz(self):
        return self.xyz

    @property
    def get_scaling(self):
        return torch.exp(self.scaling)

    @property
    def get_rotation(self):
        q = self.rotation
        return q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=1e-12)

    @property
    def get_opacity(self):
        return torch.sigmoid(self.opacity) * self.alive[:, None]

    @property
    def get_refl(self):
        return torch.sigmoid(self.refl_strength)

    @property
    def get_specular(self):
        """EnvGS blend weight (reference get_specular, gaussian_model.py:310)."""
        return torch.sigmoid(self.metalness)

    @property
    def get_rough(self):
        return torch.sigmoid(self.roughness)

    @property
    def get_ori_color(self):
        return torch.sigmoid(self.ori_color)

    @property
    def get_diffuse_color(self):
        return torch.sigmoid(self.diffuse_color)

    @property
    def n_alive(self):
        return torch.sum(self.alive.to(torch.int32))

    def get_features(self):
        """(CAP, K, 3) SH coefficients with inactive degree bands zeroed."""
        feats = torch.cat([self.features_dc, self.features_rest], dim=1)
        return self._mask_sh(feats)

    def get_indirect(self):
        # Indirect SH always evaluates at full degree.
        return torch.cat([self.indirect_dc, self.indirect_rest], dim=1)

    def _mask_sh(self, feats):
        K = feats.shape[1]
        band = torch.floor(torch.sqrt(torch.arange(K, dtype=torch.float32))).to(torch.int32)
        mask = (band.to(feats.device) <= self.active_sh_degree).to(feats.dtype)
        return feats * mask[None, :, None]

    def get_colors(self, campos: torch.Tensor) -> torch.Tensor:
        """SH -> clamped RGB toward the camera (forward.cu computeColorFromSH)."""
        dirs = self.xyz - campos[None, :]
        feats = self.get_features().transpose(1, 2)  # (CAP, 3, K)
        return sh_utils.sh_to_rgb(self.max_sh_degree, feats, dirs)

    def get_world_normal(self) -> torch.Tensor:
        """Splat normal in world space (3rd column of R)."""
        R = quat_to_rotmat(self.get_rotation)
        return R[..., :, 2]
