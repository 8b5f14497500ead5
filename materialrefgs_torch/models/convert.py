"""Carry weights across from the JAX package's model state.

The caller hands over plain numpy arrays (`np.asarray` of each leaf of a JAX
`GaussianParams`, the `alive` mask, `active_sh_degree`, and an
`EnvLightParams.base`); this module imports nothing of the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from materialrefgs_torch import resolve_device
from materialrefgs_torch.models.env_light import EnvLightParams
from materialrefgs_torch.models.gaussian_model import PARAM_SHAPES, GaussianModel


def gaussian_model_from_numpy(
    params: dict[str, np.ndarray],
    alive: np.ndarray,
    active_sh_degree: int,
    max_sh_degree: int = 3,
    device: str | torch.device | None = None,
) -> GaussianModel:
    """`params` maps each GaussianParams field name (xyz, scaling, rotation,
    ..., normal2) to its (CAP, ...) array; slots keep their positions."""
    missing = set(PARAM_SHAPES) - set(params)
    if missing:
        raise KeyError(f"missing parameter arrays: {sorted(missing)}")
    return GaussianModel.from_arrays(
        params, alive, int(active_sh_degree), max_sh_degree, device
    )


def env_light_from_numpy(
    base: np.ndarray, device: str | torch.device | None = None
) -> EnvLightParams:
    """(6, R, R, 3) cubemap logits -> EnvLightParams on `device`."""
    arr = np.asarray(base, np.float32)
    if arr.ndim != 4 or arr.shape[0] != 6 or arr.shape[3] != 3:
        raise ValueError(f"cubemap logits must be (6, R, R, 3), got {arr.shape}")
    return EnvLightParams(torch.as_tensor(arr, device=resolve_device(device)))
