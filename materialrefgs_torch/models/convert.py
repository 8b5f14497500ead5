"""Carry weights and training state across from the JAX package.

The caller hands over plain numpy arrays (`np.asarray` of each leaf of a JAX
`GaussianParams`, the `alive` mask, `active_sh_degree`, an
`EnvLightParams.base`, and for a `TrainState` the model's densification
statistics, both cubemaps and optax `ScaleByAdamState` mu/nu/count, and for a
`MeshData` its fields and per-vertex attributes); this module imports nothing
of the JAX package.
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
    arr = np.array(base, np.float32)  # a writable copy for torch
    if arr.ndim != 4 or arr.shape[0] != 6 or arr.shape[3] != 3:
        raise ValueError(f"cubemap logits must be (6, R, R, 3), got {arr.shape}")
    return EnvLightParams(torch.as_tensor(arr, device=resolve_device(device)))


def train_state_from_numpy(
    params: dict[str, np.ndarray],
    alive: np.ndarray,
    active_sh_degree: int,
    stats: dict[str, np.ndarray],
    env1: np.ndarray,
    env2: np.ndarray,
    adam_mu: dict[str, np.ndarray],
    adam_nu: dict[str, np.ndarray],
    adam_count: int,
    step: int,
    opacity_lr_scale: float = 1.0,
    max_sh_degree: int = 3,
    device: str | torch.device | None = None,
    env_gs: dict | None = None,
):
    """A JAX `TrainState` as the port's: `stats` holds xyz_gradient_accum,
    denom and max_radii2d; `adam_mu`/`adam_nu` map every parameter name of
    the model plus "env1"/"env2" to the optax moments. `env_gs`, for a state
    past the surfel2 onset, carries the JAX state's `env_gs` and
    `env_gs_opt_state`: {"params", "alive", "active_sh_degree", "stats",
    "adam_mu", "adam_nu", "adam_count"} with the model's names."""
    from materialrefgs_torch.train.trainer import TrainState
    from materialrefgs_torch.train.optim import Adam

    model = gaussian_model_from_numpy(params, alive, active_sh_degree, max_sh_degree, device)
    with torch.no_grad():
        for name in ("xyz_gradient_accum", "denom", "max_radii2d"):
            getattr(model, name).copy_(torch.as_tensor(np.array(stats[name], np.float32)))
    state = TrainState(
        model=model,
        env1=env_light_from_numpy(env1, model.device),
        env2=env_light_from_numpy(env2, model.device),
        adam=None,
        step=int(step),
        opacity_lr_scale=float(opacity_lr_scale),
    )
    adam = Adam({k: v.detach() for k, v in state.params().items()})
    for k in adam.names:
        adam.mu[k].copy_(torch.as_tensor(np.array(adam_mu[k], np.float32)))
        adam.nu[k].copy_(torch.as_tensor(np.array(adam_nu[k], np.float32)))
    adam.count = int(adam_count)
    state.adam = adam
    if env_gs is not None:
        state.env_gs = gaussian_model_from_numpy(env_gs["params"], env_gs["alive"],
                                                 env_gs["active_sh_degree"], max_sh_degree, device)
        with torch.no_grad():
            for name in ("xyz_gradient_accum", "denom", "max_radii2d"):
                getattr(state.env_gs, name).copy_(torch.as_tensor(np.array(env_gs["stats"][name], np.float32)))
        env_adam = Adam({k: v.detach() for k, v in state.env_params().items()})
        for k in env_adam.names:
            env_adam.mu[k].copy_(torch.as_tensor(np.array(env_gs["adam_mu"][k], np.float32)))
            env_adam.nu[k].copy_(torch.as_tensor(np.array(env_gs["adam_nu"][k], np.float32)))
        env_adam.count = int(env_gs["adam_count"])
        state.env_adam = env_adam
    return state


def mesh_from_numpy(arrays: dict[str, np.ndarray], attrs: dict[str, np.ndarray] | None = None,
                    device: str | torch.device | None = None):
    """A JAX `MeshData` as the port's, field for field: `arrays` maps v0,
    e1, e2, normal, valid, vertices, triangles, cluster_lo and cluster_hi to
    their arrays (padding rows included), `attrs` the per-vertex attributes."""
    from materialrefgs_torch.ops.mesh_tracer import MeshData

    dev = resolve_device(device)
    kinds = {"valid": torch.bool, "triangles": torch.int32}

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.array(a), dtype=dtype, device=dev)

    fields = {k: t(arrays[k], kinds.get(k, torch.float32))
              for k in ("v0", "e1", "e2", "normal", "valid", "vertices", "triangles", "cluster_lo", "cluster_hi")}
    return MeshData(**fields, attrs={k: t(v) for k, v in (attrs or {}).items()})
