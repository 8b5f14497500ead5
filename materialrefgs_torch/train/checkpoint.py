"""Training checkpoint save/restore (reference capture/restore,
gaussian_model.py:124-177, and torch.save((capture(), iteration)) at
train_refnerf.py:1482-1484).

One `torch.save` file per checkpoint, `chkpnt{iteration}.pt` under the run
directory: the model's raw parameters and buffers (alive mask, SH degree,
densification statistics), both cubemaps, the Adam moments and their shared
step count, the optimizer-step clock, the opacity-LR toggle and the
iteration; past the surfel2 onset also the env-GS model and its own Adam
(`has_env_gs` in chkpnt_meta.json, as the JAX package writes it). The JAX
package's Orbax checkpoints are not read here. As in the reference (and the
JAX package), `indirect_asg` is re-zeroed on restore (gaussian_model.py:173).
"""
from __future__ import annotations

import json
import os

import torch

from materialrefgs_torch.models.env_light import EnvLightParams
from materialrefgs_torch.models.gaussian_model import GaussianModel
from materialrefgs_torch.train.optim import Adam
from materialrefgs_torch.train.trainer import TrainState


def save_checkpoint(state: TrainState, iteration: int, path: str) -> str:
    """Write chkpnt{iteration}.pt under `path` (and chkpnt_meta.json naming
    the latest). Returns the file's path."""
    os.makedirs(path, exist_ok=True)
    out = os.path.join(path, f"chkpnt{iteration}.pt")
    torch.save(
        {
            "model": {k: v.detach().cpu() for k, v in state.model.state_dict().items()},
            "capacity": state.model.capacity,
            "max_sh_degree": state.model.max_sh_degree,
            "env1": state.env1.base.detach().cpu(),
            "env2": state.env2.base.detach().cpu(),
            "adam_mu": {k: v.cpu() for k, v in state.adam.mu.items()},
            "adam_nu": {k: v.cpu() for k, v in state.adam.nu.items()},
            "adam_count": state.adam.count,
            "step": state.step,
            "opacity_lr_scale": state.opacity_lr_scale,
            "iteration": iteration,
            "env_gs": _env_gs_record(state),
        },
        out,
    )
    with open(os.path.join(path, "chkpnt_meta.json"), "w") as f:
        json.dump({"iteration": iteration, "has_env_gs": state.env_gs is not None}, f)
    return out


def _env_gs_record(state: TrainState) -> dict | None:
    if state.env_gs is None:
        return None
    return {
        "model": {k: v.detach().cpu() for k, v in state.env_gs.state_dict().items()},
        "adam_mu": {k: v.cpu() for k, v in state.env_adam.mu.items()},
        "adam_nu": {k: v.cpu() for k, v in state.env_adam.nu.items()},
        "adam_count": state.env_adam.count,
    }


def _restore_adam(adam: Adam, mu: dict, nu: dict, count: int) -> Adam:
    for k in adam.names:
        adam.mu[k].copy_(mu[k])
        adam.nu[k].copy_(nu[k])
    adam.count = int(count)
    return adam


def load_checkpoint(path: str, iteration: int | None = None, device=None) -> tuple[TrainState, int]:
    """Restore a TrainState saved by save_checkpoint. Returns (state,
    iteration); `iteration` defaults to the latest in chkpnt_meta.json."""
    if iteration is None:
        meta_path = os.path.join(path, "chkpnt_meta.json")
        if not os.path.exists(meta_path):
            raise FileNotFoundError(f"no chkpnt_meta.json at {path}; pass iteration= explicitly")
        with open(meta_path) as f:
            iteration = json.load(f)["iteration"]
    ck = torch.load(os.path.join(path, f"chkpnt{iteration}.pt"), map_location="cpu")
    model = GaussianModel(ck["capacity"], ck["max_sh_degree"], device)
    model.load_state_dict(ck["model"])
    with torch.no_grad():
        model.indirect_asg.zero_()
    dev = model.device
    env1 = EnvLightParams(ck["env1"].to(dev))
    env2 = EnvLightParams(ck["env2"].to(dev))
    state = TrainState(model=model, env1=env1, env2=env2, adam=None,
                       step=int(ck["step"]), opacity_lr_scale=float(ck["opacity_lr_scale"]))
    state.adam = _restore_adam(Adam({k: v.detach() for k, v in state.params().items()}),
                               ck["adam_mu"], ck["adam_nu"], ck["adam_count"])
    env = ck.get("env_gs")
    if env is not None:
        state.env_gs = GaussianModel(ck["capacity"], ck["max_sh_degree"], device)
        state.env_gs.load_state_dict(env["model"])
        state.env_adam = _restore_adam(Adam({k: v.detach() for k, v in state.env_params().items()}),
                                       env["adam_mu"], env["adam_nu"], env["adam_count"])
    return state, int(ck["iteration"])
