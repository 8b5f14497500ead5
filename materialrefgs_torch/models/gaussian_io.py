"""Gaussian model PLY serialization (reference gaussian_model.py:490-529
save_ply, :725-838 load_ply) plus env-light state as .npz files.

Attribute layout matches construct_list_of_attributes (gaussian_model.py:470+)
and the JAX package's gaussian_io exactly, so PLYs move between the two
packages and the reference: x y z, nx ny nz, nx2 ny2 nz2, f_dc_*, f_rest_*
(channel-major), ind_dc_*, ind_rest_*, ind_asg_* (param-major, 5x32),
opacity, refl_strength, metalness, roughness, ori_color_*, diffuse_color_*,
scale_*, rot_*.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from materialrefgs_torch.models.env_light import EnvLightParams
from materialrefgs_torch.models.gaussian_model import GaussianModel
from materialrefgs_torch.utils.ply import read_ply, write_ply


def save_ply(
    model: GaussianModel,
    path: str,
    env1: EnvLightParams | None = None,
    env2: EnvLightParams | None = None,
):
    alive = model.alive.cpu().numpy()

    def take(x):
        return x.detach().cpu().numpy()[alive]

    # (P, K, 3) -> channel-major flatten (P, 3*K) like torch transpose(1,2).
    def ch_major(a):
        return a.transpose(0, 2, 1).reshape(a.shape[0], a.shape[1] * a.shape[2])

    props: dict[str, np.ndarray] = {}
    xyz = take(model.xyz)
    for i, k in enumerate(("x", "y", "z")):
        props[k] = xyz[:, i]
    n1, n2 = take(model.normal1), take(model.normal2)
    for i, k in enumerate(("nx", "ny", "nz")):
        props[k] = n1[:, i]
    for i, k in enumerate(("nx2", "ny2", "nz2")):
        props[k] = n2[:, i]
    for prefix, leaf in (
        ("f_dc", model.features_dc),
        ("f_rest", model.features_rest),
        ("ind_dc", model.indirect_dc),
        ("ind_rest", model.indirect_rest),
        ("ind_asg", model.indirect_asg),
    ):
        flat = ch_major(take(leaf))
        for i in range(flat.shape[1]):
            props[f"{prefix}_{i}"] = flat[:, i]
    for name in ("opacity", "refl_strength", "metalness", "roughness"):
        props[name] = take(getattr(model, name))[:, 0]
    for name in ("ori_color", "diffuse_color", "scaling", "rotation"):
        leaf = take(getattr(model, name))
        prefix = {"scaling": "scale", "rotation": "rot"}.get(name, name)
        for i in range(leaf.shape[1]):
            props[f"{prefix}_{i}"] = leaf[:, i]
    write_ply(path, props)

    for suffix, env in (("1.map.npz", env1), ("2.map.npz", env2)):
        if env is not None:
            np.savez(path.replace(".ply", suffix), base=env.base.detach().cpu().numpy())


def load_ply(
    path: str,
    capacity: int | None = None,
    max_sh_degree: int = 3,
    device: str | torch.device | None = None,
):
    """Returns (GaussianModel, env1 | None, env2 | None); all alive splats
    come first, then dead padding up to `capacity` (default: the next power
    of two)."""
    v = read_ply(path)
    P = len(v["x"])
    cap = capacity or int(2 ** np.ceil(np.log2(max(P, 1))))
    if P > cap:
        raise ValueError(f"{path}: {P} splats exceed capacity {cap}")
    K = (max_sh_degree + 1) ** 2

    def pad(x, fill=0.0):
        out = np.full((cap,) + x.shape[1:], fill, np.float32)
        out[:P] = x
        return out

    def stack(names):
        return np.stack([v[n] for n in names], axis=1).astype(np.float32)

    def series(prefix, n):
        return stack([f"{prefix}_{i}" for i in range(n)])

    def sh_series(prefix, n_coef):
        return series(prefix, 3 * n_coef).reshape(P, 3, n_coef).transpose(0, 2, 1)

    rotation = pad(series("rot", 4))
    rotation[P:, 0] = 1.0
    arrays = {
        "xyz": pad(stack(["x", "y", "z"])),
        "scaling": pad(series("scale", 2), fill=-10.0),
        "rotation": rotation,
        "opacity": pad(v["opacity"][:, None].astype(np.float32), fill=-15.0),
        "refl_strength": pad(v["refl_strength"][:, None].astype(np.float32)),
        "metalness": pad(v["metalness"][:, None].astype(np.float32)),
        "roughness": pad(v["roughness"][:, None].astype(np.float32)),
        "ori_color": pad(series("ori_color", 3)),
        "diffuse_color": pad(series("diffuse_color", 3)),
        "features_dc": pad(sh_series("f_dc", 1)),
        "features_rest": pad(sh_series("f_rest", K - 1)),
        "indirect_dc": pad(sh_series("ind_dc", 1)),
        "indirect_rest": pad(sh_series("ind_rest", K - 1)),
        "indirect_asg": pad(series("ind_asg", 160).reshape(P, 5, 32).transpose(0, 2, 1)),
        "normal1": pad(stack(["nx", "ny", "nz"])),
        "normal2": pad(stack(["nx2", "ny2", "nz2"])),
    }
    model = GaussianModel.from_arrays(
        arrays, np.arange(cap) < P, max_sh_degree, max_sh_degree, device
    )

    envs = []
    for suffix in ("1.map.npz", "2.map.npz"):
        p = path.replace(".ply", suffix)
        envs.append(
            EnvLightParams(torch.as_tensor(np.load(p)["base"], device=model.device))
            if os.path.exists(p)
            else None
        )
    return model, envs[0], envs[1]
