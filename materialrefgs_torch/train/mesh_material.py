"""The material mesh and its vertex-albedo refinement
(materialrefgs_tpu/train/mesh_material.py).

1. The material-textured mesh PLY (reference utils/mesh_utils.py:255-310,
   `extract_mesh_bouned_with_material`): one binary PLY whose vertices carry
   rgb, normal, diffuse, albedo, metallic and roughness. The attributes are
   baked onto the extracted mesh's vertices (ops/mesh_tracer.bake_vertex_attrs)
   rather than fused once per attribute map as the reference does.

2. The optimizable mesh tracer's vertex albedo
   (raytracing_brdf/raytracer_optimizable.py:46-50): inverse-sigmoid logits
   under Adam (optax.adam's defaults, eps 1e-8), each step descending an L1
   between the one-bounce indirect render and a target.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from materialrefgs_torch.ops.mesh_tracer import shade_one_bounce
from materialrefgs_torch.train.optim import Adam
from materialrefgs_torch.utils.transforms import abs_, inverse_sigmoid

# The PLY's vertex fields (reference mesh_utils.py:278-296). Normals are in
# [-1, 1] on disk; MeshData.attrs keeps them in [0, 1].
_FIELDS = (
    ["x", "y", "z"]
    + ["red", "green", "blue"]
    + ["normal_x", "normal_y", "normal_z"]
    + ["diffuse_r", "diffuse_g", "diffuse_b"]
    + ["albedo_r", "albedo_g", "albedo_b"]
    + ["metallic_0"]
    + ["roughness_0"]
)


def write_material_mesh_ply(path: str, verts: np.ndarray, faces: np.ndarray, attrs: dict,
                            rgb: np.ndarray | None = None) -> None:
    """Write the multi-attribute vertex PLY. `attrs` is bake_vertex_attrs'
    dict (diffuse/albedo/metallic/roughness (V, C), normal in [0, 1]); `rgb`
    is the fused render colour (default: diffuse)."""
    V = len(verts)
    if rgb is None:
        rgb = attrs["diffuse"]
    cols = np.concatenate(
        [
            np.asarray(verts, np.float32),
            np.asarray(rgb, np.float32),
            np.asarray(attrs["normal"], np.float32) * 2.0 - 1.0,
            np.asarray(attrs["diffuse"], np.float32),
            np.asarray(attrs["albedo"], np.float32),
            np.asarray(attrs["metallic"], np.float32).reshape(V, 1),
            np.asarray(attrs["roughness"], np.float32).reshape(V, 1),
        ],
        axis=-1,
    ).astype("<f4")
    if cols.shape != (V, len(_FIELDS)):
        raise ValueError(f"vertex rows {cols.shape} do not match the {len(_FIELDS)} PLY fields")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element vertex {V}\n".encode())
        for name in _FIELDS:
            f.write(f"property float {name}\n".encode())
        f.write(f"element face {len(faces)}\n".encode())
        f.write(b"property list uchar int vertex_indices\nend_header\n")
        f.write(cols.tobytes())
        fdata = np.empty(len(faces), dtype=[("n", "u1"), ("v", "<i4", 3)])
        fdata["n"] = 3
        fdata["v"] = np.asarray(faces, np.int32)
        f.write(fdata.tobytes())


def read_material_mesh_ply(path: str):
    """Read a material mesh PLY (this writer's layout, or any float-vertex
    PLY with the reference's `{prefix}_{suffix}` fields,
    raytracer_optimizable.py:66-81). Returns (verts, faces, attrs), attrs in
    MeshData's conventions (normal back in [0, 1])."""
    with open(path, "rb") as f:
        n_vert = n_face = 0
        names = []
        in_vertex = False
        while True:
            line = f.readline().decode("ascii").strip()
            if line.startswith("element vertex"):
                n_vert = int(line.split()[-1])
                in_vertex = True
            elif line.startswith("element face"):
                n_face = int(line.split()[-1])
                in_vertex = False
            elif line.startswith("property float") and in_vertex:
                names.append(line.split()[-1])
            elif line == "end_header":
                break
        data = np.frombuffer(f.read(n_vert * 4 * len(names)), dtype="<f4").reshape(n_vert, len(names))
        fdt = np.dtype([("n", "u1"), ("v", "<i4", 3)])
        faces = np.frombuffer(f.read(n_face * fdt.itemsize), dtype=fdt)["v"]

    col = {n: i for i, n in enumerate(names)}

    def grab(*fields):
        return data[:, [col[f] for f in fields]].copy()

    verts = grab("x", "y", "z")
    attrs = {}
    if "normal_x" in col:
        attrs["normal"] = grab("normal_x", "normal_y", "normal_z") * 0.5 + 0.5
    if "diffuse_r" in col:
        attrs["diffuse"] = grab("diffuse_r", "diffuse_g", "diffuse_b")
    if "albedo_r" in col:
        attrs["albedo"] = grab("albedo_r", "albedo_g", "albedo_b")
    if "metallic_0" in col:
        attrs["metallic"] = grab("metallic_0")
    if "roughness_0" in col:
        attrs["roughness"] = grab("roughness_0")
    return verts, faces.astype(np.int32).copy(), attrs


def make_vertex_albedo_step(mesh, envmap, lr: float = 1e-6):
    """Optimizable vertex albedo (raytracer_optimizable.py:46-50). Returns
    (state, step): state = (logits (V, 3), Adam) with the logits the
    inverse sigmoid of the mesh's albedo clipped to [1e-4, 1 - 1e-4], and
    step(state, surface_pos, rays_n, rays_v, target) -> (state, loss) one
    Adam step (optax.adam(lr): b1 0.9, b2 0.999, eps 1e-8) on
    mean |shade_one_bounce(...)["indirect"] - target|, with the diffuse
    attribute following the albedo as (1 - metallic) * albedo. The state is
    updated in place."""
    logits0 = inverse_sigmoid(torch.clamp(mesh.attrs["albedo"].float(), 1e-4, 1 - 1e-4)).detach()
    V = logits0.shape[0]
    metallic = mesh.attrs.get("metallic")
    if metallic is None:
        metallic = torch.zeros((V, 1), device=logits0.device)
    adam = Adam({"albedo": logits0}, eps=1e-8)

    def step(state, surface_pos, rays_n, rays_v, target):
        logits, opt = state
        leaf = logits.detach().requires_grad_(True)
        albedo = torch.sigmoid(leaf)
        attrs = dict(mesh.attrs, albedo=albedo, diffuse=(1.0 - metallic) * albedo)
        out = shade_one_bounce(dataclasses.replace(mesh, attrs=attrs), envmap, surface_pos, rays_n, rays_v)
        loss = torch.mean(abs_(out["indirect"] - target))
        (g,) = torch.autograd.grad(loss, [leaf])
        opt.step({"albedo": logits}, {"albedo": g}, {"albedo": lr})
        return (logits, opt), loss.detach()

    return (logits0, adam), step
