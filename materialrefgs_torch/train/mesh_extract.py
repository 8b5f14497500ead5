"""Triangle-mesh PLY I/O (materialrefgs_tpu/train/mesh_extract.py:310-344).

The reader and writer the serving path needs (eval loads the newest
`meshes/*.ply` a training run dumped); TSDF mesh extraction comes with the
surfel2 training slice of the port.
"""
from __future__ import annotations

import os

import numpy as np


def write_mesh_ply(path: str, verts: np.ndarray, faces: np.ndarray):
    """Binary little-endian PLY: float xyz vertices, uchar/int32 face lists."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element vertex {len(verts)}\n".encode())
        f.write(b"property float x\nproperty float y\nproperty float z\n")
        f.write(f"element face {len(faces)}\n".encode())
        f.write(b"property list uchar int vertex_indices\nend_header\n")
        f.write(np.asarray(verts).astype("<f4").tobytes())
        fdata = np.empty(len(faces), dtype=[("n", "u1"), ("v", "<i4", 3)])
        fdata["n"] = 3
        fdata["v"] = faces
        f.write(fdata.tobytes())


def read_mesh_ply(path: str):
    """Read a triangle mesh PLY in the write_mesh_ply layout. Returns
    (verts (V,3) float32, faces (T,3) int32)."""
    with open(path, "rb") as f:
        n_vert = n_face = 0
        while True:
            raw = f.readline()
            if not raw:
                raise ValueError(f"{path}: PLY header has no end_header")
            line = raw.decode("ascii").strip()
            if line.startswith("element vertex"):
                n_vert = int(line.split()[-1])
            elif line.startswith("element face"):
                n_face = int(line.split()[-1])
            elif line == "end_header":
                break
        verts = np.frombuffer(f.read(n_vert * 12), dtype="<f4").reshape(n_vert, 3)
        fdt = np.dtype([("n", "u1"), ("v", "<i4", 3)])
        faces = np.frombuffer(f.read(n_face * fdt.itemsize), dtype=fdt)["v"]
    return verts.astype(np.float32), faces.astype(np.int32)


def extract_mesh(*args, **kwargs):
    raise NotImplementedError(
        "TSDF mesh extraction (extract_mesh) is not ported yet; it comes with "
        "the surfel2 training slice of the port"
    )
