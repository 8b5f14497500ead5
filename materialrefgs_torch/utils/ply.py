"""Minimal PLY reader/writer (replaces the plyfile dependency).

Supports the subset the pipeline needs: a single 'vertex' element with f4 /
u1 scalar properties, binary-little-endian or ascii on read, binary on write.
"""
from __future__ import annotations

import os

import numpy as np

_TYPES = {
    "float": ("f4", 4), "float32": ("f4", 4),
    "double": ("f8", 8), "float64": ("f8", 8),
    "uchar": ("u1", 1), "uint8": ("u1", 1),
    "char": ("i1", 1), "int8": ("i1", 1),
    "short": ("i2", 2), "ushort": ("u2", 2),
    "int": ("i4", 4), "int32": ("i4", 4),
    "uint": ("u4", 4), "uint32": ("u4", 4),
}


def read_ply(path: str) -> dict[str, np.ndarray]:
    """Returns {property_name: (N,) array} for the 'vertex' element."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii").strip()
            header.append(line)
            if line == "end_header":
                break
        fmt = next(l.split()[1] for l in header if l.startswith("format"))
        # Parse elements; only 'vertex' is materialized.
        elements = []  # (name, count, [(prop_name, dtype)])
        cur = None
        for line in header:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "element":
                cur = (parts[1], int(parts[2]), [])
                elements.append(cur)
            elif parts[0] == "property" and cur is not None:
                if parts[1] == "list":
                    raise ValueError("list properties unsupported")
                cur[2].append((parts[2], _TYPES[parts[1]][0]))

        out = {}
        for name, count, props in elements:
            dt = np.dtype([(p, ("<" + t) if fmt.startswith("binary_little") else (">" + t)) for p, t in props])
            if fmt == "ascii":
                rows = np.loadtxt(
                    [f.readline() for _ in range(count)], dtype=np.float64
                ).reshape(count, len(props))
                if name == "vertex":
                    for i, (p, t) in enumerate(props):
                        out[p] = rows[:, i].astype(t)
            else:
                raw = np.frombuffer(f.read(count * dt.itemsize), dtype=dt, count=count)
                if name == "vertex":
                    for p, _ in props:
                        out[p] = np.ascontiguousarray(raw[p])
        return out


def write_ply(path: str, props: dict[str, np.ndarray]):
    """Write a 'vertex' element with the given (N,) float32 properties,
    binary-little-endian, preserving dict order."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    names = list(props.keys())
    n = len(next(iter(props.values())))
    dt = np.dtype([(k, "<f4") for k in names])
    arr = np.empty(n, dtype=dt)
    for k in names:
        arr[k] = np.asarray(props[k], np.float32).reshape(n)
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element vertex {n}\n".encode())
        for k in names:
            f.write(f"property float {k}\n".encode())
        f.write(b"end_header\n")
        f.write(arr.tobytes())


def write_point_cloud_ply(path: str, points: np.ndarray, colors: np.ndarray, normals: np.ndarray | None = None):
    """xyz + rgb(uchar) + normals point cloud (dataset input.ply style)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    n = len(points)
    normals = np.zeros_like(points) if normals is None else normals
    dt = np.dtype(
        [(k, "<f4") for k in ("x", "y", "z", "nx", "ny", "nz")]
        + [(k, "u1") for k in ("red", "green", "blue")]
    )
    arr = np.empty(n, dtype=dt)
    for i, k in enumerate(("x", "y", "z")):
        arr[k] = points[:, i]
    for i, k in enumerate(("nx", "ny", "nz")):
        arr[k] = normals[:, i]
    cb = np.clip(colors * 255, 0, 255).astype(np.uint8)
    for i, k in enumerate(("red", "green", "blue")):
        arr[k] = cb[:, i]
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element vertex {n}\n".encode())
        for k in ("x", "y", "z", "nx", "ny", "nz"):
            f.write(f"property float {k}\n".encode())
        for k in ("red", "green", "blue"):
            f.write(f"property uchar {k}\n".encode())
        f.write(b"end_header\n")
        f.write(arr.tobytes())


def read_point_cloud_ply(path: str):
    """Returns (points (N,3), colors (N,3) float in [0,1], normals (N,3))."""
    v = read_ply(path)
    pts = np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float32)
    if "red" in v:
        cols = np.stack([v["red"], v["green"], v["blue"]], axis=1)
        cols = cols.astype(np.float32)
        if cols.max() > 1.5:
            cols = cols / 255.0
    else:
        cols = np.full_like(pts, 0.5)
    if "nx" in v:
        nrm = np.stack([v["nx"], v["ny"], v["nz"]], axis=1).astype(np.float32)
    else:
        nrm = np.zeros_like(pts)
    return pts, cols, nrm
