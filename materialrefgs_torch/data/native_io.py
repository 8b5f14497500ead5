"""COLMAP images.bin and points3D.bin through native code.

ctypes over `csrc/colmap_io.cpp`, the port's copy of the JAX package's
native parsers (native/fastio.cpp), built with the host compiler into
build/kernels/ at first use. A failed build raises; the pure parser in
colmap_loader.py reads text models and is the tests' reference.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np

from materialrefgs_torch.ops import nvcc

SOURCE = nvcc.CSRC / "colmap_io.cpp"


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = nvcc.load(SOURCE)
    p = ctypes.POINTER
    lib.colmap_read_points3d.argtypes = [ctypes.c_char_p, p(ctypes.c_void_p), p(ctypes.c_void_p), p(ctypes.c_void_p)]
    lib.colmap_read_points3d.restype = ctypes.c_longlong
    lib.colmap_read_images.argtypes = [ctypes.c_char_p] + [p(ctypes.c_void_p)] * 5 + [p(ctypes.c_longlong)]
    lib.colmap_read_images.restype = ctypes.c_longlong
    lib.colmap_free.argtypes = [ctypes.c_void_p]
    lib.colmap_last_error.restype = ctypes.c_char_p
    return lib


def _take(lib, ptr: ctypes.c_void_p, shape, dtype) -> np.ndarray:
    """Copy a buffer the library allocated into numpy and free it."""
    n = int(np.prod(shape)) * np.dtype(dtype).itemsize
    out = np.frombuffer(ctypes.string_at(ptr, n), dtype).reshape(shape).copy()
    lib.colmap_free(ptr)
    return out


def _fail(lib, path):
    return ValueError(f"{path}: {lib.colmap_last_error().decode()}")


def read_points3d(path: str):
    """points3D.bin -> (xyz (N, 3) float64, rgb (N, 3) uint8, error (N,)
    float64)."""
    lib = _library()
    xyz, rgb, err = ctypes.c_void_p(), ctypes.c_void_p(), ctypes.c_void_p()
    n = lib.colmap_read_points3d(str(path).encode(), ctypes.byref(xyz), ctypes.byref(rgb), ctypes.byref(err))
    if n < 0:
        raise _fail(lib, path)
    return (_take(lib, xyz, (n, 3), np.float64), _take(lib, rgb, (n, 3), np.uint8),
            _take(lib, err, (n,), np.float64))


def read_images(path: str):
    """images.bin -> (image_id (N,) int32, qvec (N, 4) float64, tvec (N, 3)
    float64, camera_id (N,) int32, names), in file order; the 2D points are
    skipped."""
    lib = _library()
    ids, qv, tv, cid, names = (ctypes.c_void_p() for _ in range(5))
    nlen = ctypes.c_longlong()
    n = lib.colmap_read_images(str(path).encode(), ctypes.byref(ids), ctypes.byref(qv), ctypes.byref(tv),
                               ctypes.byref(cid), ctypes.byref(names), ctypes.byref(nlen))
    if n < 0:
        raise _fail(lib, path)
    raw = ctypes.string_at(names, nlen.value)
    lib.colmap_free(names)
    return (_take(lib, ids, (n,), np.int32), _take(lib, qv, (n, 4), np.float64), _take(lib, tv, (n, 3), np.float64),
            _take(lib, cid, (n,), np.int32), raw.decode("utf-8").split("\0")[:n])
