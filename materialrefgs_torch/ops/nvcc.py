"""Build the port's hand-written CUDA sources into shared libraries.

Each source under `csrc/` has a plain C entry point; `build(source)` compiles
it with nvcc for sm_90a into BUILD_DIR (gitignored) once per source and flag
hash, and `load(source)` opens the library with ctypes. Kernels are built on
the machine with the card at first use, never when a module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "kernels"
# -fmad=false keeps every multiply and add separately rounded, as the plain
# torch versions' elementwise ops are, so a kernel and its plain version
# agree bit for bit except where libdevice and torch disagree (and where a
# kernel sums in another order). No --use_fast_math.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    found = cand if os.path.exists(cand) else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin and on PATH)")
    return found


def build(source: Path) -> tuple[Path, str]:
    """Compile `source` into BUILD_DIR (once per source/flags hash). Returns
    (library path, compiler output); the output holds ptxas's
    register/shared-memory report when this call compiled."""
    src = source.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{source.stem}_{tag}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(source)],
            capture_output=True,
            text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source.name} ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib, proc.stdout + proc.stderr


def load(source: Path) -> ctypes.CDLL:
    path, _ = build(source)
    return ctypes.CDLL(str(path))
