"""Build the port's hand-written native sources into shared libraries.

Each source under `csrc/` has a plain C entry point. `build(source)` compiles
a CUDA source with nvcc for sm_90a and a host C++ source with the host
compiler (`c++`, the one nvcc drives), each into BUILD_DIR
(gitignored) once per source and flag hash; `load(source)` opens the library
with ctypes. Sources are built at first use, never when a module is imported.
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
HOST_FLAGS = ("-std=c++17", "-O3", "-shared", "-fPIC")


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    found = cand if os.path.exists(cand) else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin and on PATH)")
    return found


def host_compiler() -> str | None:
    """The host C++ compiler ($CXX, else `c++` on PATH), or None."""
    cxx = os.environ.get("CXX") or "c++"
    return shutil.which(cxx)


def _compile(source: Path, compiler: str, flags: tuple[str, ...]) -> tuple[Path, str]:
    src = source.read_bytes()
    tag = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{source.stem}_{tag}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([compiler, *flags, "-o", tmp, str(source)], capture_output=True, text=True)
        if proc.returncode != 0:
            name = os.path.basename(compiler)
            raise RuntimeError(f"{name} failed on {source.name} ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib, proc.stdout + proc.stderr


def build(source: Path) -> tuple[Path, str]:
    """Compile a .cu or .cpp `source` into BUILD_DIR (once per source/flags
    hash): .cu with nvcc, .cpp with the host compiler. Returns (library path,
    compiler output); for a .cu source the output holds ptxas's
    register/shared-memory report when this call compiled. Raises with the
    compiler's output when it fails, or when no compiler is found."""
    if source.suffix == ".cpp":
        cxx = host_compiler()
        if cxx is None:
            raise RuntimeError(f"no C++ compiler found ($CXX or c++ on PATH) to build {source.name}")
        return _compile(source, cxx, HOST_FLAGS)
    return _compile(source, _nvcc(), NVCC_FLAGS)


def load(source: Path) -> ctypes.CDLL:
    path, _ = build(source)
    return ctypes.CDLL(str(path))
