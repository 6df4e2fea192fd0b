"""Build a source of ``csrc/`` into a shared library and load it.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on
first use with ``nvcc`` for ``sm_90a`` into ``build/kernels/`` at the root
of the checkout; each host source ``csrc/<name>.cpp`` with the host C++
compiler into ``build/host/`` (both listed in ``.gitignore``). The
library's file name carries a hash of the source, so an edited source is
rebuilt and a stale library is never loaded. Nothing here runs at import
time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
HOST_BUILD_DIR = BUILD_DIR.parent / "host"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
CXX_FLAGS = ["-std=c++17", "-O2", "-shared", "-fPIC"]


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return nvcc


def find_cxx() -> str:
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no host C++ compiler (c++ or g++) on the PATH: the PNG "
                           "decoder builds at first use")
    return cxx


def library_path(name: str, source: Path | None = None, build_dir: Path = BUILD_DIR) -> Path:
    src = source or CSRC / f"{name}.cu"
    digest = hashlib.sha1(src.read_bytes()).hexdigest()[:12]
    return build_dir / f"lib{name}_{digest}.so"


def _compile(cmd: list[str], src: Path, out: Path) -> tuple[Path, float, str]:
    """Run ``cmd -o <tmp> src`` unless ``out`` exists, then move the result
    to ``out`` atomically: a concurrent build never sees a partial file."""
    if out.exists():
        return out, 0.0, ""
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([*cmd, "-o", tmp, str(src)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{Path(cmd[0]).name} failed for {src.name}:\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out, time.perf_counter() - t0, proc.stdout + proc.stderr


def build(name: str, source: Path | None = None) -> tuple[Path, float, str]:
    """Compile ``csrc/<name>.cu`` (or ``source``) into ``lib<name>_<hash>.so``
    unless that library is already built. Returns (library path, build
    seconds, compiler output)."""
    src = source or CSRC / f"{name}.cu"
    return _compile([find_nvcc(), *NVCC_FLAGS], src, library_path(name, src))


def build_host(name: str) -> tuple[Path, float, str]:
    """Compile the host source ``csrc/<name>.cpp`` with the host C++
    compiler into ``build/host/lib<name>_<hash>.so``, as :func:`build` does."""
    src = CSRC / f"{name}.cpp"
    return _compile([find_cxx(), *CXX_FLAGS], src, library_path(name, src, HOST_BUILD_DIR))


def load(name: str) -> ctypes.CDLL:
    return ctypes.CDLL(str(build(name)[0]))
