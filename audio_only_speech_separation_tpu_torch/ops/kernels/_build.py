"""Build and load the CUDA kernels at first use.

``nvcc`` compiles every ``csrc/*.cu`` into one shared library with a plain C
interface, for ``sm_90a``, into ``build/kernels/`` at the repository root.
The file name carries a hash of the sources and flags, so an edited source
is rebuilt and an unchanged one is loaded as it is.  The library is bound
with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
_CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return path


def _sources():
    return sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libkernels-{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, str]:
    """Compile the library unless it exists; returns (path, nvcc's output)."""
    path = library_path()
    if path.exists():
        return path, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cus = [str(s) for s in _sources() if s.suffix == ".cu"]
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *cus]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
    os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing
    return path, res.stdout + res.stderr


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build if needed, load, and declare the C entry points."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.convtasnet_separator.argtypes = [p] * 17 + [i, i, i, i, ctypes.POINTER(i), i, i, p]
    lib.convtasnet_separator.restype = i
    lib.convtasnet_error_string.argtypes = [i]
    lib.convtasnet_error_string.restype = ctypes.c_char_p
    return lib
