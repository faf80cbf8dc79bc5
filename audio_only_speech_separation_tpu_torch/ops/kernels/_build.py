"""Build and load the CUDA kernels at first use.

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a``, one process per
source, all started together, and links the objects into one shared
library with a plain C interface in ``build/kernels/`` at the repository
root.  The file name carries a hash of the sources and flags, so an edited
source is rebuilt and an unchanged one is loaded as it is.  The library is
bound with ``ctypes``.
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
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


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
    nvcc = _nvcc()
    work = tempfile.mkdtemp(dir=BUILD_DIR)
    try:
        jobs = []
        for src in (s for s in _sources() if s.suffix == ".cu"):
            obj = os.path.join(work, src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
            jobs.append((obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                               stderr=subprocess.STDOUT, text=True)))
        log = []
        for _, proc in jobs:
            log.append(proc.communicate()[0])
        failed = [(obj, proc.returncode) for obj, proc in jobs if proc.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(log))
        tmp = os.path.join(work, "lib.so")
        res = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", tmp, *(o for o, _ in jobs)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
        os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return path, "\n".join(log)


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build if needed, load, and declare the C entry points."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.convtasnet_separator.argtypes = [p] * 17 + [i, i, i, i, ctypes.POINTER(i), i, i, p]
    lib.convtasnet_separator.restype = i
    lib.convtasnet_separator_launches.argtypes = [i]
    lib.convtasnet_separator_launches.restype = i
    lib.tcn_separator.argtypes = [p] * 12 + [i, i, i, i, ctypes.POINTER(i), p]
    lib.tcn_separator.restype = i
    lib.tcn_separator_launches.argtypes = [i]
    lib.tcn_separator_launches.restype = i
    lib.tcn_backward_workspace_bytes.argtypes = [i, i, i, i]
    lib.tcn_backward_workspace_bytes.restype = ctypes.c_size_t
    lib.tcn_backward.argtypes = [p] * 14 + [i, i, i, i, ctypes.POINTER(i), p]
    lib.tcn_backward.restype = i
    lib.tcn_backward_launches.argtypes = [i]
    lib.tcn_backward_launches.restype = i
    lib.convtasnet_error_string.argtypes = [i]
    lib.convtasnet_error_string.restype = ctypes.c_char_p
    lib.attention_bdt.argtypes = [p] * 4 + [i, i, i, p]
    lib.attention_bdt.restype = i
    lib.attention_packed.argtypes = [p] * 2 + [i] * 4 + [p]
    lib.attention_packed.restype = i
    lib.add_layer_norm.argtypes = [p] * 6 + [i] * 3 + [ctypes.c_float, i, p]
    lib.add_layer_norm.restype = i
    lib.global_layer_norm.argtypes = [p] * 5 + [ctypes.c_longlong, p, i, i, i, ctypes.c_float, i, p]
    lib.global_layer_norm.restype = i
    lib.lstm_recurrence.argtypes = [p] * 3 + [i] * 5 + [p]
    lib.lstm_recurrence.restype = i
    lib.lstm_recurrence_cluster.argtypes = [i] * 4
    lib.lstm_recurrence_cluster.restype = i
    lib.lstm_resident.argtypes = [p] * 5 + [i] * 5 + [p]
    lib.lstm_resident.restype = i
    lib.lstm_resident_launches.argtypes = []
    lib.lstm_resident_launches.restype = i
    lib.lstm_resident_cluster.argtypes = [i] * 4
    lib.lstm_resident_cluster.restype = i
    bind_micro_vpu(lib)
    return lib


def bind_micro_vpu(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare K7's C entry points on ``lib`` (the package's library, or a
    profile build of ``csrc/micro_vpu.cu`` alone)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.micro_vpu.argtypes = [p] * 4 + [i] * 3 + [ctypes.c_float] * 2 + [p]
    lib.micro_vpu.restype = i
    lib.micro_vpu_per_thread.argtypes = [i, i]
    lib.micro_vpu_per_thread.restype = i
    lib.micro_vpu_partials.argtypes = [i] * 3
    lib.micro_vpu_partials.restype = i
    lib.micro_vpu_fits.argtypes = [i] * 3
    lib.micro_vpu_fits.restype = i
    lib.micro_vpu_launches.argtypes = [i]
    lib.micro_vpu_launches.restype = i
    return lib


def check_launch(lib, name: str, rc: int) -> None:
    """Raise if a C entry returned a nonzero cudaError_t."""
    if rc != 0:
        msg = lib.convtasnet_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({msg})")
