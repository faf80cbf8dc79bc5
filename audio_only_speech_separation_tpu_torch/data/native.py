"""ctypes bindings to the repository's native wav reader
(``native/wavio.cpp``; counterpart of
``audio_only_speech_separation_tpu/data/native.py``).

The library is built at the first call that needs it, never while a
module is imported: ``g++`` compiles ``native/wavio.cpp`` into
``build/wavio/`` at the repository root, under an ``fcntl`` lock, and the
result is renamed into place, so processes that start together (test
workers, one process a card) build it once and never load half a file.
The file name carries a hash of the source and the flags, so an edited
source is rebuilt.  Where no C++ compiler is found, ``get_lib()`` returns
None and ``audio_io`` reads with the standard library's ``wave``.  The
first call's outcome is kept: later calls take no lock and search no
``PATH``, and a build that failed raised once and is not tried again.  The
batch call releases the GIL for its whole threaded fan-out.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "native" / "wavio.cpp"
BUILD_DIR = _ROOT / "build" / "wavio"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared"]

_lib: Optional[ctypes.CDLL] = None
_tried = False  # get_lib() has run: _lib is its outcome (None: no library)
_lib_lock = threading.Lock()


def _compiler() -> Optional[str]:
    return shutil.which(os.environ.get("CXX", "g++"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libwavio-{h.hexdigest()[:16]}.so"


def build(cxx: str) -> Path:
    """Compile the library with ``cxx`` unless it exists; returns its path.
    One process builds while the others wait on the lock."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not path.exists():  # another process may have built it while this one waited
            work = tempfile.mkdtemp(dir=BUILD_DIR)
            try:
                tmp = os.path.join(work, "lib.so")
                res = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE)], capture_output=True, text=True,
                                     timeout=300)
                if res.returncode != 0:
                    raise RuntimeError(f"{cxx} failed ({res.returncode}) on {SOURCE}:\n{res.stderr}")
                os.replace(tmp, path)  # atomic: a loader sees all of the file or none
            finally:
                shutil.rmtree(work, ignore_errors=True)
    return path


def get_lib() -> Optional[ctypes.CDLL]:
    """The library, built and loaded at the first call; None when no C++
    compiler is found, or after a first call whose build raised."""
    global _lib, _tried
    if _tried:
        return _lib
    with _lib_lock:
        if not _tried:
            try:
                cxx = _compiler()
                _lib = None if cxx is None else _load(build(cxx))
            finally:
                _tried = True
    return _lib


def _load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    i64, fp = ctypes.c_int64, ctypes.POINTER(ctypes.c_float)
    lib.wavio_read_window.restype = i64
    lib.wavio_read_window.argtypes = [ctypes.c_char_p, i64, i64, fp]
    lib.wavio_num_frames.restype = i64
    lib.wavio_num_frames.argtypes = [ctypes.c_char_p]
    lib.wavio_read_batch.restype = i64
    lib.wavio_read_batch.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(i64), ctypes.POINTER(i64),
                                     i64, fp, i64, i64]
    return lib


def available() -> bool:
    return get_lib() is not None


def _require() -> ctypes.CDLL:
    lib = get_lib()
    if lib is None:
        raise RuntimeError("no native wav reader: no C++ compiler found to build native/wavio.cpp (set CXX), "
                           "or its build failed")
    return lib


def read_window(path: str, start: int = 0, count: int = -1) -> np.ndarray:
    """Frames [start, start + count) of the first channel as float32 (to
    the end of the file when ``count`` < 0, or where the file ends first);
    PCM16/24/32 and float32 files, else IOError."""
    lib = _require()
    if count < 0:
        count = max(num_frames(path) - start, 0)
    out = np.empty(count, np.float32)
    got = lib.wavio_read_window(path.encode(), start, count, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if got < 0:
        raise IOError(f"wavio failed to read {path} (code {got})")
    return out[:got]


def num_frames(path: str) -> int:
    n = _require().wavio_num_frames(path.encode())
    if n < 0:
        raise IOError(f"wavio failed to parse {path} (code {n})")
    return int(n)


def read_batch(paths: Sequence[str], starts: Sequence[int], count: int, n_threads: int = 8) -> np.ndarray:
    """Read len(paths) windows of ``count`` frames in parallel -> [n, count]
    (a file that ends early is zero-filled)."""
    lib = _require()
    n = len(paths)
    out = np.empty((n, count), np.float32)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    c_starts = (ctypes.c_int64 * n)(*[int(s) for s in starts])
    c_counts = (ctypes.c_int64 * n)(*([count] * n))
    failures = lib.wavio_read_batch(c_paths, c_starts, c_counts, n,
                                    out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), count, n_threads)
    if failures:
        raise IOError(f"wavio batch read: {failures}/{n} files failed")
    return out
