"""The native (C++) episodic index sampler of the host samplers, by ctypes.

``episodic_sampler.cpp`` is a byte-for-byte copy of the JAX package's
``fumi_tpu/native/episodic_sampler.cpp`` (``tests/test_torch_host_sampler.py``
pins it): per-episode class picks and in-class positions from
xoshiro256** streams addressed by ``(seed, counter)``, and a float32 row
gather. It builds at first use with ``g++ -O3 -shared -fPIC`` into the
package's git-ignored ``build/`` directory, under a name that carries a
hash of the source and the flags (as ``ops/_build.py`` names the CUDA
libraries), so an edited source builds anew and processes that build at
once never see a partial file. :func:`load` returns None where ``g++`` is
missing or the build fails; the host samplers then fall back to numpy
(``backend="auto"``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_DIR, "episodic_sampler.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "build")
GXX_FLAGS = ("-O3", "-shared", "-fPIC")
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def lib_path() -> str:
    """The library's path: a hash of the source and the flags."""
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR,
                        f"libepisodic-{digest.hexdigest()[:16]}.so")


def _build() -> Optional[str]:
    out = lib_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *GXX_FLAGS, SOURCE, "-o", tmp], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, out)  # atomic: a reader never sees a partial file
        return out
    except (OSError, subprocess.SubprocessError):
        if os.path.exists(tmp):
            os.unlink(tmp)
        return None


def load() -> Optional[ctypes.CDLL]:
    """The native library, built at first use, or None where it cannot be
    built (the samplers fall back to numpy)."""
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        path = _build()
        if path is None:
            return None
        lib = ctypes.CDLL(path)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.sample_episodes.restype = ctypes.c_int
        lib.sample_episodes.argtypes = [
            ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int32, i32p,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, i32p, i32p]
        lib.gather_rows_f32.restype = None
        lib.gather_rows_f32.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, i32p,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_float)]
        _LIB = lib
        return _LIB


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def sample_episodes_native(lib, seed: int, counter: int, counts,
                           B: int, N: int, KQ: int):
    """Episode ``counter`` of stream ``seed``: ``(class_idx (B, N), sel
    (B, N, KQ))`` int32, N distinct classes a task and KQ distinct
    in-class positions a class."""
    counts = np.ascontiguousarray(counts, dtype=np.int32)
    class_idx = np.empty((B, N), dtype=np.int32)
    sel = np.empty((B, N, KQ), dtype=np.int32)
    rc = lib.sample_episodes(
        ctypes.c_uint64(seed), ctypes.c_uint64(counter),
        ctypes.c_int32(len(counts)), _ptr(counts, ctypes.c_int32),
        ctypes.c_int32(B), ctypes.c_int32(N), ctypes.c_int32(KQ),
        _ptr(class_idx, ctypes.c_int32), _ptr(sel, ctypes.c_int32))
    if rc == -1:
        raise ValueError("N exceeds number of classes")
    if rc == -2:
        raise ValueError("a sampled class has fewer than K+Q images")
    return class_idx, sel


def gather_rows_native(lib, table, rows):
    """``table[rows]`` of a float32 (R, D) table by a memcpy loop."""
    table = np.ascontiguousarray(table, dtype=np.float32)
    rows = np.ascontiguousarray(rows, dtype=np.int32).reshape(-1)
    out = np.empty((rows.shape[0], table.shape[1]), dtype=np.float32)
    lib.gather_rows_f32(_ptr(table, ctypes.c_float),
                        ctypes.c_int64(table.shape[1]),
                        _ptr(rows, ctypes.c_int32),
                        ctypes.c_int64(rows.shape[0]),
                        _ptr(out, ctypes.c_float))
    return out
