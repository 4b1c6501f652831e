"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into a shared library with a
plain C interface, ``build/lib<name>-<hash>.so`` inside the package (the
directory is in ``.gitignore``), and loads with ``ctypes``. The build runs
at first use; the file name carries a hash of the source, the headers
beside it and the flags, so an edited source or header builds anew and an
unchanged one loads at once. Several
sources build in parallel, one ``nvcc`` each (:func:`build_all`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Dict, Iterable

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}
# ptxas report (registers, shared memory, spills) of each build
build_logs: Dict[str, str] = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the port's CUDA "
                           "kernels build on a machine with the CUDA toolkit")
    return found


def _lib_path(name: str) -> str:
    """The library's path: a hash of the source, of every header beside it
    (``csrc/*.cuh``, which a source may include) and of the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fname in [name + ".cu"] + headers:
        with open(os.path.join(CSRC, fname), "rb") as f:
            digest.update(fname.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def _start(name: str):
    """Start one nvcc; returns (process, temp output, final path) or None
    when the library is already built."""
    path = _lib_path(name)
    if os.path.exists(path):
        return None
    nvcc = nvcc_path()
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, path


def build_all(names: Iterable[str]) -> None:
    """Compile every named kernel that is not built yet, all at once."""
    jobs = {n: _start(n) for n in names}
    errors = []
    for name, job in jobs.items():
        if job is None:
            continue
        proc, tmp, path = job
        out, _ = proc.communicate()
        build_logs[name] = out
        if proc.returncode != 0:
            os.unlink(tmp)
            errors.append(f"nvcc failed for {name}.cu:\n{out}")
        else:
            os.replace(tmp, path)  # atomic: a reader never sees a partial file
    if errors:
        raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(_lib_path(name))
        _loaded[name] = lib
    return lib
