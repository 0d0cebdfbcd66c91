"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` compiles with nvcc into its own shared library with
a plain C interface, loaded with ctypes. Nothing includes PyTorch's
headers, so a build takes seconds. Libraries live under
`nerfail_tpu_torch/_build/`, named by a hash of their source and the
flags, so a changed source rebuilds and an unchanged one is reused.

Nothing is compiled at import: `load(name)` builds on first use, and
`build_all()` starts one nvcc per source at once and waits for all of
them. A failed build raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("knn", "segsum", "segsum_sq", "nerf_mlp")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _lib_path(name: str) -> str:
    src = os.path.join(CSRC, f"{name}.cu")
    h = hashlib.sha256()
    with open(src, "rb") as f:
        h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def _start(name: str):
    """Start nvcc for one source; None if its library is already built."""
    out = _lib_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return name, proc, tmp, out


def _finish(job) -> str:
    name, proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)          # atomic: a reader sees all or nothing
    return log


def build_all(names=SOURCES) -> Dict[str, str]:
    """Compile every named source in parallel; returns nvcc's log per
    source that was built now (ptxas register and spill counts)."""
    jobs: List = [j for j in (_start(n) for n in names) if j is not None]
    logs = {}
    try:
        for job in jobs:
            logs[job[0]] = _finish(job)
    finally:
        for job in jobs:
            if job[1].poll() is None:
                job[1].kill()
                job[1].wait()
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build_all((name,))
            lib = ctypes.CDLL(_lib_path(name))
            _LIBS[name] = lib
        return lib


def check(status: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch function."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status}")
