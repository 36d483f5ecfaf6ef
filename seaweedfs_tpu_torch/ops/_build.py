"""Build and load the port's CUDA kernels on first use.

Each kernel source under csrc/ is compiled by nvcc into a shared library
with a plain C interface and loaded through ctypes; nothing includes
PyTorch's headers, so a build takes seconds. Libraries land in
seaweedfs_tpu_torch/ops/build/ (listed in .gitignore), named by a hash of
the source, the shared headers and the flags, so an edited source rebuilds
and an unchanged one loads the library already there. Separate sources
build independently: call build() for each from its own thread to run the
nvcc processes at once.

Importing this module needs no nvcc, no CUDA and no GPU: only a call to
load_library() builds. A missing nvcc raises; it is never a reason to run
something else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # each kernel's registers, spills and shared memory
)

NVCC_DEFAULT = "/usr/local/cuda/bin/nvcc"

_LOCK = threading.Lock()
_LIBS: dict = {}
# seconds each library took to build in this process (0.0 when loaded from
# an earlier build), and what nvcc printed (ptxas's per-kernel report); read
# by chip_smoke.py
BUILD_SECONDS: dict = {}
BUILD_LOGS: dict = {}


def find_nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda/bin."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append(NVCC_DEFAULT)
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin): the CUDA kernels cannot be built"
    )


def library_path(name: str) -> str:
    """Where the library for csrc/<name>.cu goes, keyed by its source, the
    csrc/ headers (*.cuh, which sources share) and the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for fn in [name + ".cu", *headers]:
        with open(os.path.join(CSRC_DIR, fn), "rb") as f:
            digest.update(fn.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build(name: str) -> str:
    """Compile csrc/<name>.cu unless its library exists; returns the path.
    The output is written to a temporary name and renamed into place, so
    a concurrent build never loads a half-written library."""
    out = library_path(name)
    if os.path.exists(out):
        BUILD_SECONDS.setdefault(name, 0.0)
        return out
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=f".lib{name}-", suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, name + ".cu")]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {name}.cu (exit {proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, out)
        BUILD_LOGS[name] = proc.stdout + proc.stderr
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    BUILD_SECONDS[name] = time.perf_counter() - t0
    return out


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu's library, once per process."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            _LIBS[name] = lib
        return lib
