"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C function and compiles on its own
into ``build/lib<name>-<hash>.so`` inside this package, at first use. The
hash covers the sources and the flags, so an edited kernel rebuilds and an
unchanged one loads from the build directory. No PyTorch headers are
involved: a file builds in seconds, where PyTorch's extension builder
takes minutes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()  # guards _locks
_locks: Dict[str, threading.Lock] = {}  # one per kernel: builds run in parallel
_libs: Dict[str, ctypes.CDLL] = {}
# compiler output per kernel built by this process (ptxas registers,
# shared memory and spills)
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found on PATH or under $CUDA_HOME/bin: the CUDA kernels"
        " of whisper_nemo_tpu_torch build from source at first use"
    )


def _build(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    digest.update(src.read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.read_bytes())
    out = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
    build_logs[name] = proc.stdout + proc.stderr
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """The shared library of ``csrc/<name>.cu``, built if needed. Loads of
    different kernels may run in parallel threads."""
    with _lock:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(str(_build(name)))
        return lib


def stream(device) -> int:
    """The raw pointer of PyTorch's current stream on a CUDA ``device``
    (``torch.cuda.current_stream(device).cuda_stream`` without building
    a Stream object: a few microseconds less per launch)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def check(rc: int, what: str) -> None:
    """Raise if a launcher returned a non-zero cudaError_t."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
