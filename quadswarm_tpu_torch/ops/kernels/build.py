"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each source under `quadswarm_tpu_torch/csrc/` has a plain C interface and
compiles on its own into a shared library, named after a hash of the
source and the flags, under `quadswarm_tpu_torch/csrc/build/` (listed in
.gitignore).  A library already built from the same source is reused.
Nothing here runs at import time: the first launch builds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_LOADED: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA kernels are built with nvcc "
                       "for sm_90a on a machine with the CUDA toolkit")


def library_path(source: str) -> Path:
    src = CSRC / source
    digest = hashlib.sha1(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}_{digest.hexdigest()[:12]}.so"


def build(source: str, log: list | None = None) -> Path:
    """Compile csrc/<source> unless an up-to-date library exists.  With a
    `log` list, ptxas's register and memory report is appended to it."""
    out = library_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC / source)]
    if log is not None:
        cmd.insert(1, "-Xptxas=-v")
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {source}:\n{proc.stderr}")
        if log is not None:
            log.extend(proc.stderr.strip().splitlines())
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def load(source: str) -> ctypes.CDLL:
    """The loaded library of csrc/<source>, building it on first use."""
    if source not in _LOADED:
        _LOADED[source] = ctypes.CDLL(str(build(source)))
    return _LOADED[source]


def current_stream(device: torch.device) -> int:
    """The handle of PyTorch's current CUDA stream on `device`, as the
    integer a kernel's entry point takes.  Read through the private
    `torch._C._cuda_getCurrentRawStream`, which builds no Stream object;
    `torch.cuda.current_stream(device).cuda_stream` is the public way to
    the same handle, should a PyTorch release drop the private name."""
    index = device.index
    if index is None:
        index = torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


def check_tensor(name: str, t: torch.Tensor, shape: tuple, dtype,
                 device) -> None:
    """Raise unless `t` is what a kernel takes: on `device`, of `dtype`, of
    `shape`, contiguous."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")
