"""Build and load the port's CUDA sources, and check what their kernels get.

Each ``csrc/*.cu`` file has a plain C interface. :func:`build_library`
compiles one with ``nvcc`` for ``sm_90a`` into ``_build/`` (the file name
keyed on a hash of the source and the flags, so a changed source is rebuilt
and an unchanged one is not), and loads it with ctypes. Nothing is built
when a module is imported: the wrappers call it at their first launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import torch

PKG = Path(__file__).resolve().parent.parent
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    # PyTorch's own lookup: $CUDA_HOME / $CUDA_PATH, nvcc on PATH, then the
    # toolkit's default install location
    from torch.utils.cpp_extension import CUDA_HOME

    path = os.path.join(CUDA_HOME or "", "bin", "nvcc")
    if not CUDA_HOME or not os.path.exists(path):
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return path


def build_library(source: Path) -> tuple[ctypes.CDLL, str]:
    """Compile ``source`` (once per source hash) and load it; returns the
    library and nvcc's output (empty when the library was already built)."""
    src = source.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    out = BUILD_DIR / f"lib{source.stem}-{digest[:16]}.so"
    log = ""
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {source.name} ({r.returncode}):\n"
                f"{r.stdout}\n{r.stderr}")
        log = r.stdout + r.stderr
        os.replace(tmp, out)
    return ctypes.CDLL(str(out)), log


def check(name: str, t: torch.Tensor, device, dtype, shape) -> None:
    """Raise ValueError unless ``t`` has this device, dtype and shape and
    is contiguous."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def stream(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, as the kernels take it."""
    return torch.cuda.current_stream(t.device).cuda_stream
