"""Build and load the port's CUDA sources, and check what their kernels get.

Each ``csrc/*.cu`` file has a plain C interface. :func:`build_library`
compiles one with ``nvcc`` for ``sm_90a`` into ``_build/`` (the file name
keyed on a hash of the source, the ``csrc/*.cuh`` headers and the flags, so
a changed source is rebuilt and an unchanged one is not), and loads it with
ctypes. Nothing is built when a module is imported: the wrappers call it at
their first launch.

:func:`pruning_dims` checks the inputs that the pruning kernel pairs
(``ops/fused.py``, ``ops/staged.py``, ``ops/wide.py``, ``ops/loop.py``)
share, and
:func:`level_schedule` is the tree-level schedule that the staged and wide
pairs launch by.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np
import torch

from ..trees.heights import topo_constant
from ..trees.topology import Topology

PKG = Path(__file__).resolve().parent.parent
BUILD_DIR = PKG / "_build"
# rate categories that every pruning kernel takes (their C template values)
MAX_CATEGORIES = 8
# CUDA's bound on gridDim.y and gridDim.z, which carry the nodes of one level
MAX_LEVEL_NODES = 65535
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
    # the headers beside it (csrc/*.cuh), which it may include, are part of
    # what is built
    src = source.read_bytes() + b"".join(
        h.read_bytes() for h in sorted(source.parent.glob("*.cuh")))
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


def cluster_occupancy(lib: ctypes.CDLL, entry: str, dtype, S: int,
                      C: int) -> int:
    """``lib``'s ``entry`` (``_f32`` or ``_f64`` by ``dtype``): the most
    thread-block clusters of C blocks of a forward kernel at S states that
    the current card keeps resident at once."""
    n = ctypes.c_int(0)
    fn = getattr(lib, entry + ("_f32" if dtype == torch.float32 else "_f64"))
    err = fn(S, C, ctypes.byref(n))
    if err:
        raise RuntimeError(f"{entry} failed: cudaError {err}")
    return n.value


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


def level_schedule(topo: Topology, like: torch.Tensor):
    """(nodes, offsets): the internal ranks level by level, leaves first, as
    an int32 tensor on ``like``'s device, and the level boundaries."""
    levels = topo.levels
    offsets = tuple(int(x) for x in np.cumsum([0] + [len(lv) for lv in levels]))
    nodes = topo_constant(topo, "level_nodes",
                          lambda: np.concatenate(levels), like, torch.int32)
    return nodes, offsets


def offsets_arg(schedule):
    """(the level offsets as a C int array, the number of levels)."""
    offsets = schedule[1]
    return (ctypes.c_int * len(offsets))(*offsets), len(offsets) - 1


def pruning_dims(kernels: str, tips, pmats, children, rootw, *,
                 states=(4, 4), max_children=None, schedule=None,
                 root_alone=False, batched=False):
    """Validate a pruning kernel pair's common inputs; returns
    (T, I, C, S, maxc, P).

    tips [T, S, P] with ``states[0] <= S <= states[1]``, pmats [N, C, S, S]
    (``[L, N, C, S, S]`` if ``batched``), children [I, maxc] (int32, maxc at
    most ``max_children`` if given) and rootw [C * S] (unless None),
    contiguous on one CUDA device in float32 or float64; and the level
    ``schedule`` (nodes, offsets) if given, whose last level holds the root
    alone if ``root_alone``. ``kernels`` names the pair in the messages."""
    if tips.device.type != "cuda":
        raise ValueError(f"the CUDA {kernels} kernels need CUDA tensors, "
                         f"got {tips.device}")
    if tips.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"unsupported dtype {tips.dtype}")
    if tips.dim() != 3:
        raise ValueError(f"tips must be [T, S, P], got {tuple(tips.shape)}")
    T, S, P = tips.shape
    if not states[0] <= S <= states[1]:
        raise ValueError(f"{S} states; the {kernels} kernels take "
                         f"{states[0]} to {states[1]}")
    I, maxc = children.shape
    if max_children is not None and not 1 <= maxc <= max_children:
        raise ValueError(f"{maxc} children per node; the {kernels} kernels "
                         f"take 1 to {max_children}")
    if pmats.dim() != 4 + batched:
        raise ValueError(f"pmats must be {'[L, ' if batched else '['}"
                         f"N, C, S, S], got {tuple(pmats.shape)}")
    C = pmats.shape[-3]
    if not 1 <= C <= MAX_CATEGORIES:
        raise ValueError(f"{C} rate categories; the kernels take 1 to "
                         f"{MAX_CATEGORIES}")
    dev, dt = tips.device, tips.dtype
    check("tips", tips, dev, dt, (T, S, P))
    check("pmats", pmats, dev, dt,
          tuple(pmats.shape[:1]) * batched + (T + I, C, S, S))
    check("children", children, dev, torch.int32, (I, maxc))
    if rootw is not None:
        check("rootw", rootw, dev, dt, (C * S,))
    if schedule is not None:
        nodes, offsets = schedule
        check("nodes", nodes, dev, torch.int32, (I,))
        sizes = [b - a for a, b in zip(offsets[:-1], offsets[1:])]
        if offsets[0] != 0 or offsets[-1] != I or min(sizes) < 1:
            raise ValueError(f"level offsets {offsets} do not split {I} "
                             f"nodes")
        if max(sizes) > MAX_LEVEL_NODES:
            raise ValueError(f"a level of {max(sizes)} nodes; the kernels "
                             f"take at most {MAX_LEVEL_NODES}")
        if root_alone and sizes[-1] != 1:
            raise ValueError("the last level must hold the root alone")
    return T, I, C, S, maxc, P
