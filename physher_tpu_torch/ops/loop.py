"""Pruning likelihood and its gradient over a batch of chains through
hand-written CUDA loop kernels.

Port of ``physher_tpu/ops/pallas_pruning_loop.py``. The two TPU kernels
there, ``_kernel`` (``build_loop_forward``) and ``_backward_kernel``
(``build_loop_backward``), become kernels K5' and K6' of ``csrc/loop.cu``:
the flat postorder over nodes with any number of children, optional
rescaling, the root ``props . (freqs @ root)``, and a backward that gives
d pmats, d freqs and d props, for any state count S from 2 to 64: S = 4
takes the register kernels ``loop_forward_kernel`` /
``loop_backward_kernel``, every other S the shared-memory ones
``loop_wide_forward_kernel`` / ``loop_wide_backward_kernel`` (their node
steps ``csrc/wide_forward.cuh`` / ``csrc/wide_backward.cuh``, shared with
K7'/K8'; the forward launched as thread-block clusters of its C category
blocks). What the JAX
package got from ``jax.custom_batching.sequential_vmap`` is a leading batch
axis L here (one chain per grid row): ``pmats [L, N, C, S, S]``, ``freqs
[L, S]``, ``props [L, C]`` -> ``site_log [L, P]``, the tips ``[T, S, P]``
shared by every chain. Unbatched inputs (``pmats [N, C, S, S]``) give
``[P]``. The source note in ``csrc/loop.cu`` says what bounds them on the
card and what the design does about it.

- :func:`loop_site_log` / :func:`loop_tree_log_likelihood` are the entry
  points (the JAX signatures without ``block`` and ``interpret``). On a
  CUDA tensor they launch the kernels or raise; on a CPU tensor they run
  :func:`loop_site_log_reference`, the plain PyTorch version (the level-
  array engine of ``ops/pruning.py``).
- :func:`loop_forward` / :func:`loop_backward` are the launch wrappers;
  ``LOOP_FORWARD_LAUNCHES`` / ``LOOP_BACKWARD_LAUNCHES`` count their calls
  (one CUDA launch each, whatever L and S).
- The kernels are built at first use by ``nvcc`` (``ops/cuda_build.py``).
"""

from __future__ import annotations

import ctypes

import torch

from ..trees.heights import topo_constant
from ..trees.topology import Topology
from . import cuda_build
from .cuda_build import check, stream
from .pruning import rescaled_site_log

LOOP_FORWARD_LAUNCHES = 0
LOOP_BACKWARD_LAUNCHES = 0

# children per node (polytomies): the backward's per-warp reduction is
# [maxc, C, 16] scalars, 16 KB in float64 at C = 8
MAX_CHILDREN = 16
# patterns per block, one warp: at MCMC sizes (the fluA tree, 238 patterns)
# the grid is L x 8 blocks, 128 of the H100's 132 SMs at L = 16, where
# 128-pattern blocks would fill 32 (csrc/loop.cu)
BLOCK = 32
# patterns per block of the backward at S != 4 (4 tiles of 32; the grid is
# (blocks, C, L)): the per-block dP scratch [L, ceil(P / 128), N, C, S, S]
# is 240 MB in float32 at GY94 32 x 4096, L = 8, 208 MB at WAG+G4 64 x
# 8192, L = 4
WIDE_BACKWARD_BLOCK = 128
# CUDA's bound on gridDim.y, which carries the chains
MAX_CHAINS = 65535
# the state counts the kernels take: S = 4 in registers, any other S in
# shared memory (8 warps of 8 states each)
STATES = (2, 64)

_SOURCE = cuda_build.PKG / "csrc" / "loop.cu"

_lib = None
build_log = ""


def build() -> ctypes.CDLL:
    """Compile ``csrc/loop.cu`` (once per source hash) and load it."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    lib, build_log = cuda_build.build_library(_SOURCE)
    _lib = bind(lib)
    return _lib


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points' argument and result types on ``lib``."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for dt in ("f32", "f64"):
        fwd = getattr(lib, f"loop_forward_{dt}")
        fwd.argtypes = [ptr] * 8 + [i32] * 8 + [ptr]
        fwd.restype = i32
        bwd = getattr(lib, f"loop_backward_{dt}")
        bwd.argtypes = [ptr] * 12 + [i32] * 7 + [ptr]
        bwd.restype = i32
        wfwd = getattr(lib, f"loop_wide_forward_{dt}")
        wfwd.argtypes = [ptr] * 8 + [i32] * 8 + [ptr]
        wfwd.restype = i32
        wbwd = getattr(lib, f"loop_wide_backward_{dt}")
        wbwd.argtypes = [ptr] * 11 + [i32] * 7 + [ptr]
        wbwd.restype = i32
        occ = getattr(lib, f"loop_wide_forward_clusters_{dt}")
        occ.argtypes = [i32, i32, ctypes.POINTER(i32)]
        occ.restype = i32
    return lib


def _dims(tips, pmats, children, freqs, props):
    """Validate the kernels' inputs; returns (L, T, I, C, S, maxc, P)."""
    T, I, C, S, maxc, P = cuda_build.pruning_dims(
        "loop pruning", tips, pmats, children, None, states=STATES,
        max_children=MAX_CHILDREN, batched=True)
    L = pmats.shape[0]
    if not 1 <= L <= MAX_CHAINS:
        raise ValueError(f"{L} chains; the loop kernels take 1 to "
                         f"{MAX_CHAINS}")
    check("freqs", freqs, tips.device, tips.dtype, (L, S))
    check("props", props, tips.device, tips.dtype, (L, C))
    return L, T, I, C, S, maxc, P


def _entry(lib, name: str, tips):
    """The C entry point ``name`` for the tips' dtype."""
    return getattr(lib, name + ("_f32" if tips.dtype == torch.float32
                                else "_f64"))


def loop_forward(tips, pmats, children, freqs, props, rescale: bool = True):
    """Launch K5': returns (site_log [L, P], partials [L, I, C, S, P],
    scale [L, I, P])."""
    global LOOP_FORWARD_LAUNCHES
    L, T, I, C, S, maxc, P = _dims(tips, pmats, children, freqs, props)
    lib = build()
    partials = tips.new_empty((L, I, C, S, P))
    scale = tips.new_empty((L, I, P))
    site_log = tips.new_empty((L, P))
    ptrs = (tips.data_ptr(), pmats.data_ptr(), children.data_ptr(),
            freqs.data_ptr(), props.data_ptr(), partials.data_ptr(),
            scale.data_ptr(), site_log.data_ptr())
    with torch.cuda.device(tips.device):
        if S == 4:
            err = _entry(lib, "loop_forward", tips)(
                *ptrs, T, I, C, maxc, P, L, int(bool(rescale)), BLOCK,
                stream(tips))
        else:
            err = _entry(lib, "loop_wide_forward", tips)(
                *ptrs, T, I, C, S, maxc, P, L, int(bool(rescale)),
                stream(tips))
    LOOP_FORWARD_LAUNCHES += 1
    if err:
        raise RuntimeError(f"loop forward kernel launch failed: "
                           f"cudaError {err}")
    return site_log, partials, scale


def wide_forward_clusters(dtype, S: int, C: int) -> int:
    """The most clusters of K5' at S != 4 (one per pattern block and chain,
    C blocks each) that the current card keeps resident at once."""
    return cuda_build.cluster_occupancy(build(), "loop_wide_forward_clusters",
                                        dtype, S, C)


def loop_backward(tips, pmats, children, freqs, props, partials, scale, g):
    """Launch K6': returns (d pmats [L, N, C, S, S], d freqs [L, S],
    d props [L, C])."""
    global LOOP_BACKWARD_LAUNCHES
    L, T, I, C, S, maxc, P = _dims(tips, pmats, children, freqs, props)
    check("partials", partials, tips.device, tips.dtype, (L, I, C, S, P))
    check("scale", scale, tips.device, tips.dtype, (L, I, P))
    check("g", g, tips.device, tips.dtype, (L, P))
    lib = build()
    N = T + I
    n_blocks = -(-P // (BLOCK if S == 4 else WIDE_BACKWARD_BLOCK))
    gbuf = tips.new_empty((L, I, C, S, P))
    dP_part = tips.new_empty((L, n_blocks, N, C, S * S))
    dP_part[:, :, N - 1].zero_()  # the root is no node's child
    ptrs = (tips.data_ptr(), pmats.data_ptr(), children.data_ptr(),
            freqs.data_ptr(), props.data_ptr(), partials.data_ptr(),
            scale.data_ptr(), g.data_ptr(), gbuf.data_ptr(),
            dP_part.data_ptr())
    with torch.cuda.device(tips.device):
        if S == 4:
            dfreqs_part = tips.new_empty((L, n_blocks, 4))
            dprops_part = tips.new_empty((L, n_blocks, C))
            err = _entry(lib, "loop_backward", tips)(
                *ptrs, dfreqs_part.data_ptr(), dprops_part.data_ptr(), T, I,
                C, maxc, P, L, BLOCK, stream(tips))
        else:
            drootw_part = tips.new_empty((L, n_blocks, C, S))
            err = _entry(lib, "loop_wide_backward", tips)(
                *ptrs, drootw_part.data_ptr(), T, I, C, S, maxc, P, L,
                stream(tips))
    LOOP_BACKWARD_LAUNCHES += 1
    if err:
        raise RuntimeError(f"loop backward kernel launch failed: "
                           f"cudaError {err}")
    # deterministic second pass over the per-block partial sums
    dP = dP_part.sum(1).view(L, N, C, S, S)
    if S == 4:
        return dP, dfreqs_part.sum(1), dprops_part.sum(1)
    # d rootw -> d freqs, d props through rootw = props (x) freqs
    drootw = drootw_part.sum(1)
    return (dP, (props[:, :, None] * drootw).sum(1),
            (freqs[:, None, :] * drootw).sum(2))


class _LoopSiteLog(torch.autograd.Function):
    """site_log [L, P] = K5'(tips, pmats, freqs, props); the backward is
    K6', which reads the forward's partials and scalers."""

    @staticmethod
    def forward(ctx, tips, pmats, freqs, props, children, rescale):
        site_log, partials, scale = loop_forward(tips, pmats, children, freqs,
                                                 props, rescale)
        ctx.save_for_backward(tips, pmats, freqs, props, children, partials,
                              scale)
        return site_log

    @staticmethod
    def backward(ctx, g):
        tips, pmats, freqs, props, children, partials, scale = \
            ctx.saved_tensors
        dP, dfreqs, dprops = loop_backward(tips, pmats, children, freqs,
                                           props, partials, scale,
                                           g.contiguous())
        return None, dP, dfreqs, dprops, None, None


# the plain PyTorch version of K5'/K6''s function (ops/pruning.py)
loop_site_log_reference = rescaled_site_log


def loop_site_log(topo: Topology, rescale: bool, tip_partials, pmats, freqs,
                  props):
    """Per-pattern site log-likelihoods, ``[L, P]`` for ``pmats [L, N, C, S,
    S]``, ``freqs [L, S]``, ``props [L, C]`` (``[P]`` unbatched),
    differentiable w.r.t. pmats/freqs/props (tips are constants). CUDA
    tensors go through K5'/K6' (or raise); CPU tensors through the plain
    version."""
    if tip_partials.device.type == "cpu":
        return loop_site_log_reference(tip_partials, pmats, topo, freqs,
                                       props, rescale=rescale)
    children = topo_constant(topo, "children", lambda: topo.children,
                             tip_partials, torch.int32)
    batched = pmats.dim() == 5
    if not batched:
        pmats, freqs, props = pmats[None], freqs[None], props[None]
    site = _LoopSiteLog.apply(tip_partials.detach().contiguous(),
                              pmats.contiguous(), freqs.contiguous(),
                              props.contiguous(), children, bool(rescale))
    return site if batched else site[0]


def loop_tree_log_likelihood(tip_partials, pmats, topo: Topology, freqs,
                             props, weights, *, rescale: bool = True):
    """(logL [(L)], site_log [(L,) P]) through the loop kernels."""
    site_log = loop_site_log(topo, rescale, tip_partials, pmats, freqs,
                             props)
    return torch.sum(weights * site_log, -1), site_log
