"""Pruning likelihood and its gradient for wide state spaces (codon, protein)
through hand-written CUDA kernels.

Port of ``physher_tpu/ops/pallas_wide.py``. The two TPU kernels there,
``_fwd_kernel`` (``build_wide_forward``) and ``_bwd_kernel``
(``build_wide_backward``), become kernels K7' and K8' of ``csrc/wide.cu``:
the same function as ``ops/fused.py`` (the rescaled postorder sweep to
per-pattern site log-likelihoods, and its reverse sweep to d pmats and
d (props x freqs)) for any state count from 2 to 64, one launch per level
of the postorder. The source note in ``csrc/wide.cu`` says what bounds them
on the card and what the design does about it.

- :func:`wide_site_log` / :func:`wide_tree_log_likelihood` are the entry
  points (the JAX signatures without ``B``, ``G`` and ``interpret``). On a
  CUDA tensor they launch the kernels or raise; on a CPU tensor they run
  :func:`wide_site_log_reference`, the plain PyTorch version.
- :func:`wide_forward` / :func:`wide_backward` are the launch wrappers.
  ``WIDE_FORWARD_LAUNCHES`` / ``WIDE_BACKWARD_LAUNCHES`` count their calls:
  one forward sweep is ``len(topo.levels) + 1`` CUDA launches, one reverse
  sweep as many.
- The kernels are built at first use by ``nvcc`` (``ops/cuda_build.py``).
"""

from __future__ import annotations

import ctypes

import torch

from ..trees.heights import topo_constant
from ..trees.topology import Topology
from ..utils.profiling import spanned
from . import cuda_build
from .cuda_build import check, level_schedule, offsets_arg, stream
from .pruning import rescaled_site_log

WIDE_FORWARD_LAUNCHES = 0
WIDE_BACKWARD_LAUNCHES = 0

MIN_STATES, MAX_STATES = 2, 64
# patterns per backward block (csrc/wide.cu BWD_P): the block axis of the
# per-block dP and d rootw partial sums
BWD_PATTERNS = 128

_SOURCE = cuda_build.PKG / "csrc" / "wide.cu"

_lib = None
build_log = ""


def build() -> ctypes.CDLL:
    """Compile ``csrc/wide.cu`` (once per source hash) and load it."""
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
        fwd = getattr(lib, f"wide_forward_{dt}")
        fwd.argtypes = [ptr] * 5 + [i32] + [ptr] * 4 + [i32] * 6 + [ptr]
        fwd.restype = i32
        bwd = getattr(lib, f"wide_backward_{dt}")
        bwd.argtypes = [ptr] * 5 + [i32] + [ptr] * 7 + [i32] * 6 + [ptr]
        bwd.restype = i32
        occ = getattr(lib, f"wide_forward_clusters_{dt}")
        occ.argtypes = [i32, i32, ctypes.POINTER(i32)]
        occ.restype = i32
    return lib


def _dims(tips, pmats, children, rootw, schedule):
    """Validate the kernels' inputs; returns (T, I, C, S, maxc, P)."""
    return cuda_build.pruning_dims("wide pruning", tips, pmats, children,
                                   rootw, states=(MIN_STATES, MAX_STATES),
                                   schedule=schedule)


@spanned("physher.ops.wide.forward")
def wide_forward(tips, pmats, children, rootw, schedule):
    """Launch K7' (one launch per level, then the root): returns
    (site_log [P], partials [I, C, S, P], scale [I, P])."""
    global WIDE_FORWARD_LAUNCHES
    T, I, C, S, maxc, P = _dims(tips, pmats, children, rootw, schedule)
    lib = build()
    partials = tips.new_empty((I, C, S, P))
    scale = tips.new_empty((I, P))
    site_log = tips.new_empty((P,))
    offsets, n_levels = offsets_arg(schedule)
    fn = (lib.wide_forward_f32 if tips.dtype == torch.float32
          else lib.wide_forward_f64)
    with torch.cuda.device(tips.device):
        err = fn(tips.data_ptr(), pmats.data_ptr(), children.data_ptr(),
                 schedule[0].data_ptr(), offsets, n_levels, rootw.data_ptr(),
                 partials.data_ptr(), scale.data_ptr(), site_log.data_ptr(),
                 T, I, C, S, maxc, P, stream(tips))
    WIDE_FORWARD_LAUNCHES += 1
    if err:
        raise RuntimeError(f"wide forward kernel launch failed: "
                           f"cudaError {err}")
    return site_log, partials, scale


def forward_clusters(dtype, S: int, C: int) -> int:
    """The most clusters of K7''s level kernel (C blocks each) that the
    current card keeps resident at once."""
    return cuda_build.cluster_occupancy(build(), "wide_forward_clusters",
                                        dtype, S, C)


@spanned("physher.ops.wide.backward")
def wide_backward(tips, pmats, children, rootw, schedule, partials, scale, g):
    """Launch K8' (the root seed, then one launch per level, root first, its
    grid (pattern blocks, C, nodes of the level)): returns (d pmats [N, C,
    S, S], d rootw [C * S])."""
    global WIDE_BACKWARD_LAUNCHES
    T, I, C, S, maxc, P = _dims(tips, pmats, children, rootw, schedule)
    check("partials", partials, tips.device, tips.dtype, (I, C, S, P))
    check("scale", scale, tips.device, tips.dtype, (I, P))
    check("g", g, tips.device, tips.dtype, (P,))
    lib = build()
    N = T + I
    n_blocks = -(-P // BWD_PATTERNS)
    gbuf = tips.new_empty((I, C, S, P))
    dP_part = tips.new_empty((n_blocks, N, C, S, S))
    drootw_part = tips.new_empty((n_blocks, C * S))
    offsets, n_levels = offsets_arg(schedule)
    fn = (lib.wide_backward_f32 if tips.dtype == torch.float32
          else lib.wide_backward_f64)
    with torch.cuda.device(tips.device):
        err = fn(tips.data_ptr(), pmats.data_ptr(), children.data_ptr(),
                 schedule[0].data_ptr(), offsets, n_levels, rootw.data_ptr(),
                 partials.data_ptr(), scale.data_ptr(), g.data_ptr(),
                 gbuf.data_ptr(), dP_part.data_ptr(), drootw_part.data_ptr(),
                 T, I, C, S, maxc, P, stream(tips))
    WIDE_BACKWARD_LAUNCHES += 1
    if err:
        raise RuntimeError(f"wide backward kernel launch failed: "
                           f"cudaError {err}")
    # deterministic second pass over the per-block partial sums
    return dP_part.sum(0), drootw_part.sum(0)


class _WideSiteLog(torch.autograd.Function):
    """site_log = K7'(tips, pmats, rootw); the backward is K8'. The
    forward's rescaled partials and scalers are kept for it."""

    @staticmethod
    def forward(ctx, tips, pmats, rootw, children, nodes, offsets):
        schedule = (nodes, offsets)
        site_log, partials, scale = wide_forward(tips, pmats, children,
                                                 rootw, schedule)
        ctx.save_for_backward(tips, pmats, rootw, children, nodes, partials,
                              scale)
        ctx.offsets = offsets
        return site_log

    @staticmethod
    def backward(ctx, g):
        tips, pmats, rootw, children, nodes, partials, scale = \
            ctx.saved_tensors
        dP, drootw = wide_backward(tips, pmats, children, rootw,
                                   (nodes, ctx.offsets), partials, scale,
                                   g.contiguous())
        return None, dP, drootw, None, None, None


# the plain PyTorch version of the kernels' function (ops/pruning.py)
wide_site_log_reference = rescaled_site_log


def wide_site_log(tip_partials, pmats, topo: Topology, freqs, props):
    """Per-pattern site log-likelihoods [P], differentiable w.r.t.
    pmats/freqs/props (tips are constants). CUDA tensors go through the
    kernels (or raise); CPU tensors through the plain version."""
    if tip_partials.device.type == "cpu":
        return wide_site_log_reference(tip_partials, pmats, topo, freqs,
                                       props)
    children = topo_constant(topo, "children", lambda: topo.children,
                             tip_partials, torch.int32)
    nodes, offsets = level_schedule(topo, tip_partials)
    # rootw = props (x) freqs in torch: autograd maps d rootw to d props
    # and d freqs
    rootw = (props[:, None] * freqs[None, :]).reshape(-1)
    return _WideSiteLog.apply(tip_partials.detach().contiguous(),
                              pmats.contiguous(), rootw.contiguous(),
                              children, nodes, offsets)


def wide_tree_log_likelihood(tip_partials, pmats, topo: Topology, freqs,
                             props, weights, *, rescale: bool = True):
    """(logL, site_log). ``rescale`` is accepted for engine-API
    compatibility; the kernels always rescale (exact)."""
    site_log = wide_site_log(tip_partials, pmats, topo, freqs, props)
    return torch.sum(weights * site_log), site_log
