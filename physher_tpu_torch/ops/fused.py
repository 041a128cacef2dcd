"""Pruning likelihood and its gradient through hand-written CUDA kernels.

Port of ``physher_tpu/ops/pallas_fused.py``. The two TPU kernels there,
``_fused_fwd_kernel`` (``build_fused_forward``) and ``_fused_bwd_kernel``
(``build_fused_backward``), become kernel F and kernel B of
``csrc/pruning.cu``: the same function (the rescaled postorder sweep to
per-pattern site log-likelihoods, and its reverse sweep to d pmats and
d (props x freqs)), but not the TPU layout. F is the S = 4 forward step of
``csrc/s4_forward.cuh`` (a walk by postorder level, which K5' at S = 4
shares), B the S = 4 reverse step of ``csrc/s4_backward.cuh`` (a walk by
preorder level and a dP pass, which K6' at S = 4 shares), each at one
chain. The source notes in ``csrc/pruning.cu`` and the headers say what
bounds them on the card and what the design does about it.

- :func:`fused_site_log` / :func:`fused_tree_log_likelihood` are the entry
  points (the JAX signatures without ``B``, ``tile`` and ``interpret``). On
  a CUDA tensor they launch the kernels or raise; on a CPU tensor they run
  :func:`fused_site_log_reference`, the plain PyTorch version.
- :func:`pruning_forward` / :func:`pruning_backward` are the launch
  wrappers; they take the walks' schedules
  (``cuda_build.postorder_schedule`` / ``preorder_schedule``).
- The kernels are built at first use by ``nvcc`` from the package's own
  sources into ``_build/`` (keyed on a hash of the sources and flags), and
  loaded with ctypes. Nothing is built when the module is imported.
- ``FORWARD_LAUNCHES`` / ``BACKWARD_LAUNCHES`` count the wrappers' calls:
  one CUDA launch for F, two for B (the walk and the dP pass).
"""

from __future__ import annotations

import ctypes

import torch

from ..trees.heights import topo_constant
from ..trees.topology import Topology
from . import cuda_build
from .cuda_build import check as _check, stream as _stream
from .pruning import rescaled_site_log

FORWARD_LAUNCHES = 0
BACKWARD_LAUNCHES = 0

_SOURCE = cuda_build.PKG / "csrc" / "pruning.cu"

_lib = None
build_log = ""


def build() -> ctypes.CDLL:
    """Compile ``csrc/pruning.cu`` (once per source hash) and load it."""
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
        fwd = getattr(lib, f"pruning_forward_{dt}")
        fwd.argtypes = [ptr] * 9 + [i32] * 6 + [ptr]
        fwd.restype = i32
        bwd = getattr(lib, f"pruning_backward_{dt}")
        bwd.argtypes = [ptr] * 13 + [i32] * 7 + [ptr]
        bwd.restype = i32
    return lib


def _dims(tips, pmats, children, rootw):
    """Validate the kernels' inputs; returns (T, I, C, maxc, P)."""
    T, I, C, _, maxc, P = cuda_build.pruning_dims("pruning", tips, pmats,
                                                  children, rootw)
    return T, I, C, maxc, P


def pruning_forward(tips, pmats, children, rootw, schedule):
    """Launch kernel F by ``schedule``, the (order, offsets) of
    ``cuda_build.postorder_schedule``: returns (site_log [P], partials
    [I, C, 4, P], scale [I, P])."""
    global FORWARD_LAUNCHES
    T, I, C, maxc, P = _dims(tips, pmats, children, rootw)
    n_levels = cuda_build.check_schedule(schedule, tips.device, I)
    order, offsets = schedule
    lib = build()
    partials = tips.new_empty((I, C, 4, P))
    scale = tips.new_empty((I, P))
    site_log = tips.new_empty((P,))
    fn = (lib.pruning_forward_f32 if tips.dtype == torch.float32
          else lib.pruning_forward_f64)
    with torch.cuda.device(tips.device):
        err = fn(tips.data_ptr(), pmats.data_ptr(), children.data_ptr(),
                 order.data_ptr(), offsets.data_ptr(), rootw.data_ptr(),
                 partials.data_ptr(), scale.data_ptr(), site_log.data_ptr(),
                 n_levels, T, I, C, maxc, P, _stream(tips))
    FORWARD_LAUNCHES += 1
    if err:
        raise RuntimeError(f"pruning forward kernel launch failed: "
                           f"cudaError {err}")
    return site_log, partials, scale


def pruning_backward(tips, pmats, children, rootw, schedule, partials,
                     scale, g):
    """Launch kernel B (the walk and the dP pass of
    ``csrc/s4_backward.cuh``, one wrapper call) by ``schedule``, the
    (order, offsets) of ``cuda_build.preorder_schedule``: returns (d pmats
    [N, C, 4, 4], d rootw [C * 4])."""
    global BACKWARD_LAUNCHES
    T, I, C, maxc, P = _dims(tips, pmats, children, rootw)
    _check("partials", partials, tips.device, tips.dtype, (I, C, 4, P))
    _check("scale", scale, tips.device, tips.dtype, (I, P))
    _check("g", g, tips.device, tips.dtype, (P,))
    n_levels = cuda_build.check_schedule(schedule, tips.device, I)
    order, offsets = schedule
    lib = build()
    N = T + I
    nq = -(-P // cuda_build.S4_DP_CHUNK)
    gbuf = tips.new_empty((I, C, 4, P))
    inv = tips.new_empty((P,))
    dP_part = tips.new_empty((nq, N, C, 16))
    drootw_part = tips.new_empty((nq, C * 4))
    fn = (lib.pruning_backward_f32 if tips.dtype == torch.float32
          else lib.pruning_backward_f64)
    with torch.cuda.device(tips.device):
        err = fn(tips.data_ptr(), pmats.data_ptr(), children.data_ptr(),
                 order.data_ptr(), offsets.data_ptr(), rootw.data_ptr(),
                 partials.data_ptr(), scale.data_ptr(), g.data_ptr(),
                 gbuf.data_ptr(), inv.data_ptr(), dP_part.data_ptr(),
                 drootw_part.data_ptr(), n_levels, T, I, C, maxc, P,
                 cuda_build.S4_DP_CHUNK, _stream(tips))
    BACKWARD_LAUNCHES += 1
    if err:
        raise RuntimeError(f"pruning backward kernel launch failed: "
                           f"cudaError {err}")
    # deterministic second pass over the per-chunk partial sums
    if nq > 1:
        dP_part, drootw_part = dP_part.sum(0), drootw_part.sum(0)
    else:
        dP_part, drootw_part = dP_part[0], drootw_part[0]
    return dP_part.view(N, C, 4, 4), drootw_part


class _FusedSiteLog(torch.autograd.Function):
    """site_log = F(tips, pmats, rootw) by the postorder schedule; the
    backward is kernel B by the preorder one. The forward's rescaled
    partials and scalers are kept for it."""

    @staticmethod
    def forward(ctx, tips, pmats, rootw, children, postorder, preorder):
        site_log, partials, scale = pruning_forward(tips, pmats, children,
                                                    rootw, postorder)
        ctx.save_for_backward(tips, pmats, rootw, children, partials, scale)
        ctx.schedule = preorder
        return site_log

    @staticmethod
    def backward(ctx, g):
        tips, pmats, rootw, children, partials, scale = ctx.saved_tensors
        dP, drootw = pruning_backward(tips, pmats, children, rootw,
                                      ctx.schedule, partials, scale,
                                      g.contiguous())
        return None, dP, drootw, None, None, None


# the plain PyTorch version of the kernels' function (ops/pruning.py)
fused_site_log_reference = rescaled_site_log


def fused_site_log(tip_partials, pmats, topo: Topology, freqs, props):
    """Per-pattern site log-likelihoods [P], differentiable w.r.t.
    pmats/freqs/props (tips are constants). CUDA tensors go through the
    kernels (or raise); CPU tensors through the plain version."""
    if tip_partials.device.type == "cpu":
        return fused_site_log_reference(tip_partials, pmats, topo, freqs,
                                        props)
    children = topo_constant(topo, "children", lambda: topo.children,
                             tip_partials, torch.int32)
    # rootw = props (x) freqs in torch: autograd maps d rootw to d props
    # and d freqs
    rootw = (props[:, None] * freqs[None, :]).reshape(-1)
    return _FusedSiteLog.apply(
        tip_partials.detach().contiguous(), pmats.contiguous(),
        rootw.contiguous(), children,
        cuda_build.postorder_schedule(topo, tip_partials),
        cuda_build.preorder_schedule(topo, tip_partials))


def fused_tree_log_likelihood(tip_partials, pmats, topo: Topology, freqs,
                              props, weights, *, rescale: bool = True):
    """(logL, site_log). ``rescale`` is accepted for engine-API
    compatibility; the kernels always rescale (exact)."""
    site_log = fused_site_log(tip_partials, pmats, topo, freqs, props)
    return torch.sum(weights * site_log), site_log
