"""Pruning likelihood and its gradient through hand-written CUDA kernels.

Port of ``physher_tpu/ops/pallas_fused.py``. The two TPU kernels there,
``_fused_fwd_kernel`` (``build_fused_forward``) and ``_fused_bwd_kernel``
(``build_fused_backward``), become kernel F and kernel B of
``csrc/pruning.cu``: the same function (the rescaled postorder sweep to
per-pattern site log-likelihoods, and its reverse sweep to d pmats and
d (props x freqs)), but not the TPU layout, for any state count from 2 to
64. At S = 4, F is the S = 4 forward step of ``csrc/s4_forward.cuh`` (a
walk by postorder level, which K5' at S = 4 shares), B the S = 4 reverse
step of ``csrc/s4_backward.cuh`` (a walk by preorder level and a dP pass,
which K6' at S = 4 shares), each at one chain. At any other S they are
``fused_wide_forward_kernel`` / ``fused_wide_backward_kernel``, the walks of
K5'/K6' at S != 4 (``csrc/wide_forward.cuh``, ``csrc/wide_backward.cuh``) at
one chain, in both of the TPU wrapper's modes, chosen by its rule
(:func:`needs_csplit`, a copy of ``_needs_csplit``):

- packed: one sweep, rescaled by the per-pattern max over (C, S);
- category-split (protein at C = 4, codon): one sweep per rate category
  with its own scalers, ``site_log = logsumexp_c(log max(props_c freqs .
  root_c, tiny) + sum_k log m_k^c)``; the kernels write the per-category
  rows, and the logsumexp (and its gradient, the per-category cotangent
  the reverse sweep takes) is PyTorch's.

The source notes in ``csrc/pruning.cu`` and the headers say what bounds
them on the card and what the design does about it.

- :func:`fused_site_log` / :func:`fused_tree_log_likelihood` are the entry
  points (the JAX signatures without ``B``, ``tile`` and ``interpret``). On
  a CUDA tensor they launch the kernels or raise; on a CPU tensor they run
  the plain PyTorch version of the mode: :func:`fused_site_log_reference`
  (packed) or :func:`fused_split_site_log_reference` (category-split).
- :func:`pruning_forward` / :func:`pruning_backward` are the S = 4 launch
  wrappers; they take the walks' schedules
  (``cuda_build.postorder_schedule`` / ``preorder_schedule``).
  :func:`fused_wide_forward` / :func:`fused_wide_backward` are those of
  any other S.
- The kernels are built at first use by ``nvcc`` from the package's own
  sources into ``_build/`` (keyed on a hash of the sources and flags), and
  loaded with ctypes. Nothing is built when the module is imported.
- ``FORWARD_LAUNCHES`` / ``BACKWARD_LAUNCHES`` count the wrappers' calls:
  one CUDA launch for F, two for B at S = 4 (the walk and the dP pass),
  one each at any other S.
"""

from __future__ import annotations

import ctypes

import torch

from ..trees.heights import topo_constant
from ..trees.topology import Topology
from . import cuda_build
from .cuda_build import check as _check, stream as _stream
# at S != 4 the walks of K5'/K6' (csrc/tiles.cuh): their state counts, and
# the patterns a block of the reverse sweep sums (its dP scratch's block
# axis)
from .loop import STATES, WIDE_BACKWARD_BLOCK
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
        wfwd = getattr(lib, f"fused_wide_forward_{dt}")
        wfwd.argtypes = [ptr] * 7 + [i32] * 7 + [ptr]
        wfwd.restype = i32
        wbwd = getattr(lib, f"fused_wide_backward_{dt}")
        wbwd.argtypes = [ptr] * 10 + [i32] * 7 + [ptr]
        wbwd.restype = i32
    return lib


def needs_csplit(C: int, S: int) -> bool:
    """Whether the TPU wrapper runs K1/K2 in category-split mode at C
    categories and S states (``physher_tpu/ops/pallas_fused.py``
    ``_needs_csplit``): packed rows need C*S % 8 == 0 with tolerable
    padding; odd S (61) can never satisfy it by padding categories, and
    C*S past 64 (protein at C = 4) is too large a row. The kernels here take
    either mode at any S; the port keeps the TPU wrapper's choice."""
    if S <= 8:
        return False
    CS = C * S
    while CS % 8:
        CS += S
    return bool(CS > 64 or S % 2)


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


def _wide_dims(tips, pmats, children, rootw):
    """Validate the S != 4 kernels' inputs; returns (T, I, C, S, maxc, P)."""
    return cuda_build.pruning_dims("fused pruning", tips, pmats, children,
                                   rootw, states=STATES)


def fused_wide_forward(tips, pmats, children, rootw, split: bool):
    """Launch F at any S from 2 to 64 (one launch): packed, returns
    (site_log [P], partials [I, C, S, P], scale [I, P]); category-split
    (``split``), (per-category site logs [C, P], partials, scale [C, I,
    P])."""
    global FORWARD_LAUNCHES
    T, I, C, S, maxc, P = _wide_dims(tips, pmats, children, rootw)
    lib = build()
    partials = tips.new_empty((I, C, S, P))
    scale = tips.new_empty((C, I, P) if split else (I, P))
    site = tips.new_empty((C, P) if split else (P,))
    with torch.cuda.device(tips.device):
        err = cuda_build.entry(lib, "fused_wide_forward", tips)(
            tips.data_ptr(), pmats.data_ptr(), children.data_ptr(),
            rootw.data_ptr(), partials.data_ptr(), scale.data_ptr(),
            site.data_ptr(), T, I, C, S, maxc, P, int(bool(split)),
            _stream(tips))
    FORWARD_LAUNCHES += 1
    if err:
        raise RuntimeError(f"fused forward kernel launch failed at S = {S}: "
                           f"cudaError {err}")
    return site, partials, scale


def fused_wide_backward(tips, pmats, children, rootw, split: bool, partials,
                        scale, g):
    """Launch B at any S from 2 to 64 (one launch) from the forward's
    partials and scalers and the cotangent ``g`` of its output ([P], or
    [C, P] with ``split``): returns (d pmats [N, C, S, S], d rootw
    [C * S])."""
    global BACKWARD_LAUNCHES
    T, I, C, S, maxc, P = _wide_dims(tips, pmats, children, rootw)
    _check("partials", partials, tips.device, tips.dtype, (I, C, S, P))
    _check("scale", scale, tips.device, tips.dtype,
           (C, I, P) if split else (I, P))
    _check("g", g, tips.device, tips.dtype, (C, P) if split else (P,))
    lib = build()
    N = T + I
    n_blocks = -(-P // WIDE_BACKWARD_BLOCK)
    gbuf = tips.new_empty((I, C, S, P))
    dP_part = tips.new_empty((n_blocks, N, C, S, S))
    dP_part[:, N - 1].zero_()  # the root is no node's child
    drootw_part = tips.new_empty((n_blocks, C * S))
    with torch.cuda.device(tips.device):
        err = cuda_build.entry(lib, "fused_wide_backward", tips)(
            tips.data_ptr(), pmats.data_ptr(), children.data_ptr(),
            rootw.data_ptr(), partials.data_ptr(), scale.data_ptr(),
            g.data_ptr(), gbuf.data_ptr(), dP_part.data_ptr(),
            drootw_part.data_ptr(), T, I, C, S, maxc, P, int(bool(split)),
            _stream(tips))
    BACKWARD_LAUNCHES += 1
    if err:
        raise RuntimeError(f"fused backward kernel launch failed at S = "
                           f"{S}: cudaError {err}")
    # deterministic second pass over the per-block partial sums
    return dP_part.sum(0), drootw_part.sum(0)


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


class _FusedWideSiteLog(torch.autograd.Function):
    """F at S != 4 (or in category-split mode): site_log [P], or with
    ``split`` the per-category site logs [C, P]; the backward is B from
    the forward's rescaled partials and scalers, which are kept for it."""

    @staticmethod
    def forward(ctx, tips, pmats, rootw, children, split):
        site, partials, scale = fused_wide_forward(tips, pmats, children,
                                                   rootw, split)
        ctx.save_for_backward(tips, pmats, rootw, children, partials, scale)
        ctx.split = split
        return site

    @staticmethod
    def backward(ctx, g):
        tips, pmats, rootw, children, partials, scale = ctx.saved_tensors
        dP, drootw = fused_wide_backward(tips, pmats, children, rootw,
                                         ctx.split, partials, scale,
                                         g.contiguous())
        return None, dP, drootw, None, None


# the plain PyTorch version of the kernels' function in packed mode
# (ops/pruning.py)
fused_site_log_reference = rescaled_site_log


def category_site_logs_reference(tip_partials, pmats, topo: Topology, freqs,
                                 props):
    """[C, P]: per category c the rescaled sweep at C = 1 with that
    category's P matrices and root weight props_c freqs, ``log max(props_c
    freqs . root_c, tiny) + sum_k log m_k^c`` (a category of props_c = 0
    gives log tiny, not -inf, as the TPU kernel's does); the plain version
    of the category-split kernels' output."""
    C = pmats.shape[-3]
    return rescaled_site_log(tip_partials, pmats.transpose(0, 1)[:, :, None],
                             topo, freqs.expand(C, -1), props[:, None])


def fused_split_site_log_reference(tip_partials, pmats, topo: Topology,
                                   freqs, props):
    """Site log-likelihoods [P] in category-split mode: the logsumexp over
    the categories of :func:`category_site_logs_reference`; the plain
    version of the kernels' function in that mode."""
    return torch.logsumexp(category_site_logs_reference(
        tip_partials, pmats, topo, freqs, props), 0)


def fused_site_log(tip_partials, pmats, topo: Topology, freqs, props, *,
                   split_categories: bool | None = None):
    """Per-pattern site log-likelihoods [P], differentiable w.r.t.
    pmats/freqs/props (tips are constants). ``split_categories`` (default:
    :func:`needs_csplit`, the TPU wrapper's rule) selects category-split
    mode. CUDA tensors go through the kernels (or raise); CPU tensors
    through the plain version of the mode."""
    S, C = tip_partials.shape[1], pmats.shape[-3]
    split = (needs_csplit(C, S) if split_categories is None
             else bool(split_categories))
    if tip_partials.device.type == "cpu":
        reference = (fused_split_site_log_reference if split
                     else fused_site_log_reference)
        return reference(tip_partials, pmats, topo, freqs, props)
    children = topo_constant(topo, "children", lambda: topo.children,
                             tip_partials, torch.int32)
    # rootw = props (x) freqs in torch: autograd maps d rootw to d props
    # and d freqs
    rootw = (props[:, None] * freqs[None, :]).reshape(-1).contiguous()
    tips = tip_partials.detach().contiguous()
    if S == 4 and not split:
        return _FusedSiteLog.apply(
            tips, pmats.contiguous(), rootw, children,
            cuda_build.postorder_schedule(topo, tip_partials),
            cuda_build.preorder_schedule(topo, tip_partials))
    site = _FusedWideSiteLog.apply(tips, pmats.contiguous(), rootw, children,
                                   split)
    return torch.logsumexp(site, 0) if split else site


def fused_tree_log_likelihood(tip_partials, pmats, topo: Topology, freqs,
                              props, weights, *, rescale: bool = True):
    """(logL, site_log). ``rescale`` is accepted for engine-API
    compatibility; the kernels always rescale (exact)."""
    site_log = fused_site_log(tip_partials, pmats, topo, freqs, props)
    return torch.sum(weights * site_log), site_log
