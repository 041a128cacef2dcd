"""Pruning likelihood and its gradient for large nucleotide alignments
through hand-written CUDA kernels staged by tree level.

Port of ``physher_tpu/ops/pallas_staged.py``. The two TPU kernels there,
``_fwd_kernel`` (``build_staged_forward``, run with ``spill=True``) and
``_bwd_kernel`` (``build_staged_backward``), become kernels K3' and K4' of
``csrc/staged.cu``: the same function as ``ops/fused.py`` (the rescaled
postorder sweep to per-pattern site log-likelihoods, and its reverse sweep
to d pmats and d (props x freqs)) for S = 4, with the tree step as a
parallel axis: one launch per wide level of the postorder, the level's
nodes and the pattern tiles on the grid, and the narrow top of the tree,
from :func:`walk_level` to the root, in one launch: the S = 4 forward walk
(``csrc/s4_forward.cuh``, which K1' and K5' share) over few patterns, a
walk of one thread a pattern over many. The forward keeps
its rescaled partials and log-scalers in device memory; the backward reads
them and never recomputes the forward. The source note in ``csrc/staged.cu`` says what bounds them on
the card and what the design does about it.

At any other S from 2 to 64 (the TPU wrapper takes any S, padding C until
C*S % 8 == 0) the level-staged sweep is ``csrc/wide.cu``'s level kernels,
K7'/K8' (``ops/wide.py``), launched from here. On the TPU, ``pallas_staged``
and ``pallas_wide`` differ in where the stage lives (VMEM or HBM,
``physher_tpu/ops/pallas_wide.py:12-20``); on the card both keep every
node's rescaled partials ``[I, C, S, P]`` and scalers ``[I, P]`` in device
memory and launch one kernel a level, so ``csrc/wide.cu`` is the staged
design at any S, and no second any-S level kernel is written. Those
launches count in ``ops.wide``'s counters.

- :func:`staged_site_log` / :func:`staged_tree_log_likelihood` are the entry
  points (the JAX signatures without ``B`` and ``interpret``). On a CUDA
  tensor they launch the kernels (K3'/K4' at S = 4, K7'/K8' at any other
  S) or raise; on a CPU tensor they run :func:`staged_site_log_reference`,
  the plain PyTorch version.
- :func:`staged_forward` / :func:`staged_backward` are the launch wrappers.
  ``STAGED_FORWARD_LAUNCHES`` / ``STAGED_BACKWARD_LAUNCHES`` count their
  calls: one forward sweep is :func:`forward_launches` CUDA launches (the
  levels below the walk, then the walk, which also computes the site
  log-likelihoods), one reverse sweep ``len(topo.levels) + 2`` (the root
  seed, the levels, the sum of the per-block partial sums).
- :func:`walk_level` and :func:`forward_ppt` are the forward's schedule:
  the level from which one launch walks to the root, and which walk (the
  S = 4 walk of ``csrc/s4_forward.cuh``, or ``csrc/staged.cu``'s chain
  walk over many patterns); the patterns a thread at each level below.
- :func:`level_ppt` and :func:`backward_rows` are the reverse sweep's
  schedule: the patterns a thread takes at each level and where each node's
  per-block partial sums go.
- The kernels are built at first use by ``nvcc`` (``ops/cuda_build.py``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..trees.heights import topo_constant
from ..trees.topology import Topology
from ..utils.profiling import spanned
from . import cuda_build, wide
from .cuda_build import check, level_schedule, offsets_arg, stream
from .pruning import rescaled_site_log

STAGED_FORWARD_LAUNCHES = 0
STAGED_BACKWARD_LAUNCHES = 0
# the CUDA kernel launches that K3''s calls made, as its C code counts them
STAGED_FORWARD_KERNELS = 0

# children per node: the backward stages [maxc, C, 16] P entries and an
# [8 warps, 32] reduction in shared memory, at most 18 KB in float64 (a
# binary node's cp.async slots add 106 KB)
MAX_CHILDREN = 16
# K4''s blocks (csrc/staged.cu NW): 8 warps, CP of them (C rounded up to a
# power of two) on each row of 32 patterns
WARPS = 8
# K4''s patterns a thread at a level (a power of two up to MAX_PPT): those
# that minimize the level's waves of BLOCKS blocks an SM (csrc/staged.cu
# BWD_BLOCKS) times a block's time, FIXED + ppt in units of one pattern
# (staging, reduction, launch ramp), so a narrow level fills one wave and a
# wide one takes the most a thread
MAX_PPT = 16
BLOCKS = 2
FIXED = 4
# K3''s switch to a walk of the top of the tree (walk_level), fitted to the
# least summed time over 192 shapes on an NVIDIA H100 (chip_profile.py
# --switch): the S = 4 walk where P x C' (C rounded up to a power of two)
# is at most WALK_S4_PATTERNS, from the first level whose nodes x pattern
# tiles of WALK_TILE fall under WALK_BLOCKS blocks an SM; over more
# patterns the chain walk from the first level of at most CHAIN_NODES
# nodes
WALKS = ("s4", "chain")
WALK_S4_PATTERNS = 16384
WALK_TILE = 128
WALK_BLOCKS = 1
CHAIN_NODES = 3
# K3''s levels below the walk: a wide level's threads take 16 bytes of
# each row as one vector (forward_ppt) where its blocks then give every SM
# at least VECTOR_BLOCKS
VECTOR_BLOCKS = 4

_SOURCE = cuda_build.PKG / "csrc" / "staged.cu"

_lib = None
build_log = ""


def build() -> ctypes.CDLL:
    """Compile ``csrc/staged.cu`` (once per source hash) and load it."""
    global _lib, build_log
    if _lib is None:
        lib, build_log = cuda_build.build_library(_SOURCE)
        _lib = bind(lib)
    return _lib


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points' argument and result types on ``lib``."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for dt in ("f32", "f64"):
        fwd = getattr(lib, f"staged_forward_{dt}")
        fwd.argtypes = ([ptr] * 8 + [i32] * 3 + [ptr] * 4 + [i32] * 5
                        + [ctypes.POINTER(i32), ptr])
        fwd.restype = i32
        bwd = getattr(lib, f"staged_backward_{dt}")
        bwd.argtypes = [ptr] * 5 + [i32] + [ptr] * 11 + [i32] * 5 + [ptr]
        bwd.restype = i32
    return lib


def block_patterns(C: int) -> int:
    """Patterns one row of a K4' block covers at C categories."""
    return WARPS * 32 // (1 << (C - 1).bit_length())


def level_ppt(offsets, C: int, P: int, sms: int) -> tuple:
    """K4''s patterns a thread at each level of the schedule ``offsets``."""
    qb, slots, out = block_patterns(C), BLOCKS * sms, []
    for lo, hi in zip(offsets[:-1], offsets[1:]):
        def cost(ppt):
            waves = -(-(-(-P // (qb * ppt)) * (hi - lo)) // slots)
            return waves * (FIXED + ppt), -ppt
        out.append(min((1 << i for i in range(MAX_PPT.bit_length())),
                       key=cost))
    return tuple(out)


def walk_level(offsets, C: int, P: int, sms: int) -> tuple:
    """K3''s switch for the schedule ``offsets``: (the level from which one
    launch walks to the root, which walk: "s4" or "chain"). The levels
    below it take a launch each; ``len(offsets) - 1`` is past the last
    level (a launch a level, the root's computing the site
    log-likelihoods), where no level qualifies."""
    n_levels = len(offsets) - 1
    widths = [hi - lo for lo, hi in zip(offsets[:-1], offsets[1:])]
    if P * (1 << (C - 1).bit_length()) <= WALK_S4_PATTERNS:
        tiles, wave = -(-P // WALK_TILE), WALK_BLOCKS * sms
        return next((d for d, n in enumerate(widths) if n * tiles <= wave),
                    n_levels), "s4"
    return next((d for d, n in enumerate(widths) if n <= CHAIN_NODES),
                n_levels), "chain"


def forward_ppt(offsets, top: int, C: int, P: int, sms: int,
                itemsize: int) -> tuple:
    """K3''s patterns a thread at each level below the switch ``top``: in
    float32, 16 bytes of each row (8 above C = 4; csrc/staged.cu
    FwdPatterns), read as one vector, where P is a multiple of them and the
    level's blocks of 128 threads then give every SM at least
    VECTOR_BLOCKS; else one (as many strided took 9 % longer at the widest
    level of the 128-taxon config, and float64's pairs 5 % longer at
    balanced 128 x 16 384)."""
    wide = (4 if C <= 4 else 2) if itemsize == 4 else 1
    out = []
    for lo, hi in zip(offsets[:top], offsets[1:top + 1]):
        blocks = (hi - lo) * -(-P // (128 * wide))
        out.append(wide if P % wide == 0 and blocks >= VECTOR_BLOCKS * sms
                   else 1)
    return tuple(out)


def forward_launches(offsets, top: int) -> int:
    """CUDA launches of one K3' sweep that switches to the walk at ``top``."""
    return top + (top < len(offsets) - 1)


def backward_rows(offsets, ppt, C: int, maxc: int, P: int):
    """([(offset, blocks)] per schedule position, scratch size): node
    ``nodes[q]``'s per-block partial sums of d pmats, [blocks, maxc, C, 16]
    from that offset of K4''s scratch."""
    qb, width = block_patterns(C), maxc * C * 16
    rows, size = [], 0
    for (lo, hi), n in zip(zip(offsets[:-1], offsets[1:]), ppt):
        blocks = -(-P // (qb * n))
        for _ in range(lo, hi):
            rows.append((size, blocks))
            size += blocks * width
    return rows, size


@functools.lru_cache(maxsize=64)
def _backward_plan(offsets, C, maxc, P, device, *rule):
    """K4''s launch arguments for one schedule, built once: (the level
    offsets and patterns a thread as C arrays, the rows as a device
    tensor, the scratch size, the root seed's blocks). ``rule`` keys the
    cache on MAX_PPT, BLOCKS and FIXED."""
    ppt = level_ppt(offsets, C, P, _sms(device))
    rows, size = backward_rows(offsets, ppt, C, maxc, P)
    n = len(ppt)
    return ((ctypes.c_int * (n + 1))(*offsets), (ctypes.c_int * n)(*ppt),
            torch.tensor(rows, dtype=torch.int64, device=device), size,
            -(-P // (block_patterns(C) * ppt[-1])))


@functools.lru_cache(maxsize=64)
def _forward_plan(offsets, top, C, P, sms, itemsize, *rule):
    """forward_ppt as a C array, built once for each schedule and switch;
    ``rule`` keys the cache on VECTOR_BLOCKS."""
    ppt = forward_ppt(offsets, top, C, P, sms, itemsize)
    return (ctypes.c_int * max(len(ppt), 1))(*ppt)


@functools.lru_cache(maxsize=None)
def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _dims(tips, pmats, children, rootw, schedule):
    """Validate the kernels' inputs; returns (T, I, C, maxc, P)."""
    T, I, C, _, maxc, P = cuda_build.pruning_dims(
        "staged pruning", tips, pmats, children, rootw,
        max_children=MAX_CHILDREN, schedule=schedule, root_alone=True)
    return T, I, C, maxc, P


# the walk's tables of one schedule and switch level: key -> (the nodes
# tensor, its level offsets on the device, each rank's hand-off slot)
_walks: dict = {}


def _walk_tables(nodes, offsets, top: int):
    """(offsets [levels + 1], slots [I]) as int32 tensors on ``nodes``'s
    device: rank k's slot is its position in ``nodes`` less ``offsets[top]``
    for a walked node, -1 below the walk. Built once for each schedule
    (the nodes tensor, kept alive by its topology) and switch level."""
    key = (nodes.data_ptr(), nodes.device, tuple(offsets), top)
    hit = _walks.get(key)
    if hit is not None and hit[0] is nodes:
        return hit[1:]
    j0 = offsets[top]
    slots = torch.full_like(nodes, -1)
    slots[nodes[j0:].long()] = torch.arange(
        len(nodes) - j0, dtype=torch.int32, device=nodes.device)
    dev_offsets = torch.tensor(offsets, dtype=torch.int32,
                               device=nodes.device)
    if len(_walks) >= 64:
        _walks.clear()
    _walks[key] = (nodes, dev_offsets, slots)
    return dev_offsets, slots


@spanned("physher.ops.staged.forward")
def staged_forward(tips, pmats, children, rootw, schedule, top=None,
                   walk=None):
    """Launch K3': the levels below ``top`` one launch each, then one walk
    of the rest to the root (``walk``: "s4" or "chain"), which also
    computes the site log-likelihoods; ``top`` = the number of levels: a
    launch a level, the root's computing them. Either left None is
    :func:`walk_level`'s. Returns (site_log [P], partials [I, C, 4, P],
    logscale [I, P])."""
    global STAGED_FORWARD_LAUNCHES, STAGED_FORWARD_KERNELS
    T, I, C, maxc, P = _dims(tips, pmats, children, rootw, schedule)
    offsets, n_levels = offsets_arg(schedule)
    level, kind = walk_level(schedule[1], C, P, _sms(tips.device))
    top = level if top is None else top
    walk = kind if walk is None else walk
    if not 0 <= top <= n_levels or walk not in WALKS:
        raise ValueError(f"switch level {top} of {n_levels} levels, walk "
                         f"{walk!r}: levels 0 to {n_levels}, walks {WALKS}")
    lib = build()
    partials = tips.new_empty((I, C, 4, P))
    logscale = tips.new_empty((I, P))
    site_log = tips.new_empty((P,))
    dev_offsets, slots = _walk_tables(schedule[0], schedule[1], top)
    ppt = _forward_plan(schedule[1], top, C, P, _sms(tips.device),
                        tips.element_size(), VECTOR_BLOCKS)
    launched = ctypes.c_int(0)
    fn = (lib.staged_forward_f32 if tips.dtype == torch.float32
          else lib.staged_forward_f64)
    with torch.cuda.device(tips.device):
        err = fn(tips.data_ptr(), pmats.data_ptr(), children.data_ptr(),
                 schedule[0].data_ptr(), offsets, dev_offsets.data_ptr(),
                 slots.data_ptr(), ppt, n_levels, top, WALKS.index(walk),
                 rootw.data_ptr(), partials.data_ptr(), logscale.data_ptr(),
                 site_log.data_ptr(), T, I, C, maxc, P,
                 ctypes.byref(launched), stream(tips))
    STAGED_FORWARD_LAUNCHES += 1
    STAGED_FORWARD_KERNELS += launched.value
    if err:
        raise RuntimeError(f"staged forward kernel launch failed: "
                           f"cudaError {err}")
    return site_log, partials, logscale


@spanned("physher.ops.staged.backward")
def staged_backward(tips, pmats, children, rootw, schedule, partials,
                    logscale, g):
    """Launch K4' (the root seed, one launch per level, root first, then
    the sum of the per-block partial sums): returns (d pmats [N, C, 4, 4],
    d rootw [C * 4])."""
    global STAGED_BACKWARD_LAUNCHES
    T, I, C, maxc, P = _dims(tips, pmats, children, rootw, schedule)
    check("partials", partials, tips.device, tips.dtype, (I, C, 4, P))
    check("logscale", logscale, tips.device, tips.dtype, (I, P))
    check("g", g, tips.device, tips.dtype, (P,))
    lib = build()
    N = T + I
    offsets, ppt, rows, size, root_blocks = _backward_plan(
        tuple(schedule[1]), C, maxc, P, tips.device, MAX_PPT, BLOCKS, FIXED)
    # the reverse sweep's cotangents and per-block sums, one allocation;
    # d pmats and d rootw another
    work = tips.new_empty(I * C * 4 * P + size + root_blocks * C * 4)
    gbuf = work[:I * C * 4 * P]
    dP_part = work[I * C * 4 * P:I * C * 4 * P + size]
    drootw_part = work[I * C * 4 * P + size:]
    out = tips.new_empty(N * C * 16 + C * 4)
    fn = (lib.staged_backward_f32 if tips.dtype == torch.float32
          else lib.staged_backward_f64)
    with torch.cuda.device(tips.device):
        err = fn(tips.data_ptr(), pmats.data_ptr(), children.data_ptr(),
                 schedule[0].data_ptr(), offsets, len(ppt), ppt,
                 rows.data_ptr(), rootw.data_ptr(), partials.data_ptr(),
                 logscale.data_ptr(), g.data_ptr(), gbuf.data_ptr(),
                 dP_part.data_ptr(), drootw_part.data_ptr(), out.data_ptr(),
                 out[N * C * 16:].data_ptr(), T, I, C, maxc, P,
                 stream(tips))
    STAGED_BACKWARD_LAUNCHES += 1
    if err:
        raise RuntimeError(f"staged backward kernel launch failed: "
                           f"cudaError {err}")
    return out[:N * C * 16].view(N, C, 4, 4), out[N * C * 16:]


class _StagedSiteLog(torch.autograd.Function):
    """site_log = K3'(tips, pmats, rootw); the backward is K4'. The
    forward's rescaled partials and log-scalers are kept for it."""

    @staticmethod
    def forward(ctx, tips, pmats, rootw, children, nodes, offsets):
        schedule = (nodes, offsets)
        site_log, partials, logscale = staged_forward(tips, pmats, children,
                                                      rootw, schedule)
        ctx.save_for_backward(tips, pmats, rootw, children, nodes, partials,
                              logscale)
        ctx.offsets = offsets
        return site_log

    @staticmethod
    def backward(ctx, g):
        tips, pmats, rootw, children, nodes, partials, logscale = \
            ctx.saved_tensors
        dP, drootw = staged_backward(tips, pmats, children, rootw,
                                     (nodes, ctx.offsets), partials, logscale,
                                     g.contiguous())
        return None, dP, drootw, None, None, None


# the plain PyTorch version of the kernels' function (ops/pruning.py)
staged_site_log_reference = rescaled_site_log


def staged_site_log(tip_partials, pmats, topo: Topology, freqs, props):
    """Per-pattern site log-likelihoods [P], differentiable w.r.t.
    pmats/freqs/props (tips are constants). CUDA tensors go through the
    kernels, K3'/K4' at S = 4 and ``csrc/wide.cu``'s level kernels at any
    other S (or raise); CPU tensors through the plain version."""
    if tip_partials.device.type == "cpu":
        return staged_site_log_reference(tip_partials, pmats, topo, freqs,
                                         props)
    if tip_partials.shape[1] != 4:
        return wide.wide_site_log(tip_partials, pmats, topo, freqs, props)
    children = topo_constant(topo, "children", lambda: topo.children,
                             tip_partials, torch.int32)
    nodes, offsets = level_schedule(topo, tip_partials)
    # rootw = props (x) freqs in torch: autograd maps d rootw to d props
    # and d freqs
    rootw = (props[:, None] * freqs[None, :]).reshape(-1)
    return _StagedSiteLog.apply(tip_partials.detach().contiguous(),
                                pmats.contiguous(), rootw.contiguous(),
                                children, nodes, offsets)


def staged_tree_log_likelihood(tip_partials, pmats, topo: Topology, freqs,
                               props, weights, *, rescale: bool = True):
    """(logL, site_log). ``rescale`` is accepted for engine-API
    compatibility; the kernels always rescale (exact)."""
    site_log = staged_site_log(tip_partials, pmats, topo, freqs, props)
    return torch.sum(weights * site_log), site_log
