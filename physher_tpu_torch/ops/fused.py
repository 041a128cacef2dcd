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
which K6' at S = 4 shares), each at one chain. At any other S each is one
launch a sweep of one of two kernels on the node steps of K5'/K6' and
K7'/K8' (``csrc/wide_forward.cuh``, ``csrc/wide_backward.cuh``), chosen a
call by :func:`walks`: ``fused_wide_*_walk`` (one block per pattern block
and category visits every node: the walks of K5'/K6') where those blocks
fill the card or the tree is a chain, else ``fused_wide_*_tree``, which
spreads the tree's (node, pattern block, category) steps over the card in
an order built here from the tree (:func:`forward_plan`,
:func:`backward_plan`); both in the TPU wrapper's two modes, chosen by its
rule (:func:`needs_csplit`, a copy of ``_needs_csplit``):

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
- At S != 4 the tree kernels hand work between blocks through counters
  and flags in a per-device int32 workspace (:func:`sync_words`), zeroed
  once when it is made; every launch leaves it at zero, so a CUDA graph
  can replay a sweep. Sweeps on one device must not run at once on two
  streams. The schedules come from a host copy of ``children`` kept on
  that tensor (:func:`fused_site_log` leaves the topology's there; a
  wrapper given another tensor copies it from the device once).
"""

from __future__ import annotations

import ctypes

import numpy as np
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
        wfwd.argtypes = [ptr] * 11 + [i32] * 9 + [ptr]
        wfwd.restype = i32
        wbwd = getattr(lib, f"fused_wide_backward_{dt}")
        wbwd.argtypes = [ptr] * 14 + [i32] * 9 + [ptr]
        wbwd.restype = i32
        blocks = getattr(lib, f"fused_wide_blocks_{dt}")
        blocks.argtypes = [i32, i32, ptr]
        blocks.restype = i32
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


# the patterns a step of the S != 4 forward takes at S > 32 (128 below, as
# the backward's blocks; csrc/tiles.cuh), the fewest, which bounds its
# pattern blocks
_FORWARD_MIN_PATTERNS = 32
# A sweep at S != 4 walks the tree in one block per (pattern block,
# category), as K5'/K6' walk a chain (the walk kernels), where those blocks
# number at least WALK_FILL of the blocks that the card keeps resident,
# so that the walk fills the card by itself, or where the tree is a chain
# (its postorder levels more than half its internal nodes: a caterpillar),
# which no schedule spreads; other shapes take the tree's schedule (the
# tree kernels). "walk" or "tree" in SCHEDULE forces one.
WALK_FILL = 0.5
SCHEDULE = None


def _tree(children: np.ndarray, T: int):
    """(parent [I], the parent's internal rank or -1 at the root; the
    number of internal children [I]; the height [I], 0 where every child
    is a tip) of ``children`` [I, maxc]."""
    I = children.shape[0]
    inner = children >= T
    rows, cols = np.nonzero(inner)
    parent = np.full(I, -1, np.int32)
    parent[children[rows, cols] - T] = rows
    height = np.zeros(I, np.int64)
    for k in range(I):                   # a child's rank is below its parent's
        kids = children[k][inner[k]] - T
        if kids.size:
            height[k] = 1 + height[kids].max()
    return parent, inner.sum(1).astype(np.int32), height


def forward_plan(children: np.ndarray, T: int):
    """The tree's schedule of F at S != 4 from ``children`` [I, maxc] (node
    ids, -1 for none; internal rank k is node T + k, the root rank I - 1):
    (next [I], the parent's rank, -1 at the root; need [I], the number of
    internal children; starts, the ranks whose children are all tips),
    int32. A block starts at each start and goes up to the parent; at a
    parent of ``need`` > 1 internal children only the last of them to
    arrive goes on."""
    parent, need, _ = _tree(np.asarray(children), T)
    return parent, need, np.nonzero(need == 0)[0].astype(np.int32)


def is_chain(children: np.ndarray, T: int) -> bool:
    """Whether the tree's postorder levels number more than half its
    internal nodes (a caterpillar: all of them)."""
    height = _tree(np.asarray(children), T)[2]
    return 2 * (int(height.max()) + 1) > len(height)


def backward_plan(children: np.ndarray, T: int, blocks: int, C: int,
                  split_width: int):
    """The schedule of B at S != 4 from ``children`` [I, maxc], at
    ``blocks`` pattern blocks of 128 and C categories: (items [n, 4], claims
    [m], consumers [I]), int32.

    Item i is (node rank k, child index j or -1 for all of k's children,
    the item to continue with or -1, 0 / 1 / 2: continued / waits for k's
    cotangent rows / the root's seed, plus 4 where it writes rows that
    other items wait on). A node whose preorder level holds at
    most ``split_width`` (node, pattern block, category) steps has an item
    per child, as K8' splits such a level, its lead first (the one at the
    tallest internal child); any other node one item. The item that writes
    a node's cotangent rows goes on with that node's lead item (at its
    tallest internal child), so a chain of nodes is one block's; the other
    items are claimed in ``claims``' order: preorder level, root first,
    then rank and lead. ``consumers[k]``: the items that
    wait on node k's rows."""
    children = np.asarray(children)
    I, maxc = children.shape
    parent, _, height = _tree(children, T)
    depth = np.zeros(I, np.int64)
    for k in range(I - 2, -1, -1):       # a parent's rank is above its child's
        depth[k] = depth[parent[k]] + 1
    split = blocks * C * np.bincount(depth)[depth] <= split_width

    def tallest(kids):
        """Index into ``kids`` of the internal child of greatest height,
        None if every one is a tip or missing."""
        inner = [i for i, ch in enumerate(kids) if ch >= T]
        return max(inner, key=lambda i: height[kids[i] - T]) if inner \
            else None
    items, first = [], np.zeros(I, np.int64)
    for k in np.lexsort((np.arange(I), depth)):
        first[k] = len(items)
        if split[k]:
            parts = [int(j) for j in np.nonzero(children[k] >= 0)[0]]
            lead = tallest(children[k, parts])
            if lead:
                parts.insert(0, parts.pop(lead))
        else:
            parts = [-1]
        items += [[k, j, -1, 1] for j in parts]
    items = np.array(items, np.int32).reshape(-1, 4)
    items[first[I - 1], 3] = 2
    for i, (k, j, _, _) in enumerate(items):
        kids = children[k] if j < 0 else children[k, j:j + 1]
        t = tallest(kids)
        if t is not None:
            ch = first[kids[t] - T]
            items[i, 2] = ch
            items[ch, 3] = 0
    waiting = items[:, 3] == 1
    consumers = np.bincount(items[waiting, 0], minlength=I).astype(np.int32)
    claims = np.nonzero(items[:, 3] > 0)[0].astype(np.int32)
    for i, (k, j, _, _) in enumerate(items):
        kids = children[k] if j < 0 else children[k, j:j + 1]
        if consumers[kids[kids >= T] - T].any():
            items[i, 3] |= 4
    return items, claims, consumers


def _plans(children: torch.Tensor) -> dict:
    """The cache of schedules built from ``children`` (a tensor of the
    device), kept on the tensor itself: its host copy is read once per
    tensor (:func:`fused_site_log` leaves the topology's there, so that
    call makes no copy)."""
    cache = getattr(children, "_fused_plans", None)
    if cache is None:
        cache = {"host": children.cpu().numpy()}
        children._fused_plans = cache
    return cache


def resident_blocks(device, S: int, dtype, backward: bool) -> int:
    """Blocks of F (``backward``: B) at S != 4 that the card keeps
    resident at once: blocks an SM (occupancy) x SMs."""
    n = ctypes.c_int(0)
    err = cuda_build.entry(build(), "fused_wide_blocks",
                           torch.empty(0, dtype=dtype))(
        S, int(backward), ctypes.byref(n))
    if err:
        raise RuntimeError(f"fused_wide_blocks failed: cudaError {err}")
    return n.value * torch.cuda.get_device_properties(
        device).multi_processor_count


def walks(blocks: int, C: int, resident: int, chain: bool) -> bool:
    """Whether a sweep of ``blocks`` pattern blocks x C categories walks
    (one block each visits every node) rather than takes the tree's
    schedule: where those blocks fill WALK_FILL of the ``resident`` blocks
    or the tree is a ``chain``, unless SCHEDULE forces one."""
    if SCHEDULE is not None:
        return SCHEDULE == "walk"
    return chain or blocks * C >= WALK_FILL * resident


_SYNC: dict = {}


def sync_words(device, n: int) -> torch.Tensor:
    """A zeroed int32 workspace of at least ``n`` words on ``device`` for
    the S != 4 kernels' counters and flags (every launch leaves it zero).
    A larger one replaces it when needed; the old ones are kept, since a
    captured CUDA graph may still point at them."""
    bufs = _SYNC.setdefault(torch.device(device), [])
    if not bufs or bufs[-1].numel() < n:
        bufs.append(torch.zeros(max(n, 1 << 16), dtype=torch.int32,
                                device=device))
    return bufs[-1]


def _launch_setup(children: torch.Tensor, backward: bool, T: int, C: int,
                  S: int, P: int, dtype):
    """(walk, the schedule's tensors, the workspace) of one sweep's shape,
    built once and kept on ``children`` (:func:`_plans`), so that a call
    costs a lookup; SCHEDULE is part of the key."""
    cache = _plans(children)
    key = (backward, C, S, P, dtype, SCHEDULE)
    setup = cache.get(key)
    if setup is None:
        dev, host, I = children.device, cache["host"], children.shape[0]
        if "chain" not in cache:
            cache["chain"] = is_chain(host, T)
        blocks = -(-P // (WIDE_BACKWARD_BLOCK if backward or S <= 32
                          else _FORWARD_MIN_PATTERNS))
        walk = walks(blocks, C, resident_blocks(dev, S, dtype, backward),
                     cache["chain"])
        # levels of at most one (node, pattern block, category) an SM split
        # by child, as K8' splits them
        plan = (backward_plan(host, T, blocks, C, torch.cuda
                              .get_device_properties(dev)
                              .multi_processor_count)
                if backward else forward_plan(host, T))
        # the claim counter, then a word per (internal node, pattern block,
        # category) at the forward's smallest step (the most blocks)
        sync = sync_words(dev, 1 + I * -(-P // _FORWARD_MIN_PATTERNS) * C)
        setup = cache[key] = (walk, [torch.as_tensor(a, device=dev)
                                     for a in plan], sync)
    return setup


def kernel_launches() -> int:
    """CUDA kernel launches that the S != 4 entries made in this process
    (one a sweep), counted by the C code."""
    fn = build().fused_wide_kernel_launches
    fn.restype = ctypes.c_long
    return int(fn())


def fused_wide_forward(tips, pmats, children, rootw, split: bool):
    """Launch F at any S from 2 to 64 (one launch): packed, returns
    (site_log [P], partials [I, C, S, P], scale [I, P]); category-split
    (``split``), (per-category site logs [C, P], partials, scale [C, I,
    P])."""
    global FORWARD_LAUNCHES
    T, I, C, S, maxc, P = _wide_dims(tips, pmats, children, rootw)
    lib = build()
    walk, (nxt, need, starts), sync = _launch_setup(children, False, T, C,
                                                    S, P, tips.dtype)
    partials = tips.new_empty((I, C, S, P))
    scale = tips.new_empty((C, I, P) if split else (I, P))
    site = tips.new_empty((C, P) if split else (P,))
    with torch.cuda.device(tips.device):
        err = cuda_build.entry(lib, "fused_wide_forward", tips)(
            tips.data_ptr(), pmats.data_ptr(), children.data_ptr(),
            rootw.data_ptr(), partials.data_ptr(), scale.data_ptr(),
            site.data_ptr(), nxt.data_ptr(), need.data_ptr(),
            starts.data_ptr(), sync.data_ptr(), starts.numel(), T, I, C, S,
            maxc, P, int(bool(split)), int(walk), _stream(tips))
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
    walk, (items, claims, consumers), sync = _launch_setup(
        children, True, T, C, S, P, tips.dtype)
    gbuf = tips.new_empty((I, C, S, P))
    # the kernel writes every row, the root's zero rows too
    dP_part = tips.new_empty((n_blocks, N, C, S, S))
    drootw_part = tips.new_empty((n_blocks, C * S))
    with torch.cuda.device(tips.device):
        err = cuda_build.entry(lib, "fused_wide_backward", tips)(
            tips.data_ptr(), pmats.data_ptr(), children.data_ptr(),
            rootw.data_ptr(), partials.data_ptr(), scale.data_ptr(),
            g.data_ptr(), gbuf.data_ptr(), dP_part.data_ptr(),
            drootw_part.data_ptr(), items.data_ptr(), claims.data_ptr(),
            consumers.data_ptr(), sync.data_ptr(), claims.numel(), T, I, C,
            S, maxc, P, int(bool(split)), int(walk), _stream(tips))
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
    if not hasattr(children, "_fused_plans"):
        # the schedules of the S != 4 kernels come from the topology's own
        # host copy, with no copy back from the device
        children._fused_plans = {"host": topo.children}
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
