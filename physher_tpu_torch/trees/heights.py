"""Node-height reparameterizations for time trees (PyTorch).

Port of ``physher_tpu/trees/heights.py`` (reference:
src/phyc/treetransform.c). The ratio transform is

    h(root)     = params[root_rank]
    h(internal) = lower(n) + (h(parent(n)) - lower(n)) * params[rank(n)]

with ``lower(n)`` = max tip height below ``n`` and log|Jacobian| = sum over
non-root internals of log(h(parent) - lower). The SHIFT parameterization
``h = max(child heights) + shift`` is also provided. Parameters are ordered
by internal postorder rank, root last.

The numpy helpers (``compute_lowers``, ``ratios_from_heights``,
``shifts_from_heights``) are host-side and shared with ``timetree.py``.
Static index and mask arrays are cached on the topology per device and
dtype, so a step on the card copies nothing from the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.profiling import span, spanned
from .topology import Topology


def compute_lowers(topo: Topology, tip_heights: np.ndarray) -> np.ndarray:
    """Static per-node lower bounds: max descendant tip height [N]."""
    lowers = np.zeros(topo.N)
    lowers[: topo.T] = tip_heights
    for k in range(topo.I):
        cs = topo.children[k, : topo.child_count[k]]
        lowers[topo.T + k] = lowers[cs].max()
    return lowers


# Above this internal-node count the closed-form path's [I,I] ancestor
# matrix would exceed ~16 MB; use the level sweep instead.
_MATRIX_MAX_I = 2048


def topo_constant(topo: Topology, name: str, make, like: torch.Tensor,
                  dtype=None) -> torch.Tensor:
    """``make()`` (a numpy array built from ``topo``) as a tensor on
    ``like``'s device, in ``dtype`` (default ``like.dtype``), cached on the
    topology."""
    dtype = like.dtype if dtype is None else dtype
    cache = topo.__dict__.setdefault("_torch_constants", {})
    key = (name, like.device, dtype)
    hit = cache.get(key)
    if hit is None:
        hit = torch.as_tensor(make(), dtype=dtype, device=like.device)
        cache[key] = hit
    return hit


def _as(x, like: torch.Tensor) -> torch.Tensor:
    """A host array copied to ``like``'s device: on the card the copy from
    pageable memory waits for the device."""
    with span("physher.sync.h2d"):
        return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def _ratio_ancestor_mask(topo: Topology) -> np.ndarray:
    """[I-1, I-1] mask: A[k, j] = 1 iff non-root internal j is an
    ancestor-or-self of non-root internal k."""
    I, T = topo.I, topo.T
    A = np.zeros((max(I - 1, 1), max(I - 1, 1)))
    # postorder ranks: parent rank > child rank, so descending order visits
    # parents first and A[parent] is complete when the child needs it
    for k in range(I - 2, -1, -1):
        p = int(topo.parent[T + k]) - T
        if p != I - 1:  # parent is not the root
            A[k] = A[p]
        A[k, k] = 1.0
    return A


def ratio_params(ratios: torch.Tensor,
                 root_height: torch.Tensor) -> torch.Tensor:
    """The ratio transform's parameter vector ``[(L,) I]``: the non-root
    ratios ``[(L,) I-1]`` and the root height ``[(L)]`` last."""
    return torch.cat([ratios, root_height[..., None]], -1)


@spanned("physher.heights")
def heights_from_ratios(params: torch.Tensor, topo: Topology,
                        tip_heights, lowers) -> torch.Tensor:
    """Forward ratio transform: params [(L,) I] (root height last) ->
    heights [(L,) N].

    For trees up to ``_MATRIX_MAX_I`` internals the recursion
    ``h(n) = l(n)(1-r(n)) + r(n) h(parent)`` is unrolled to its closed form

        h(n) = sum_a W[n,a] l(a)(1-r(a)) + R(n) H,
        W[n,a] = exp(logR(n) - logR(a)) for ancestors-or-self a,
        logR(n) = sum of log r over non-root internal ancestors-or-self,

    one masked [I,I] matvec instead of tree-depth many level updates. All W
    entries are products of ratios in (0,1], so it is as stable as the
    sequential sweep (reference semantics: src/phyc/treetransform.c:224-266).
    The closed form runs in float64 for float32 parameters: there logR's
    sums of log ratios, large near the prior, would lose their last digits
    in W's exponents, differently in a batch of chains (a batched product)
    and one chain at a time, and a branch, a difference of two heights,
    with them.
    """
    I, T = topo.I, topo.T
    lead = params.shape[:-1]
    tips = _as(tip_heights, params).expand(lead + (T,))
    H = params[..., I - 1]
    if I == 1:
        return torch.cat([tips, H[..., None]], -1)
    lowers_t = _as(lowers, params)
    if I <= _MATRIX_MAX_I:
        wide = (params.to(torch.float64) if params.dtype == torch.float32
                else params)
        A = topo_constant(topo, "ratio_mask",
                          lambda: _ratio_ancestor_mask(topo), wide)
        lows = _as(lowers, wide)[T: T + I - 1]
        # exact-zero ratios would make logR[-inf]-logR[-inf] = nan in W
        r = torch.clamp(wide[..., : I - 1],
                        min=torch.finfo(params.dtype).tiny)
        logR = torch.matmul(torch.log(r), A.T)
        W = torch.exp(logR[..., :, None] - logR[..., None, :]) * A
        h_int = (torch.matmul(W, (lows * (1.0 - r))[..., None])[..., 0]
                 + torch.exp(logR) * wide[..., I - 1, None])
        return torch.cat([tips, h_int.to(params.dtype), H[..., None]], -1)
    h = [None] * topo.N
    for t in range(T):
        h[t] = tips[..., t]
    h[topo.root] = H
    for ranks in topo.preorder_levels[1:]:
        for k in ranks:
            node = T + int(k)
            low = lowers_t[node]
            h[node] = (low + (h[int(topo.parent[node])] - low)
                       * params[..., int(k)])
    return torch.stack(h, -1)


def ratios_from_heights(heights: np.ndarray, topo: Topology,
                        lowers: np.ndarray) -> np.ndarray:
    """Inverse transform (host-side): heights [N] -> params [I]
    (reference: src/phyc/treetransform.c:263-266)."""
    params = np.zeros(topo.I)
    params[topo.I - 1] = heights[topo.root]
    for k in range(topo.I - 1):
        node = topo.T + k
        p = topo.parent[node]
        params[k] = (heights[node] - lowers[node]) / (heights[p] - lowers[node])
    return params


def ratio_log_jacobian(heights: torch.Tensor, topo: Topology,
                       lowers) -> torch.Tensor:
    """log |det dh/dratios| summed over non-root internal nodes, per batch
    entry of heights [(L,) N]."""
    nodes = topo.T + np.arange(topo.I - 1)
    parents = topo_constant(topo, "nonroot_parents",
                            lambda: topo.parent[nodes], heights, torch.long)
    low = _as(lowers, heights)[topo.T: topo.N - 1]
    return torch.sum(torch.log(heights[..., parents] - low), -1)


def _shift_masks(topo: Topology):
    """(anc_incl [I, I], tip_anc [T, I], desc_tip [I, T]) masks:
    internal-ancestor-or-self of internals, internal ancestors of tips, and
    descendant tips of internals."""
    I, T = topo.I, topo.T
    anc = np.zeros((I, I))
    for k in range(I - 1, -1, -1):
        node = T + k
        p = int(topo.parent[node])
        if p >= 0:
            anc[k] = anc[p - T]
        anc[k, k] = 1.0
    tip_anc = np.zeros((T, I))
    for t in range(T):
        tip_anc[t] = anc[int(topo.parent[t]) - T]
    return anc, tip_anc, tip_anc.T.copy()


def heights_from_shifts(params: torch.Tensor, topo: Topology,
                        tip_heights) -> torch.Tensor:
    """SHIFT parameterization: h = max(child heights) + shift.

    Closed form: with U(x) = sum of shifts over internal
    ancestors(-or-self) of x,

        h(n) = max_{t in subtree(n)} (tip_h(t) + U(t)) - U(n) + shift(n)

    (reference semantics: src/phyc/treetransform.c:14-31). params
    [(L,) I] -> heights [(L,) N]."""
    I, T = topo.I, topo.T
    tips = _as(tip_heights, params).expand(params.shape[:-1] + (T,))
    if I <= _MATRIX_MAX_I:
        anc = topo_constant(topo, "shift_anc", lambda: _shift_masks(topo)[0],
                            params)
        tip_anc = topo_constant(topo, "shift_tip_anc",
                                lambda: _shift_masks(topo)[1], params)
        desc = topo_constant(topo, "shift_desc", lambda: _shift_masks(topo)[2],
                             params)
        U = torch.matmul(params, anc.T)            # [(L,) I]
        U_tip = torch.matmul(params, tip_anc.T)    # [(L,) T]
        val = tips + U_tip                         # [(L,) T]
        neg_inf = torch.full_like(desc, -torch.inf)
        best = torch.max(torch.where(desc > 0, val[..., None, :], neg_inf),
                         dim=-1).values
        h_int = best - U + params
        return torch.cat([tips, h_int], -1)
    h = [tips[..., t] for t in range(T)] + [None] * I
    for ranks in topo.levels:
        for k in ranks:
            cs = topo.children[int(k), : topo.child_count[int(k)]]
            h[T + int(k)] = (torch.stack([h[int(c)] for c in cs], -1)
                             .max(-1).values + params[..., int(k)])
    return torch.stack(h, -1)


def shifts_from_heights(heights: np.ndarray, topo: Topology) -> np.ndarray:
    params = np.zeros(topo.I)
    for k in range(topo.I):
        cs = topo.children[k, : topo.child_count[k]]
        params[k] = heights[topo.T + k] - heights[cs].max()
    return params


def branch_durations(heights: torch.Tensor, topo: Topology) -> torch.Tensor:
    """Per-node time-duration of the branch above each node: [(L,) N] with
    0 at the root. d(n) = h(parent(n)) - h(n)."""
    parent = topo_constant(
        topo, "parent_or_root",
        lambda: np.where(topo.parent >= 0, topo.parent, topo.root),
        heights, torch.long)
    d = heights[..., parent] - heights
    # the root is node N-1 and its entry is h(root) - h(root) = 0 already;
    # the explicit zero keeps its gradient at exactly nothing
    return torch.cat([d[..., :-1], torch.zeros_like(d[..., -1:])], -1)
