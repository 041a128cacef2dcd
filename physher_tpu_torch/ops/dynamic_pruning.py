"""Pruning with the topology as runtime data (for batched tree search).

Port of ``physher_tpu/ops/dynamic_pruning.py``. The main engines walk a
fixed ``Topology`` (its level schedule, or the CUDA kernels' schedule
cached on it). Tree search and the batched tree MCMC score MANY topologies
at once, one a row: here the children arrays are tensors ``[B, I, 2]``
(binary; node ids, tips ``< T``, internal row ``k`` = id ``T + k``, root =
``N - 1``), and the postorder is a loop over internal ranks that gathers
every row's children by advanced indexing across the batch B. The JAX
package ``vmap``s a per-node ``lax.scan`` over candidates so that one
compiled evaluator takes every topology; in PyTorch a new topology costs
no compile, and the batch is an explicit leading axis.

Each function takes one topology (children ``[I, 2]``, pmats ``[N, C, S,
S]``) or a batch (children ``[B, I, 2]``, pmats ``[B, N, C, S, S]``); the
tips ``[T, S, P]`` are shared by the rows, or ``[B, T, S, P]`` one set a
row (candidates whose taxa are numbered differently). ``freqs`` ``[S]`` /
``[B, S]`` and ``props`` ``[C]`` / ``[B, C]``.

These run as plain PyTorch on either device: the JAX package computes them
in plain XLA, not in a Pallas kernel. On the card a sweep is a handful of
launches a node whatever B (two gathers, one batched product, the
children's product and the write; with rescaling a few more).

Children must satisfy children-before-parents id order for the id-order
sweep (:func:`tree_loglik_dynamic`); device-side NNI edits can break it,
and :func:`postorder_from_children` gives a valid order for any tree.
"""

from __future__ import annotations

import numpy as np
import torch


def _batched(children: torch.Tensor, *tensors):
    """(True, inputs) for a batch; else (False, inputs with a unit batch
    axis put in front)."""
    if children.dim() == 3:
        return True, (children,) + tensors
    return False, (children[None],) + tuple(
        None if t is None else t[None] for t in tensors)


def _sweep(tips, pmats, children, order=None, *, rescale: bool = False):
    """The postorder over a batch: buf [B, N, C, S, P], scal [B, N, P].
    ``order`` [B, I] (None: id order)."""
    B, N, C, S = pmats.shape[:4]
    T, P = tips.shape[-3], tips.shape[-1]
    I = N - T
    dev = pmats.device
    buf = tips.new_zeros((B, N, C, S, P))
    buf[:, :T] = tips[..., None, :, :]
    scal = tips.new_zeros((B, N, P))
    rows = torch.arange(B, device=dev)
    rows2 = rows[:, None]
    tiny = torch.finfo(tips.dtype).tiny
    for k in range(I):
        if order is None:
            kids = children[:, k]                        # [B, 2]
            node = T + k
        else:
            r = order[:, k]
            kids = children[rows, r]
            node = T + r
        both = torch.einsum("bkcij,bkcjp->bkcip", pmats[rows2, kids],
                            buf[rows2, kids])
        res = both[:, 0] * both[:, 1]
        if rescale:
            m = torch.clamp(torch.amax(res, dim=(1, 2)), min=tiny)   # [B, P]
            res = res / m[:, None, None]
            scal[rows, node] = scal[rows2, kids].sum(1) + torch.log(m)
        buf[rows, node] = res
    return buf, scal


def root_loglik_from_partials(buf, scal, freqs, props, weights, *,
                              rescale: bool = False):
    """(logL, site_log) from a partials state (root = last node)."""
    site_l = torch.einsum("...s,...csp->...cp", freqs, buf[..., -1, :, :, :])
    site_log = torch.log(torch.einsum("...c,...cp->...p", props, site_l))
    if rescale:
        site_log = site_log + scal[..., -1, :]
    return torch.sum(weights * site_log, -1), site_log


def tree_loglik_dynamic(tip_partials, pmats, children, freqs, props,
                        weights, *, rescale: bool = False):
    """Likelihood with the topology as data, children in id order: returns
    (logL, site_log), ``[B]`` and ``[B, P]`` for a batch."""
    return tree_loglik_dynamic_ordered(tip_partials, pmats, children, None,
                                       freqs, props, weights,
                                       rescale=rescale)


def batched_tree_loglik(tip_partials, pmats_batch, children_batch, freqs,
                        props, weights, *, rescale: bool = False):
    """Candidate topologies as one batch: pmats [B, N, C, S, S], children
    [B, I, 2] -> logLs [B]."""
    return tree_loglik_dynamic(tip_partials, pmats_batch, children_batch,
                               freqs, props, weights, rescale=rescale)[0]


def parent_array(children, T: int):
    """parent[n] for every node ([N] or [B, N]); the root points to
    itself."""
    batched, (ch,) = _batched(children)
    B, I = ch.shape[:2]
    N = T + I
    nodes = (T + torch.arange(I, device=ch.device)).expand(B, I)
    parent = torch.full((B, N), N - 1, dtype=ch.dtype, device=ch.device)
    parent.scatter_(1, ch[..., 0], nodes)
    parent.scatter_(1, ch[..., 1], nodes)
    parent[:, N - 1] = N - 1
    return parent if batched else parent[0]


def _depths(parent):
    """Every node's distance to the root [B, N] by pointer doubling on
    ``parent`` [B, N]: ceil(log2 N) gather rounds."""
    N = parent.shape[1]
    dist = (torch.arange(N, device=parent.device) != N - 1).to(
        parent.dtype).expand_as(parent)
    ptr = parent
    for _ in range(max(1, int(np.ceil(np.log2(max(N, 2)))))):
        dist = dist + torch.gather(dist, 1, ptr)
        ptr = torch.gather(ptr, 1, ptr)
    return dist


def postorder_from_children(children, T: int):
    """A valid internal-node evaluation order ([I] or [B, I]) for ANY
    children array (no children-before-parents invariant needed).

    Device-side NNI edits (:func:`propose_nni_device`) can hang a
    higher-numbered subtree under a lower-numbered internal node. Every
    node's depth comes from pointer doubling on the parent array, and the
    internals are evaluated deepest first (a stable argsort, as the JAX
    package's): children are strictly deeper than their parents, so every
    dependency is met."""
    batched, (ch,) = _batched(children)
    dist = _depths(parent_array(ch, T))
    order = torch.argsort(-dist[:, T:], dim=1, stable=True)
    return order if batched else order[0]


def tree_loglik_dynamic_ordered(tip_partials, pmats, children, order, freqs,
                                props, weights, *, rescale: bool = False):
    """:func:`tree_loglik_dynamic` with an explicit evaluation order
    ([I] or [B, I], from :func:`postorder_from_children`; None: id order),
    the evaluator for device-side topology proposals."""
    batched, (ch, pm, od) = _batched(children, pmats, order)
    buf, scal = _sweep(tip_partials, pm, ch, od, rescale=rescale)
    logl, site = root_loglik_from_partials(buf, scal, freqs, props, weights,
                                           rescale=rescale)
    return (logl, site) if batched else (logl[0], site[0])


def tree_partials_dynamic_ordered(tip_partials, pmats, children, order, *,
                                  rescale: bool = False):
    """The whole postorder's state (buf [(B,) N, C, S, P], scal [(B,) N,
    P]): the start of the incremental sampler
    (:func:`update_path_partials`)."""
    batched, (ch, pm, od) = _batched(children, pmats, order)
    buf, scal = _sweep(tip_partials, pm, ch, od, rescale=rescale)
    return (buf, scal) if batched else (buf[0], scal[0])


def update_path_partials(buf, scal, pmats, children, start, T: int, *,
                         rescale: bool = False, parent=None):
    """Incremental recompute: new partials, refreshed from node ``start``
    ([B] or a scalar) up the root path only (reference: dirty-flag
    recomputation with O(1) store/restore, src/phyc/treelikelihood.c:
    126-161). ``buf`` and ``scal`` are left as they are, so keeping them is
    the restore.

    Every row climbs as many steps as the longest path of the batch (one
    host read), as the JAX package's ``while_loop`` under ``vmap`` does: a
    row that has reached the root recomputes the root again, which changes
    nothing."""
    batched, (ch, b, s, pm, st, par) = _batched(
        children, buf, scal, pmats,
        torch.as_tensor(start, device=buf.device), parent)
    B, N = b.shape[:2]
    if par is None:
        par = parent_array(ch, T)
    rows = torch.arange(B, device=b.device)
    rows2 = rows[:, None]
    node = st.to(torch.long).expand(B)
    steps = int(torch.gather(_depths(par), 1, node[:, None]).max()) + 1
    b, s = b.clone(), s.clone()
    tiny = torch.finfo(b.dtype).tiny
    for _ in range(steps):
        kids = ch[rows, node - T]
        both = torch.einsum("bkcij,bkcjp->bkcip", pm[rows2, kids],
                            b[rows2, kids])
        res = both[:, 0] * both[:, 1]
        if rescale:
            m = torch.clamp(torch.amax(res, dim=(1, 2)), min=tiny)
            res = res / m[:, None, None]
            s[rows, node] = s[rows2, kids].sum(1) + torch.log(m)
        b[rows, node] = res
        node = torch.where(node == N - 1, node, par[rows, node])
    return (b, s) if batched else (b[0], s[0])


def nni_edit(children, c, side, T: int):
    """The rooted NNI on internal non-root node ``c`` ([B] or a scalar) as
    two row edits: c's child on ``side`` (bool: True the second) swaps
    places with c's sibling. Returns the new children array; node ids are
    untouched, so each branch travels with its subtree."""
    batched, (ch,) = _batched(children)
    B = ch.shape[0]
    dev = ch.device
    rows = torch.arange(B, device=dev)
    c = torch.as_tensor(c, device=dev).to(torch.long).expand(B)
    side = torch.as_tensor(side, device=dev).to(torch.bool).expand(B)
    parent = parent_array(ch, T)
    rc = c - T
    rp = parent[rows, c] - T
    prow, crow = ch[rows, rp], ch[rows, rc]                    # [B, 2]
    s = torch.where(prow[:, 0] == c, prow[:, 1], prow[:, 0])
    a = torch.where(side, crow[:, 1], crow[:, 0])
    c_row = torch.where(side[:, None],
                        torch.stack([crow[:, 0], s], -1),
                        torch.stack([s, crow[:, 1]], -1))
    p_row = torch.where(prow == s[:, None], a[:, None], prow)
    out = ch.clone()
    out[rows, rc] = c_row
    out[rows, rp] = p_row
    return out if batched else out[0]


def propose_nni_device(generator: torch.Generator, children, T: int):
    """One uniform rooted-NNI move a row, as index edits on the device.

    Draws an internal non-root node c and a side (which child of c), then
    :func:`nni_edit` (the reference's NNI operator,
    src/phyc/operator.c:419-626). Uniform over (c, side) pairs, whose count
    is the same for every binary topology on T taxa: a symmetric proposal,
    log q ratio 0. The edited array may break children-before-parents id
    order: evaluate it with :func:`postorder_from_children`. Returns
    ``(children', c)``; c is the deepest node it dirtied, where the
    incremental evaluator starts (:func:`update_path_partials`)."""
    batched, (ch,) = _batched(children)
    B, I = ch.shape[:2]
    dev = ch.device
    c = torch.randint(T, T + I - 1, (B,), generator=generator, device=dev)
    side = torch.rand(B, generator=generator, device=dev) < 0.5
    out = nni_edit(ch, c, side, T)
    return (out, c) if batched else (out[0], c[0])


def fitch_score_dynamic(tip_sets, children, weights):
    """Weighted Fitch score with the topology as data (the SPR prescreen,
    reference: src/phyc/spropt.c): tip_sets bool [T, P, S] or [B, T, P, S];
    a scalar, or [B] for a batch."""
    batched, (ch,) = _batched(children)
    B, I = ch.shape[:2]
    T, P, S = tip_sets.shape[-3:]
    dev = ch.device
    sets = torch.zeros((B, T + I, P, S), dtype=torch.bool, device=dev)
    sets[:, :T] = tip_sets
    rows = torch.arange(B, device=dev)
    score = torch.zeros(B, dtype=weights.dtype, device=dev)
    for k in range(I):
        sl = sets[rows, ch[:, k, 0]]
        sr = sets[rows, ch[:, k, 1]]
        inter = sl & sr
        empty = ~inter.any(-1)                                    # [B, P]
        sets[:, T + k] = torch.where(empty[..., None], sl | sr, inter)
        score = score + empty.to(weights.dtype) @ weights
    return score if batched else score[0]


def batched_fitch(tip_sets, children_batch, weights):
    """Fitch scores of B topologies [B]."""
    return fitch_score_dynamic(tip_sets, children_batch, weights)
