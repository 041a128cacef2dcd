"""Felsenstein pruning as level-batched tensor contractions (plain PyTorch).

Port of ``physher_tpu/ops/pruning.py``. This is the port's plain engine:
the CPU engine, the float64 golden engine, and the oracle that the CUDA
kernels of ``ops/fused.py``, ``ops/staged.py``, ``ops/wide.py`` and
``ops/loop.py`` are held against.

- partials are ``[C, S, P]`` per node (rate category, state, pattern),
- the postorder runs as ``len(levels)`` batched steps; every node in a
  level computes ``prod_children P_child @ partial_child`` as one einsum,
- rescaling (optional) factors the per-node per-pattern max over (C, S)
  into a log accumulator, exact in the final log-likelihood. The max is
  held constant for the gradient (``detach``): ``log(x/m) + log m = log x``
  whatever ``m`` is, so this changes no derivative.

:func:`pruning_partials` keeps every node's partials in one buffer
``[N, C, S, P]``, for the upper partials and the ancestral analyses
(``ops/upper.py``, ``likelihood/analysis.py``).

:func:`tree_log_likelihood` runs the level-array form
(:func:`pruning_root_levels`): the partials of each level live in their own
array, gathered slot-wise from earlier levels, and a leading chain axis L
may run through it (``pmats [L, N, C, S, S]``, ``freqs [L, S]``,
``props [L, C]``; the tips ``[T, S, P]`` are shared by every chain). It is
the CPU engine for chain batches and the plain version of the batched loop
kernels K5'/K6'.

Autograd gives the gradient w.r.t. the P matrices, frequencies and
category weights.
"""

from __future__ import annotations

import numpy as np
import torch

from ..trees.topology import Topology


def pruning_partials(tip_partials: torch.Tensor, pmats: torch.Tensor,
                     topo: Topology, *, rescale: bool = False):
    """The postorder sweep level by level, keeping every node's partials
    (the input of the upper partials and the ancestral analyses).

    tip_partials [T, S, P]; pmats [N, C, S, S], the branch above each node
    (root entry unused). Returns partials [N, C, S, P] and log-scalers
    [N, P] (zeros unless ``rescale``)."""
    T, S, P = tip_partials.shape
    N, C = pmats.shape[0], pmats.shape[1]
    dev = tip_partials.device
    buf = tip_partials.new_zeros((N, C, S, P))
    buf[:T] = tip_partials[:, None]
    scal = tip_partials.new_zeros((N, P))
    maxc = topo.children.shape[1]
    for ranks in topo.levels:
        nodes = torch.as_tensor(topo.T + ranks, dtype=torch.long, device=dev)
        res = sc = None
        for j in range(maxc):
            ch = topo.children[ranks, j]
            mask = ch >= 0
            ch_safe = torch.as_tensor(np.where(mask, ch, 0), dtype=torch.long,
                                      device=dev)
            contrib = torch.einsum("ncij,ncjp->ncip", pmats[ch_safe],
                                   buf[ch_safe])
            if not mask.all():
                m = torch.as_tensor(mask, dtype=buf.dtype,
                                    device=dev)[:, None, None, None]
                contrib = contrib * m + (1.0 - m)
            res = contrib if res is None else res * contrib
            if rescale:
                s = torch.where(torch.as_tensor(mask, device=dev)[:, None],
                                scal[ch_safe], 0.0)
                sc = s if sc is None else sc + s
        if rescale:
            m = torch.clamp(torch.amax(res, dim=(1, 2)),
                            min=torch.finfo(res.dtype).tiny)
            res = res / m[:, None, None, :]
            scal[nodes] = sc + torch.log(m)
        buf[nodes] = res
    return buf, scal


def root_log_likelihood(root_partials: torch.Tensor, freqs: torch.Tensor,
                        props: torch.Tensor, weights: torch.Tensor,
                        log_scalers: torch.Tensor | None = None):
    """Integrate over states and rate categories at the root and reduce.

    root_partials: [(L,) C, S, P]; returns (total logL [(L)], per-pattern
    site log-liks [(L,) P]).
    """
    site_l = torch.einsum("...s,...csp->...cp", freqs, root_partials)
    site_lik = torch.einsum("...c,...cp->...p", props, site_l)
    site_log = torch.log(site_lik)
    if log_scalers is not None:
        site_log = site_log + log_scalers
    return torch.sum(weights * site_log, -1), site_log


def _level_schedule(topo: Topology):
    """Per-level gather plan for the level-array engine, cached on the
    topology (the JAX package's ``_level_schedule``).

    For level ``d`` and child slot ``j``, children are grouped by SOURCE
    (-1 = tips, else an earlier level index), each group carrying
    (positions-in-level, positions-in-source); ``"pad"`` lists the
    positions whose node has no child in that slot. Returns (plan,
    root level, root position)."""
    cached = topo.__dict__.get("_level_sched")
    if cached is not None:
        return cached
    lev_of, pos_of = {}, {}
    for d, ranks in enumerate(topo.levels):
        for i, k in enumerate(ranks):
            lev_of[int(k)] = d
            pos_of[int(k)] = i
    maxc = topo.children.shape[1]
    plan = []
    for ranks in topo.levels:
        slots = []
        for j in range(maxc):
            groups: dict = {}
            for i, k in enumerate(ranks):
                ch = int(topo.children[k, j])
                if j >= int(topo.child_count[k]) or ch < 0:
                    groups.setdefault("pad", []).append(i)
                    continue
                src, sp = ((-1, ch) if ch < topo.T
                           else (lev_of[ch - topo.T], pos_of[ch - topo.T]))
                tgt_list, src_list = groups.setdefault(src, ([], []))
                tgt_list.append(i)
                src_list.append(sp)
            slots.append({k: (np.asarray(v[0]), np.asarray(v[1]))
                          if isinstance(v, tuple) else np.asarray(v)
                          for k, v in groups.items()})
        plan.append((np.asarray(ranks), slots))
    sched = (plan, lev_of[topo.root - topo.T], pos_of[topo.root - topo.T])
    topo.__dict__["_level_sched"] = sched
    return sched


def pruning_root_levels(tip_partials, pmats, topo: Topology, *,
                        rescale: bool = False):
    """Level-array postorder: returns (root_partials [(L,) C, S, P],
    root_log_scalers [(L,) P] or None).

    The partials live in per-level arrays ``[L, n_level, C, S, P]``
    gathered slot-wise from earlier levels.
    ``pmats`` is ``[N, C, S, S]`` or, for a batch of L chains,
    ``[L, N, C, S, S]``; the tips are shared by every chain."""
    batched = pmats.dim() == 5
    if not batched:
        pmats = pmats[None]
    L, C = pmats.shape[0], pmats.shape[2]
    T, S, P = tip_partials.shape
    dev = tip_partials.device

    def idx(a):
        return torch.as_tensor(a, dtype=torch.long, device=dev)

    plan, root_level, root_pos = _level_schedule(topo)
    tips_c = tip_partials[None, :, None].expand(L, T, C, S, P)
    level_parts: list = []
    level_scal: list = []
    for ranks, slots in plan:
        n = len(ranks)
        res = None
        sc = tip_partials.new_zeros((L, n, P)) if rescale else None
        for j, groups in enumerate(slots):
            real = [(src, grp) for src, grp in groups.items()
                    if src != "pad"]
            if not real:  # every node lacks this child slot
                continue
            if len(real) == 1 and len(real[0][1][0]) == n and (
                    real[0][1][0] == np.arange(n)).all():
                # single full in-order group: plain gather, no placement
                src, (_, sp) = real[0]
                src_arr = tips_c if src == -1 else level_parts[src]
                cp = src_arr[:, idx(sp)]
                if rescale and src != -1:
                    sc = sc + level_scal[src][:, idx(sp)]
            else:
                cp = tips_c.new_zeros((L, n, C, S, P))
                for src, (tgt, sp) in real:
                    src_arr = tips_c if src == -1 else level_parts[src]
                    cp = cp.index_copy(1, idx(tgt), src_arr[:, idx(sp)])
                    if rescale and src != -1:
                        sc = sc.index_add(1, idx(tgt),
                                          level_scal[src][:, idx(sp)])
            ch_col = topo.children[ranks, j]
            has = ch_col >= 0
            pm = pmats[:, idx(np.where(has, ch_col, 0))]
            contrib = torch.einsum("lncij,lncjp->lncip", pm, cp)
            if not has.all():
                m = torch.as_tensor(has, dtype=contrib.dtype,
                                    device=dev)[:, None, None, None]
                contrib = contrib * m + (1.0 - m)
            res = contrib if res is None else res * contrib
        if rescale:
            m = torch.amax(res, dim=(2, 3)).detach()         # [L, n, P]
            m = torch.clamp(m, min=torch.finfo(res.dtype).tiny)
            res = res / m[:, :, None, None, :]
            sc = sc + torch.log(m)
        level_parts.append(res)
        level_scal.append(sc)
    root = level_parts[root_level][:, root_pos]
    scal = level_scal[root_level][:, root_pos] if rescale else None
    if not batched:
        root = root[0]
        scal = scal[0] if rescale else None
    return root, scal


def tree_log_likelihood(tip_partials, pmats, topo: Topology, freqs, props,
                        weights, *, rescale: bool = False):
    """Full pruning likelihood through the level arrays: returns (logL,
    site_log_likelihoods), ``[L]`` and ``[L, P]`` for a batch of L chains
    (``pmats [L, N, C, S, S]``, ``freqs [L, S]``, ``props [L, C]``)."""
    root, scal = pruning_root_levels(tip_partials, pmats, topo,
                                     rescale=rescale)
    return root_log_likelihood(root, freqs, props, weights, scal)


def rescaled_site_log(tip_partials, pmats, topo: Topology, freqs, props, *,
                      rescale: bool = True):
    """Per-pattern site log-likelihoods ``[(L,) P]`` in the form the CUDA
    kernels compute: ``log max(sum_c props_c sum_s freqs_s root[c, s],
    tiny) + sum_nodes log m``. The plain PyTorch version of the kernels of
    ``ops/fused.py``, ``ops/staged.py``, ``ops/wide.py`` and (with a chain
    axis and ``rescale`` on or off) ``ops/loop.py``; tips are constants,
    autograd gives the gradient."""
    root, scal = pruning_root_levels(tip_partials.detach(), pmats, topo,
                                     rescale=rescale)
    site = torch.einsum("...c,...s,...csp->...p", props, freqs, root)
    site = torch.log(torch.clamp(site, min=torch.finfo(site.dtype).tiny))
    return site + scal if rescale else site


def pad_patterns(n: int, multiple: int = 128) -> int:
    """Pattern-axis padding target."""
    return int(-(-n // multiple) * multiple)
