"""Felsenstein pruning as level-batched tensor contractions (plain PyTorch).

Port of ``physher_tpu/ops/pruning.py``. This is the port's plain engine:
the CPU engine, the float64 golden engine, and the oracle that the CUDA
kernels of ``ops/fused.py`` are held against.

- partials are ``[N, C, S, P]`` (node, rate category, state, pattern),
- the postorder runs as ``len(levels)`` batched steps; every node in a
  level computes ``prod_children P_child @ partial_child`` as one einsum,
- rescaling (optional) factors the per-node per-pattern max over (C, S)
  into a log accumulator, exact in the final log-likelihood. The max is
  held constant for the gradient (``detach``): ``log(x/m) + log m = log x``
  whatever ``m`` is, so this changes no derivative.

Autograd gives the gradient w.r.t. the P matrices, frequencies and
category weights.
"""

from __future__ import annotations

import numpy as np
import torch

from ..trees.topology import Topology


def pruning_partials(tip_partials: torch.Tensor, pmats: torch.Tensor,
                     topo: Topology, *, rescale: bool = False):
    """Run the postorder sweep.

    Parameters
    ----------
    tip_partials : [T, S, P]
    pmats        : [N, C, S, S] transition matrices of the branch above each
                   node (root entry unused).
    Returns
    -------
    partials [N, C, S, P], log_scalers [N, P] (zeros when rescale=False)
    """
    T, S, P = tip_partials.shape
    N, C = pmats.shape[0], pmats.shape[1]
    tips_c = tip_partials[:, None].expand(T, C, S, P)
    parts = [tips_c[t] for t in range(T)] + [None] * (N - T)
    zero = tip_partials.new_zeros(P)
    scal = [zero] * N
    maxc = topo.children.shape[1]
    for ranks in topo.levels:
        nodes = topo.T + ranks
        res = None
        sc = None
        for j in range(maxc):
            ch = topo.children[ranks, j]
            mask = ch >= 0
            ch_safe = np.where(mask, ch, 0)
            pm = pmats[torch.as_tensor(ch_safe, device=pmats.device)]
            cp = torch.stack([parts[c] for c in ch_safe])   # [n, C, S, P]
            contrib = torch.einsum("ncij,ncjp->ncip", pm, cp)
            if not mask.all():
                m = torch.as_tensor(mask, dtype=contrib.dtype,
                                    device=contrib.device)[:, None, None, None]
                contrib = contrib * m + (1.0 - m)
            res = contrib if res is None else res * contrib
            if rescale:
                s = torch.stack([scal[c] if ok else zero
                                 for c, ok in zip(ch_safe, mask)])
                sc = s if sc is None else sc + s
        if rescale:
            m = torch.amax(res, dim=(1, 2)).detach()         # [n, P]
            m = torch.clamp(m, min=torch.finfo(res.dtype).tiny)
            res = res / m[:, None, None, :]
            sc = sc + torch.log(m)
        for i, node in enumerate(nodes):
            parts[node] = res[i]
            if rescale:
                scal[node] = sc[i]
    return torch.stack(parts), torch.stack(scal)


def root_log_likelihood(root_partials: torch.Tensor, freqs: torch.Tensor,
                        props: torch.Tensor, weights: torch.Tensor,
                        log_scalers: torch.Tensor | None = None):
    """Integrate over states and rate categories at the root and reduce.

    root_partials: [C, S, P]; returns (total logL, per-pattern site log-liks).
    """
    site_l = torch.einsum("s,csp->cp", freqs, root_partials)
    site_lik = torch.einsum("c,cp->p", props, site_l)
    site_log = torch.log(site_lik)
    if log_scalers is not None:
        site_log = site_log + log_scalers
    return torch.sum(weights * site_log), site_log


def tree_log_likelihood(tip_partials, pmats, topo: Topology, freqs, props,
                        weights, *, rescale: bool = False):
    """Full pruning likelihood: returns (logL, site_log_likelihoods)."""
    parts, scal = pruning_partials(tip_partials, pmats, topo, rescale=rescale)
    return root_log_likelihood(parts[topo.root], freqs, props, weights,
                               scal[topo.root] if rescale else None)


def rescaled_site_log(tip_partials, pmats, topo: Topology, freqs, props):
    """Per-pattern site log-likelihoods [P] of the rescaled postorder, in
    the form the CUDA kernels compute: ``log max(sum_{c,s} rootw * root,
    tiny) + sum_nodes log m`` with ``rootw = props (x) freqs``. The plain
    PyTorch version of the kernels of ``ops/fused.py`` and ``ops/wide.py``
    (tips are constants; autograd gives the gradient)."""
    parts, scal = pruning_partials(tip_partials.detach(), pmats, topo,
                                   rescale=True)
    rootw = props[:, None] * freqs[None, :]
    site = torch.einsum("cs,csp->p", rootw, parts[topo.root])
    site = torch.clamp(site, min=torch.finfo(site.dtype).tiny)
    return torch.log(site) + scal[topo.root]


def pad_patterns(n: int, multiple: int = 128) -> int:
    """Pattern-axis padding target."""
    return int(-(-n // multiple) * multiple)
