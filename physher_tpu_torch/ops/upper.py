"""Upper (pre-order) partials and marginal node posteriors.

Port of ``physher_tpu/ops/upper.py`` (reference:
src/phyc/treelikelihood.c:2129 ``update_upper_partials``, and marginal
ancestral reconstruction at src/phyc/asr.c:104). The preorder sweep runs on
the topology's preorder level schedule with the batched einsums of the
postorder engine. The JAX package computes these in plain XLA, not in a
Pallas kernel, so here they are plain PyTorch on either device.

``upper[n, c, s, p]`` is the likelihood of all data outside n's subtree
given state s at node n, so the node marginal is upper * lower, and the
root's upper partials are the root frequencies.
"""

from __future__ import annotations

import numpy as np
import torch

from ..trees.topology import Topology


def upper_partials(lower: torch.Tensor, pmats: torch.Tensor, topo: Topology,
                   freqs: torch.Tensor) -> torch.Tensor:
    """Upper partials [N, C, S, P] from the postorder buffer ``lower``
    [N, C, S, P] (``ops.pruning.pruning_partials``) and the branch matrices
    ``pmats`` [N, C, S, S] (the branch above each node)."""
    N, C, S, P = lower.shape
    dev = lower.device
    up = lower.new_zeros((N, C, S, P))
    up[topo.root] = freqs[None, :, None].expand(C, S, P)
    maxc = topo.children.shape[1]
    for ranks in topo.preorder_levels:
        # the CHILDREN of these internal nodes: for child j of parent k,
        # up[child] = P_child^T @ (up[parent] * prod_{sib != child} P_sib
        # lower[sib])
        parents = torch.as_tensor(topo.T + ranks, dtype=torch.long,
                                  device=dev)
        contribs = []
        for j in range(maxc):
            mask = topo.children[ranks, j] >= 0
            ch_safe = np.where(mask, topo.children[ranks, j], 0)
            idx = torch.as_tensor(ch_safe, dtype=torch.long, device=dev)
            c = torch.einsum("ncij,ncjp->ncip", pmats[idx], lower[idx])
            if not mask.all():
                m = torch.as_tensor(mask, dtype=lower.dtype,
                                    device=dev)[:, None, None, None]
                c = c * m + (1.0 - m)
            contribs.append((mask, ch_safe, idx, c))
        parent_up = up[parents]
        for j in range(maxc):
            mask, ch_safe, idx, _ = contribs[j]
            prod = parent_up
            for j2 in range(maxc):
                if j2 != j:
                    prod = prod * contribs[j2][3]
            upc = torch.einsum("ncji,ncjp->ncip", pmats[idx], prod)  # P^T
            if not mask.all():
                sel = np.where(mask)[0]
                up[torch.as_tensor(ch_safe[sel], dtype=torch.long,
                                   device=dev)] = upc[torch.as_tensor(
                                       sel, dtype=torch.long, device=dev)]
            else:
                up[idx] = upc
    return up


def node_marginals(lower, upper, props, weights=None):
    """Posterior state probabilities per node and pattern [N, S, P]
    (reference: src/phyc/asr.c, marginal ASR from upper * lower)."""
    joint = torch.einsum("c,ncsp->nsp", props, lower * upper)
    return joint / joint.sum(1, keepdim=True)


def site_category_posteriors(lower_root, upper_root_freqs, props):
    """P(category | pattern) [C, P] (reference: src/phyc/ppsites.c:16-30)."""
    site_l = torch.einsum("s,csp->cp", upper_root_freqs, lower_root)
    joint = props[:, None] * site_l
    return joint / joint.sum(0, keepdim=True)
