"""Fitch parsimony as vectorized boolean set operations.

Port of ``physher_tpu/likelihood/parsimony.py`` (reference:
src/phyc/parsimony.c:28-952: Fitch sets with int scores, used standalone
and to pre-screen SPR moves). State sets are boolean masks ``[nodes,
patterns, states]``; the postorder runs on the likelihood engine's level
schedule. Scores are weighted pattern counts.
"""

from __future__ import annotations

import numpy as np
import torch

from ..data.sitepattern import SitePattern
from ..models.parameters import ParamSpace
from ..trees.topology import Topology


def tip_state_sets(sp: SitePattern, topo: Topology) -> np.ndarray:
    """[T, P, S] boolean state sets from the datatype's ambiguity table, in
    the topology's tip order."""
    order = [sp.taxa.index(t) for t in topo.taxa]
    table = sp.datatype.partials_table > 0  # [codes, S]
    return table[sp.codes][order]


def fitch_score(tip_sets: torch.Tensor, topo: Topology,
                weights: torch.Tensor) -> torch.Tensor:
    """Weighted Fitch parsimony score (a scalar tensor) of ``tip_sets``
    bool [T, P, S] on ``topo``."""
    T, P, S = tip_sets.shape
    dev = tip_sets.device
    sets = torch.zeros((topo.N, P, S), dtype=torch.bool, device=dev)
    sets[:T] = tip_sets
    score = torch.zeros(P, dtype=weights.dtype, device=dev)
    maxc = topo.children.shape[1]
    for ranks in topo.levels:
        inter = union = None
        for j in range(maxc):
            ch = topo.children[ranks, j]
            mask = ch >= 0
            s = sets[torch.as_tensor(np.where(mask, ch, 0), dtype=torch.long,
                                     device=dev)]
            if not mask.all():
                s = s | ~torch.as_tensor(mask, device=dev)[:, None, None]
            inter = s if inter is None else inter & s
            union = s if union is None else union | s
        empty = ~inter.any(-1)  # [n, P]
        sets[torch.as_tensor(topo.T + ranks, dtype=torch.long, device=dev)] = \
            torch.where(empty[..., None], union, inter)
        score = score + empty.sum(0)
    return torch.sum(score * weights)


class Parsimony:
    """Parsimony 'model' over a fixed topology (config type "parsimony",
    reference: src/physher.c:190 MODEL_PARSIMONY); its tensors on
    ``device``, the weights in ``dtype``."""

    def __init__(self, sp: SitePattern, topo: Topology, *,
                 dtype: torch.dtype, device):
        self.sp = sp
        self.topo = topo
        self.tip_sets = torch.as_tensor(tip_state_sets(sp, topo),
                                        device=device)
        self.weights = torch.as_tensor(sp.weights, dtype=dtype,
                                       device=device)

    def param_specs(self):
        return []

    def param_space(self):
        return ParamSpace([])

    def score(self, topo: Topology | None = None) -> float:
        topo = topo or self.topo
        tips = self.tip_sets
        if topo is not self.topo:
            tips = tips[[self.topo.taxa.index(t) for t in topo.taxa]]
        return float(fitch_score(tips, topo, self.weights))

    def log_prob(self, params=None):
        """Negated score, so that 'maximize logP' minimizes parsimony."""
        return -fitch_score(self.tip_sets, self.topo, self.weights)

    __call__ = log_prob
