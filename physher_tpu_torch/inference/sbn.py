"""Subsplit Bayesian networks from posterior tree samples.

A copy of ``physher_tpu/inference/sbn.py`` (numpy only). Rebuild of the reference's SBN support (reference: src/phyc/sbn.c:1-389,
action "sbn" at src/physher.c:293): collect rootsplit and subsplit
frequencies from a posterior sample of (rooted) trees, yielding the SBN
parameterization of a distribution over topologies (Zhang & Matsen 2018).
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

from ..trees.topology import Topology


def _clades(topo: Topology):
    """node id -> frozenset of tip names below it."""
    below = {}
    for node in range(topo.T):
        below[node] = frozenset([topo.taxa[node]])
    for k in range(topo.I):
        node = topo.T + k
        s = frozenset()
        for j in range(topo.child_count[k]):
            s |= below[int(topo.children[k, j])]
        below[node] = s
    return below


def _canon(pair):
    a, b = pair
    return (a, b) if sorted(a)[0] <= sorted(b)[0] else (b, a)


class SBN:
    """Counts-based SBN estimate (the reference's simple-average variant)."""

    def __init__(self):
        self.rootsplit_counts = defaultdict(float)
        self.subsplit_counts = defaultdict(lambda: defaultdict(float))
        self.n_trees = 0

    def add_tree(self, topo: Topology, weight: float = 1.0):
        below = _clades(topo)
        self.n_trees += weight
        for k in range(topo.I):
            node = topo.T + k
            if topo.child_count[k] != 2:
                raise ValueError("SBN requires binary trees")
            c1 = below[int(topo.children[k, 0])]
            c2 = below[int(topo.children[k, 1])]
            ss = _canon((c1, c2))
            if node == topo.root:
                self.rootsplit_counts[ss] += weight
            else:
                parent_clade = below[node]
                self.subsplit_counts[parent_clade][ss] += weight

    def probabilities(self):
        """(rootsplit probs, conditional subsplit probs per parent clade)."""
        total = sum(self.rootsplit_counts.values())
        roots = {k: v / total for k, v in self.rootsplit_counts.items()}
        conds = {}
        for clade, counts in self.subsplit_counts.items():
            t = sum(counts.values())
            conds[clade] = {k: v / t for k, v in counts.items()}
        return roots, conds

    def log_prob(self, topo: Topology) -> float:
        """log SBN probability of a topology (-inf if unsupported)."""
        roots, conds = self.probabilities()
        below = _clades(topo)
        logp = 0.0
        for k in range(topo.I):
            node = topo.T + k
            c1 = below[int(topo.children[k, 0])]
            c2 = below[int(topo.children[k, 1])]
            ss = _canon((c1, c2))
            if node == topo.root:
                p = roots.get(ss, 0.0)
            else:
                p = conds.get(below[node], {}).get(ss, 0.0)
            if p <= 0.0:
                return -np.inf
            logp += np.log(p)
        return float(logp)

    @staticmethod
    def from_trees(trees, weights=None) -> "SBN":
        sbn = SBN()
        for i, t in enumerate(trees):
            topo = t[0] if isinstance(t, tuple) else t
            sbn.add_tree(topo, weights[i] if weights is not None else 1.0)
        return sbn
