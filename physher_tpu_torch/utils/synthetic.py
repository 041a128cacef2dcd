"""Synthetic benchmark fixtures: balanced topologies and random alignments."""

from __future__ import annotations

import numpy as np

from ..trees.topology import Topology
from ..data.sitepattern import SitePattern
from ..data.datatype import get_datatype


def balanced_topology(n_tips: int) -> Topology:
    """Balanced-ish rooted binary tree over ``n_tips`` (power of two ideal)."""

    def build(lo, hi):
        if hi - lo == 1:
            return {"name": f"t{lo}", "length": 0.1, "children": []}
        mid = (lo + hi) // 2
        return {"name": None, "length": 0.1,
                "children": [build(lo, mid), build(mid, hi)]}

    topo, _ = Topology.from_nested(build(0, n_tips))
    return topo


def caterpillar_topology(n_tips: int) -> Topology:
    """Caterpillar (ladder) tree over ``n_tips``: the deepest rooted binary
    tree, one internal node per level."""
    nested = {"name": "t0", "length": 0.1, "children": []}
    for i in range(1, n_tips):
        nested = {"name": None, "length": 0.1, "children": [
            nested, {"name": f"t{i}", "length": 0.1, "children": []}]}
    topo, _ = Topology.from_nested(nested)
    return topo


def random_alignment(n_tips: int, n_sites: int, seed: int = 0,
                     datatype: str = "nucleotide"):
    """Random (incompressible) alignment dict for throughput benchmarks."""
    dt = get_datatype(datatype)
    rng = np.random.default_rng(seed)
    symbols = [dt.symbol(i) for i in range(dt.state_count)]
    out = {}
    for i in range(n_tips):
        states = rng.integers(0, dt.state_count, n_sites)
        out[f"t{i}"] = "".join(symbols[s] for s in states)
    return out


def random_sitepattern(n_tips: int, n_patterns: int, seed: int = 0,
                       datatype: str = "nucleotide") -> SitePattern:
    """Directly build a SitePattern with ``n_patterns`` unique columns and
    unit weights (skips compression; for kernel benchmarks)."""
    dt = get_datatype(datatype)
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, dt.state_count, (n_tips, n_patterns)).astype(np.int32)
    weights = np.ones(n_patterns)
    indexes = np.arange(n_patterns, dtype=np.int32)
    taxa = [f"t{i}" for i in range(n_tips)]
    return SitePattern(codes, weights, indexes, taxa, dt)
