"""Dated (time) tree construction: tip dates -> heights -> ratio init.

Reproduces the reference's initialization pipeline exactly (it determines the
golden log-likelihoods of the dated fluA tests):

1. ``init_dates``: tip height = max(date) - date for heterochronous data
   (reference: src/phyc/tree.c:353-392),
2. ``init_heights_from_distances``: internal height = max over children of
   (child height + clamp(child branch length, 1e-6, inf)), postorder
   (reference: src/phyc/tree.c:498-585),
3. inverse ratio transform initializes the reparameterization
   (reference: src/phyc/tree.c:522-571 + treetransform.c:263-266).
"""

from __future__ import annotations

import numpy as np

from .topology import Topology
from .heights import compute_lowers, ratios_from_heights


class TimeTreeData:
    """Static data of a dated tree: tip heights, lowers, initial parameters."""

    def __init__(self, topo: Topology, tip_heights: np.ndarray,
                 node_heights0: np.ndarray, dates: dict | None = None):
        self.topo = topo
        self.tip_heights = np.asarray(tip_heights, dtype=np.float64)
        self.node_heights0 = np.asarray(node_heights0, dtype=np.float64)
        self.lowers = compute_lowers(topo, self.tip_heights)
        self.ratios0 = ratios_from_heights(self.node_heights0, topo, self.lowers)
        self.dates = dict(dates) if dates else None

    @staticmethod
    def from_dated_tree(topo: Topology, distances: np.ndarray,
                        dates: dict | None) -> "TimeTreeData":
        """Build from a newick tree (branch lengths in time units) + tip dates."""
        T, N = topo.T, topo.N
        heights = np.zeros(N)
        homochronous = True
        if dates:
            tipmap = topo.tip_name_to_id()
            tip_dates = np.zeros(T)
            for name, date in dates.items():
                if name not in tipmap:
                    raise ValueError(f"taxon {name!r} in dates not found in tree")
                tip_dates[tipmap[name]] = float(date)
                if float(date) != 0.0:
                    homochronous = False
            if not homochronous:
                heights[:T] = tip_dates.max() - tip_dates
        if homochronous:
            heights[:T] = 0.0
        # postorder: internal height from child heights + clamped branch lengths
        for k in range(topo.I):
            node = T + k
            cs = topo.children[k, : topo.child_count[k]]
            d = np.clip(np.nan_to_num(distances[cs], nan=1e-6), 1e-6, np.inf)
            heights[node] = (heights[cs] + d).max()
        return TimeTreeData(topo, heights[:T], heights, dates)

    @staticmethod
    def from_heights(topo: Topology, node_heights: np.ndarray) -> "TimeTreeData":
        return TimeTreeData(topo, node_heights[: topo.T], node_heights)
