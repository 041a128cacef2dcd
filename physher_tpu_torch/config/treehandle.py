"""TreeHandle: the config-layer view of a tree model.

Port of ``physher_tpu/config/treehandle.py``. It bundles the topology and
branch data with the parameter names the tree likelihood uses, and exposes
functions of the parameter dict (heights, branch durations, tree length) so
that priors and coalescents built from JSON bind to the same tree as the
likelihood (the reference shares one Tree object through its hashtable;
reference: src/physher.c:163-205).
"""

from __future__ import annotations

import torch

from ..trees.heights import (
    heights_from_ratios, heights_from_shifts, branch_durations, ratio_params,
)
from ..trees.timetree import TimeTreeData
from ..trees.topology import Topology


class TreeHandle:
    def __init__(self, topo: Topology, distances, td: TimeTreeData | None,
                 prefix: str = "tree."):
        self.topo = topo
        self.distances = distances
        self.td = td
        self.prefix = prefix
        # height reparameterization (reference: treetransform.h:17-22);
        # build_tree overrides it from the JSON "transform" key
        self.transform = "ratio"

    @property
    def is_time_tree(self):
        return self.td is not None

    def key(self, k):
        return f"{self.prefix}{k}"

    def heights(self, params) -> torch.Tensor:
        td = self.td
        if self.transform == "shift":
            return heights_from_shifts(params[self.key("shifts")], self.topo,
                                       td.tip_heights)
        ratios = ratio_params(params[self.key("ratios")],
                              params[self.key("root_height")])
        return heights_from_ratios(ratios, self.topo, td.tip_heights,
                                   td.lowers)

    def durations(self, params) -> torch.Tensor:
        return branch_durations(self.heights(params), self.topo)

    def tree_length(self, params) -> torch.Tensor:
        """Total time length (sum of branch durations), the CTMC-scale
        prior's T (reference: src/phyc/ctmcscale.c:21-27); one per batch
        entry."""
        if self.is_time_tree:
            return torch.sum(self.durations(params), -1)
        return torch.sum(params[self.key("distances")], -1)
