"""Static tree topology as index arrays, with level schedules for TPU pruning.

The reference keeps a pointer-based ``Node``/``Tree`` graph with listeners
(reference: src/phyc/tree.c:38-55, src/phyc/node.h:34-54). Here a topology is
a frozen set of NumPy index arrays:

- node ids follow the reference convention (reference: src/phyc/tree.c:183-200
  ``init_indices``): tips get ids ``0..T-1`` in postorder visit order, internal
  nodes get ``T + k`` where ``k`` is their postorder rank (root is ``N-1``),
- ``levels`` groups internal nodes whose children are all complete so that one
  batched kernel invocation processes a whole level (the reference's flat
  postorder loop at src/phyc/treelikelihood.c:1645 is depth-sequential per
  node; level batching is the TPU-friendly schedule),
- ``preorder_levels`` is the mirror schedule for root-to-tip sweeps (node
  height transforms, upper/pre-order partials).
"""

from __future__ import annotations

import numpy as np


class Topology:
    """A rooted tree with fixed structure (binary or with polytomies)."""

    def __init__(self, taxa, parent, children, child_count):
        self.taxa = list(taxa)
        self.parent = np.asarray(parent, dtype=np.int32)
        self.children = np.asarray(children, dtype=np.int32)  # [I, maxc], -1 pad
        self.child_count = np.asarray(child_count, dtype=np.int32)  # [I]
        self.T = len(self.taxa)
        self.N = self.parent.shape[0]
        self.I = self.N - self.T
        self.root = self.N - 1
        self._levels = None
        self._preorder_levels = None
        self._validate()

    # -- construction ------------------------------------------------------

    @staticmethod
    def from_nested(nested) -> "tuple[Topology, np.ndarray]":
        """Build from a nested structure of ``(children_list, name, length)``.

        ``nested`` nodes are ``dict(name=str|None, length=float|None,
        children=list)``. Returns (topology, distances[N]) where distances
        follow node-id order (root distance is nan if absent).
        """
        tips: list[dict] = []
        internals: list[dict] = []

        def visit(node):
            if node.get("children"):
                for c in node["children"]:
                    visit(c)
                internals.append(node)
            else:
                tips.append(node)

        visit(nested)
        T = len(tips)
        N = T + len(internals)
        for i, node in enumerate(tips):
            node["_id"] = i
        for k, node in enumerate(internals):
            node["_id"] = T + k

        maxc = max(len(n["children"]) for n in internals)
        parent = np.full(N, -1, dtype=np.int32)
        children = np.full((len(internals), maxc), -1, dtype=np.int32)
        child_count = np.zeros(len(internals), dtype=np.int32)
        distances = np.full(N, np.nan)
        taxa = [n.get("name") or f"tip{i}" for i, n in enumerate(tips)]
        for k, node in enumerate(internals):
            for j, c in enumerate(node["children"]):
                children[k, j] = c["_id"]
                parent[c["_id"]] = node["_id"]
            child_count[k] = len(node["children"])
        for node in tips + internals:
            if node.get("length") is not None:
                distances[node["_id"]] = node["length"]
        topo = Topology(taxa, parent, children, child_count)
        return topo, distances

    def _validate(self):
        if self.I < 1:
            raise ValueError("tree must have at least one internal node")
        # children of internal k must have smaller postorder rank
        for k in range(self.I):
            for j in range(self.child_count[k]):
                c = self.children[k, j]
                if c >= self.T and c - self.T >= k:
                    raise ValueError("children must precede parents in postorder")

    # -- schedules ---------------------------------------------------------

    @property
    def levels(self) -> list[np.ndarray]:
        """Postorder level schedule: lists of internal ranks, leaves-first."""
        if self._levels is None:
            depth = np.zeros(self.N, dtype=np.int64)
            for k in range(self.I):
                cs = self.children[k, : self.child_count[k]]
                depth[self.T + k] = 1 + depth[cs].max()
            lv = []
            for d in range(1, int(depth.max()) + 1):
                ranks = np.nonzero(depth[self.T :] == d)[0]
                if ranks.size:
                    lv.append(ranks.astype(np.int32))
            self._levels = lv
        return self._levels

    @property
    def preorder_levels(self) -> list[np.ndarray]:
        """Preorder level schedule: internal ranks, root-first (root level 0)."""
        if self._preorder_levels is None:
            rdepth = np.zeros(self.N, dtype=np.int64)
            order = []  # internal ranks in preorder (parents before children)
            for k in range(self.I - 1, -1, -1):
                node = self.T + k
                p = self.parent[node]
                rdepth[node] = 0 if p < 0 else rdepth[p] + 1
            lv = []
            for d in range(0, int(rdepth[self.T :].max()) + 1):
                ranks = np.nonzero(rdepth[self.T :] == d)[0]
                if ranks.size:
                    lv.append(ranks.astype(np.int32))
            self._preorder_levels = lv
        return self._preorder_levels

    # -- traversal helpers (host-side) -------------------------------------

    def postorder_nodes(self) -> np.ndarray:
        """All node ids in a valid postorder (tips first is NOT implied)."""
        order = []

        def visit(node):
            if node >= self.T:
                k = node - self.T
                for j in range(self.child_count[k]):
                    visit(int(self.children[k, j]))
            order.append(node)

        visit(self.root)
        return np.asarray(order, dtype=np.int32)

    def is_binary(self) -> bool:
        return bool((self.child_count == 2).all())

    def tip_name_to_id(self) -> dict:
        return {name: i for i, name in enumerate(self.taxa)}

    def __repr__(self):
        return f"Topology(T={self.T}, N={self.N}, levels={len(self.levels)})"
