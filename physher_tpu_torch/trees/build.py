"""Starting-tree construction: neighbor joining and UPGMA.

Bit-faithful rebuild of the reference's algorithms — including their scan
order and tie-breaking — so NJ-initialized reference configs reproduce the
same topology and branch lengths (reference: src/phyc/nj.c:231-317 ``new_NJ``,
src/phyc/upgma.c:29-112 ``new_UPGMA``).
"""

from __future__ import annotations

import numpy as np

from .topology import Topology


def _to_topology(node) -> "tuple[Topology, np.ndarray]":
    return Topology.from_nested(node)


def nj(taxa, matrix: np.ndarray):
    """Neighbor joining (reference: src/phyc/nj.c:231-317).

    Scan order, first-minimum tie-breaking, child order [imin, jmin], and the
    >=0 branch-length clamp all match the reference.
    """
    dim = len(taxa)
    D = np.array(matrix, dtype=np.float64)
    nodes = [{"name": t, "length": None, "children": []} for t in taxa]
    alias = list(range(dim))
    ncluster = dim

    while ncluster > 2:
        r = np.array([sum(D[alias[i]][alias[j]] for j in range(ncluster))
                      for i in range(ncluster)])
        denom = 1.0 / (ncluster - 2)
        best = np.inf
        imin = jmin = 0
        for i in range(ncluster):
            for j in range(i + 1, ncluster):
                sij = D[alias[i]][alias[j]] - (r[i] + r[j]) * denom
                if sij < best:
                    imin, jmin, best = i, j, sij
        ai, aj = alias[imin], alias[jmin]
        il = (D[ai][aj] + (r[imin] - r[jmin]) / (ncluster - 2)) * 0.5
        jl = D[ai][aj] - il
        inode, jnode = nodes[ai], nodes[aj]
        inode["length"] = max(0.0, il)
        jnode["length"] = max(0.0, jl)
        parent = {"name": None, "length": None, "children": [inode, jnode]}
        nodes[ai] = parent
        for k in range(ncluster):
            if k in (imin, jmin):
                continue
            ak = alias[k]
            D[ak][ai] = D[ai][ak] = (D[ak][ai] + D[ak][aj] - D[ai][aj]) * 0.5
        del alias[jmin]
        ncluster -= 1

    a0, a1 = alias[0], alias[1]
    l = max(0.0, D[a0][a1] * 0.5)
    nodes[a0]["length"] = l
    nodes[a1]["length"] = l
    root = {"name": None, "length": None, "children": [nodes[a0], nodes[a1]]}
    return _to_topology(root)


def upgma(taxa, matrix: np.ndarray):
    """UPGMA (reference: src/phyc/upgma.c:29-112), including the reference's
    count-update-before-average quirk."""
    dim = len(taxa)
    D = np.array(matrix, dtype=np.float64)
    nodes = [{"name": t, "length": None, "children": []} for t in taxa]
    alias = list(range(dim))
    h = np.zeros(dim)
    counts = np.ones(dim, dtype=np.int64)
    ncluster = dim

    while ncluster > 2:
        best = np.inf
        imin = jmin = 0
        for i in range(ncluster):
            for j in range(i + 1, ncluster):
                sij = D[alias[i]][alias[j]]
                if sij < best:
                    imin, jmin, best = i, j, sij
        ai, aj = alias[imin], alias[jmin]
        l = max(0.0, D[ai][aj] * 0.5)
        inode, jnode = nodes[ai], nodes[aj]
        inode["length"] = l - h[ai]
        jnode["length"] = l - h[aj]
        parent = {"name": None, "length": None, "children": [inode, jnode]}
        nodes[ai] = parent
        counts[ai] += counts[aj]  # reference updates count BEFORE averaging
        h[ai] = l
        ci, cj = counts[ai], counts[aj]
        for k in range(ncluster):
            if k in (imin, jmin):
                continue
            ak = alias[k]
            D[ak][ai] = D[ai][ak] = (ci * D[ak][ai] + cj * D[ak][aj]) / (ci + cj)
        del alias[jmin]
        ncluster -= 1

    a0, a1 = alias[0], alias[1]
    l = max(0.0, D[a0][a1] * 0.5)
    nodes[a0]["length"] = l - h[a0]
    nodes[a1]["length"] = l - h[a1]
    root = {"name": None, "length": None, "children": [nodes[a0], nodes[a1]]}
    return _to_topology(root)
