"""Tree comparison & statistics: RF, branch score, K-tree score, splits,
patristic distances, tree metrics.

A copy of ``physher_tpu/trees/stats.py`` (numpy only).

Rebuild of the reference's tree-comparison layer (reference: src/phyc/rf.c
Robinson-Foulds/branch-score/K-tree score, src/phyc/splitsystem.c bitset
splits, src/phyc/patristic.c pairwise path lengths, src/phyc/treestat.c).
Splits are frozensets of tip names so topologies with different taxon
orderings compare correctly.
"""

from __future__ import annotations

import numpy as np

from .topology import Topology


def splits(topo: Topology, distances=None):
    """Non-trivial bipartitions: {frozenset(tip names): branch length}.

    A split is the smaller/canonical side of each internal edge (reference:
    src/phyc/splitsystem.c).
    """
    all_taxa = frozenset(topo.taxa)
    below: dict[int, frozenset] = {}
    out: dict[frozenset, float] = {}
    for node in range(topo.N):
        if node < topo.T:
            below[node] = frozenset([topo.taxa[node]])
    for k in range(topo.I):
        node = topo.T + k
        s = frozenset()
        for j in range(topo.child_count[k]):
            s = s | below[int(topo.children[k, j])]
        below[node] = s
        if node == topo.root:
            continue
        if len(s) <= 1 or len(s) >= topo.T - 1:
            continue  # trivial
        canon = s if (len(s) < topo.T - len(s)
                      or (len(s) == topo.T - len(s)
                          and min(s) <= min(all_taxa - s))) else all_taxa - s
        bl = float(distances[node]) if distances is not None else 0.0
        out[canon] = out.get(canon, 0.0) + bl
    return out


def robinson_foulds(t1: Topology, t2: Topology) -> int:
    """Symmetric-difference (RF) distance (reference: src/phyc/rf.c:24-30)."""
    s1 = set(splits(t1))
    s2 = set(splits(t2))
    return len(s1 ^ s2)


def branch_score(t1: Topology, d1, t2: Topology, d2) -> float:
    """Kuhner-Felsenstein branch score distance (reference: src/phyc/rf.c)."""
    sp1 = splits(t1, d1)
    sp2 = splits(t2, d2)
    total = 0.0
    for s in set(sp1) | set(sp2):
        total += (sp1.get(s, 0.0) - sp2.get(s, 0.0)) ** 2
    return float(np.sqrt(total))


def k_tree_score(t1: Topology, d1, t2: Topology, d2) -> float:
    """K-tree score: branch score after optimal scaling of tree 2 onto tree 1
    (Soria-Carrasco et al 2007; reference: src/phyc/rf.c K-score)."""
    sp1 = splits(t1, d1)
    sp2 = splits(t2, d2)
    keys = sorted(set(sp1) | set(sp2), key=lambda s: sorted(s))
    a = np.array([sp1.get(s, 0.0) for s in keys])
    b = np.array([sp2.get(s, 0.0) for s in keys])
    denom = float(b @ b)
    k = float(a @ b) / denom if denom > 0 else 1.0
    return float(np.sqrt(((a - k * b) ** 2).sum()))


def patristic_distances(topo: Topology, distances) -> np.ndarray:
    """[T, T] pairwise path-length matrix (reference: src/phyc/patristic.c)."""
    # distance from each node up to root, then LCA via paths
    up = np.zeros(topo.N)
    parent = topo.parent
    for node in range(topo.N - 2, -1, -1):
        pass
    # accumulate root-to-node distances
    dist_to_root = np.zeros(topo.N)
    for k in range(topo.I - 1, -1, -1):
        node = topo.T + k
        for j in range(topo.child_count[k]):
            c = int(topo.children[k, j])
            d = distances[c]
            dist_to_root[c] = dist_to_root[node] + (0.0 if np.isnan(d) else d)
    # ancestors sets for LCA
    anc = [set() for _ in range(topo.N)]
    order = []
    for node in range(topo.N):
        a = set()
        x = node
        while x != -1:
            a.add(x)
            x = int(parent[x]) if parent[x] >= 0 else -1
        anc[node] = a
    out = np.zeros((topo.T, topo.T))
    for i in range(topo.T):
        for j in range(i + 1, topo.T):
            common = anc[i] & anc[j]
            lca = max(common, key=lambda n: dist_to_root[n])
            out[i, j] = out[j, i] = (dist_to_root[i] + dist_to_root[j]
                                     - 2 * dist_to_root[lca])
    return out


def tree_length(topo: Topology, distances) -> float:
    d = np.asarray(distances)[: topo.N - 1]
    return float(np.nansum(d))


def node_depths(topo: Topology) -> np.ndarray:
    depth = np.zeros(topo.N, dtype=np.int64)
    for k in range(topo.I - 1, -1, -1):
        node = topo.T + k
        for j in range(topo.child_count[k]):
            depth[int(topo.children[k, j])] = depth[node] + 1
    return depth
