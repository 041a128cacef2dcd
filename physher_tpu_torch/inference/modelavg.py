"""Information-criterion model averaging over tree logs.

A copy of ``physher_tpu/inference/modelavg.py`` (numpy only). Rebuild of the reference's model-averaging tool (reference:
src/phyc/modelavg.c Model_average_from_log — reads a NEXUS tree log whose
tree comments carry ``IC=``/``AICc=`` scores and per-branch annotations
(``rate=``/``class=``, GA local-clock output), weights each model by
exp(-0.5 * deltaIC), and averages per-branch values; src/modelAveraging.c is
the standalone ``modelavg`` CLI).

Branch identity across trees with different topologies uses taxon splits
(the reference assumes a fixed topology; split-keying generalizes it).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

import numpy as np

from ..trees.stats import splits
from ..trees.topology import Topology


def ic_weights(ics) -> np.ndarray:
    """Akaike-style weights exp(-0.5 dIC) / sum (modelavg.c:239-258)."""
    ics = np.asarray(ics, dtype=np.float64)
    d = ics - ics.min()
    w = np.exp(-0.5 * d)
    return w / w.sum()


@dataclass
class AveragedModel:
    """Per-branch weighted mean/min/max keyed by taxon split
    (reference: ModelAveraged struct modelavg.h:33-38)."""
    mean: dict
    min: dict
    max: dict
    weights: np.ndarray = field(default=None)


def average_branch_values(topos, values, ics) -> AveragedModel:
    """IC-weighted average of per-branch values over models.

    topos: list of Topology; values: list of float[N] per-branch values
    aligned with each topology's node order; ics: per-model IC scores.
    """
    w = ic_weights(ics)
    acc, wsum, vmin, vmax = {}, {}, {}, {}
    for topo, vals, wi in zip(topos, values, w):
        vals = np.asarray(vals, dtype=np.float64)
        for node, split in _node_splits(topo):
            if not np.isfinite(vals[node]):
                continue
            acc[split] = acc.get(split, 0.0) + wi * vals[node]
            wsum[split] = wsum.get(split, 0.0) + wi
            vmin[split] = min(vmin.get(split, np.inf), vals[node])
            vmax[split] = max(vmax.get(split, -np.inf), vals[node])
    mean = {s: acc[s] / wsum[s] for s in acc}
    return AveragedModel(mean, vmin, vmax, w)


def _node_splits(topo: Topology):
    """(node_index, frozenset taxon split below node) for non-root nodes."""
    below = [set() for _ in range(topo.N)]
    for t in range(topo.T):
        below[t] = {topo.taxa[t]}
    for k in range(topo.I):
        node = topo.T + k
        for c in topo.children[k, : topo.child_count[k]]:
            below[node] |= below[c]
    root = topo.N - 1
    return [(n, frozenset(below[n])) for n in range(topo.N) if n != root]


_TREE_RE = re.compile(
    r"^\s*tree\s+\S+\s*(\[[^\]]*\])?\s*=?\s*(?:\[[^\]]*\])?\s*(\(.*;)\s*$",
    re.IGNORECASE)
_IC_RE = re.compile(r"(?:IC|AICc)\s*=\s*(-?[\d.eE+-]+)")


def read_annotated_tree_log(path_or_text: str, value_key: str = "rate"):
    """Parse a NEXUS tree log with IC scores + per-branch annotations.

    Returns (topos, values, ics). Handles the reference's log format:
    ``tree TREE1 [&LnL=...,IC=...] = (a[&rate=0.1]:0.2,...);``
    (modelavg.c:186-237). Per-node ``[&key=value]`` annotations are read off
    the parsed newick structure directly.
    """
    import os

    from ..io.treeio import parse_newick

    if os.path.exists(path_or_text):
        with open(path_or_text) as fh:
            text = fh.read()
    else:
        text = path_or_text

    topos, values, ics = [], [], []
    for line in text.splitlines():
        m = _TREE_RE.match(line)
        if not m:
            continue
        header = m.group(1) or ""
        icm = _IC_RE.search(header) or _IC_RE.search(line)
        if icm is None:
            continue
        nested = parse_newick(m.group(2))
        topo, _dist = Topology.from_nested(nested)
        vals = np.full(topo.N, np.nan)

        def visit(node):
            annot = node.get("annotation")
            if annot:
                a = annot.lstrip("&")
                kv = dict(p.split("=", 1) for p in a.split(",") if "=" in p)
                if value_key in kv:
                    vals[node["_id"]] = float(kv[value_key])
            for c in node.get("children") or []:
                visit(c)

        visit(nested)
        topos.append(topo)
        values.append(vals)
        ics.append(float(icm.group(1)))
    return topos, values, ics


def cli_main(argv=None):
    """Standalone model-averaging tool (reference: src/modelAveraging.c
    modelavg CLI, modelAveraging.c:33-50)."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="physher-tpu-torch-modelavg",
        description="IC-weighted model averaging over an annotated tree log")
    ap.add_argument("log", help="NEXUS tree log with IC annotations")
    ap.add_argument("-k", "--key", default="rate",
                    help="per-branch annotation key to average")
    args = ap.parse_args(argv)
    out = model_average_from_log(args.log, args.key)
    print("split\tmean\tmin\tmax")
    for split in sorted(out.mean, key=lambda s: (len(s), sorted(s))):
        taxa = ",".join(sorted(split))
        print(f"{{{taxa}}}\t{out.mean[split]:.6g}\t{out.min[split]:.6g}"
              f"\t{out.max[split]:.6g}")
    return 0


def model_average_from_log(path_or_text: str, value_key: str = "rate"):
    """End-to-end: parse log -> IC-weighted branch averages
    (reference: Model_average_from_log modelavg.c:154 + modelAveraging.c)."""
    topos, values, ics = read_annotated_tree_log(path_or_text, value_key)
    if not topos:
        raise ValueError("no IC-annotated trees found")
    return average_branch_values(topos, values, ics)
