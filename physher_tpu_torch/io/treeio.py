"""Newick / NEXUS tree reading and writing.

Rebuild of the reference's tree I/O (reference: src/phyc/treeio.c:1-1078,
src/phyc/tree.c:74+ newick parsing). The parser produces the nested dict
structure consumed by :meth:`physher_tpu_torch.trees.topology.Topology.from_nested`.
NEXUS files with Translate tables and multi-tree files are supported through
:func:`read_nexus_trees` / :class:`TreeFileIterator`.
"""

from __future__ import annotations

import os
import re

import numpy as np

from ..trees.topology import Topology


def parse_newick(newick: str):
    """Parse one newick string into nested dicts.

    Each node is ``{"name", "length", "children", "annotation"}``; supports
    quoted labels, branch lengths, and BEAST-style ``[&...]`` annotations.
    """
    s = newick.strip()
    if s.endswith(";"):
        s = s[:-1]
    pos = 0
    n = len(s)

    def parse_node():
        nonlocal pos
        node = {"name": None, "length": None, "children": [], "annotation": None}
        if pos < n and s[pos] == "(":
            pos += 1
            while True:
                node["children"].append(parse_node())
                if pos >= n:
                    raise ValueError("unbalanced parentheses in newick")
                if s[pos] == ",":
                    pos += 1
                    continue
                if s[pos] == ")":
                    pos += 1
                    break
                raise ValueError(f"unexpected char {s[pos]!r} at {pos}")
        # label
        if pos < n and s[pos] == "'":
            end = pos + 1
            buf = []
            while True:
                if s[end] == "'":
                    if end + 1 < n and s[end + 1] == "'":
                        buf.append("'")
                        end += 2
                        continue
                    break
                buf.append(s[end])
                end += 1
            node["name"] = "".join(buf)
            pos = end + 1
        else:
            m = re.match(r"[^,():;\[\]]*", s[pos:])
            label = m.group(0)
            if label:
                node["name"] = label
            pos += len(label)
        # annotation on the node
        if pos < n and s[pos] == "[":
            end = s.index("]", pos)
            node["annotation"] = s[pos + 1 : end]
            pos = end + 1
        # branch length
        if pos < n and s[pos] == ":":
            pos += 1
            if pos < n and s[pos] == "[":
                end = s.index("]", pos)
                pos = end + 1
            m = re.match(r"[-+0-9.eE]+", s[pos:])
            if not m:
                raise ValueError(f"bad branch length at {pos}")
            node["length"] = float(m.group(0))
            pos += len(m.group(0))
        return node

    root = parse_node()
    if pos != n:
        raise ValueError(f"trailing characters in newick at {pos}: {s[pos:pos+20]!r}")
    return root


def read_newick(path_or_string: str) -> "tuple[Topology, np.ndarray]":
    """Read a newick tree from a file or a literal string."""
    text = path_or_string
    if os.path.exists(path_or_string):
        with open(path_or_string) as fh:
            text = fh.read()
    text = text.strip()
    if text[:6].lower() == "#nexus":
        trees = read_nexus_trees(text)
        if not trees:
            raise ValueError("no trees in NEXUS file")
        return trees[0]
    return Topology.from_nested(parse_newick(text))


def _apply_translate(node, table):
    if node["children"]:
        for c in node["children"]:
            _apply_translate(c, table)
    elif node["name"] in table:
        node["name"] = table[node["name"]]


def read_nexus_trees(text: str, max_trees: int | None = None):
    """Read all trees from a NEXUS trees block (with optional Translate)."""
    out = []
    for topo_dist in iter_nexus_trees(text):
        out.append(topo_dist)
        if max_trees and len(out) >= max_trees:
            break
    return out


def iter_nexus_trees(text: str):
    if os.path.exists(text):
        with open(text) as fh:
            text = fh.read()
    m = re.search(r"begin\s+trees\s*;(.*?)end\s*;", text, re.IGNORECASE | re.DOTALL)
    if not m:
        raise ValueError("no trees block in NEXUS file")
    block = m.group(1)
    table = {}
    tm = re.search(r"translate(.*?);", block, re.IGNORECASE | re.DOTALL)
    if tm:
        for entry in tm.group(1).split(","):
            parts = entry.split()
            if len(parts) >= 2:
                key = parts[0].strip()
                val = " ".join(parts[1:]).strip().strip("'")
                table[key] = val
    for tmatch in re.finditer(
        r"tree\s+[^=]+=\s*(?:\[[^\]]*\]\s*)?([^;]+;)", block, re.IGNORECASE
    ):
        nested = parse_newick(tmatch.group(1))
        if table:
            _apply_translate(nested, table)
        yield Topology.from_nested(nested)


class TreeFileIterator:
    """Iterate trees in a newick or NEXUS file lazily (reference:
    src/phyc/treeio.h:25-43 TreeFileIterator)."""

    def __init__(self, path: str):
        with open(path) as fh:
            self.text = fh.read()
        self.is_nexus = self.text.lstrip()[:6].lower() == "#nexus"

    def __iter__(self):
        if self.is_nexus:
            yield from iter_nexus_trees(self.text)
        else:
            for line in self.text.splitlines():
                line = line.strip()
                if line:
                    yield Topology.from_nested(parse_newick(line))


def write_newick(topo: Topology, distances=None, *, internal_labels=None,
                 annotations=None, decimals: int = 10) -> str:
    """Serialize a topology (+ branch lengths) to newick."""

    def fmt(node):
        parts = []
        if node >= topo.T:
            k = node - topo.T
            inner = ",".join(
                fmt(int(topo.children[k, j])) for j in range(topo.child_count[k])
            )
            label = ""
            if internal_labels is not None and internal_labels.get(node):
                label = str(internal_labels[node])
            parts.append(f"({inner}){label}")
        else:
            name = topo.taxa[node]
            if re.search(r"[\s(),:;\[\]]", name):
                name = "'" + name.replace("'", "''") + "'"
            parts.append(name)
        if annotations is not None and annotations.get(node):
            parts.append(f"[&{annotations[node]}]")
        if distances is not None and node != topo.root:
            d = float(distances[node])
            if np.isfinite(d):
                parts.append(f":{d:.{decimals}g}")
        return "".join(parts)

    return fmt(topo.root) + ";"


def write_nexus_trees(trees, path: str | None = None, names=None) -> str:
    """Write trees (list of (topo, distances)) as a NEXUS trees block."""
    lines = ["#NEXUS", "begin trees;"]
    for i, (topo, dist) in enumerate(trees):
        name = names[i] if names else f"STATE_{i}"
        lines.append(f"tree {name} = {write_newick(topo, dist)}")
    lines += ["end;", ""]
    text = "\n".join(lines)
    if path:
        with open(path, "w") as fh:
            fh.write(text)
    return text
