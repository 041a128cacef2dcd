"""The port's copied host-side modules give the JAX package's arrays.

io/seqio, io/treeio, data/*, trees/topology, trees/timetree and
utils/synthetic are numpy code copied into physher_tpu_torch; on the fluA
alignment, the dated jc69-time.json tree and fluA-rooted.nxs they must give
identical codes, weights, tip partials, topologies and time-tree data.
"""

import json
import os

import numpy as np
import pytest

from physher_tpu.data.sitepattern import SitePattern as JSitePattern
from physher_tpu.io.seqio import read_alignment as j_read_alignment
from physher_tpu.io.treeio import read_newick as j_read_newick
from physher_tpu.trees.timetree import TimeTreeData as JTimeTreeData
from physher_tpu.utils import synthetic as j_synthetic
from physher_tpu_torch.data.sitepattern import SitePattern
from physher_tpu_torch.io.seqio import read_alignment
from physher_tpu_torch.io.treeio import read_newick
from physher_tpu_torch.trees.timetree import TimeTreeData
from physher_tpu_torch.utils import synthetic


@pytest.fixture(scope="module")
def patterns(data_dir):
    path = os.path.join(data_dir, "fluA.fa")
    seqs, j_seqs = read_alignment(path), j_read_alignment(path)
    assert seqs == j_seqs
    return (SitePattern.from_alignment(seqs, "nucleotide"),
            JSitePattern.from_alignment(j_seqs, "nucleotide"))


def test_site_patterns(patterns):
    sp, jsp = patterns
    assert sp.pattern_count == jsp.pattern_count == 238
    assert sp.taxa == jsp.taxa
    np.testing.assert_array_equal(sp.codes, jsp.codes)
    np.testing.assert_array_equal(sp.weights, jsp.weights)
    np.testing.assert_array_equal(sp.indexes, jsp.indexes)
    np.testing.assert_array_equal(sp.padded_weights(256),
                                  jsp.padded_weights(256))


@pytest.mark.parametrize("tipstates", [True, False])
def test_tip_partials(patterns, tipstates):
    sp, jsp = patterns
    for pad in (None, 256):
        np.testing.assert_array_equal(
            sp.tip_partials(tipstates=tipstates, pad_to=pad),
            jsp.tip_partials(tipstates=tipstates, pad_to=pad))


def _tree_sources(data_dir):
    with open(os.path.join(data_dir, "jc69-time.json")) as fh:
        cfg = json.load(fh)
    return {"jc69-time": cfg["model"]["tree"]["newick"],
            "fluA-rooted": os.path.join(data_dir, "fluA-rooted.nxs")}


@pytest.mark.parametrize("name", ["jc69-time", "fluA-rooted"])
def test_topology(data_dir, name):
    src = _tree_sources(data_dir)[name]
    topo, dist = read_newick(src)
    jtopo, jdist = j_read_newick(src)
    assert topo.taxa == jtopo.taxa
    assert (topo.T, topo.N, topo.root) == (jtopo.T, jtopo.N, jtopo.root)
    np.testing.assert_array_equal(topo.children, jtopo.children)
    np.testing.assert_array_equal(topo.child_count, jtopo.child_count)
    np.testing.assert_array_equal(topo.parent, jtopo.parent)
    np.testing.assert_array_equal(dist, jdist)
    assert len(topo.levels) == len(jtopo.levels)
    for a, b in zip(topo.levels, jtopo.levels):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(topo.preorder_levels, jtopo.preorder_levels):
        np.testing.assert_array_equal(a, b)


def test_time_tree_data(data_dir):
    with open(os.path.join(data_dir, "jc69-time.json")) as fh:
        tree_cfg = json.load(fh)["model"]["tree"]
    topo, dist = read_newick(tree_cfg["newick"])
    jtopo, jdist = j_read_newick(tree_cfg["newick"])
    td = TimeTreeData.from_dated_tree(topo, dist, tree_cfg["dates"])
    jtd = JTimeTreeData.from_dated_tree(jtopo, jdist, tree_cfg["dates"])
    np.testing.assert_array_equal(td.tip_heights, jtd.tip_heights)
    np.testing.assert_array_equal(td.node_heights0, jtd.node_heights0)
    np.testing.assert_array_equal(td.lowers, jtd.lowers)
    np.testing.assert_array_equal(td.ratios0, jtd.ratios0)


def test_synthetic():
    topo, jtopo = (synthetic.balanced_topology(12),
                   j_synthetic.balanced_topology(12))
    np.testing.assert_array_equal(topo.children, jtopo.children)
    sp = synthetic.random_sitepattern(12, 300, seed=4)
    jsp = j_synthetic.random_sitepattern(12, 300, seed=4)
    np.testing.assert_array_equal(sp.codes, jsp.codes)
    np.testing.assert_array_equal(sp.tip_partials(pad_to=512),
                                  jsp.tip_partials(pad_to=512))
