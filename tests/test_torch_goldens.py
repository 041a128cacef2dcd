"""The reference-oracle goldens on tiny.fa through the port's
``config.builder.build_config`` (float64, CPU), at the tolerances of
tests/test_oracle_goldens.py: logP at rtol 5e-9 / atol 2e-8, the branch
gradients against the reference's finite differences at rtol 5e-4 / atol
5e-2 and, for JC69, against its analytic gradients at 1e-6. The fixtures
under tests/data/goldens/ were made by tools/reforacle.c, which links the
reference's libphyc."""

import json
import os
import re

import numpy as np
import pytest
import torch

from physher_tpu_torch.config.builder import build_config

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "data", "goldens")
KW = dict(dtype=torch.float64, device="cpu")


def parse_golden(path):
    """(logP, node ids in postorder with the root last, analytic branch
    gradients, finite-difference branch gradients) of a golden file."""
    logp, node_ids, grads, fd_grads = None, [], [], []
    with open(path) as fh:
        for line in fh:
            if line.startswith("logP "):
                logp = float(line.split()[1])
            elif line.startswith("node "):
                m = re.match(r"node \S+ id (\d+) distance (\S+)", line)
                node_ids.append(int(m.group(1)))
            elif line.startswith("dlogP_distance "):
                grads.append(float(line.split()[2]))
            elif line.startswith("dlogP_fd "):
                fd_grads.append(float(line.split()[2]))
    return logp, node_ids, grads, fd_grads


def golden_config(case, data_dir):
    """The golden's config with its alignment read from ``data_dir``."""
    with open(os.path.join(GOLDEN_DIR, f"{case}.json")) as fh:
        cfg = json.load(fh)
    aln = cfg["model"]["sitepattern"]["alignment"]
    aln["file"] = os.path.join(data_dir, os.path.basename(aln["file"]))
    return cfg


@pytest.mark.parametrize("case", ["jc69nj", "hky2", "gtrg4"])
def test_golden(case, data_dir):
    _check_golden(case, data_dir)


def _check_golden(case, data_dir):
    ctx, _ = build_config(golden_config(case, data_dir), base_dir=data_dir,
                          **KW)
    tlk = ctx.objects["treelikelihood"]
    params = tlk.param_space().init_params(**KW)
    logp_ref, node_ids, grads_ref, fd_ref = parse_golden(
        os.path.join(GOLDEN_DIR, f"{case}.txt"))

    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    logp = tlk.log_likelihood(leaves)
    np.testing.assert_allclose(float(logp.detach()), logp_ref, rtol=5e-9,
                               atol=2e-8)
    (g,) = torch.autograd.grad(logp, [leaves["tree.distances"]])
    g = g.numpy()  # indexed by node id, root absent

    topo = tlk.topo
    root = topo.root
    root_children = {int(c) for c in topo.children[root - topo.T][
        : topo.child_count[root - topo.T]]}
    nonroot_ids = [i for i in node_ids if i != root]
    # the reference's central differences of its own logP; atol covers the
    # differences' bias at (near-)zero-length edges
    assert len(nonroot_ids) == len(fd_ref)
    for nid, fd in zip(nonroot_ids, fd_ref):
        np.testing.assert_allclose(g[nid], fd, rtol=5e-4, atol=5e-2)
    if case.startswith("jc69"):
        # the reference's analytic gradient is right for JC69; it folds the
        # two root edges into one (the full gradient on one child, 0 on
        # the other) where the port reports the equal sum on both
        assert len(nonroot_ids) == len(grads_ref)
        for nid, gref in zip(nonroot_ids, grads_ref):
            if nid in root_children:
                if gref != 0.0:
                    np.testing.assert_allclose(g[nid], gref, rtol=1e-6)
            else:
                np.testing.assert_allclose(g[nid], gref, rtol=1e-6,
                                           atol=1e-9)

    # autograd against central differences of the port's own logP
    d = params["tree.distances"]
    for nid in [0, 1, topo.T]:
        e = torch.zeros_like(d)
        e[nid] = 1e-6
        with torch.no_grad():
            fd = (float(tlk.log_likelihood({**params, "tree.distances":
                                            d + e}))
                  - float(tlk.log_likelihood({**params, "tree.distances":
                                              d - e}))) / 2e-6
        np.testing.assert_allclose(g[nid], fd, rtol=5e-4, atol=1e-6)


def test_weibull_golden_raises(data_dir):
    """jc69w4 (JC69 with four median Weibull rate categories) through the
    builder, at the other goldens' tolerances. The name dates from when
    the port raised for Weibull rates."""
    _check_golden("jc69w4", data_dir)
