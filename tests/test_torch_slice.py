"""The port's first slice end to end on the CPU, against the JAX package.

- Checkpoint A: the fluA JC69 strict-clock time tree in float64, at the
  tolerances of tests/test_jc69_time_golden.py (logP with and without the
  ratio Jacobian, the clock-rate gradient, all 67 ratio gradients and the
  root-height gradient), and every gradient key against the JAX
  TreeLikelihood on the same parameters.
- GTR+Gamma4 on fluA (tests/data/goldens/gtrg4_fluA.json) against the
  reference golden at the tolerances of tests/test_oracle_goldens.py, and
  against the JAX model that physher_tpu.config.builder builds from the
  same file.
- 5 Adam steps from the same start: the logP trajectories agree to 1e-8.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from physher_tpu.config.builder import build_config
from physher_tpu.data.sitepattern import SitePattern as JSitePattern
from physher_tpu.inference.ml import optimize_adam as j_optimize_adam
from physher_tpu.io.seqio import read_alignment as j_read_alignment
from physher_tpu.io.treeio import read_newick as j_read_newick
from physher_tpu.models.clock import StrictClock as JStrictClock
from physher_tpu.models.substitution import JC69 as JJC69
from physher_tpu.models.treelikelihood import TreeLikelihood as JTreeLikelihood
from physher_tpu.trees.timetree import TimeTreeData as JTimeTreeData
from physher_tpu_torch.data.sitepattern import SitePattern
from physher_tpu_torch.inference.ml import optimize_adam
from physher_tpu_torch.io.seqio import read_alignment
from physher_tpu_torch.io.treeio import read_newick
from physher_tpu_torch.models.clock import StrictClock
from physher_tpu_torch.models.parameters import params_from_numpy
from physher_tpu_torch.models.sitemodel import GammaSiteModel
from physher_tpu_torch.models.substitution import GTR, JC69
from physher_tpu_torch.models.treelikelihood import TreeLikelihood
from physher_tpu_torch.trees.timetree import TimeTreeData
from test_jc69_time_golden import (
    EXPECTED_LOGP, EXPECTED_LOGP_JAC, EXPECTED_RATE_GRAD, EXPECTED_RATIO_GRAD,
    EXPECTED_RATIO_GRAD_JAC, EXPECTED_ROOT_GRAD, EXPECTED_ROOT_GRAD_JAC)
from test_oracle_goldens import GOLDEN_DIR, parse_golden

F64 = dict(dtype=torch.float64, device="cpu")
NUC_RATE_ORDER = ["ac", "ag", "at", "cg", "ct", "gt"]


def _grad(fn, params):
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    out = fn(leaves)
    out.backward()
    return float(out.detach()), {k: v.grad.numpy() for k, v in leaves.items()}


def _numpy(params):
    return {k: np.asarray(v) for k, v in params.items()}


@pytest.fixture(scope="module")
def jc69_time(data_dir):
    with open(os.path.join(data_dir, "jc69-time.json")) as fh:
        tree_cfg = json.load(fh)["model"]["tree"]
    aln = os.path.join(data_dir, "fluA.fa")
    topo, dist = read_newick(tree_cfg["newick"])
    td = TimeTreeData.from_dated_tree(topo, dist, tree_cfg["dates"])
    sp = SitePattern.from_alignment(read_alignment(aln))
    tlk = TreeLikelihood(sp, topo, JC69(**F64),
                         clock=StrictClock(topo.N, rate_init=1e-3, **F64),
                         time_data=td, tipstates=True, **F64)
    jtopo, jdist = j_read_newick(tree_cfg["newick"])
    jtd = JTimeTreeData.from_dated_tree(jtopo, jdist, tree_cfg["dates"])
    jsp = JSitePattern.from_alignment(j_read_alignment(aln))
    jtlk = JTreeLikelihood(jsp, jtopo, JJC69(),
                           clock=JStrictClock(jtopo.N, rate_init=1e-3),
                           time_data=jtd, tipstates=True)
    jparams = jtlk.param_space().init_params()
    return tlk, params_from_numpy(_numpy(jparams), **F64), jtlk, jparams


@pytest.mark.parametrize("jacobian", [False, True])
def test_checkpoint_a(jc69_time, jacobian):
    tlk, params, _, _ = jc69_time

    def fn(p):
        out = tlk.log_likelihood_only(p)
        return out + tlk.log_jacobian(p) if jacobian else out

    logp, grad = _grad(fn, params)
    np.testing.assert_allclose(
        logp, EXPECTED_LOGP_JAC if jacobian else EXPECTED_LOGP, rtol=0,
        atol=1e-8)
    np.testing.assert_allclose(float(grad["rate"]), EXPECTED_RATE_GRAD,
                               rtol=1e-10)
    np.testing.assert_allclose(
        grad["tree.ratios"],
        EXPECTED_RATIO_GRAD_JAC if jacobian else EXPECTED_RATIO_GRAD,
        rtol=0, atol=1e-7)
    np.testing.assert_allclose(
        float(grad["tree.root_height"]),
        EXPECTED_ROOT_GRAD_JAC if jacobian else EXPECTED_ROOT_GRAD,
        rtol=0, atol=1e-8)


def _assert_same_gradients(tlk, params, jtlk, jparams, rtol, atol):
    logp, grad = _grad(tlk.log_likelihood, params)
    jlogp = float(jax.jit(jtlk.log_likelihood)(jparams))
    jgrad = jax.jit(jax.grad(jtlk.log_likelihood))(jparams)
    np.testing.assert_allclose(logp, jlogp, rtol=rtol)
    assert set(grad) == set(jgrad)
    for k in grad:
        np.testing.assert_allclose(grad[k], np.asarray(jgrad[k]), rtol=rtol,
                                   atol=atol, err_msg=k)


def test_time_tree_gradients_match_jax(jc69_time):
    """Every gradient key on perturbed parameters (a numpy seed)."""
    tlk, params, jtlk, jparams = jc69_time
    rng = np.random.default_rng(3)
    jp = _numpy(jparams)
    jp["tree.ratios"] = np.clip(
        jp["tree.ratios"] * rng.uniform(0.9, 1.1, jp["tree.ratios"].shape),
        1e-3, 1 - 1e-3)
    jp["rate"] = jp["rate"] * 1.3
    _assert_same_gradients(tlk, params_from_numpy(jp, **F64), jtlk, jp,
                           rtol=1e-10, atol=1e-9)


def build_gtrg4_fluA(cfg, data_dir, *, dtype, device):
    """The port's GTR+Gamma4 fluA model from the golden config, through the
    Python API (the JSON-config builder is not ported)."""
    m = cfg["model"]
    sm_cfg = m["sitemodel"]["substitutionmodel"]
    rates = [sm_cfg["rates"][k]["value"] if k in sm_cfg["rates"] else 1.0
             for k in NUC_RATE_ORDER]
    alpha = m["sitemodel"]["distribution"]["parameters"]["value"]
    cats = m["sitemodel"]["distribution"]["categories"]
    aln = os.path.join(data_dir, os.path.basename(
        m["sitepattern"]["alignment"]["file"]))
    topo, dist = read_newick(m["tree"]["newick"])
    sp = SitePattern.from_alignment(read_alignment(aln))
    kw = dict(dtype=dtype, device=device)
    return TreeLikelihood(
        sp, topo,
        GTR("sm.", rates_init=rates,
            freqs_init=sm_cfg["frequencies"]["values"], **kw),
        GammaSiteModel(cats, prefix="sitemodel.", shape_init=alpha, **kw),
        distances_init=np.nan_to_num(dist[: topo.N - 1], nan=0.1),
        tipstates=True, **kw)


@pytest.fixture(scope="module")
def gtrg4(data_dir):
    with open(os.path.join(GOLDEN_DIR, "gtrg4_fluA.json")) as fh:
        cfg = json.load(fh)
    tlk = build_gtrg4_fluA(cfg, data_dir, **F64)
    ctx, _ = build_config(cfg, base_dir=data_dir)
    jtlk = ctx.objects["treelikelihood"]
    jparams = jtlk.param_space().init_params()
    return tlk, params_from_numpy(_numpy(jparams), **F64), jtlk, jparams


def test_gtrg4_fluA_golden(gtrg4):
    tlk, params, _, _ = gtrg4
    logp_ref, node_ids, _, fd_ref = parse_golden(
        os.path.join(GOLDEN_DIR, "gtrg4_fluA.txt"))
    logp, grad = _grad(tlk.log_likelihood, params)
    np.testing.assert_allclose(logp, logp_ref, rtol=5e-9, atol=2e-8)
    g = grad["tree.distances"]
    nonroot_ids = [i for i in node_ids if i != tlk.topo.root]
    assert len(nonroot_ids) == len(fd_ref)
    for nid, fd in zip(nonroot_ids, fd_ref):
        np.testing.assert_allclose(g[nid], fd, rtol=5e-4, atol=5e-2)


def test_gtrg4_fluA_matches_jax(gtrg4):
    tlk, params, jtlk, jparams = gtrg4
    assert tlk.param_space().names == jtlk.param_space().names
    _assert_same_gradients(tlk, params, jtlk, jparams, rtol=1e-9, atol=1e-8)


def test_adam_trajectory_matches_jax(gtrg4):
    tlk, params, jtlk, jparams = gtrg4
    res = optimize_adam(tlk.log_likelihood, tlk.param_space(), params,
                        learning_rate=0.01, max_iter=5)
    jres = j_optimize_adam(jtlk.log_likelihood, jtlk.param_space(), jparams,
                           learning_rate=0.01, max_iter=5)
    assert len(res.history) == len(jres.history) == 5
    assert res.history[-1] > res.history[0]
    np.testing.assert_allclose(res.history, jres.history, rtol=1e-8)
    np.testing.assert_allclose(res.logp, jres.logp, rtol=1e-8)
    for k, v in res.params.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jres.params[k]),
                                   rtol=1e-7, atol=1e-10, err_msg=k)
