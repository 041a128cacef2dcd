"""Topology in the port (``ops/dynamic_pruning.py``,
``inference/topology_search.py``, ``inference/treemcmc.py`` and the
``topology`` optimizer and ``nni`` mcmc of the config), held against the
JAX package on the CPU in float64, with inputs made from a numpy seed:

- every dynamic-pruning function on random children arrays at 1e-10
  relative (orders and parents exactly), and the deterministic NNI edit
  against ``propose_nni_device`` for the same (c, side);
- ``nni_neighbors`` and ``spr_candidates`` equal to the JAX package's;
- the NNI search on the 6-taxon ``WRONG_NNI`` case of
  tests/test_topology_search.py, on data that the JAX package simulates,
  reaches the JAX search's topology (RF 0) and logP (1e-6); SPR recovers
  the true tree;
- the samplers by statistics: the strong-signal 4-taxon recovery above 0.9,
  the incremental state equal to a from-scratch evaluation at 1e-9, the
  tree validity after 25 device NNI moves;
- the config routes on tests/data/tiny.fa: the one-chain and 4-chain
  (incremental) nni mcmc with their logs, and a topology optimizer.
"""

import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physher_tpu.data.sitepattern import SitePattern as JSitePattern
from physher_tpu.inference.topology_search import (
    TopologySearch as JTopologySearch, nni_neighbors as j_nni_neighbors,
    spr_candidates as j_spr_candidates, to_nested as j_to_nested)
from physher_tpu.io.treeio import read_newick as j_read_newick
from physher_tpu.likelihood.analysis import simulate_alignment
from physher_tpu.models.sitemodel import ConstantSiteModel as JConstant
from physher_tpu.models.substitution import JC69 as JJC69
from physher_tpu.models.treelikelihood import TreeLikelihood as JTLK
from physher_tpu.ops import dynamic_pruning as J
from physher_tpu_torch.config.actions import Runner
from physher_tpu_torch.config.builder import build_config
from physher_tpu_torch.data.distance import distance_matrix
from physher_tpu_torch.data.sitepattern import SitePattern
from physher_tpu_torch.inference.topology_search import (
    TopologySearch, nni_neighbors, spr_candidates, to_nested)
from physher_tpu_torch.inference.treemcmc import BatchedTreeMCMC, TreeMCMC
from physher_tpu_torch.io.seqio import read_alignment
from physher_tpu_torch.io.treeio import read_newick
from physher_tpu_torch.models.substitution import JC69
from physher_tpu_torch.models.treelikelihood import TreeLikelihood
from physher_tpu_torch.ops import dynamic_pruning as D
from physher_tpu_torch.trees.build import nj
from physher_tpu_torch.trees.stats import robinson_foulds, splits

KW = dict(dtype=torch.float64, device="cpu")

DATA = os.path.join(os.path.dirname(__file__), "data")
TRUE = "(((a:0.1,b:0.1):0.05,(c:0.1,d:0.1):0.05):0.05,(e:0.1,f:0.1):0.1);"
WRONG = "(((a:0.1,f:0.1):0.05,(c:0.1,e:0.1):0.05):0.05,(b:0.1,d:0.1):0.1);"
WRONG_NNI = "(((a:0.1,c:0.1):0.05,(b:0.1,d:0.1):0.05):0.05,(e:0.1,f:0.1):0.1);"


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the searches and samplers run thousands of ops
    on small tensors, which gain nothing from more threads, and
    beside other test processes on the same cores each op's thread barrier
    stalls."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _random_children(T, rng):
    """A random binary tree as children [I, 2] in postorder id order."""
    nodes, nxt, ch = list(range(T)), T, []
    while len(nodes) > 1:
        i, j = rng.choice(len(nodes), 2, replace=False)
        ch.append([nodes[i], nodes[j]])
        nodes = [n for k, n in enumerate(nodes) if k not in (i, j)] + [nxt]
        nxt += 1
    return np.asarray(ch, np.int32)


def _close(a, b, rtol=1e-10):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=0)


@pytest.mark.parametrize("rescale", [False, True])
def test_dynamic_pruning_matches_jax(rescale):
    rng = np.random.default_rng(4)
    T, C, S, P, B = 9, 2, 4, 23, 3
    N = 2 * T - 1
    chs = np.stack([_random_children(T, rng) for _ in range(B)])
    tips = rng.uniform(size=(T, S, P))
    pm = rng.uniform(size=(B, N, C, S, S)) * 0.3
    fr, pr = rng.dirichlet(np.ones(S)), rng.dirichlet(np.ones(C))
    w = rng.uniform(1.0, 3.0, P)
    j_args = [jnp.asarray(a) for a in (fr, pr, w)]
    args = [_t(a) for a in (fr, pr, w)]
    kw = dict(rescale=rescale)
    _close(D.batched_tree_loglik(_t(tips), _t(pm), _t(chs).long(), *args,
                                 **kw),
           J.batched_tree_loglik(jnp.asarray(tips), jnp.asarray(pm),
                                 jnp.asarray(chs), *j_args, **kw))
    # NNI-edited arrays break id order: the ordered forms
    key = jax.random.PRNGKey(0)
    ch, jch = _t(chs[0]).long(), jnp.asarray(chs[0])
    for _ in range(6):
        key, sub = jax.random.split(key)
        jch, jc = J.propose_nni_device(sub, jch, T)
        side = bool(jax.random.bernoulli(jax.random.split(sub)[1]))
        ch = D.nni_edit(ch, int(jc), side, T)
        np.testing.assert_array_equal(ch.numpy(), np.asarray(jch))
    np.testing.assert_array_equal(D.parent_array(ch, T).numpy(),
                                  np.asarray(J.parent_array(jch, T)))
    order = D.postorder_from_children(ch, T)
    jorder = J.postorder_from_children(jch, T)
    np.testing.assert_array_equal(order.numpy(), np.asarray(jorder))
    ll, site = D.tree_loglik_dynamic_ordered(_t(tips), _t(pm[0]), ch, order,
                                             *args, **kw)
    jll, jsite = J.tree_loglik_dynamic_ordered(
        jnp.asarray(tips), jnp.asarray(pm[0]), jch, jorder, *j_args, **kw)
    _close(ll, jll)
    _close(site, jsite)
    buf, scal = D.tree_partials_dynamic_ordered(_t(tips), _t(pm[0]), ch,
                                                order, **kw)
    jbuf, jscal = J.tree_partials_dynamic_ordered(
        jnp.asarray(tips), jnp.asarray(pm[0]), jch, jorder, **kw)
    _close(buf, jbuf)
    _close(scal, jscal)
    _close(D.root_loglik_from_partials(buf, scal, *args, **kw)[0],
           J.root_loglik_from_partials(jbuf, jscal, *j_args, **kw)[0])
    # a branch changed below node `start`: refresh its root path only
    pm2 = pm[0].copy()
    leaf = int(ch[2, 0])
    pm2[leaf] *= 1.5
    start = int(D.parent_array(ch, T)[leaf])
    b2, s2 = D.update_path_partials(buf, scal, _t(pm2), ch, start, T, **kw)
    jb2, js2 = J.update_path_partials(jbuf, jscal, jnp.asarray(pm2), jch,
                                      jnp.asarray(start), T, **kw)
    _close(b2, jb2)
    _close(s2, js2)
    full = D.tree_partials_dynamic_ordered(_t(tips), _t(pm2), ch, order,
                                           **kw)
    _close(b2, full[0])
    # Fitch with the topology as data
    sets = rng.uniform(size=(T, P, S)) < 0.4
    sets[..., 0] |= ~sets.any(-1)
    _close(D.batched_fitch(_t(sets), _t(chs).long(), _t(w)),
           J.batched_fitch(jnp.asarray(sets), jnp.asarray(chs),
                           jnp.asarray(w)))
    _close(D.fitch_score_dynamic(_t(sets), ch, _t(w)),
           J.fitch_score_dynamic(jnp.asarray(sets), jch, jnp.asarray(w)))


def test_move_generation_matches_jax():
    topo, dist = read_newick(TRUE)
    jtopo, jdist = j_read_newick(TRUE)
    nested, jnested = to_nested(topo, dist), j_to_nested(jtopo, jdist)
    assert nested == jnested
    assert nni_neighbors(nested) == j_nni_neighbors(jnested)
    assert len(nni_neighbors(nested)) == 2 * (topo.I - 1)
    for radius in (None, 4):
        spr = spr_candidates(nested, radius)
        assert spr == j_spr_candidates(jnested, radius)
        assert len(spr) > 10


@pytest.fixture(scope="module")
def sim_data():
    """tests/test_topology_search.py's data: 2000 sites that the JAX
    package simulates down the true tree, in both packages."""
    jtopo, dist = j_read_newick(TRUE)
    seqs = simulate_alignment(jax.random.PRNGKey(7), jtopo, JJC69(),
                              JConstant(), {}, np.nan_to_num(dist, nan=0.0),
                              2000)
    return JSitePattern.from_alignment(seqs), SitePattern.from_alignment(seqs)


def _factory(sp):
    def make(topo, dist):
        return TreeLikelihood(
            sp, topo, JC69(**KW), distances_init=np.nan_to_num(
                np.asarray(dist)[: topo.N - 1], nan=0.05), **KW)
    return make


def test_nni_search_matches_jax(sim_data):
    jsp, sp = sim_data

    def jmake(topo, dist):
        return JTLK(jsp, topo, JJC69(), distances_init=np.nan_to_num(
            np.asarray(dist)[: topo.N - 1], nan=0.05))

    jres = JTopologySearch(jmake, algorithm="nni").run(
        *j_read_newick(WRONG_NNI))
    res = TopologySearch(_factory(sp), algorithm="nni").run(
        *read_newick(WRONG_NNI))
    assert res.moves_accepted > 0
    assert robinson_foulds(res.topology, read_newick(TRUE)[0]) == 0
    assert robinson_foulds(res.topology, read_newick(
        j_write(jres.topology, jres.distances))[0]) == 0
    assert abs(res.logp - jres.logp) < 1e-6
    assert all(b >= a for a, b in zip(res.history, res.history[1:]))


def j_write(topo, dist):
    from physher_tpu.io.treeio import write_newick

    return write_newick(topo, dist)


def test_spr_recovers_true_tree(sim_data):
    _, sp = sim_data
    res = TopologySearch(_factory(sp), algorithm="spr", spr_radius=6).run(
        *read_newick(WRONG))
    assert robinson_foulds(res.topology, read_newick(TRUE)[0]) == 0


def _strong_signal_tlk():
    """4 taxa with a strong ((A,B),(C,D)) signal, the start tree wrong."""
    rng = np.random.default_rng(0)
    anc = rng.integers(0, 4, 400)
    other = (anc + 1 + rng.integers(0, 3, 400)) % 4
    seqs = {k: "".join("ACGT"[i] for i in v)
            for k, v in (("A", anc), ("B", anc), ("C", other),
                         ("D", other))}
    topo, _ = read_newick("((A:0.1,C:0.1):0.1,(B:0.1,D:0.1):0.1);")
    return TreeLikelihood(SitePattern.from_alignment(seqs), topo, JC69(**KW),
                          distances_init=np.full(topo.N - 1, 0.1), **KW)


def _clades(children, taxa):
    """Clade taxa sets from a children array in any id order."""
    T, I = len(taxa), len(children)
    sets = [frozenset([t]) for t in taxa] + [None] * I
    remaining = set(range(I))
    while remaining:
        done = {r for r in remaining
                if sets[int(children[r][0])] is not None
                and sets[int(children[r][1])] is not None}
        assert done, "cyclic children array"
        for r in done:
            sets[T + r] = sets[int(children[r][0])] | sets[int(children[r][1])]
        remaining -= done
    return sets


AB_CD = {frozenset({"A", "B"}), frozenset({"C", "D"})}


def test_tree_mcmc_recovers_strong_signal():
    tlk = _strong_signal_tlk()
    tm = TreeMCMC(tlk)
    res = tm.run(torch.Generator().manual_seed(1), tm.space.init_params(**KW),
                 n_iter=3000, every=20, burnin=1000, p_topo=0.4)
    assert np.isfinite(res.log_posterior).all()
    hits = sum(bool(AB_CD & set(splits(read_newick(t)[0])))
               for t in res.trees)
    assert hits / len(res.trees) > 0.9


@pytest.mark.parametrize("incremental", [False, True])
def test_batched_tree_mcmc_recovers_strong_signal(incremental):
    tlk = _strong_signal_tlk()
    res = BatchedTreeMCMC(tlk, p_nni=0.4).run(
        torch.Generator().manual_seed(1), n_iter=1500, every=50, n_chains=8,
        burnin=500, incremental=incremental)
    assert 0.0 < res["acceptance"]["nni"] < 1.0
    assert 0.0 < res["acceptance"]["branch"] < 1.0
    assert np.isfinite(res["logp"]).all()
    taxa = tlk.topo.taxa
    hits = [bool(AB_CD & set(_clades(ch, taxa)[tlk.topo.T:]))
            for ch in res["children"].reshape(-1, tlk.topo.I, 2)]
    assert np.mean(hits) > 0.9


def _tiny_tlk():
    sp = SitePattern.from_alignment(read_alignment(os.path.join(DATA,
                                                                "tiny.fa")))
    topo, dist = nj(sp.taxa, distance_matrix(sp))
    return TreeLikelihood(sp, topo, JC69(**KW),
                          distances_init=dist[: topo.N - 1], **KW)


def test_incremental_state_equals_full_evaluation():
    """Every chain's carried log posterior equals a from-scratch evaluation
    of its final (children, bl): the reference's incremental-equals-full
    invariant (src/phyc/treelikelihood.c:126-161)."""
    tlk = _tiny_tlk()
    tm = BatchedTreeMCMC(tlk)
    res = tm.run(torch.Generator().manual_seed(3), n_iter=400, every=400,
                 n_chains=6, incremental=True)
    assert 0.0 < res["acceptance"]["nni"] < 1.0
    assert 0.0 < res["acceptance"]["branch"] < 1.0
    ch = torch.as_tensor(res["children"][-1])
    bl = torch.as_tensor(res["bl"][-1])
    pm = tlk.subst.p_t({}, torch.clamp(bl, min=0.0)[..., None])
    ll = D.tree_loglik_dynamic_ordered(
        tlk.tip_partials, pm, ch, D.postorder_from_children(ch, tlk.topo.T),
        tlk.subst.frequencies({}), torch.ones(1, **KW), tlk.weights,
        rescale=tlk.rescale)[0]
    rate = tm.bl_prior_rate
    lp = ll + (bl.shape[1] - 1) * np.log(rate) - rate * bl[:, :-1].sum(-1)
    assert np.isfinite(res["logp"][-1]).all()
    np.testing.assert_allclose(res["logp"][-1], lp.numpy(), rtol=1e-9)


def test_samplers_move_model_parameters():
    """HKY's kappa and frequencies as parameter blocks: the one-chain
    sampler's walk and the batched sampler's, as a batch [B, dim] through
    the model's chain axis, both move them, and each batched chain's
    carried log posterior
    equals an evaluation of its final state through the fixed-topology
    engine (the tree numbered anew from its children array)."""
    from physher_tpu_torch.models.substitution import HKY
    from physher_tpu_torch.trees.topology import Topology

    base = _tiny_tlk()
    tlk = TreeLikelihood(base.sp, base.topo, HKY(kappa_init=2.0, **KW),
                         distances_init=base.distances_init, **KW)
    tm = TreeMCMC(tlk)
    one = tm.run(torch.Generator().manual_seed(2), tm.space.init_params(**KW),
                 n_iter=300, every=50)
    assert 0.0 < one.acceptance["param"] < 1.0
    assert np.isfinite(one.log_posterior).all()
    bm = BatchedTreeMCMC(tlk)
    res = bm.run(torch.Generator().manual_seed(2), n_iter=200, every=100,
                 n_chains=4)
    assert bm.dim == 4 and res["u"].shape == (2, 4, 4)  # kappa, freqs
    assert 0.0 < res["acceptance"]["params"] < 1.0
    assert np.ptp(res["u"][-1]) > 0
    T, root = tlk.topo.T, tlk.topo.N - 1
    for b in range(4):
        ch, bl = res["children"][-1, b], res["bl"][-1, b]

        def build(nid):
            kids = [] if nid < T else [build(int(c)) for c in ch[nid - T]]
            return {"name": tlk.topo.taxa[nid] if nid < T else None,
                    "length": None if nid == root else float(bl[nid]),
                    "children": kids}

        topo, dist = Topology.from_nested(build(root))
        up = bm.space.unflatten_unconstrained(torch.as_tensor(res["u"][-1, b]))
        blt = torch.as_tensor(np.nan_to_num(dist, nan=0.0))
        lp = (tlk.topology_log_likelihood(bm.space.constrain(up), topo,
                                          tlk.tips_for(topo), blt)
              + bm.space.log_jacobian(up) + (topo.N - 1) * np.log(10.0)
              - 10.0 * blt[:-1].sum())
        np.testing.assert_allclose(res["logp"][-1, b], float(lp), rtol=1e-9)


def test_device_nni_keeps_trees_valid():
    tlk = _tiny_tlk()
    T, N = tlk.topo.T, tlk.topo.N
    ch = torch.as_tensor(tlk.topo.children[:, :2]).long()
    gen = torch.Generator().manual_seed(0)
    for _ in range(25):
        ch, _ = D.propose_nni_device(gen, ch, T)
        chn = ch.numpy()
        assert sorted(chn.ravel().tolist()) == list(range(N - 1))
        assert _clades(chn, tlk.topo.taxa)[-1] == frozenset(tlk.topo.taxa)
        order = D.postorder_from_children(ch, T).numpy()
        pos = {T + int(r): i for i, r in enumerate(order)}
        for i, r in enumerate(order):
            for c in chn[int(r)]:
                assert int(c) < T or pos[int(c)] < i


def _tiny_config(physher):
    return {
        "model": {
            "id": "treelikelihood", "type": "treelikelihood",
            "sitepattern": {
                "id": "patterns", "type": "sitepattern",
                "datatype": "nucleotide",
                "alignment": {"id": "seqs", "type": "alignment",
                              "file": os.path.join(DATA, "tiny.fa")}},
            "sitemodel": {
                "id": "sitemodel", "type": "sitemodel",
                "substitutionmodel": {
                    "id": "sm", "type": "substitutionmodel",
                    "model": "jc69", "datatype": "nucleotide"}},
            "tree": {"id": "tree", "type": "tree",
                     "parameters": "tree.distances",
                     "init": {"algorithm": "nj",
                              "sitepattern": "&patterns"}}},
        "physher": physher}


def _nni_mcmc(tmp_path, **extra):
    return {"id": "mcmc", "type": "mcmc", "model": "&treelikelihood",
            "operators": [
                {"id": "o1", "type": "operator", "algorithm": "nni",
                 "x": "&tree", "weight": 1},
                {"id": "o2", "type": "operator", "algorithm": "scaler",
                 "x": "%tree.distances", "weight": 4}],
            "log": [
                {"id": "l1", "type": "logger", "every": 100,
                 "file": str(tmp_path / "chain.log")},
                {"id": "l2", "type": "logger", "every": 100,
                 "file": str(tmp_path / "chain.trees"), "models": "&tree"}],
            **extra}


@pytest.mark.parametrize("chains", [1, 4])
def test_nni_mcmc_routes_from_config(tmp_path, chains):
    node = (_nni_mcmc(tmp_path, length=600) if chains == 1 else
            _nni_mcmc(tmp_path, length=400, chains=4, incremental=True))
    ctx, actions = build_config(_tiny_config([node]), base_dir=DATA, **KW)
    res = Runner(ctx, seed=1, out=io.StringIO()).run(actions)["mcmc"]
    n = 6 if chains == 1 else 4
    if chains > 1:
        assert res["children"].shape[1] == 4
        assert 0 < res["acceptance"]["nni"] <= 1.0
    else:
        assert 0 < res.acceptance["nni"] <= 1.0
    lines = (tmp_path / "chain.log").read_text().strip().split("\n")
    assert lines[0] == "state\tposterior"
    assert len(lines) == 1 + n
    assert np.isfinite([float(ln.split()[1]) for ln in lines[1:]]).all()
    trees = (tmp_path / "chain.trees").read_text().strip().split("\n")
    assert len(trees) == n
    topo, dist = read_newick(trees[-1])
    assert topo.T == 10
    assert np.isfinite(dist[: topo.N - 1]).all()


def test_topology_optimizer_replaces_the_likelihood():
    node = {"id": "topo", "type": "optimizer", "algorithm": "topology",
            "model": "&treelikelihood", "rounds": 2}
    ctx, actions = build_config(_tiny_config([node]), base_dir=DATA, **KW)
    start = ctx.objects["treelikelihood"]
    with torch.no_grad():
        start_logp = float(start.log_likelihood(
            start.param_space().init_params(**KW)))
    out = io.StringIO()
    runner = Runner(ctx, seed=0, out=out)
    res = runner.run(actions)["topo"]
    final = ctx.objects["treelikelihood"]
    assert final is not start and final.topo is res.topology
    assert res.rounds <= 2 and res.logp >= start_logp
    assert all(b >= a for a, b in zip(res.history, res.history[1:]))
    with torch.no_grad():
        logp = float(final.log_likelihood(runner.params_for(
            final.param_space())))
    assert abs(logp - res.logp) < 1e-6
    assert out.getvalue().startswith("Topology search (nni): logP")
