"""The likelihood analyses of the port (``ops/pruning.pruning_partials``,
``ops/upper.py``, ``likelihood/analysis.py``, ``likelihood/parsimony.py``,
the ``asr``/``ppsite``/``cat``/``simultron`` actions and the ``parsimony``
model) and its numpy copies ``trees/stats.py`` and ``trees/roottotip.py``,
held against the JAX package on the CPU in float64, with inputs made from a
numpy seed:

- the postorder buffer, the upper partials, the node marginals and the
  site-category posteriors at 1e-10 relative, on a binary tree and one
  with a polytomy, and the invariant that lower * upper at every node gives
  the root's site likelihood;
- ancestral states (posteriors at 1e-10, MAP states exact), rate-category
  posteriors and CAT assignment, through both packages' models;
- the Fitch scores exactly: the hand case and a random 10-taxon tree;
- the actions on tests/data/tiny.fa with HKY+G4 through both packages'
  Runners: the same ancestral sequences and categories, ppsite at 1e-10;
  simultron's alignment shape and alphabet; the parsimony model through
  the builder and the CLI's ``--dry``.
"""

import io
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physher_tpu.config.actions import Runner as JRunner
from physher_tpu.config.builder import build_config as j_build_config
from physher_tpu.data.sitepattern import SitePattern as JSitePattern
from physher_tpu.io.treeio import read_newick as j_read_newick
from physher_tpu.likelihood import analysis as j_analysis
from physher_tpu.likelihood.parsimony import Parsimony as JParsimony
from physher_tpu.models.sitemodel import GammaSiteModel as JGamma
from physher_tpu.models.substitution import HKY as JHKY
from physher_tpu.models.treelikelihood import TreeLikelihood as JTLK
from physher_tpu.ops.pruning import pruning_partials as j_pruning_partials
from physher_tpu.ops import upper as j_upper
from physher_tpu.trees import roottotip as j_roottotip
from physher_tpu.trees import stats as j_stats
from physher_tpu_torch import cli
from physher_tpu_torch.config.actions import Runner
from physher_tpu_torch.config.builder import build_config
from physher_tpu_torch.data.sitepattern import SitePattern
from physher_tpu_torch.io.treeio import read_newick
from physher_tpu_torch.likelihood import analysis
from physher_tpu_torch.likelihood.parsimony import Parsimony
from physher_tpu_torch.models.sitemodel import GammaSiteModel
from physher_tpu_torch.models.substitution import HKY
from physher_tpu_torch.models.treelikelihood import TreeLikelihood
from physher_tpu_torch.ops.pruning import pruning_partials
from physher_tpu_torch.ops import upper
from physher_tpu_torch.trees import roottotip, stats

KW = dict(dtype=torch.float64, device="cpu")

BINARY = "(((a:0.1,b:0.2):0.05,c:0.3):0.1,(d:0.15,e:0.25):0.2);"
POLYTOMY = "((a:0.1,b:0.2,c:0.05):0.1,(d:0.15,e:0.25):0.2,f:0.3);"


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the analyses and the actions run many ops on
    small tensors, which gain nothing from more threads, and
    beside other test processes on the same cores each op's thread barrier
    stalls."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(newick, n_sites=40, seed=0):
    """HKY+G4 (kappa 2, frequencies from the seed) on ``newick`` over
    random sequences from the seed, in both packages."""
    rng = np.random.default_rng(seed)
    jtopo, dist = j_read_newick(newick)
    topo, _ = read_newick(newick)
    seqs = {t: "".join(rng.choice(list("ACGT"), n_sites)) for t in jtopo.taxa}
    freqs = rng.dirichlet(np.full(4, 5.0))
    d0 = np.nan_to_num(dist[: jtopo.N - 1])
    jtlk = JTLK(JSitePattern.from_alignment(seqs), jtopo,
                JHKY(kappa_init=2.0, freqs_init=freqs), JGamma(4),
                distances_init=d0)
    tlk = TreeLikelihood(SitePattern.from_alignment(seqs), topo,
                         HKY(kappa_init=2.0, freqs_init=freqs, **KW),
                         GammaSiteModel(4, **KW), distances_init=d0, **KW)
    return jtlk, tlk


def _close(a, b, rtol=1e-10):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=0)


@pytest.mark.parametrize("newick", [BINARY, POLYTOMY])
def test_partials_and_marginals_match_jax(newick):
    jtlk, tlk = _models(newick)
    jp = jtlk.param_space().init_params()
    p = tlk.param_space().init_params(**KW)
    jpm, jfr, jpr, jlo = j_analysis._engine_state(jtlk, jp)
    pm, fr, pr, lo = analysis._engine_state(tlk, p)
    _close(pm, jpm)
    _close(lo, jlo)
    for rescale in (False, True):
        jb, js = j_pruning_partials(jtlk.tip_partials, jpm, jtlk.topo,
                                    rescale=rescale)
        b, s = pruning_partials(tlk.tip_partials, pm, tlk.topo,
                                rescale=rescale)
        _close(b, jb)
        _close(s, js)
    jup = j_upper.upper_partials(jlo, jpm, jtlk.topo, jfr)
    up = upper.upper_partials(lo, pm, tlk.topo, fr)
    _close(up, jup)
    _close(upper.node_marginals(lo, up, pr),
           j_upper.node_marginals(jlo, jup, jpr))
    _close(upper.site_category_posteriors(lo[-1], fr, pr),
           j_upper.site_category_posteriors(jlo[-1], jfr, jpr))
    # sum_s lower * upper at ANY node gives the root site likelihood
    ref = torch.einsum("c,s,csp->p", pr, fr, lo[tlk.topo.root])
    for node in range(tlk.topo.N):
        _close(torch.einsum("c,csp->p", pr, lo[node] * up[node]), ref)


def test_ancestral_states_and_categories_match_jax():
    jtlk, tlk = _models(BINARY, n_sites=60, seed=5)
    jp = jtlk.param_space().init_params()
    p = tlk.param_space().init_params(**KW)
    jpost, jmap = j_analysis.ancestral_states(jtlk, jp)
    post, map_states = analysis.ancestral_states(tlk, p)
    _close(post, jpost)
    np.testing.assert_array_equal(map_states, jmap)
    np.testing.assert_allclose(post.sum(1), 1.0, rtol=1e-12)
    assert analysis.ancestral_sequences(tlk, p) == \
        j_analysis.ancestral_sequences(jtlk, jp)
    _close(analysis.site_rate_posteriors(tlk, p),
           j_analysis.site_rate_posteriors(jtlk, jp))
    cats = analysis.cat_assignment(tlk, p)
    np.testing.assert_array_equal(cats, j_analysis.cat_assignment(jtlk, jp))
    assert cats.shape == (60,)


def _random_newick(n_taxa, rng):
    nodes = [f"t{i}" for i in range(n_taxa)]
    while len(nodes) > 1:
        i, j = sorted(rng.choice(len(nodes), 2, replace=False))
        merged = f"({nodes[i]}:0.1,{nodes[j]}:0.1)"
        nodes = [n for k, n in enumerate(nodes) if k not in (i, j)] + [merged]
    return nodes[0] + ";"


def test_fitch_scores_match_jax():
    seqs = {"a": "AAC", "b": "AAC", "c": "CCA", "d": "CCA"}
    sp = SitePattern.from_alignment(seqs)
    for newick, expected in (("((a:1,b:1):1,(c:1,d:1):1);", 3.0),
                             ("((a:1,c:1):1,(b:1,d:1):1);", 6.0)):
        assert Parsimony(sp, read_newick(newick)[0], **KW).score() == \
            expected
    rng = np.random.default_rng(11)
    newick = _random_newick(10, rng)
    seqs = {f"t{i}": "".join(rng.choice(list("ACGT-R"), 80))
            for i in range(10)}
    pars = Parsimony(SitePattern.from_alignment(seqs), read_newick(newick)[0],
                     **KW)
    jpars = JParsimony(JSitePattern.from_alignment(seqs),
                       j_read_newick(newick)[0])
    assert pars.score() == jpars.score()
    assert float(pars.log_prob()) == -pars.score()
    # the same data on another topology, the tips renumbered by name
    other = _random_newick(10, rng)
    assert pars.score(read_newick(other)[0]) == \
        jpars.score(j_read_newick(other)[0])


def test_stats_and_root_to_tip_match_jax():
    rng = np.random.default_rng(2)
    for _ in range(3):
        a, b = _random_newick(8, rng), _random_newick(8, rng)
        ta, da = read_newick(a)
        tb, db = read_newick(b)
        jta, jda = j_read_newick(a)
        jtb, jdb = j_read_newick(b)
        da = np.where(np.isnan(da), np.nan, rng.uniform(0.01, 0.3, da.size))
        jda = da
        assert stats.robinson_foulds(ta, tb) == \
            j_stats.robinson_foulds(jta, jtb)
        assert stats.branch_score(ta, da, tb, db) == \
            j_stats.branch_score(jta, jda, jtb, jdb)
        assert stats.k_tree_score(ta, da, tb, db) == \
            j_stats.k_tree_score(jta, jda, jtb, jdb)
        np.testing.assert_array_equal(stats.patristic_distances(ta, da),
                                      j_stats.patristic_distances(jta, jda))
        dates = {t: float(rng.uniform(0, 10)) for t in ta.taxa}
        r, jr = (roottotip.root_to_tip_regression(ta, da, dates),
                 j_roottotip.root_to_tip_regression(jta, jda, dates))
        for k in ("rate", "intercept", "origin", "r2"):
            assert r[k] == jr[k]


def _tiny_hky_config(data_dir, physher):
    return {
        "model": {
            "id": "treelikelihood", "type": "treelikelihood",
            "sitepattern": {
                "id": "patterns", "type": "sitepattern",
                "datatype": "nucleotide",
                "alignment": {"id": "seqs", "type": "alignment",
                              "file": os.path.join(data_dir, "tiny.fa")}},
            "sitemodel": {
                "id": "sitemodel", "type": "sitemodel",
                "distribution": {"distribution": "gamma", "categories": 4,
                                 "parameters": {"alpha": {
                                     "id": "alpha", "type": "parameter",
                                     "value": 0.3, "lower": 0}}},
                "substitutionmodel": {
                    "id": "sm", "type": "substitutionmodel",
                    "model": "hky", "datatype": "nucleotide",
                    "rates": {"kappa": {"id": "kappa", "type": "parameter",
                                        "value": 3.0, "lower": 0}},
                    "frequencies": {"id": "freqs", "type": "simplex",
                                    "values": [0.3, 0.2, 0.2, 0.3]}}},
            "tree": {"id": "tree", "type": "tree",
                     "parameters": "tree.distances",
                     "init": {"algorithm": "nj",
                              "sitepattern": "&patterns"}}},
        "physher": physher}


def test_analysis_actions_match_jax(data_dir, tmp_path):
    acts = [{"id": "asr", "type": "asr", "model": "&treelikelihood",
             "file": str(tmp_path / "asr.fa")},
            {"id": "ppsite", "type": "ppsite", "model": "&treelikelihood",
             "file": str(tmp_path / "pp.txt")},
            {"id": "cat", "type": "cat", "model": "&treelikelihood"},
            {"id": "sim", "type": "simultron", "model": "&treelikelihood",
             "length": 300, "output": str(tmp_path / "sim.fa")}]
    cfg = _tiny_hky_config(data_dir, acts)
    jctx, jactions = j_build_config(cfg, base_dir=data_dir)
    jres = JRunner(jctx, seed=0, out=io.StringIO()).run(jactions)
    ctx, actions = build_config(cfg, base_dir=data_dir, **KW)
    res = Runner(ctx, seed=0, out=io.StringIO()).run(actions)
    assert res["asr"] == jres["asr"]
    _close(res["ppsite"], jres["ppsite"])
    np.testing.assert_allclose(np.loadtxt(tmp_path / "pp.txt"),
                               res["ppsite"].T, rtol=1e-5)
    np.testing.assert_array_equal(res["cat"], jres["cat"])
    assert (tmp_path / "asr.fa").read_text().count(">") == len(res["asr"])
    sim = res["sim"]
    tlk = ctx.objects["treelikelihood"]
    assert sorted(sim) == sorted(tlk.topo.taxa)
    assert {len(s) for s in sim.values()} == {300}
    assert set("".join(sim.values())) <= set("ACGT")


def test_parsimony_model_builds_and_dry_runs(data_dir, tmp_path):
    cfg = {"model": {"id": "pars", "type": "parsimony",
                     "sitepattern": {"id": "p", "type": "sitepattern",
                                     "datatype": "nucleotide",
                                     "alignment": {"id": "a",
                                                   "type": "alignment",
                                                   "file": "tiny.fa"}},
                     "tree": {"id": "t", "type": "tree",
                              "init": {"algorithm": "nj",
                                       "sitepattern": "&p"}}},
           "physher": []}
    ctx, _ = build_config(cfg, base_dir=data_dir, **KW)
    jctx, _ = j_build_config(cfg, base_dir=data_dir)
    assert ctx.objects["pars"].score() == jctx.objects["pars"].score()
    path = tmp_path / "pars.json"
    path.write_text(json.dumps(cfg))
    out = io.StringIO()
    assert cli.run([str(path), "--dry"], out=out) is None
    assert json.loads(out.getvalue())["model"]["type"] == "parsimony"
