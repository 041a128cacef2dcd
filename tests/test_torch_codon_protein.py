"""The port's codon and protein models against the JAX package, in float64.

Q and P(t) of WAG, LG, Dayhoff, GY94 and MG94 at non-default parameters;
the structural identities of tests/test_codon_protein.py; the libphyc codon
goldens (GY94, MG94 on codon_small) and the WAG golden (tiny_aa on the
port's own Kimura-distance NJ tree); gradients against jax.grad; the copied
distance, NJ and tip-partial code against JAX's; and the simulate-then-fit
recovery of GY94's omega and kappa by Adam. Inputs come from numpy and go
to both packages as numpy arrays.
"""

import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physher_tpu.data.distance import distance_matrix as j_distance_matrix
from physher_tpu.data.sitepattern import SitePattern as JSitePattern
from physher_tpu.io.treeio import read_newick as j_read_newick
from physher_tpu.models import codon as j_codon
from physher_tpu.models import protein as j_protein
from physher_tpu.models.treelikelihood import TreeLikelihood as JTreeLikelihood
from physher_tpu.trees.build import nj as j_nj, upgma as j_upgma
from physher_tpu_torch.data.distance import distance_matrix
from physher_tpu_torch.data.sitepattern import SitePattern
from physher_tpu_torch.inference.ml import optimize_adam
from physher_tpu_torch.io.seqio import read_alignment
from physher_tpu_torch.io.treeio import read_newick
from physher_tpu_torch.likelihood.analysis import simulate_alignment
from physher_tpu_torch.models import codon, protein, substitution
from physher_tpu_torch.models.parameters import params_from_numpy
from physher_tpu_torch.models.sitemodel import ConstantSiteModel
from physher_tpu_torch.models.treelikelihood import TreeLikelihood
from physher_tpu_torch.trees.build import nj, upgma
from physher_tpu_torch.utils.synthetic import balanced_topology

F64 = dict(dtype=torch.float64, device="cpu")
WAG_GOLDEN = -1297.2958256864874

# (name, JAX maker, port maker, non-default parameters)
MODELS = [
    ("wag", j_protein.WAG, protein.WAG, {}),
    ("lg", j_protein.LG, protein.LG, {}),
    ("dayhoff", j_protein.Dayhoff, protein.Dayhoff, {}),
    ("gy94", j_codon.GY94, codon.GY94, {"kappa": 2.7, "omega": 0.35}),
    ("mg94", j_codon.MG94, codon.MG94,
     {"kappa": 1.8, "alpha": 1.3, "beta": 0.45}),
]


def _params(space_params, overrides, seed):
    """Numpy parameters: the model's defaults, the overrides, and random
    non-uniform frequencies."""
    rng = np.random.default_rng(seed)
    p = {k: np.asarray(v) for k, v in space_params.items()}
    p.update({k: np.asarray(v) for k, v in overrides.items()})
    S = p["frequencies"].shape[0]
    p["frequencies"] = rng.dirichlet(np.full(S, 5.0))
    return p


@pytest.mark.parametrize("name,j_maker,maker,over", MODELS,
                         ids=[m[0] for m in MODELS])
def test_q_and_p_t_match_jax(name, j_maker, maker, over):
    jm, tm = j_maker(), maker(**F64)
    p = _params(jm.param_space().init_params(), over, seed=3)
    assert set(p) == set(tm.param_space().names)
    tp = params_from_numpy(p, **F64)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    t = np.random.default_rng(4).uniform(0.0, 1.5, (5, 2))
    np.testing.assert_allclose(tm.q(tp).numpy(), np.asarray(jm.q(jp)),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(
        tm.p_t(tp, torch.as_tensor(t)).numpy(),
        np.asarray(jm.p_t(jp, jnp.asarray(t))), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name,j_maker,maker,over", MODELS,
                         ids=[m[0] for m in MODELS])
def test_q_identities(name, j_maker, maker, over):
    """Zero row sums, unit mean rate, detailed balance; P(t) is stochastic."""
    tm = maker(**F64)
    p = params_from_numpy(_params(
        {k: v.numpy() for k, v in tm.param_space().init_params(**F64).items()},
        over, seed=5), **F64)
    Q, pi = tm.q(p).numpy(), tm.frequencies(p).numpy()
    np.testing.assert_allclose(Q.sum(1), 0.0, atol=1e-12)
    np.testing.assert_allclose(-np.sum(pi * np.diag(Q)), 1.0, rtol=1e-12)
    np.testing.assert_allclose(pi[:, None] * Q, (pi[:, None] * Q).T,
                               atol=1e-12)
    P = tm.p_t(p, torch.as_tensor([0.1, 1.0], dtype=torch.float64)).numpy()
    np.testing.assert_allclose(P.sum(-1), 1.0, atol=1e-9)
    assert (P >= -1e-12).all()


def test_mg94_equals_gy94():
    """MG94(alpha=1, beta=omega, kappa) == GY94(kappa, omega)."""
    gy, mg = codon.GY94(**F64), codon.MG94(**F64)
    pg = gy.param_space().init_params(**F64)
    pm = mg.param_space().init_params(**F64)
    pg.update(kappa=torch.tensor(3.0, **F64), omega=torch.tensor(0.15, **F64))
    pm.update(kappa=torch.tensor(3.0, **F64), alpha=torch.tensor(1.0, **F64),
              beta=torch.tensor(0.15, **F64))
    np.testing.assert_allclose(gy.q(pg).numpy(), mg.q(pm).numpy(),
                               atol=1e-14)


def test_codon_pair_classes_match_jax():
    cls = codon.codon_pair_classes(0)
    np.testing.assert_array_equal(cls, j_codon.codon_pair_classes(0))
    assert (cls == cls.T).all() and (cls > 0).sum(1).max() <= 9


# -- data, distances and trees --------------------------------------------


@pytest.mark.parametrize("fasta,datatype", [("codon_small.fa", "codon"),
                                            ("tiny_aa.fa", "aa")])
@pytest.mark.parametrize("tipstates", [True, False])
def test_tip_partials_match_jax(data_dir, fasta, datatype, tipstates):
    seqs = read_alignment(os.path.join(data_dir, fasta))
    sp = SitePattern.from_alignment(seqs, datatype)
    jsp = JSitePattern.from_alignment(seqs, datatype)
    np.testing.assert_array_equal(sp.codes, jsp.codes)
    np.testing.assert_array_equal(sp.weights, jsp.weights)
    for pad in (None, 256):
        np.testing.assert_array_equal(
            sp.tip_partials(tipstates=tipstates, pad_to=pad),
            jsp.tip_partials(tipstates=tipstates, pad_to=pad))


@pytest.mark.parametrize("fasta,datatype,model", [
    ("tiny_aa.fa", "aa", "kimura"), ("tiny_aa.fa", "aa", "uncorrected"),
    ("fluA.fa", "nucleotide", "jc69"), ("fluA.fa", "nucleotide", "k2p")])
def test_distance_and_trees_match_jax(data_dir, fasta, datatype, model):
    seqs = read_alignment(os.path.join(data_dir, fasta))
    sp = SitePattern.from_alignment(seqs, datatype)
    D = distance_matrix(sp, model)
    np.testing.assert_array_equal(
        D, j_distance_matrix(JSitePattern.from_alignment(seqs, datatype),
                             model))
    for build, j_build in ((nj, j_nj), (upgma, j_upgma)):
        topo, dist = build(sp.taxa, D)
        jtopo, jdist = j_build(sp.taxa, D)
        assert topo.taxa == jtopo.taxa
        np.testing.assert_array_equal(topo.children, jtopo.children)
        np.testing.assert_array_equal(dist, jdist)


# -- goldens --------------------------------------------------------------


def _codon_small(data_dir):
    seqs = read_alignment(os.path.join(data_dir, "codon_small.fa"))
    with open(os.path.join(data_dir, "codon_small.nwk")) as fh:
        newick = fh.read().strip()
    return seqs, newick


def _codon_goldens(data_dir):
    with open(os.path.join(data_dir, "goldens", "codon_small.txt")) as fh:
        golden = fh.read()
    return (float(re.search(r"gy94 .* logP (\S+)", golden).group(1)),
            float(re.search(r"mg94 .* logP (\S+)", golden).group(1)))


CODON_CASES = {"gy94": (codon.GY94, {"kappa": 2.5, "omega": 0.3}),
               "mg94": (codon.MG94, {"alpha": 1.0, "beta": 0.4,
                                     "kappa": 2.0})}


@pytest.mark.parametrize("name", ["gy94", "mg94"])
def test_codon_reference_goldens(data_dir, name):
    """libphyc's GY94 / MG94 logP on codon_small through the port's
    TreeLikelihood, at tests/test_codon_protein.py's tolerances."""
    seqs, newick = _codon_small(data_dir)
    topo, dist = read_newick(newick)
    sp = SitePattern.from_alignment(seqs, "codon")
    maker, values = CODON_CASES[name]
    tlk = TreeLikelihood(sp, topo, maker(fixed_freqs=True, **F64),
                         distances_init=dist, **F64)
    p = tlk.param_space().init_params(**F64)
    p.update({k: torch.tensor(v, **F64) for k, v in values.items()})
    golden = dict(zip(("gy94", "mg94"), _codon_goldens(data_dir)))[name]
    np.testing.assert_allclose(float(tlk.log_likelihood(p)), golden,
                               rtol=5e-9, atol=1e-7)


def _wag_nj(data_dir, free_freqs=False):
    """The WAG golden's model as tests/data/goldens/wag.json builds it:
    tiny_aa, NJ over Kimura distances (amino-acid data always uses them),
    tip states on."""
    with open(os.path.join(data_dir, "goldens", "wag.json")) as fh:
        cfg = json.load(fh)["model"]
    fasta = os.path.basename(cfg["sitepattern"]["alignment"]["file"])
    seqs = read_alignment(os.path.join(data_dir, fasta))
    sp = SitePattern.from_alignment(seqs, cfg["sitepattern"]["datatype"])
    topo, dist = nj(sp.taxa, distance_matrix(sp, "kimura"))
    dist0 = np.nan_to_num(dist[: topo.N - 1], nan=0.1)
    return seqs, sp, topo, dist0


def test_wag_golden(data_dir):
    _, sp, topo, dist0 = _wag_nj(data_dir)
    tlk = TreeLikelihood(sp, topo, protein.WAG(**F64), distances_init=dist0,
                         tipstates=True, **F64)
    logp = float(tlk.log_likelihood(tlk.param_space().init_params(**F64)))
    np.testing.assert_allclose(logp, WAG_GOLDEN, rtol=0, atol=1e-8)


# -- gradients against jax.grad -------------------------------------------


def _grads(tlk, jtlk, params):
    leaves = params_from_numpy(params, **F64)
    leaves = {k: v.requires_grad_(True) for k, v in leaves.items()}
    logp = tlk.log_likelihood(leaves)
    logp.backward()
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    # jitted: eager JAX walks the 61-state sweep op by op (about 10 s)
    jval, jg = jax.jit(jax.value_and_grad(jtlk.log_likelihood))(jp)
    # 61 x 61 eigendecompositions by two LAPACK paths: ~1e-11 relative
    np.testing.assert_allclose(float(logp.detach()), float(jval), rtol=1e-10)
    return {k: v.grad.numpy() for k, v in leaves.items()}, \
        {k: np.asarray(v) for k, v in jg.items()}


def test_gy94_gradient_matches_jax(data_dir):
    seqs, newick = _codon_small(data_dir)
    topo, dist = read_newick(newick)
    jtopo, _ = j_read_newick(newick)
    tlk = TreeLikelihood(SitePattern.from_alignment(seqs, "codon"), topo,
                         codon.GY94(fixed_freqs=True, **F64),
                         distances_init=dist, **F64)
    jtlk = JTreeLikelihood(JSitePattern.from_alignment(seqs, "codon"), jtopo,
                           j_codon.GY94(fixed_freqs=True),
                           distances_init=dist)
    params = {k: np.asarray(v) for k, v in
              jtlk.param_space().init_params().items()}
    params.update(kappa=np.asarray(2.5), omega=np.asarray(0.3))
    g, jg = _grads(tlk, jtlk, params)
    for k in ("kappa", "omega", "tree.distances"):
        np.testing.assert_allclose(g[k], jg[k], rtol=1e-8, err_msg=k)


def test_wag_free_frequencies_gradient_matches_jax(data_dir):
    seqs, sp, topo, dist0 = _wag_nj(data_dir)
    jsp = JSitePattern.from_alignment(seqs, "aa")
    jtopo, _ = j_nj(jsp.taxa, j_distance_matrix(jsp, "kimura"))
    tlk = TreeLikelihood(sp, topo, protein.WAG(free_freqs=True, **F64),
                         distances_init=dist0, tipstates=True, **F64)
    jtlk = JTreeLikelihood(jsp, jtopo, j_protein.WAG(free_freqs=True),
                           distances_init=dist0, tipstates=True)
    params = {k: np.asarray(v) for k, v in
              jtlk.param_space().init_params().items()}
    g, jg = _grads(tlk, jtlk, params)
    for k in ("frequencies", "tree.distances"):
        np.testing.assert_allclose(g[k], jg[k], rtol=1e-8, err_msg=k)


def test_gy94_degenerate_gradient_matches_jax(data_dir):
    """At kappa = omega = 1 the generator has repeated eigenvalues, where
    the backward takes the divided differences' limit: float64 against
    jax.grad."""
    seqs, newick = _codon_small(data_dir)
    topo, dist = read_newick(newick)
    jtopo, _ = j_read_newick(newick)
    tlk = TreeLikelihood(SitePattern.from_alignment(seqs, "codon"), topo,
                         codon.GY94(fixed_freqs=True, **F64),
                         distances_init=dist, **F64)
    jtlk = JTreeLikelihood(JSitePattern.from_alignment(seqs, "codon"), jtopo,
                           j_codon.GY94(fixed_freqs=True),
                           distances_init=dist)
    params = {k: np.asarray(v) for k, v in
              jtlk.param_space().init_params().items()}
    params.update({k: np.asarray(v) for k, v in DEGENERATE["gy94"].items()})
    g, jg = _grads(tlk, jtlk, params)
    for k in ("kappa", "omega", "tree.distances"):
        np.testing.assert_allclose(g[k], jg[k], rtol=1e-8, err_msg=k)


# -- float32: P(t) from a float64 decomposition of Q ------------------------
#
# The port's reversible models decompose Q in float64 whatever their dtype
# (models/substitution.p_t_reversible). Here the port's float32 departs from
# the JAX package's: a float32 eigh of the 61-state generator gives JAX a
# NaN logP at the goldens (negative entries of P) and wrong gradients at
# kappa = omega = 1 (repeated eigenvalues that float32 noise splits), as
# ROADMAP.md's Queue 3 records. So float32 is held against the port's own
# float64: logP within 1e-5 relative, each gradient in the model's
# parameters finite and within 1e-3 of the largest float64 entry.

F32 = dict(dtype=torch.float32, device="cpu")
DEGENERATE = {"gy94": {"kappa": 1.0, "omega": 1.0},
              "mg94": {"alpha": 1.0, "beta": 1.0, "kappa": 1.0}}
F32_POINTS = {f"{name}-{point}": (name, values)
              for name in ("gy94", "mg94")
              for point, values in (("golden", CODON_CASES[name][1]),
                                    ("degenerate", DEGENERATE[name]))}


def _codon_value_and_grad(data_dir, name, values, kw):
    """The port's logP on codon_small at the model parameters ``values``
    (floats, or lists: one chain each) and its gradient in them."""
    seqs, newick = _codon_small(data_dir)
    topo, dist = read_newick(newick)
    tlk = TreeLikelihood(SitePattern.from_alignment(seqs, "codon"), topo,
                         CODON_CASES[name][0](fixed_freqs=True, **kw),
                         distances_init=dist, **kw)
    p = tlk.param_space().init_params(**kw)
    lead = np.shape(next(iter(values.values())))
    p = {k: v.expand(lead + v.shape) for k, v in p.items()}
    p.update({k: torch.tensor(v, **kw).requires_grad_(True)
              for k, v in values.items()})
    logp = tlk.log_likelihood(p)
    assert logp.shape == lead
    logp.sum().backward()
    return (logp.detach().double().numpy(),
            {k: p[k].grad.double().numpy() for k in values})


def _assert_f32_near_f64(v32, g32, v64, g64):
    assert np.isfinite(v32).all()
    np.testing.assert_allclose(v32, v64, rtol=1e-5)
    big = max(np.abs(g).max() for g in g64.values())
    for k in g64:
        assert np.isfinite(g32[k]).all(), k
        np.testing.assert_allclose(g32[k], g64[k], rtol=0, atol=1e-3 * big,
                                   err_msg=k)


@pytest.mark.parametrize("case", sorted(F32_POINTS))
def test_codon_float32_matches_float64(data_dir, case):
    name, values = F32_POINTS[case]
    _assert_f32_near_f64(*_codon_value_and_grad(data_dir, name, values, F32),
                         *_codon_value_and_grad(data_dir, name, values, F64))


def test_codon_float32_batch_matches_float64(data_dir):
    """Two GY94 chains, one at the golden and one at the degenerate point,
    in one float32 call of the plain engine."""
    values = {k: [CODON_CASES["gy94"][1][k], DEGENERATE["gy94"][k]]
              for k in ("kappa", "omega")}
    _assert_f32_near_f64(
        *_codon_value_and_grad(data_dir, "gy94", values, F32),
        *_codon_value_and_grad(data_dir, "gy94", values, F64))


def test_p_t_reversible_dtypes():
    """A float32 GY94 generator: P is float32 and equals the float64
    decomposition's P rounded; a float64 one goes straight through."""
    m64, m32 = codon.GY94(**F64), codon.GY94(**F32)
    p = m64.param_space().init_params(**F64)
    p.update(kappa=torch.tensor(2.5, **F64), omega=torch.tensor(0.3, **F64))
    p32 = {k: v.float() for k, v in p.items()}
    t = torch.as_tensor(np.random.default_rng(0).uniform(0, 1, (5, 2)))
    Q32, pi32 = m32.q(p32), m32.frequencies(p32)
    P32 = substitution.p_t_reversible(Q32, pi32, t.float())
    assert P32.dtype == torch.float32
    ref = substitution._PtReversible.apply(Q32.double(), pi32.double(),
                                           t.float().double())
    assert torch.equal(P32, ref.float())
    Q, pi = m64.q(p), m64.frequencies(p)
    assert torch.equal(substitution.p_t_reversible(Q, pi, t),
                       substitution._PtReversible.apply(Q, pi, t))


# -- simulation and the M0 fit ---------------------------------------------


def _gy94_sim(n_taxa, n_codons, seed):
    topo = balanced_topology(n_taxa)
    subst = codon.GY94(fixed_freqs=True, **F64)
    params = subst.param_space().init_params(**F64)
    params.update(kappa=torch.tensor(2.0, **F64),
                  omega=torch.tensor(0.2, **F64))
    bl = np.full(topo.N, 0.3)
    bl[topo.root] = 0.0
    gen = torch.Generator().manual_seed(seed)
    seqs = simulate_alignment(gen, topo, subst, ConstantSiteModel(**F64),
                              params, bl, n_codons, datatype="codon")
    return topo, seqs


def test_simulate_alignment_shapes():
    topo, seqs = _gy94_sim(6, 50, seed=1)
    assert list(seqs) == topo.taxa
    assert all(len(s) == 150 for s in seqs.values())
    sp = SitePattern.from_alignment(seqs, "codon")
    assert sp.datatype.state_count == 61
    assert (sp.codes < 61).all()             # sense codons only
    topo2, seqs2 = _gy94_sim(6, 50, seed=1)
    assert seqs2 == seqs                     # the generator's seed fixes it


def test_codon_m0_ml_recovers_omega():
    """tests/test_codon_protein.py's BASELINE workload #3 in the port:
    simulate GY94 (kappa 2, omega 0.2) on a balanced 8-taxon tree and
    recover omega and kappa by full-gradient Adam. The random streams
    differ from JAX's, so the converged values are what is held."""
    topo, seqs = _gy94_sim(8, 1200, seed=0)
    sp = SitePattern.from_alignment(seqs, "codon")
    tlk = TreeLikelihood(sp, topo, codon.GY94(fixed_freqs=True, **F64),
                         distances_init=np.full(topo.N - 1, 0.3), **F64)
    space = tlk.param_space()
    res = optimize_adam(tlk.log_likelihood, space,
                        space.init_params(**F64), learning_rate=0.05,
                        max_iter=600)
    assert np.isfinite(res.logp)
    assert abs(float(res.params["omega"]) - 0.2) < 0.05
    assert abs(float(res.params["kappa"]) - 2.0) < 0.5
