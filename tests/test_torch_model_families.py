"""The substitution, site and clock models beyond the strict-clock
nucleotide set, on the CPU in float64, held against the JAX package:

- special functions (``utils/special.py``): the quantiles and ``log1mexp``
  at 1e-12; the regularized incomplete beta at 1e-12; its inverse at 1e-10
  and the inverse's derivatives at 1e-6 relative (both packages take dI/da
  and dI/db by central differences at a step of 1e-6); the derivative of
  the lower incomplete gamma in its first argument at 1e-10;
- ``expm_pade`` at 1e-12 (and against ``torch.linalg.matrix_exp`` at
  1e-10), Q and P(t) of UNREST, NONSTAT and the general reversible model at
  1e-12, UNREST's stationary frequencies and their gradient at 1e-12;
- the site models' rates and proportions, with their gradients, at 1e-10;
  gradients through an inverse whose derivative both packages take by
  central differences at 1e-8 (the Gamma quantiles', as
  tests/test_torch_models.py holds them) and 1e-6 (the beta quadrature's);
- the clocks' rates exactly (the distribution clock's bins to 4e-15);
- configs built by ``build_config`` in both packages on fluA (the site and
  substitution variants on the jc69-time.json tree and strict clock, the
  clock variants on the same time tree): logP at atol 1e-8 and the
  gradient at rtol 1e-7;
- a batch of L = 3 parameter dicts against three single calls at 1e-12,
  for every new model.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physher_tpu.config.builder import build_config as j_build_config
from physher_tpu.models import clock as j_clock
from physher_tpu.models import sitemodel as j_site
from physher_tpu.models import substitution as j_subst
from physher_tpu.trees.topology import Topology as JTopology
from physher_tpu.utils import special as j_special
from physher_tpu_torch.config.builder import build_config, load_json
from physher_tpu_torch.models import clock, sitemodel, substitution
from physher_tpu_torch.models.parameters import params_from_numpy
from physher_tpu_torch.trees.topology import Topology
from physher_tpu_torch.utils import special

KW = dict(dtype=torch.float64, device="cpu")


def _t(x):
    return torch.as_tensor(np.asarray(x, np.float64))


# -- special functions --------------------------------------------------------


@pytest.mark.parametrize("name", ["qweibull1", "qlognormal", "qnorm",
                                  "log1mexp"])
def test_special_quantiles_match(name):
    p = np.random.default_rng(1).uniform(0.01, 0.99, 50)
    args = {"qweibull1": (p, 0.6), "qlognormal": (p, -0.3, 0.7),
            "qnorm": (p, 0.2, 1.3), "log1mexp": (p * 3,)}[name]
    got = getattr(special, name)(*map(_t, args)).numpy()
    np.testing.assert_allclose(got, np.asarray(getattr(j_special, name)(
        *map(jnp.asarray, args))), rtol=1e-12, atol=1e-12)


def test_gauss_laguerre_matches():
    for n in (2, 4, 8):
        for a, b in zip(special.gauss_laguerre(n),
                        j_special.gauss_laguerre(n)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_betainc_matches(dtype):
    rng = np.random.default_rng(0)
    a, b = rng.uniform(0.05, 20, (2, 2000))
    x = np.concatenate([rng.uniform(0, 1, 1998), [0.0, 1.0]])
    ref = np.asarray(jax.scipy.special.betainc(a, b, x))
    got = special.betainc(*(torch.as_tensor(v, dtype=dtype)
                            for v in (a, b, x))).double().numpy()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-12 if dtype == torch.float64 else 2e-5)


@pytest.mark.parametrize("a,b", [(0.3, 1.0), (2.5, 0.4), (5.0, 5.0)])
def test_betaincinv_and_derivatives_match(a, b):
    """The inverse at the beta quadrature's grid and one inner point, and
    its derivatives in a, b and p."""
    p = np.asarray([0.0, 0.25, 0.5, 0.75, 0.3])
    w = np.arange(1.0, 6.0)

    def jf(a_, b_, p_):
        return jnp.sum(j_special.betaincinv(a_, b_, p_) * w)

    jx = np.asarray(jax.jit(j_special.betaincinv)(a, b, jnp.asarray(p)))
    jg = jax.jit(jax.grad(jf, argnums=(0, 1, 2)))(a, b, jnp.asarray(p))
    leaves = [_t(v).requires_grad_(True) for v in (a, b, p)]
    x = special.betaincinv(*leaves)
    np.testing.assert_allclose(x.detach().numpy(), jx, rtol=1e-10,
                               atol=1e-10)
    grads = torch.autograd.grad(torch.sum(x * _t(w)), leaves)
    # p = 0 sits at the clip, where the derivative in p is 1 / pdf there
    for g, ref in zip(grads, jg):
        np.testing.assert_allclose(g.numpy(), np.asarray(ref), rtol=1e-6)


def test_gammainc_derivative_in_a_matches():
    """d/da P(a + 1, x) (the mean quadrature's) against JAX's exact
    derivative."""
    a = np.asarray([0.1, 0.5, 1.0, 3.0, 10.0])
    x = np.asarray([0.01, 0.3, 1.0, 3.0, 20.0])
    ref = jax.grad(lambda a_: jnp.sum(jax.scipy.special.gammainc(
        a_ + 1.0, jnp.asarray(x)) * jnp.arange(1.0, 6.0)))(jnp.asarray(a))
    at = _t(a).requires_grad_(True)
    val = special.gammainc(at + 1.0, _t(x))
    np.testing.assert_allclose(val.detach().numpy(), np.asarray(
        jax.scipy.special.gammainc(a + 1.0, x)), rtol=1e-12, atol=1e-14)
    (g,) = torch.autograd.grad(torch.sum(val * torch.arange(1.0, 6.0,
                                                            **KW)), [at])
    np.testing.assert_allclose(g.numpy(), np.asarray(ref), rtol=1e-10,
                               atol=1e-12)


# -- substitution models ----------------------------------------------------


@pytest.mark.parametrize("scale", [0.01, 1.0, 20.0, 150.0])
def test_expm_pade_matches(scale):
    """Batched generators at norms that take 0, 2 to 4, 6 to 8 and 10
    squarings."""
    rng = np.random.default_rng(3)
    A = rng.random((5, 4, 4)) * scale
    A = A - np.eye(4) * A.sum(-1, keepdims=True)
    ref = np.asarray(j_subst.expm_pade(jnp.asarray(A)))
    got = substitution.expm_pade(_t(A))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12, atol=1e-12)
    if scale <= 20.0:
        np.testing.assert_allclose(got.numpy(),
                                   torch.linalg.matrix_exp(_t(A)).numpy(),
                                   rtol=1e-10, atol=1e-10)


def _subst_pair(name):
    if name == "unrest":
        return (substitution.UNREST("sm.", **KW), j_subst.UNREST("sm."))
    if name == "nonstat":
        return (substitution.NONSTAT("sm.", **KW), j_subst.NONSTAT("sm."))
    mapping = [0, 1, 0, 2, 0, 3]
    return (substitution.GeneralReversible(4, mapping, "sm.", **KW),
            j_subst.GeneralReversible(4, mapping, "sm."))


def _subst_params(model, rng):
    out = {}
    for spec in model.param_specs():
        v = rng.uniform(0.2, 3.0, spec.init.shape)
        out[spec.name] = v / v.sum() if spec.transform == "simplex" else v
    return out


@pytest.mark.parametrize("name", ["unrest", "nonstat", "gensubst"])
def test_generator_and_pt_match(name):
    """Q, the frequencies and P(t) over a [7, 3] grid of branch lengths, and
    the gradient of a weighted sum of P(t) in the parameters."""
    model, jmodel = _subst_pair(name)
    rng = np.random.default_rng(4)
    p = _subst_params(jmodel, rng)
    t = rng.uniform(0.0, 2.0, (7, 3))
    W = rng.normal(size=(7, 3, 4, 4))
    leaves = {k: _t(v).requires_grad_(True) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    np.testing.assert_allclose(model.q(leaves).detach().numpy(),
                               np.asarray(jmodel.q(jp)), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(model.frequencies(leaves).detach().numpy(),
                               np.asarray(jmodel.frequencies(jp)),
                               rtol=1e-12, atol=1e-12)
    P = model.p_t(leaves, _t(t))

    def jf(q):
        jP = jmodel.p_t(q, jnp.asarray(t))
        return jnp.sum(jP * W), jP

    (_, jP), jg = jax.jit(jax.value_and_grad(jf, has_aux=True))(jp)
    np.testing.assert_allclose(P.detach().numpy(), np.asarray(jP),
                               rtol=1e-12, atol=1e-12)
    # NONSTAT's root frequencies do not enter P(t): no gradient, JAX's 0
    grads = torch.autograd.grad(torch.sum(P * _t(W)), list(leaves.values()),
                                allow_unused=True)
    for k, g in zip(leaves, grads):
        g = torch.zeros_like(leaves[k]) if g is None else g
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[k]), rtol=1e-10,
                                   atol=1e-12)


def test_unrest_stationary_matches():
    """UNREST's frequencies (JAX: a least-squares solve of the augmented
    system; here its exact square solve) and their gradient."""
    model, jmodel = _subst_pair("unrest")
    p = _subst_params(jmodel, np.random.default_rng(5))
    w = np.asarray([1.0, -2.0, 0.5, 3.0])
    leaves = {k: _t(v).requires_grad_(True) for k, v in p.items()}
    pi = model.frequencies(leaves)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    np.testing.assert_allclose(pi.detach().numpy(),
                               np.asarray(jmodel.frequencies(jp)),
                               rtol=1e-12, atol=1e-12)
    jg = jax.jit(jax.grad(lambda q: jnp.sum(jmodel.frequencies(q) * w)))(
        jp)
    (g,) = torch.autograd.grad(torch.sum(pi * _t(w)), [leaves["sm.rates"]])
    np.testing.assert_allclose(g.numpy(), np.asarray(jg["sm.rates"]),
                               rtol=1e-12, atol=1e-12)


# -- site models ------------------------------------------------------------

SITE_CASES = {
    "invariant": ("InvariantSiteModel", (), dict(pinv_init=0.2)),
    "discrete": ("DiscreteSiteModel", (3,), {}),
    "gamma-median-i": ("QuantileSiteModel", (4, "gamma", True, "median"),
                       dict(shape_init=0.7)),
    "gamma-mean": ("QuantileSiteModel", (4, "gamma", False, "mean"),
                   dict(shape_init=0.7)),
    "gamma-mean-i-mu": ("QuantileSiteModel", (3, "gamma", True, "mean"),
                        dict(shape_init=1.3, mu=True, mu_init=1.5)),
    "gamma-beta": ("QuantileSiteModel", (4, "gamma", False, "beta"),
                   dict(shape_init=0.8)),
    "gamma-kumaraswamy": ("QuantileSiteModel",
                          (4, "gamma", False, "kumaraswamy"),
                          dict(shape_init=0.8)),
    "weibull-median": ("QuantileSiteModel", (4, "weibull", False, "median"),
                       dict(shape_init=0.6)),
    "weibull-median-i": ("QuantileSiteModel", (4, "weibull", True, "median"),
                         dict(shape_init=0.6)),
    "lognormal-median": ("QuantileSiteModel",
                         (4, "lognormal", False, "median"),
                         dict(shape_init=0.9)),
    "lognormal-kumaraswamy": ("QuantileSiteModel",
                              (3, "lognormal", True, "kumaraswamy"),
                              dict(shape_init=0.9)),
}


# the gradients that go through the inverse functions' derivatives, which
# both packages take by central differences: the gamma quantiles' at a step
# of 1e-5 (held at 1e-8 as in tests/test_torch_models.py), the beta
# quadrature's grid at 1e-6
GRAD_RTOL = {"gamma-median-i": 1e-8, "gamma-mean": 1e-8,
             "gamma-mean-i-mu": 1e-8, "gamma-kumaraswamy": 1e-8,
             "gamma-beta": 1e-6}


def _site_pair(case):
    cls, args, kw = SITE_CASES[case]
    return (getattr(sitemodel, cls)(*args, prefix="s.", **kw, **KW),
            getattr(j_site, cls)(*args, prefix="s.", **kw))


def _site_params(jmodel, rng, L=None):
    """The init point moved by numpy noise: ``[L, ...]`` per parameter for a
    batch of L."""
    out = {}
    for spec in jmodel.param_specs():
        shape = spec.init.shape if L is None else (L,) + spec.init.shape
        v = spec.init * rng.uniform(0.7, 1.3, shape)
        out[spec.name] = (v / v.sum(-1, keepdims=True)
                          if spec.transform == "simplex" else v)
    return out


@pytest.mark.parametrize("case", sorted(SITE_CASES))
def test_site_rates_props_match(case):
    model, jmodel = _site_pair(case)
    p = _site_params(jmodel, np.random.default_rng(6))
    C = jmodel.cat_count
    wr, wp = np.random.default_rng(7).normal(size=(2, C))

    def jf(q):
        r, pr = jmodel.rates_props(q)
        return jnp.sum(r * wr) + jnp.sum(pr * wp), (r, pr)

    (_, (jr, jpr)), jg = jax.jit(jax.value_and_grad(jf, has_aux=True))(
        {k: jnp.asarray(v) for k, v in p.items()})
    leaves = {k: _t(v).requires_grad_(True) for k, v in p.items()}
    r, pr = model.rates_props(leaves)
    assert model.cat_count == C and r.shape == pr.shape == (C,)
    np.testing.assert_allclose(r.detach().numpy(), np.asarray(jr),
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(pr.detach().numpy(), np.asarray(jpr),
                               rtol=1e-10, atol=1e-10)
    grads = torch.autograd.grad(torch.sum(r * _t(wr)) + torch.sum(pr * _t(wp)),
                                list(leaves.values()))
    rtol = GRAD_RTOL.get(case, 1e-10)
    for k, g in zip(leaves, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[k]), rtol=rtol,
                                   atol=1e-12)


def test_laguerre_quadrature_raises_as_in_jax():
    with pytest.raises(ValueError, match="requires gamma"):
        sitemodel.QuantileSiteModel(4, "weibull", quadrature="laguerre", **KW)
    model = sitemodel.QuantileSiteModel(4, quadrature="laguerre", **KW)
    with pytest.raises(NotImplementedError, match="laguerre"):
        model.rates_props(model.param_space().init_params(**KW))


# -- clock models -----------------------------------------------------------


def _small_topos():
    def tip(i):
        return {"name": f"t{i}", "length": 0.1, "children": []}
    nested = {"name": None, "children": [
        {"name": None, "length": 0.2, "children": [
            tip(0), {"name": None, "length": 0.1,
                     "children": [tip(1), tip(2)]}]},
        {"name": None, "length": 0.1, "children": [tip(3), tip(4)]}]}
    return Topology.from_nested(nested)[0], JTopology.from_nested(nested)[0]


def _clock_pair(case):
    topo, jtopo = _small_topos()
    N = topo.N
    if case == "discrete":
        cmap = np.arange(N) % 3
        return (clock.DiscreteClock(N, cmap, "c.", **KW),
                j_clock.DiscreteClock(N, cmap, "c."))
    if case == "local":
        ind = np.zeros(N, bool)
        ind[[1, 6]] = True
        return (clock.LocalClock(topo, ind, "c.", **KW),
                j_clock.LocalClock(jtopo, ind, "c."))
    if case == "relaxed":
        return clock.RelaxedClock(N, "c.", **KW), j_clock.RelaxedClock(N, "c.")
    if case == "ssvs":
        return (clock.SSVSLocalClock(topo, "c.", **KW),
                j_clock.SSVSLocalClock(jtopo, "c."))
    dist, n = case.split("-")
    return (clock.DistributionRelaxedClock(N, dist, "c.", n_cats=int(n),
                                           **KW),
            j_clock.DistributionRelaxedClock(N, dist, "c.", n_cats=int(n)))


CLOCK_CASES = ["discrete", "local", "relaxed", "ssvs", "lognormal-5",
               "exponential-4", "discrete-5", "discrete-6", "discrete-1"]


@pytest.mark.parametrize("case", CLOCK_CASES)
def test_clock_rates_match(case):
    """The gathers exactly; the distribution clock's bins to 4e-15
    relative, a few units in the last place (ndtri and log1p are other
    implementations, and XLA contracts multiply-adds)."""
    model, jmodel = _clock_pair(case)
    p = _site_params(jmodel, np.random.default_rng(8))
    got = model.rates(params_from_numpy(p, **KW)).numpy()
    ref = np.asarray(jmodel.rates({k: jnp.asarray(v) for k, v in p.items()}))
    if case[-1].isdigit():
        np.testing.assert_allclose(got, ref, rtol=4e-15, atol=0)
    else:
        np.testing.assert_array_equal(got, ref)
    if case == "local":
        np.testing.assert_array_equal(model.class_map, jmodel.class_map)


def test_ssvs_rates_from_indicators_match_exactly():
    """Bits [L, N] as one batch against JAX one set of bits at a time."""
    model, jmodel = _clock_pair("ssvs")
    rng = np.random.default_rng(9)
    p = _site_params(jmodel, rng)
    bits = rng.random((6, model.N)) < 0.3
    bits[0] = False
    batch = model.rates_from_indicators(params_from_numpy(p, **KW),
                                        torch.as_tensor(bits))
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    for row, b in zip(batch.numpy(), bits):
        np.testing.assert_array_equal(row, np.asarray(
            jmodel.rates_from_indicators(jp, jnp.asarray(b))))
    np.testing.assert_array_equal(model.chains.numpy(),
                                  j_clock.ancestor_chains(jmodel.topo))


# -- through build_config on fluA --------------------------------------------

GTR = {"id": "sm", "type": "substitutionmodel", "model": "gtr",
       "datatype": "nucleotide",
       "frequencies": {"id": "freqs", "type": "Simplex",
                       "values": [0.34, 0.18, 0.21, 0.27]},
       "rates": {k: {"id": k, "type": "parameter", "value": v, "lower": 0}
                 for k, v in zip(["ac", "ag", "at", "cg", "ct"],
                                 [1.7, 5.2, 0.9, 0.6, 6.1])}}


def flua_variant(data_dir, name):
    """tests/data/jc69-time.json (fluA, its time tree and strict clock) with
    the substitution, site or branch model of ``name``."""
    cfg = load_json(os.path.join(data_dir, "jc69-time.json"))
    cfg.pop("physher")
    m = cfg["model"]
    sm = m["sitemodel"]
    alpha = {"id": "alpha", "type": "parameter", "value": 0.5, "lower": 0}
    pinv = {"id": "pinv", "type": "Simplex", "values": [0.2, 0.8]}
    dist = {"gtr-g4-i": {"distribution": "gamma", "categories": 4,
                         "parameters": alpha, "proportions": pinv},
            "gtr-i": {"distribution": "gamma", "categories": 1,
                      "parameters": alpha, "proportions": pinv},
            "discrete-sites": {"distribution": "discrete", "categories": 3},
            "weibull": {"distribution": "weibull", "categories": 4,
                        "parameters": alpha}}
    if name in dist:
        sm["substitutionmodel"] = copy.deepcopy(GTR)
        sm["distribution"] = dist[name]
    elif name in ("unrest", "nonstat", "01020"):
        sm["substitutionmodel"] = {"id": "sm", "type": "substitutionmodel",
                                   "model": name, "datatype": "nucleotide"}
        if name == "01020":
            sm["substitutionmodel"]["frequencies"] = copy.deepcopy(
                GTR["frequencies"])
    elif name == "relaxed":
        m["branchmodel"] = {"id": "bm", "type": "branchmodel",
                            "model": "relaxed", "tree": "&tree"}
    elif name == "discrete-clock":
        m["branchmodel"] = {"id": "bm", "type": "branchmodel",
                            "model": "discrete", "tree": "&tree",
                            "map": [i % 3 for i in range(137)]}
    elif name == "lognormal-clock":
        m["branchmodel"] = {
            "id": "bm", "type": "branchmodel", "model": "relaxed",
            "distribution": "lognormal", "categories": 8, "tree": "&tree",
            "parameters": {
                "logmean": {"id": "lm", "type": "parameter", "value": -6.5},
                "logsigma": {"id": "ls", "type": "parameter", "value": 0.4,
                             "lower": 0}}}
    else:
        raise ValueError(name)
    return cfg


FLUA_VARIANTS = ["gtr-g4-i", "gtr-i", "discrete-sites", "weibull", "unrest",
                 "nonstat", "01020", "relaxed", "discrete-clock",
                 "lognormal-clock"]


def _built(data_dir, name):
    cfg = flua_variant(data_dir, name)
    jctx, _ = j_build_config(copy.deepcopy(cfg), base_dir=data_dir)
    ctx, _ = build_config(cfg, base_dir=data_dir, **KW)
    assert ctx.param_names == jctx.param_names
    jtlk = jctx.objects["treelikelihood"]
    # the JAX package's plain engine (its Pallas kernel in interpret mode
    # compiles for longer)
    jtlk.engine = "xla"
    return jtlk, ctx.objects["treelikelihood"]


def _moved(jspace, rng, L=None):
    """Points moved from the init point in the unconstrained space by numpy
    noise: one dict, or ``[L, ...]`` arrays for a batch of L."""
    p0 = jspace.init_params()
    u = jspace.flatten_unconstrained(jspace.unconstrain(p0))
    points = []
    for _ in range(1 if L is None else L):
        q = jspace.constrain(jspace.unflatten_unconstrained(
            u + rng.normal(0.0, 0.05, u.shape)))
        points.append({k: np.asarray(v, np.float64) for k, v in q.items()})
    if L is None:
        return points[0]
    return {k: np.stack([q[k] for q in points]) for k in points[0]}


@pytest.mark.parametrize("name", FLUA_VARIANTS)
def test_flua_config_matches_jax(data_dir, name):
    jtlk, tlk = _built(data_dir, name)
    assert tlk.param_space().names == jtlk.param_space().names
    assert tlk.site_model.cat_count == len(jtlk.site_model.rates_props(
        jtlk.site_model.param_space().init_params())[1])
    p = _moved(jtlk.param_space(), np.random.default_rng(10))
    jval, jgrad = jax.jit(jax.value_and_grad(jtlk.log_likelihood))(
        {k: jnp.asarray(v) for k, v in p.items()})
    leaves = {k: v.requires_grad_(True)
              for k, v in params_from_numpy(p, **KW).items()}
    val = tlk.log_likelihood(leaves)
    np.testing.assert_allclose(float(val.detach()), float(jval), rtol=0,
                               atol=1e-8)
    grads = torch.autograd.grad(val, list(leaves.values()))
    for k, g in zip(leaves, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jgrad[k]),
                                   rtol=1e-7, atol=1e-9)


@pytest.mark.parametrize("name", FLUA_VARIANTS)
def test_flua_batch_equals_single_calls(data_dir, name):
    """L = 3 parameter dicts as one batch (the plain engine's chain axis)
    against three single calls."""
    cfg = flua_variant(data_dir, name)
    ctx, _ = build_config(cfg, base_dir=data_dir, **KW)
    tlk = ctx.objects["treelikelihood"]
    space = tlk.param_space()
    rng = np.random.default_rng(11)
    start = space.init_params(**KW)
    u = space.flatten_unconstrained(space.unconstrain(start))
    flat = u + torch.as_tensor(rng.normal(0.0, 0.05, (3,) + u.shape), **KW)
    batch = space.constrain(space.unflatten_unconstrained(flat))
    with torch.no_grad():
        got = tlk.log_likelihood(batch)
        assert got.shape == (3,)
        for i in range(3):
            one = tlk.log_likelihood({k: v[i] for k, v in batch.items()})
            np.testing.assert_allclose(float(got[i]), float(one), rtol=1e-12,
                                       atol=0)


def _model_batch_cases():
    cases = [("site", c) for c in sorted(SITE_CASES)]
    cases += [("clock", c) for c in CLOCK_CASES]
    cases += [("subst", c) for c in ("unrest", "nonstat", "gensubst")]
    return cases


@pytest.mark.parametrize("kind,case", _model_batch_cases())
def test_model_batch_equals_single_calls(kind, case):
    """Every new model on parameters [3, ...]: rates and proportions [3, C],
    branch rates [3, N], Q [3, S, S] and P(t) [3, N, C, S, S], each equal to
    three single calls."""
    rng = np.random.default_rng(12)
    if kind == "site":
        model, jmodel = _site_pair(case)

        def f(q):
            return model.rates_props(q)
    elif kind == "clock":
        model, jmodel = _clock_pair(case)

        def f(q):
            return (model.rates(q),)
    else:
        model, jmodel = _subst_pair(case)
        t3 = _t(rng.uniform(0.0, 1.0, (3, 5, 2)))

        def f(q, i=None):
            t = t3 if i is None else t3[i]
            return model.q(q), model.frequencies(q), model.p_t(q, t)
    p = _site_params(jmodel, rng, L=3)
    with torch.no_grad():
        batch = f(params_from_numpy(p, **KW))
        for i in range(3):
            q = params_from_numpy({k: v[i] for k, v in p.items()}, **KW)
            one = f(q, i) if kind == "subst" else f(q)
            for b, o in zip(batch, one):
                assert b.shape[0] == 3
                np.testing.assert_allclose(b[i].numpy(),
                                           o.expand_as(b[i]).numpy(),
                                           rtol=1e-12, atol=1e-15)


def test_non_finite_generators_give_nan():
    """A line search's trial point far out can make Q non-finite or UNREST's
    system singular: the port gives NaN there, as the JAX package's eigh,
    solve and lstsq do, where torch's eigh and solve raise."""
    Q = torch.full((2, 4, 4), float("nan"), **KW)
    pi = torch.full((2, 4), 0.25, **KW)
    assert torch.isnan(substitution.p_t_reversible(
        Q, pi, torch.ones(2, 3, **KW))).all()
    assert torch.isnan(substitution.expm_pade(Q)).all()
    unrest = substitution.UNREST(**KW)
    assert not torch.isfinite(unrest.frequencies(
        {"rates": torch.zeros(12, **KW)})).any()
