"""The Interface API of the port (physher_tpu_torch/api.py) held against the
JAX package's (physher_tpu/api.py) on the CPU in float64: every case of
tests/test_api.py through both packages, the log-likelihood and
Gradient() of the tree likelihood at 1e-10 relative (the same arithmetic
in another order), checkpoint A at 1e-8, the height transform's JVP and
log-Jacobian gradient at 1e-10, and no card: no quiet CPU run.
"""

import json
import os

import jax  # noqa: F401  (conftest sets float64 and the CPU)
import numpy as np
import pytest
import torch

from physher_tpu import api as japi
from physher_tpu.io.seqio import read_alignment
from physher_tpu_torch import api as tapi

DATA = os.path.join(os.path.dirname(__file__), "data")
CPU = dict(device="cpu")
NEWICK = "((a:0.1,b:0.2):0.05,(c:0.3,d:0.1):0.05);"
GOLDEN_LOGP, GOLDEN_RATE_GRAD = -4777.616349713985, 328017.6732813406


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the models here run many ops on small tensors,
    which gain nothing from more threads, and beside other test processes
    on the same cores each op's thread barrier stalls."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _toy_alignment():
    return {"a": "ACGTACGTAC", "b": "ACGTACCTAA",
            "c": "AGGTACGTAT", "d": "ACGAACGTAA"}


def _both(make):
    """``make(api, kw)`` for the JAX package and the port (on the CPU)."""
    return make(japi, {}), make(tapi, CPU)


def _close(a, b, rtol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    np.testing.assert_allclose(b, a, rtol=0,
                               atol=rtol * max(np.abs(a).max(), 1e-300))


@pytest.fixture(scope="module")
def flua():
    cfg = json.load(open(os.path.join(DATA, "jc69-time.json")))
    aln = read_alignment(os.path.join(DATA, "fluA.fa"))

    def make(api, kw):
        tm = api.ReparameterizedTimeTreeModelInterface(
            cfg["model"]["tree"]["newick"],
            dates=cfg["model"]["tree"]["dates"], **kw)
        clock = api.StrictClockModelInterface(0.001, tm)
        tlk = api.TreeLikelihoodInterface(
            aln, tm, api.JC69Interface(), api.ConstantSiteModelInterface(),
            clock, use_tip_states=True, **kw)
        return tm, clock, tlk

    return _both(make)


# -- the cases of tests/test_api.py, through both packages ------------------

def test_jc69_loglik_and_gradient():
    def make(api, kw):
        tm = api.UnRootedTreeModelInterface(NEWICK, **kw)
        tlk = api.TreeLikelihoodInterface(
            _toy_alignment(), tm, api.JC69Interface(),
            api.ConstantSiteModelInterface(), **kw)
        ll = tlk.LogLikelihood()
        tlk.RequestGradient()
        g = tlk.Gradient()
        eps = 1e-6
        d = tm._values["distances"].copy()
        d2 = d.copy()
        d2[0] += eps
        tm.SetParameters(d2)
        up = tlk.LogLikelihood()
        tm.SetParameters(d)
        return ll, g, (up - ll) / eps, tlk.LogLikelihood()

    (jll, jg, jfd, _), (ll, g, fd, back) = _both(make)
    assert np.isfinite(ll) and ll < 0 and g.size >= 6  # N - 1 branches
    np.testing.assert_allclose(g[0], fd, rtol=1e-3)
    assert back == ll
    _close(jll, ll, 1e-12)
    _close(jg, g, 1e-10)


def test_hky_set_parameters_changes_loglik():
    def make(api, kw):
        tm = api.UnRootedTreeModelInterface(NEWICK, **kw)
        sub = api.HKYInterface(kappa=2.0)
        tlk = api.TreeLikelihoodInterface(
            _toy_alignment(), tm, sub, api.ConstantSiteModelInterface(), **kw)
        l1 = tlk.LogLikelihood()
        sub.SetParameters(np.r_[8.0, 0.25, 0.25, 0.25, 0.25])
        return l1, tlk.LogLikelihood(), sub.GetParameters()

    (jl1, jl2, jp), (l1, l2, p) = _both(make)
    assert l1 != l2
    _close([jl1, jl2], [l1, l2], 1e-12)
    np.testing.assert_array_equal(jp, p)


@pytest.mark.parametrize("site", ["gamma", "weibull_invariant", "invariant"])
def test_gtr_site_models(site):
    def make(api, kw):
        tm = api.UnRootedTreeModelInterface(NEWICK, **kw)
        sm = {"gamma": lambda: api.GammaSiteModelInterface(0.5, 4),
              "weibull_invariant": lambda: api.WeibullSiteModelInterface(
                  0.7, 3, invariant=0.2),
              "invariant": lambda: api.InvariantSiteModelInterface(0.3)}[
            site]()
        tlk = api.TreeLikelihoodInterface(
            _toy_alignment(), tm, api.GTRInterface(), sm, **kw)
        return tlk.LogLikelihood(), tlk.Gradient()

    (jll, jg), (ll, g) = _both(make)
    assert np.isfinite(ll) and np.isfinite(g).all()
    _close(jll, ll, 1e-12)
    _close(jg, g, 1e-10)


def test_flua_golden(flua):
    """Checkpoint A through the Interface API (test_tree_likelihood.c:29),
    and the JAX api's logP and Gradient() at 1e-10."""
    (_, _, jtlk), (_, _, tlk) = flua
    ll = tlk.LogLikelihood()
    np.testing.assert_allclose(ll, GOLDEN_LOGP, rtol=1e-8)
    _close(jtlk.LogLikelihood(), ll, 1e-10)
    g = tlk.Gradient()
    jg = jtlk.Gradient()
    _close(jg, g, 1e-10)
    # the gradient's order is the parameters' names: bm rate first
    np.testing.assert_allclose(g[0], GOLDEN_RATE_GRAD, rtol=1e-8)


def test_flua_set_parameters_and_flags(flua):
    """New ratios and rate through SetParameters move both packages alike;
    the flag filter keeps the blocks JAX's does."""
    (jtm, jclock, jtlk), (tm, clock, tlk) = flua
    F = (japi.TreeLikelihoodGradientFlags,
         tapi.TreeLikelihoodGradientFlags)
    r0 = tm.GetParameters()
    r = r0 * np.linspace(0.97, 1.0, r0.size)
    try:
        for m, c in ((jtm, jclock), (tm, clock)):
            m.SetParameters(r)
            c.SetParameters([1.3e-3])
        _close(jtlk.LogLikelihood(), tlk.LogLikelihood(), 1e-10)
        for names in (["TREE_HEIGHT"], ["BRANCH_MODEL"]):
            jtlk.RequestGradient([getattr(F[0], n) for n in names])
            tlk.RequestGradient([getattr(F[1], n) for n in names])
            buf = np.zeros(tm.topo.I + 1)
            g = tlk.Gradient(buf)
            _close(jtlk.Gradient(), g, 1e-10)
            np.testing.assert_array_equal(buf[: g.size], g)
    finally:
        for m, c in ((jtm, jclock), (tm, clock)):
            m.SetParameters(r0)
            c.SetParameters([1e-3])
        jtlk.RequestGradient()
        tlk.RequestGradient()


def test_height_transform_jvp(flua):
    (jtm, _, _), (tm, _, _) = flua
    h = tm.GetNodeHeights()
    assert h.shape == (tm.topo.N,)
    _close(jtm.GetNodeHeights(), h, 1e-12)
    hg = np.random.default_rng(0).normal(size=tm.topo.I)
    rg = tm.GradientTransformJVP(hg)
    assert rg.shape == (tm.topo.I,) and np.isfinite(rg).all()
    _close(jtm.GradientTransformJVP(hg), rg, 1e-10)
    jac = tm.GradientTransformJacobian()
    assert np.isfinite(jac).all()
    _close(jtm.GradientTransformJacobian(), jac, 1e-10)


def _coal_tm(api, kw):
    return api.TimeTreeModelInterface(
        "((a:1.0,b:1.0):1.0,(c:1.5,d:1.5):0.5);",
        dates={"a": 0, "b": 0, "c": 0, "d": 0}, **kw)


@pytest.mark.parametrize("name,args", [
    ("ConstantCoalescentModelInterface", (2.0,)),
    ("PiecewiseConstantCoalescentInterface", ([1.0, 2.0, 3.0],)),
    ("PiecewiseConstantCoalescentGridInterface", ([1.0, 2.0, 3.0], 1.8)),
    ("PiecewiseLinearCoalescentGridInterface", ([1.0, 2.0, 3.0], 1.8)),
    ("CTMCScaleModelInterface", ([0.001],)),
])
def test_coalescent_and_ctmc_scale(name, args):
    def make(api, kw):
        tm = _coal_tm(api, kw)
        c = getattr(api, name)(args[0], tm, *args[1:])
        return c.LogLikelihood(), c.Gradient()

    (jll, jg), (ll, g) = _both(make)
    assert np.isfinite(ll) and np.isfinite(g).all()
    _close(jll, ll, 1e-12)
    _close(jg, g, 1e-10)


def test_no_card_raises():
    """Without a CUDA device and device='cpu' the API raises; it never
    carries on quietly on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    tm = tapi.UnRootedTreeModelInterface(NEWICK)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapi.TreeLikelihoodInterface(_toy_alignment(), tm,
                                     tapi.JC69Interface(),
                                     tapi.ConstantSiteModelInterface())
    coal = tapi.ConstantCoalescentModelInterface(2.0, _coal_tm(tapi, {}))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        coal.LogLikelihood()
