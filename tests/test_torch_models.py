"""The port's models against the JAX package, in float64.

P(t) and its gradient for JC69 and GTR (random, and degenerate with equal
rates and frequencies, where eigh's own gradient is NaN), the median-Gamma
rates and their alpha-derivative (float64 Newton inverse and the float32
table), and the height transforms with their gradients. Inputs come from a
numpy seed and go to both packages as numpy arrays.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physher_tpu.io.treeio import read_newick as j_read_newick
from physher_tpu.models import sitemodel as j_sitemodel
from physher_tpu.models import substitution as j_subst
from physher_tpu.trees import heights as j_heights
from physher_tpu.trees.timetree import TimeTreeData as JTimeTreeData
from physher_tpu.utils import special as j_special
from physher_tpu_torch.io.treeio import read_newick
from physher_tpu_torch.models import sitemodel, substitution
from physher_tpu_torch.models.parameters import params_from_numpy
from physher_tpu_torch.trees import heights
from physher_tpu_torch.trees.timetree import TimeTreeData
from physher_tpu_torch.utils import special

F64 = dict(dtype=torch.float64, device="cpu")


def _torch_grad(fn, params):
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    out = fn(leaves)
    out.backward()
    return float(out.detach()), {k: v.grad.numpy() for k, v in leaves.items()}


def _pt_case(model, seed, degenerate):
    rng = np.random.default_rng(seed)
    t = rng.uniform(0.0, 0.8, (7, 4))
    t[0, 0] = 0.0                        # a zero-length branch
    W = rng.normal(size=(7, 4, 4, 4))
    p = {"t": t}
    if model == "gtr":
        rates = np.ones(6) if degenerate else rng.uniform(0.3, 4.0, 6)
        freqs = np.full(4, 0.25) if degenerate else rng.dirichlet(np.ones(4) * 5)
        p.update({"rates": rates, "frequencies": freqs})
    return p, W


@pytest.mark.parametrize("model,degenerate", [
    ("jc69", False), ("gtr", False), ("gtr", True)])
def test_p_t_and_gradient(model, degenerate):
    p_np, W = _pt_case(model, 11, degenerate)
    if model == "jc69":
        jm, tm = j_subst.JC69(), substitution.JC69(**F64)
    else:
        jm, tm = j_subst.GTR(), substitution.GTR(**F64)

    def j_loss(p):
        return jnp.sum(jnp.asarray(W) * jm.p_t(p, p["t"]))

    def t_loss(p):
        return torch.sum(torch.as_tensor(W) * tm.p_t(p, p["t"]))

    jp = {k: jnp.asarray(v) for k, v in p_np.items()}
    j_val, j_g = jax.value_and_grad(j_loss)(jp)
    t_val, t_g = _torch_grad(t_loss, params_from_numpy(p_np, **F64))
    np.testing.assert_allclose(
        tm.p_t(params_from_numpy(p_np, **F64),
               torch.as_tensor(p_np["t"])).numpy(),
        np.asarray(jm.p_t(jp, jp["t"])), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(t_val, float(j_val), rtol=1e-10)
    for k in p_np:
        assert np.isfinite(t_g[k]).all(), k
        np.testing.assert_allclose(t_g[k], np.asarray(j_g[k]), rtol=1e-10,
                                   atol=1e-10, err_msg=k)


@pytest.mark.parametrize("alpha", [0.1, 0.5, 2.0])
def test_median_gamma_newton(alpha):
    jm = j_sitemodel.GammaSiteModel(4)
    tm = sitemodel.GammaSiteModel(4, **F64)
    w = np.array([0.3, -1.2, 0.7, 2.0])

    def j_loss(a):
        rates, _ = jm.rates_props({"shape": a})
        return jnp.sum(jnp.asarray(w) * rates)

    def t_loss(p):
        rates, _ = tm.rates_props({"shape": p["shape"]})
        return torch.sum(torch.as_tensor(w) * rates)

    j_rates, j_props = jm.rates_props({"shape": jnp.float64(alpha)})
    t_rates, t_props = tm.rates_props(
        {"shape": torch.tensor(alpha, dtype=torch.float64)})
    np.testing.assert_allclose(t_rates.numpy(), np.asarray(j_rates),
                               rtol=1e-8)
    np.testing.assert_allclose(t_props.numpy(), np.asarray(j_props))
    _, t_g = _torch_grad(t_loss, {"shape": torch.tensor(alpha,
                                                        dtype=torch.float64)})
    j_g = jax.grad(j_loss)(jnp.float64(alpha))
    np.testing.assert_allclose(t_g["shape"], float(j_g), rtol=1e-8)


@pytest.mark.parametrize("alpha", [0.1, 0.5, 2.0])
def test_qgamma_table(alpha):
    """float32 table path against the JAX table; the float64 evaluation of
    the same interpolant agrees to rounding. The alpha-derivative divides
    table differences by the grid step (8.4e-4 in log alpha), which
    amplifies float32 rounding of the log-quantiles (1e-7) about a
    thousandfold: hence its float32 tolerance of 2e-3 of the largest
    derivative."""
    static_p = (0.125, 0.375, 0.625, 0.875)
    ref = np.asarray(j_special.qgamma_fixed_p(static_p, jnp.float64(alpha)))
    j_d = np.asarray(jax.jacfwd(lambda a: j_special.qgamma_fixed_p(
        static_p, a))(jnp.float64(alpha)))
    for dtype, rtol, grad_rtol in ((torch.float64, 1e-12, 1e-10),
                                   (torch.float32, 1e-6, 2e-3)):
        a = torch.tensor(alpha, dtype=dtype, requires_grad=True)
        q = special.qgamma_fixed_p(static_p, a)
        np.testing.assert_allclose(q.detach().double().numpy(), ref,
                                   rtol=rtol)
        d = [torch.autograd.grad(q[i], a, retain_graph=True)[0].item()
             for i in range(len(static_p))]
        np.testing.assert_allclose(d, j_d, rtol=grad_rtol,
                                   atol=grad_rtol * np.abs(j_d).max())


@pytest.fixture(scope="module")
def time_tree(data_dir):
    with open(os.path.join(data_dir, "jc69-time.json")) as fh:
        tree_cfg = json.load(fh)["model"]["tree"]
    topo, dist = read_newick(tree_cfg["newick"])
    jtopo, jdist = j_read_newick(tree_cfg["newick"])
    return (topo, TimeTreeData.from_dated_tree(topo, dist, tree_cfg["dates"]),
            jtopo, JTimeTreeData.from_dated_tree(jtopo, jdist,
                                                 tree_cfg["dates"]))


@pytest.mark.parametrize("closed_form", [True, False])
def test_heights_from_ratios(time_tree, monkeypatch, closed_form):
    """The closed form and the level sweep (used past _MATRIX_MAX_I
    internal nodes) against the JAX closed form."""
    if not closed_form:
        monkeypatch.setattr(heights, "_MATRIX_MAX_I", 0)
    topo, td, jtopo, jtd = time_tree
    rng = np.random.default_rng(5)
    W = rng.normal(size=topo.N)
    ratios = np.asarray(td.ratios0, dtype=np.float64)

    def j_fn(r):
        h = j_heights.heights_from_ratios(r, jtopo, jtd.tip_heights,
                                          jtd.lowers)
        d = j_heights.branch_durations(h, jtopo)
        return (jnp.sum(jnp.asarray(W) * (h + d))
                + j_heights.ratio_log_jacobian(h, jtopo, jtd.lowers))

    def t_fn(p):
        h = heights.heights_from_ratios(p["r"], topo, td.tip_heights,
                                        td.lowers)
        d = heights.branch_durations(h, topo)
        return (torch.sum(torch.as_tensor(W) * (h + d))
                + heights.ratio_log_jacobian(h, topo, td.lowers))

    h = heights.heights_from_ratios(torch.as_tensor(ratios), topo,
                                    td.tip_heights, td.lowers)
    np.testing.assert_allclose(h.numpy(), td.node_heights0, rtol=1e-12)
    j_val, j_g = jax.value_and_grad(j_fn)(jnp.asarray(ratios))
    t_val, t_g = _torch_grad(t_fn, {"r": torch.as_tensor(ratios)})
    np.testing.assert_allclose(t_val, float(j_val), rtol=1e-12)
    np.testing.assert_allclose(t_g["r"], np.asarray(j_g), rtol=1e-10,
                               atol=1e-10)


@pytest.mark.parametrize("closed_form", [True, False])
def test_heights_from_shifts(time_tree, monkeypatch, closed_form):
    if not closed_form:
        monkeypatch.setattr(heights, "_MATRIX_MAX_I", 0)
    topo, td, jtopo, jtd = time_tree
    shifts = heights.shifts_from_heights(td.node_heights0, topo)
    W = np.random.default_rng(6).normal(size=topo.N)

    def j_fn(s):
        h = j_heights.heights_from_shifts(s, jtopo, jtd.tip_heights)
        return jnp.sum(jnp.asarray(W) * h)

    def t_fn(p):
        h = heights.heights_from_shifts(p["s"], topo, td.tip_heights)
        return torch.sum(torch.as_tensor(W) * h)

    j_val, j_g = jax.value_and_grad(j_fn)(jnp.asarray(shifts))
    t_val, t_g = _torch_grad(t_fn, {"s": torch.as_tensor(shifts)})
    np.testing.assert_allclose(t_val, float(j_val), rtol=1e-12)
    np.testing.assert_allclose(t_g["s"], np.asarray(j_g), rtol=1e-12,
                               atol=1e-12)


def test_param_space_transforms():
    """Every transform: constrain(unconstrain(x)) and the log-Jacobian,
    value and gradient, against the JAX ParamSpace."""
    from physher_tpu.models.parameters import (
        ParamSpace as JParamSpace, ParamSpec as JParamSpec)
    from physher_tpu_torch.models.parameters import ParamSpace, ParamSpec

    def specs(mod):
        return [mod.vector("v", [0.2, 1.5], lower=0.0),              # log
                mod.scalar("s", 3.0, lower=1.0),                     # shifted
                mod.vector("r", [0.1, 0.7, 0.4], lower=0.0, upper=1.0),
                mod.simplex("f", [0.1, 0.2, 0.3, 0.4]),
                mod.scalar("n", -0.3),                               # none
                mod.fixed("x", [2.0])]

    space, jspace = ParamSpace(specs(ParamSpec)), JParamSpace(specs(JParamSpec))
    assert [s.transform for s in space.specs] == \
        [s.transform for s in jspace.specs]
    params = space.init_params(**F64)
    u = space.unconstrain(params)
    ju = jspace.unconstrain(jspace.init_params())
    for k in ju:
        np.testing.assert_allclose(u[k].numpy(), np.asarray(ju[k]),
                                   rtol=1e-13, atol=1e-15)
    back = space.constrain(u)
    for k, v in params.items():
        np.testing.assert_allclose(back[k].numpy(), v.numpy(), rtol=1e-13)

    def t_fn(p):
        c = space.constrain(p)
        return space.log_jacobian(p) + sum(torch.sum(v * (i + 1))
                                           for i, v in enumerate(c.values()))

    def j_fn(p):
        c = jspace.constrain(p)
        return jspace.log_jacobian(p) + sum(jnp.sum(v * (i + 1))
                                            for i, v in enumerate(c.values()))

    t_val, t_g = _torch_grad(t_fn, u)
    j_val, j_g = jax.value_and_grad(j_fn)(ju)
    np.testing.assert_allclose(t_val, float(j_val), rtol=1e-13)
    for k in ju:
        np.testing.assert_allclose(t_g[k], np.asarray(j_g[k]), rtol=1e-12,
                                   atol=1e-14, err_msg=k)


@pytest.mark.parametrize("model", ["jc69", "gtr", "hky"])
def test_dp_dt_matches_jax(model):
    """dP/dt: JC69's closed form, and P(t) Q for GTR and HKY, against the
    JAX package's at the same numpy parameters (float64, 1e-12)."""
    p_np, _ = _pt_case("gtr" if model == "gtr" else "jc69", 12, False)
    if model == "hky":
        rng = np.random.default_rng(13)
        p_np.update(kappa=np.asarray(2.7),
                    frequencies=rng.dirichlet(np.ones(4) * 5))
    jm = {"jc69": j_subst.JC69, "gtr": j_subst.GTR, "hky": j_subst.HKY}[
        model]()
    tm = {"jc69": substitution.JC69, "gtr": substitution.GTR,
          "hky": substitution.HKY}[model](**F64)
    p = params_from_numpy(p_np, **F64)
    got = tm.dp_dt(p, p["t"])
    want = np.asarray(jm.dp_dt({k: jnp.asarray(v) for k, v in p_np.items()},
                               jnp.asarray(p_np["t"])))
    assert got.shape == (7, 4, 4, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    if model == "jc69":   # the closed form is the general P(t) Q
        np.testing.assert_allclose(
            got.numpy(),
            substitution.SubstitutionModel.dp_dt(tm, p, p["t"]).numpy(),
            rtol=1e-12, atol=1e-12)


def test_param_space_merge():
    """merge: the specs in order, a shared spec kept once, a conflicting
    duplicate refused, as in the JAX ParamSpace."""
    from physher_tpu.models.parameters import (
        ParamSpace as JParamSpace, ParamSpec as JParamSpec)
    from physher_tpu_torch.models.parameters import ParamSpace, ParamSpec

    def spaces(mod, space):
        shared = mod.simplex("f", [0.1, 0.2, 0.3, 0.4])
        return (space([mod.scalar("a", 2.0, lower=0.0), shared]),
                space([shared, mod.vector("b", [0.3, 0.6], lower=0.0,
                                          upper=1.0)]),
                space([mod.fixed("c", [1.5])]),
                space([mod.scalar("a", 3.0, lower=0.0)]))

    a, b, c, bad = spaces(ParamSpec, ParamSpace)
    ja, jb, jc, jbad = spaces(JParamSpec, JParamSpace)
    merged, jmerged = a.merge(b, c), ja.merge(jb, jc)
    assert merged.names == jmerged.names == ["a", "f", "b", "c"]
    assert merged.unconstrained_slices() == jmerged.unconstrained_slices()
    for s, js in zip(merged.specs, jmerged.specs):
        np.testing.assert_array_equal(s.init, js.init)
        assert (s.lower, s.upper, s.transform) == (js.lower, js.upper,
                                                   js.transform)
    params = merged.init_params(**F64)
    jparams = jmerged.init_params()
    u, ju = merged.unconstrain(params), jmerged.unconstrain(jparams)
    np.testing.assert_allclose(
        float(merged.log_jacobian(u)), float(jmerged.log_jacobian(ju)),
        rtol=1e-12)
    assert a.merge().names == ["a", "f"]
    for space, other in ((a, bad), (ja, jbad)):
        with pytest.raises(ValueError):
            space.merge(other)
