"""The port's ML estimator, Hessian, Laplace estimates and CSV checkpoints on
the CPU, held against the JAX package (float64, tiny.fa models and toy
targets; inputs from seeded numpy).

Tolerances: the analytic posterior mean at 1e-6 (L-BFGS, meta) and 5e-3
(Adam), as tests/test_inference.py; Brent's x and f(x) at 1e-12 (the same
scalar algorithm in both packages); the Brent pass at 1e-8 (the models
agree to about 1e-12, so Brent's comparisons of nearly equal values may
fall the other way near the optimum); optima reached by different line
searches or starts at 1e-6 to 1e-3 nats; the Hessian, a central difference
of the exact gradient, at 1e-6 of max|H| against JAX's exact one; the
Laplace estimates at the tolerances of tests/test_inference.py and
tests/test_laplace_fits.py; checkpoints bit for bit (%.17g).
"""

import io
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.optimize
import scipy.stats as st
import torch
from scipy.special import betaln, gammaln

from physher_tpu.config.actions import Runner as JRunner
from physher_tpu.config.builder import build_config as j_build_config
from physher_tpu.inference import ml as jml
from physher_tpu.models.treelikelihood import engine_override
from physher_tpu_torch import cli
from physher_tpu_torch.config.actions import Runner
from physher_tpu_torch.config.builder import Context, build_config
from physher_tpu_torch.inference import marginal, ml
from physher_tpu_torch.models.distributions import normal_logpdf
from physher_tpu_torch.models.parameters import (
    ParamSpace, ParamSpec, batch_shape)

KW = dict(dtype=torch.float64, device="cpu")
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "data", "goldens")

# conjugate normal model: y_i ~ N(theta, s2), theta ~ N(0, t2)
Y = np.array([0.3, 1.2, -0.4, 0.8, 1.9, 0.1, 0.7, 1.1])
S2, T2 = 1.0, 4.0
SPACE = ParamSpace([ParamSpec.scalar("theta", 0.0)])


def log_post(params):
    """logP of theta, or of each theta of a batch ``[L]``."""
    theta = params["theta"]
    y = torch.as_tensor(Y, dtype=theta.dtype)
    like = normal_logpdf(y, theta[..., None], math.sqrt(S2)).sum(-1)
    return like + normal_logpdf(theta, 0.0, math.sqrt(T2))


def posterior_mean():
    prec = len(Y) / S2 + 1 / T2
    return (Y.sum() / S2) / prec


def analytic_log_marginal():
    n = len(Y)
    cov = S2 * np.eye(n) + T2 * np.ones((n, n))
    return st.multivariate_normal.logpdf(Y, np.zeros(n), cov)


def golden_config(case, data_dir, physher=None):
    with open(os.path.join(GOLDEN_DIR, f"{case}.json")) as fh:
        cfg = json.load(fh)
    aln = cfg["model"]["sitepattern"]["alignment"]
    aln["file"] = os.path.join(data_dir, os.path.basename(aln["file"]))
    if physher is not None:
        cfg["physher"] = physher
    return cfg


def both_models(case, data_dir):
    """(JAX tree likelihood, port tree likelihood) of a tiny.fa golden."""
    cfg = golden_config(case, data_dir)
    jctx, _ = j_build_config(json.loads(json.dumps(cfg)), base_dir=data_dir)
    ctx, _ = build_config(cfg, base_dir=data_dir, **KW)
    return jctx.objects["treelikelihood"], ctx.objects["treelikelihood"]


def as_np(params):
    return {k: np.asarray(v.detach() if torch.is_tensor(v) else v,
                          np.float64) for k, v in params.items()}


def to_torch(params):
    return {k: torch.tensor(np.asarray(v, np.float64), **KW)
            for k, v in params.items()}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the optimizers' loops run thousands of ops on
    tensors of a few hundred entries, which gain nothing from more threads,
    and beside other test processes on the same cores each op's thread
    barrier stalls."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the optimizers -----------------------------------------------------------


@pytest.mark.parametrize("method, atol", [("lbfgs", 1e-6), ("meta", 1e-6),
                                          ("adam", 5e-3)])
def test_conjugate_optimum(method, atol):
    """test_ml_conjugate and test_adam_and_meta of tests/test_inference.py:
    the analytic posterior mean."""
    kw = dict(learning_rate=0.1, max_iter=2000) if method == "adam" else {}
    res = ml.optimize(log_post, SPACE, SPACE.init_params(**KW),
                      method=method, **kw)
    np.testing.assert_allclose(float(res.params["theta"]), posterior_mean(),
                               atol=atol)


def test_lbfgs_backs_off_from_non_finite_points():
    """A line search that extrapolates into a region where the model is NaN
    (as a time tree's trial root height at exp(700) makes it): L-BFGS backs
    off from those points and reaches the optimum, as the JAX package's zoom
    search does; torch's own search would step on past a NaN."""
    space = ParamSpace([ParamSpec.scalar("x", 0.0)])
    seen = []

    def log_prob(p):
        x = p["x"]
        seen.append(float(x.detach()))
        val = -torch.sqrt(1.0 + (x - 30.0) ** 2)
        return torch.where(x < 40.0, val, torch.full_like(val, np.nan))

    res = ml.optimize_lbfgs(log_prob, space, space.init_params(**KW))
    assert max(seen) >= 40.0
    np.testing.assert_allclose(float(res.params["x"]), 30.0, atol=1e-4)
    assert np.isfinite(res.logp)


BRENT_CASES = [
    (lambda x: (x - 1.3) ** 2 + 0.5, -4.0, 6.0),
    (lambda x: math.cos(x) + 0.1 * x, 2.0, 5.0),
    (lambda x: abs(x - 0.2) + x ** 4 - 3.0 * x ** 3, -1.0, 4.0),
]


@pytest.mark.parametrize("case", range(len(BRENT_CASES)))
def test_brent_matches_jax(case):
    f, lo, hi = BRENT_CASES[case]
    x, fx = ml.brent_minimize(f, lo, hi)
    jx, jfx = jml.brent_minimize(f, lo, hi)
    np.testing.assert_allclose(x, jx, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(fx, jfx, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("case, name", [("hky2", "sm.kappa"),
                                        ("gtrg4", "sitemodel.shape")])
def test_brent_scalar_pass_matches_jax(case, name, data_dir):
    """One Brent pass over the scalars (kappa; the gamma shape) from a start
    moved off the golden's values."""
    jt, tt = both_models(case, data_dir)
    p0 = as_np(jt.param_space().init_params())
    p0[name] = np.asarray(float(p0[name]) * 3.0)
    jout = jml._brent_scalar_pass(jt.log_likelihood, jt.param_space(),
                                  {k: jnp.asarray(v) for k, v in p0.items()},
                                  1e-6)
    out = ml._brent_scalar_pass(tt.log_likelihood, tt.param_space(),
                                to_torch(p0), 1e-6)
    assert abs(float(out[name]) - float(p0[name])) > 0.1
    for k, v in as_np(jout).items():
        np.testing.assert_allclose(out[k].numpy(), v, rtol=1e-8)


def test_adam_adapt_matches_jax(data_dir, monkeypatch):
    """The batched trials over the etas pick JAX's eta; the Adam run at it
    reaches JAX's logP."""
    jt, tt = both_models("hky2", data_dir)
    picked = {}

    def spy(mod, key):
        inner = mod.optimize_adam

        def adam(*a, learning_rate, **kw):
            picked[key] = learning_rate
            return inner(*a, learning_rate=learning_rate, **kw)
        monkeypatch.setattr(mod, "optimize_adam", adam)

    spy(jml, "jax")
    spy(ml, "port")
    calls = []
    log_prob = counting(tt.log_likelihood, calls)
    kw = dict(trial_iter=30, max_iter=100, tol=1e-8)
    jres = jml.optimize_adam_adapt(jt.log_likelihood, jt.param_space(),
                                   jt.param_space().init_params(), **kw)
    res = ml.optimize_adam_adapt(log_prob, tt.param_space(),
                                 tt.param_space().init_params(**KW), **kw)
    assert picked["port"] == picked["jax"]
    # 30 trial steps and the final values, each one call at L = 4
    assert calls[:31] == [(4,)] * 31
    np.testing.assert_allclose(res.logp, jres.logp, rtol=0, atol=1e-6)


def counting(log_prob, calls):
    """``log_prob`` that records the batch shape of each call."""
    def wrapped(p):
        calls.append(batch_shape(p))
        return log_prob(p)
    return wrapped


def test_multistart_warmup(data_dir):
    """One batched call a step at L = n_starts; the best start is no worse
    than the start alone; meta with six starts from a poor kappa reaches
    JAX's optimum (its L-BFGS run to 1e-10)."""
    jt, tt = both_models("hky2", data_dir)
    space = tt.param_space()
    p0 = space.init_params(**KW)
    p0["sm.kappa"] = torch.tensor(0.2, **KW)
    calls = []
    best = ml._multistart_warmup(counting(tt.log_likelihood, calls), space,
                                 p0, n_starts=6, iters=50)
    assert calls == [(6,)] * 51
    single = ml._multistart_warmup(tt.log_likelihood, space, p0,
                                   n_starts=1, iters=50)
    with torch.no_grad():
        assert float(tt.log_likelihood(best)) >= \
            float(tt.log_likelihood(single)) - 1e-9
    res = ml.optimize(tt.log_likelihood, space, p0, method="meta",
                      n_starts=6, tol=1e-5)
    np.testing.assert_allclose(res.logp, jax_optimum(jt), rtol=0, atol=1e-4)


def jax_optimum(jt) -> float:
    """The maximum of the JAX model's logP: BFGS (scipy) to a gradient of
    1e-9 on its jitted value and gradient in the unconstrained space."""
    js = jt.param_space()
    u0 = js.flatten_unconstrained(js.unconstrain(js.init_params()))
    vg = jax.jit(jax.value_and_grad(lambda z: -jt.log_likelihood(
        js.constrain(js.unflatten_unconstrained(z)))))
    r = scipy.optimize.minimize(
        lambda z: tuple(np.asarray(a, np.float64)
                        for a in vg(jnp.asarray(z))),
        np.asarray(u0), jac=True, method="BFGS", options=dict(gtol=1e-9))
    return -float(r.fun)


# -- the Runner ---------------------------------------------------------------


def test_runner_meta_serial_matches_jax(data_dir):
    """jc69nj.json's own action list (meta + serial): the schedule scopes
    the fit to the distances, and both Runners print the same maximum."""
    cfg = golden_config("jc69nj", data_dir)
    jctx, jactions = j_build_config(json.loads(json.dumps(cfg)),
                                    base_dir=data_dir)
    ctx, actions = build_config(cfg, base_dir=data_dir, **KW)
    out, jout = io.StringIO(), io.StringIO()
    runner = Runner(ctx, out=out)
    assert runner._schedule_scope(actions[0]) == ["tree.distances"]
    runner.run(actions)
    JRunner(jctx, out=jout).run(jactions)

    def maximum(text):
        line = text.getvalue().splitlines()[0]
        assert line.startswith("Maximum log likelihood: ")
        return float(line.split()[3])
    np.testing.assert_allclose(maximum(out), maximum(jout), rtol=0,
                               atol=1e-3)
    assert set(runner.results["metaopt"].params) == {"tree.distances"}


@pytest.mark.parametrize("case, sub, expected", [
    ("jc69-time", "serial", ["tree.ratios", "tree.root_height"]),
    ("hky2", "brent", ["tree.distances"])])
def test_schedule_scope(case, sub, expected, data_dir):
    """A serial or brent sub-optimizer names the branch parameters: the
    height parameters of jc69-time.json's time tree, not the clock rate,
    and an unrooted tree's distances, as the JAX package's does (built,
    not run)."""
    if case == "jc69-time":
        with open(os.path.join(data_dir, "jc69-time.json")) as fh:
            cfg = json.load(fh)
    else:
        cfg = golden_config(case, data_dir, physher=[
            {"id": "ml", "type": "optimizer", "algorithm": "meta",
             "model": "&treelikelihood",
             "list": [{"algorithm": sub, "model": "&treelikelihood"}]}])
    assert cfg["physher"][0]["list"][0]["algorithm"] == sub
    jctx, jactions = j_build_config(json.loads(json.dumps(cfg)),
                                    base_dir=data_dir)
    ctx, actions = build_config(cfg, base_dir=data_dir, **KW)
    names = Runner(ctx)._schedule_scope(actions[0])
    jmodel = jctx.resolve(jactions[0]["model"])
    jnames = JRunner(jctx)._schedule_scope(jactions[0], jmodel)
    assert names == jnames == expected


@pytest.mark.parametrize("algorithm", ["lbfgs", "bfgs", "cg"])
def test_runner_algorithms(algorithm, data_dir):
    """Each quasi-Newton name runs L-BFGS on the full space and improves on
    the start."""
    act = {"id": "ml", "type": "optimizer", "algorithm": algorithm,
           "model": "&treelikelihood", "precision": 1e-3}
    ctx, actions = build_config(golden_config("hky2", data_dir,
                                              physher=[act]),
                                base_dir=data_dir, **KW)
    tlk = ctx.objects["treelikelihood"]
    with torch.no_grad():
        start = float(tlk.log_likelihood(
            tlk.param_space().init_params(**KW)))
    runner = Runner(ctx, out=io.StringIO())
    runner.run(actions)
    res = runner.results["ml"]
    with torch.no_grad():
        at = float(tlk.log_likelihood(runner.params_for(tlk.param_space())))
    assert res.logp > start + 1.0
    assert set(res.params) == set(tlk.param_space().names)
    np.testing.assert_allclose(at, res.logp, rtol=0, atol=1e-6)


# -- the Hessian and Laplace ------------------------------------------------


@pytest.mark.parametrize("case", ["jc69nj", "hky2"])
def test_hessian_matches_jax(case, data_dir):
    """The action's Hessian (batched central differences of the exact
    gradient, one call at L = 2n + 1) against JAX's reverse-over-reverse
    one, at a point moved off the golden's values by seeded noise."""
    cfg = golden_config(case, data_dir, physher=[
        {"id": "h", "type": "hessian", "model": "&treelikelihood"}])
    jctx, jactions = j_build_config(json.loads(json.dumps(cfg)),
                                    base_dir=data_dir)
    ctx, actions = build_config(cfg, base_dir=data_dir, **KW)
    tlk = ctx.objects["treelikelihood"]
    space = tlk.param_space()
    u = space.flatten_unconstrained(space.unconstrain(
        space.init_params(**KW)))
    noise = np.random.default_rng(3).normal(0.0, 0.1, u.shape)
    with torch.no_grad():
        point = space.constrain(space.unflatten_unconstrained(
            u + torch.as_tensor(noise, **KW)))
    jH = jax_hessian(jctx.objects["treelikelihood"], as_np(point))
    calls = []
    tlk.log_likelihood = counting(tlk.log_likelihood, calls)
    runner = Runner(ctx, out=io.StringIO())
    runner.pool = dict(point)
    H = runner.action_hessian(actions[0])
    n = space.unconstrained_size
    assert calls == [(2 * n + 1,)]
    np.testing.assert_allclose(H, jH, rtol=0,
                               atol=1e-6 * np.abs(jH).max())
    assert "Hessian (unconstrained space):" in runner.out.getvalue()


def jax_hessian(jt, point, jacobian=False):
    """JAX's action_hessian at ``point`` (reverse over reverse through the
    XLA engine, jitted); with ``jacobian`` that of logP + log|J| as JAX's
    laplace_marginal takes it, and its value."""
    js = jt.param_space()
    u = js.flatten_unconstrained(js.unconstrain(
        {k: jnp.asarray(v) for k, v in point.items()}))

    def f(z):
        up = js.unflatten_unconstrained(z)
        logp = jt.log_likelihood(js.constrain(up))
        return logp + js.log_jacobian(up) if jacobian else logp
    with engine_override("xla"):
        H = np.asarray(jax.jit(jax.jacrev(jax.grad(f)))(u))
    return (H, float(f(u))) if jacobian else H


def test_hessian_chunks(data_dir):
    """Past ``max_chains`` the rows run in chunks, with the same result."""
    _, tlk = both_models("hky2", data_dir)
    space = tlk.param_space()
    p = space.init_params(**KW)
    calls = []
    H, v, g = ml.hessian(tlk.log_likelihood, space, p)
    H2, v2, g2 = ml.hessian(counting(tlk.log_likelihood, calls), space, p,
                            max_chains=16)
    n = space.unconstrained_size
    assert [c[0] for c in calls] == [16, 16, 2 * n + 1 - 32]
    np.testing.assert_allclose(H2.numpy(), H.numpy(), rtol=1e-12,
                               atol=1e-9 * float(H.abs().max()))
    assert v2 == v


def test_laplace_normal_exact():
    """test_laplace of tests/test_inference.py: exact on a normal target."""
    res = ml.optimize(log_post, SPACE, SPACE.init_params(**KW),
                      method="lbfgs")
    lap = marginal.laplace_marginal(log_post, SPACE, res.params)
    np.testing.assert_allclose(lap, analytic_log_marginal(), atol=1e-5)


def _space(name, init, lower=0.0, upper=np.inf):
    return ParamSpace([ParamSpec.scalar(name, init, lower=lower,
                                        upper=upper)])


ALPHA, BETA = 3.5, 2.0
MU, SIGMA = 0.3, 0.4
A, B = 3.0, 4.0
AP, BP = 2.5, 3.0
# tests/test_laplace_fits.py: family, target, its mode, bounds, the exact
# log normalizer, rtol
FITS = [
    ("gamma", lambda x: (ALPHA - 1.0) * torch.log(x) - BETA * x,
     (ALPHA - 1) / BETA, (0.0, np.inf),
     float(gammaln(ALPHA) - ALPHA * math.log(BETA)), 1e-10),
    ("lognormal",
     lambda x: -torch.log(x) - (torch.log(x) - MU) ** 2 / (2 * SIGMA ** 2),
     math.exp(MU - SIGMA ** 2), (0.0, np.inf),
     0.5 * math.log(2 * math.pi) + math.log(SIGMA), 1e-10),
    ("beta", lambda x: (A - 1.0) * torch.log(x) + (B - 1.0) * torch.log1p(-x),
     (A - 1) / (A + B - 2), (0.0, 1.0), float(betaln(A, B)), 1e-8),
    ("betaprime",
     lambda x: (AP - 1.0) * torch.log(x) - (AP + BP) * torch.log1p(x),
     (AP - 1) / (BP + 1), (0.0, np.inf), float(betaln(AP, BP)), 1e-8),
]


@pytest.mark.parametrize("fit", FITS, ids=[f[0] for f in FITS])
def test_laplace_fitted_recovers_normalizer(fit):
    family, target, mode, (lo, hi), expected, rtol = fit
    space = _space("x", mode, lower=lo, upper=hi)
    got = marginal.laplace_marginal_fitted(
        lambda p: target(p["x"]), space, space.init_params(**KW),
        family=family)
    np.testing.assert_allclose(got, expected, rtol=rtol)


def test_laplace_action_gamma():
    """test_gamma_fit_through_runner_action of tests/test_laplace_fits.py."""
    alpha, beta = 4.0, 1.5

    class Model:
        def param_space(self):
            return _space("x", (alpha - 1) / beta)

        def log_prob(self, p):
            return (alpha - 1.0) * torch.log(p["x"]) - beta * p["x"]

    ctx = Context(**KW)
    ctx.objects["m"] = Model()
    runner = Runner(ctx, out=io.StringIO())
    val = runner.action_laplace({"model": "&m", "distribution": "gamma",
                                 "id": "lap"})
    np.testing.assert_allclose(
        val, float(gammaln(alpha) - alpha * math.log(beta)), rtol=1e-10)
    assert runner.out.getvalue().startswith(
        "Laplace log marginal likelihood: ")


def test_laplace_action_matches_jax(data_dir):
    """The multivariate-normal Laplace action on hky2 against JAX's
    laplace_marginal's arithmetic on its exact Hessian of logP + log|J|."""
    act = [{"id": "lap", "type": "laplace", "model": "&treelikelihood"}]
    cfg = golden_config("hky2", data_dir, physher=act)
    jctx, _ = j_build_config(json.loads(json.dumps(cfg)), base_dir=data_dir)
    ctx, actions = build_config(cfg, base_dir=data_dir, **KW)
    jt = jctx.objects["treelikelihood"]
    js = jt.param_space()
    H, value = jax_hessian(jt, as_np(js.init_params()), jacobian=True)
    expected = (value + 0.5 * len(H) * math.log(2 * math.pi)
                - 0.5 * np.linalg.slogdet(-H)[1])
    runner = Runner(ctx, out=io.StringIO())
    val = runner.run(actions)["lap"]
    np.testing.assert_allclose(val, expected, rtol=1e-9)
    assert runner.out.getvalue() == \
        f"Laplace log marginal likelihood: {val:.6f}\n"


# -- checkpoints ------------------------------------------------------------


def test_checkpoint_roundtrip(tmp_path):
    params = {"a": torch.tensor(1.5, **KW),
              "b": torch.tensor([0.1, 0.2, 0.3], **KW)}
    path = str(tmp_path / "ckpt.csv")
    ml.save_checkpoint(path, params)
    restored = ml.load_checkpoint(path, {
        "a": torch.tensor(0.0, dtype=torch.float32),
        "b": torch.zeros(3, **KW), "c": torch.tensor(7.0, **KW)})
    assert restored["a"].dtype == torch.float32
    assert float(restored["a"]) == 1.5
    assert restored["b"].tolist() == [0.1, 0.2, 0.3]
    assert float(restored["c"]) == 7.0


def test_checkpoint_crosses_packages(tmp_path):
    """A file that either package writes loads in the other, bit for bit."""
    rng = np.random.default_rng(7)
    values = {"tree.distances": rng.gamma(2.0, 0.05, 9),
              "sm.kappa": np.asarray(rng.gamma(3.0, 1.0))}
    zeros = {k: np.zeros_like(v) for k, v in values.items()}
    port_file, jax_file = str(tmp_path / "port.csv"), str(tmp_path /
                                                           "jax.csv")
    ml.save_checkpoint(port_file, to_torch(values))
    jml.save_checkpoint(jax_file, {k: jnp.asarray(v)
                                   for k, v in values.items()})
    with open(port_file) as a, open(jax_file) as b:
        assert a.read() == b.read()
    from_port = jml.load_checkpoint(port_file, {
        k: jnp.asarray(v) for k, v in zeros.items()})
    from_jax = ml.load_checkpoint(jax_file, to_torch(zeros))
    for k, v in values.items():
        np.testing.assert_array_equal(np.asarray(from_port[k]), v)
        np.testing.assert_array_equal(from_jax[k].numpy(), v)


def test_cli_checkpoint_restores(data_dir, tmp_path):
    """An optimizer's "checkpoint" writes the CSV; ``-c`` seeds the next
    run's pool from it, so that a logger reads the optimum back."""
    ckpt = str(tmp_path / "ml.csv")
    first = golden_config("hky2", data_dir, physher=[
        {"id": "ml", "type": "optimizer", "algorithm": "lbfgs",
         "model": "&treelikelihood", "precision": 1e-3,
         "checkpoint": ckpt}])
    second = golden_config("hky2", data_dir, physher=[
        {"id": "log", "type": "logger", "models": ["&treelikelihood"]}])
    paths = []
    for i, cfg in enumerate((first, second)):
        paths.append(str(tmp_path / f"c{i}.json"))
        with open(paths[-1], "w") as fh:
            json.dump(cfg, fh)
    runner = cli.run([paths[0], "--device", "cpu"], out=io.StringIO())
    res = runner.results["ml"]
    out = io.StringIO()
    restored = cli.run([paths[1], "--device", "cpu", "-c", ckpt], out=out)
    for k, v in res.params.items():
        assert torch.equal(restored.pool[k], v.detach())
    tlk = runner.ctx.objects["treelikelihood"]
    with torch.no_grad():
        at = float(tlk.log_likelihood(runner.params_for(tlk.param_space())))
    logged = float(out.getvalue().splitlines()[0].split()[1])
    np.testing.assert_allclose(logged, at, rtol=0, atol=1e-6)
