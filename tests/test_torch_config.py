"""The JSON-config path of the port on the CPU, held against the JAX package:
the model graph that both build from tests/data/fluA-elbo.json (parameter
names, initial values, the log posterior and its gradient), the
variational target, the densities, coalescents and closed-form nucleotide
models, the Adam with the reference's eta/sqrt(t) schedule, and the CLI
(its ML branch against the JAX package's).

Float64 throughout. Tolerances: 1e-10 for the model graph (the same
arithmetic in another order), 1e-9 for the variational target (it adds
the transforms' Jacobians over 70 parameters), 1e-12 for single densities
and P(t).
"""

import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physher_tpu.config.actions import Runner as JRunner
from physher_tpu.config.builder import build_config as j_build_config
from physher_tpu.config.builder import load_json as j_load_json
from physher_tpu.models import coalescent as j_coal
from physher_tpu.models import distributions as j_dist
from physher_tpu.models import substitution as j_subst
from physher_tpu.utils.optim import adam as j_adam
from physher_tpu_torch import cli
from physher_tpu_torch.config.builder import (
    build_config, load_json, route_engine)
from physher_tpu_torch.inference import vb as vb_mod
from physher_tpu_torch.models import coalescent, distributions, substitution
from physher_tpu_torch.models.parameters import (
    params_from_numpy, vparams_from_numpy)

KW = dict(dtype=torch.float64, device="cpu")


@pytest.fixture(scope="module")
def graphs(data_dir):
    """(JAX context, port context) built from fluA-elbo.json."""
    cfg = j_load_json(os.path.join(data_dir, "fluA-elbo.json"))
    jctx, _ = j_build_config(cfg, base_dir=data_dir)
    ctx, actions = build_config(load_json(os.path.join(data_dir,
                                                       "fluA-elbo.json")),
                                base_dir=data_dir, **KW)
    assert actions[0]["algorithm"] == "sg"
    return jctx, ctx


def _np(d):
    return {k: np.asarray(v, np.float64) for k, v in d.items()}


def _points(jspace):
    """The initial point and a perturbed one (moved in the unconstrained
    space by numpy noise), as numpy dicts."""
    p0 = jspace.init_params()
    u = jspace.flatten_unconstrained(jspace.unconstrain(p0))
    noise = np.random.default_rng(0).normal(0.0, 0.05, u.shape)
    p1 = jspace.constrain(jspace.unflatten_unconstrained(u + noise))
    return [_np(p0), _np(p1)]


def test_parameter_space_matches(graphs):
    jctx, ctx = graphs
    jspace = jctx.objects["posterior"].param_space()
    space = ctx.objects["posterior"].param_space()
    assert space.names == jspace.names
    assert space.unconstrained_size == jspace.unconstrained_size == 70
    assert space.unconstrained_slices() == jspace.unconstrained_slices()
    for s, js in zip(space.specs, jspace.specs):
        np.testing.assert_array_equal(s.init, js.init)
        assert (s.lower, s.upper, s.transform) == (js.lower, js.upper,
                                                   js.transform)
    assert ctx.param_names == jctx.param_names
    assert ctx.slices == jctx.slices


def _jax_value_and_grad(jpost):
    """The JAX posterior's jitted value and gradient, compiled once (eager
    JAX walks the tree op by op)."""
    if not hasattr(jpost, "_test_vg"):
        jpost._test_vg = jax.jit(jax.value_and_grad(jpost.log_prob))
    return jpost._test_vg


@pytest.mark.parametrize("point", [0, 1])
def test_log_posterior_and_gradient_match(graphs, point):
    jctx, ctx = graphs
    jpost, post = jctx.objects["posterior"], ctx.objects["posterior"]
    p = _points(jpost.param_space())[point]
    jval, jgrad = _jax_value_and_grad(jpost)(
        {k: jnp.asarray(v) for k, v in p.items()})
    leaves = {k: v.requires_grad_(True)
              for k, v in params_from_numpy(p, **KW).items()}
    val = post.log_prob(leaves)
    grads = torch.autograd.grad(val, list(leaves.values()))
    np.testing.assert_allclose(float(val.detach()), float(jval), rtol=1e-10)
    for k, g in zip(leaves, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jgrad[k]),
                                   rtol=1e-10,
                                   atol=1e-10 * np.abs(jgrad[k]).max())
    # each component on its own
    for jc, c in zip(jpost.components, post.components):
        jf = getattr(jc, "log_prob", None) or jc.log_likelihood
        f = getattr(c, "log_prob", None) or c.log_likelihood
        with torch.no_grad():
            np.testing.assert_allclose(
                float(f(params_from_numpy(p, **KW))),
                float(jf({k: jnp.asarray(v) for k, v in p.items()})),
                rtol=1e-10)


def test_variational_family_matches(graphs):
    """Initial variational parameters, the ELBO's target log p(z) + log|J|
    and its gradient at numpy-made z, the entropy and log q."""
    jctx, ctx = graphs
    jfam, fam = jctx.objects["varnormal"].family, ctx.objects[
        "varnormal"].family
    for k in ("loc", "log_scale"):
        np.testing.assert_allclose(fam.init[k].numpy(),
                                   np.asarray(jfam.init[k]), rtol=1e-12)
    rng = np.random.default_rng(1)
    vp_np = {k: np.asarray(v) + rng.normal(0, 0.02, np.shape(v))
             for k, v in jfam.init.items()}
    vp = vparams_from_numpy(vp_np, **KW)
    jvp = {k: jnp.asarray(v) for k, v in vp_np.items()}
    z = vp_np["loc"] + np.exp(vp_np["log_scale"]) * rng.normal(
        0, 1, (3, fam.dim))
    jvg = jax.jit(jax.value_and_grad(jfam._target))
    for zi in z:
        jval, jg = jvg(jnp.asarray(zi))
        zt = torch.as_tensor(zi).requires_grad_(True)
        val = fam._target(zt)
        (g,) = torch.autograd.grad(val, [zt])
        np.testing.assert_allclose(float(val.detach()), float(jval), rtol=1e-9)
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-9,
                                   atol=1e-9 * np.abs(jg).max())
    np.testing.assert_allclose(float(fam.entropy(vp)),
                               float(jfam.entropy(jvp)), rtol=1e-12)
    np.testing.assert_allclose(fam.log_q(vp, torch.as_tensor(z)).numpy(),
                               np.asarray(jfam.log_q(jvp, jnp.asarray(z))),
                               rtol=1e-12)
    # the ELBO over the same draws: mean target plus entropy
    eps = (z - vp_np["loc"]) / np.exp(vp_np["log_scale"])
    with torch.no_grad():
        elbo = float(fam.elbo(vp, eps=torch.as_tensor(eps)))
    jelbo = float(np.mean([jvg(jnp.asarray(zi))[0] for zi in z])
                  + jfam.entropy(jvp))
    np.testing.assert_allclose(elbo, jelbo, rtol=1e-9)


_X = np.asarray([0.3, 0.7, 1.4, 2.5])
_U = np.asarray([0.05, 0.3, 0.6, 0.95])
LOGPDF_CASES = [
    ("normal", _X - 1.0, dict(mean=0.2, sigma=1.3)),
    ("normal", _X, dict(mean=0.2, tau=2.0)),
    ("halfnormal", _X, dict(sigma=0.8)),
    ("lognormal", _X, dict(mu=-0.1, sigma=0.6)),
    ("gamma", _X, dict(shape=2.2, rate=1.5)),
    ("gamma", _X, dict(shape=0.7, scale=2.0)),
    ("exponential", _X, dict(rate=1.7)),
    ("exponential", _X, dict(mean=0.4)),
    ("beta", _U, dict(alpha=2.0, beta=3.5)),
    ("betaprime", _X, dict(alpha=1.5, beta=2.5)),
    ("cauchy", _X - 1.0, dict(location=0.1, scale=0.9)),
    ("kumaraswamy", _U, dict(a=1.7, b=2.9)),
    ("weibull", _X, dict(shape=1.6, scale=1.2)),
    ("dirichlet", _U / _U.sum(), dict(alpha=np.asarray([1., 2., 3., 4.]))),
    ("oneonx", _X, {}),
    ("uniform", _U, dict(lower=0.0, upper=2.0)),
    ("multivariatenormal", _X, dict(mean=np.ones(4),
                                    cov=np.eye(4) + 0.3)),
    ("student", _X, dict(df=3.0, loc=0.5, scale=1.2)),
    ("gmrf", np.log(_X), dict(precision=2.5)),
]


@pytest.mark.parametrize("name,x,hyper", LOGPDF_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in
                              enumerate(LOGPDF_CASES)])
def test_logpdf_matches(name, x, hyper):
    got = distributions.LOGPDFS[name](torch.as_tensor(x), **hyper)
    want = j_dist.LOGPDFS[name](jnp.asarray(x), **hyper)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-12)


def test_ctmc_scale_logpdf_matches():
    got = distributions.ctmc_scale_logpdf(torch.as_tensor(_X * 1e-3),
                                          torch.tensor(42.0, dtype=torch.float64))
    want = j_dist.ctmc_scale_logpdf(jnp.asarray(_X * 1e-3), 42.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)


def test_sample_shapes_and_support():
    gen = torch.Generator().manual_seed(0)
    for name, kw in (("normal", dict(mean=0.0, sigma=1.0)),
                     ("gamma", dict(shape=2.0, rate=1.0)),
                     ("beta", dict(alpha=2.0, beta=2.0)),
                     ("exponential", dict(rate=2.0)),
                     ("uniform", dict(lower=1.0, upper=2.0))):
        x = distributions.sample(name, gen, (500,), **kw)
        assert x.shape == (500,) and torch.isfinite(x).all()
    g = distributions.sample("gamma", gen, (20000,), shape=2.0, rate=4.0)
    assert abs(float(g.mean()) - 0.5) < 0.02


@pytest.mark.parametrize("model,params,kw", [
    ("constant", {"c.theta": 3.0}, {}),
    ("constant", {"c.theta": np.log(3.0)}, {"log_space": True}),
    ("exponential", {"c.n0": 5.0, "c.rate": 0.2}, {}),
    ("exponential", {"c.n0": 5.0, "c.rate": 0.0}, {}),
    ("skyride", None, {"log_space": True}),
    ("skyride", None, {"log_space": False}),
    ("skyride", "delta", {"delta": True, "log_space": False}),
])
def test_coalescent_matches(graphs, model, params, kw):
    """Value and gradients (heights, population parameters) on the fluA
    time tree's initial heights."""
    jctx, ctx = graphs
    jtree, tree = jctx.objects["tree"], ctx.objects["tree"]
    I = tree.topo.I
    h = np.asarray(jtree.heights(jctx.objects["posterior"].param_space()
                                 .init_params()), np.float64)
    rng = np.random.default_rng(3)
    if model == "skyride":
        if params == "delta":
            v = np.concatenate([[2.0], rng.normal(0, 1, I - 1), [1.0, 0.5]])
        elif kw["log_space"]:
            v = rng.normal(1.0, 0.3, I)
        else:
            v = rng.uniform(1.0, 4.0, I)
        params = {"c.thetas": v}
    jcls = {"constant": j_coal.ConstantCoalescent,
            "exponential": j_coal.ExponentialCoalescent,
            "skyride": j_coal.SkyrideCoalescent}[model]
    cls = {"constant": coalescent.ConstantCoalescent,
           "exponential": coalescent.ExponentialCoalescent,
           "skyride": coalescent.SkyrideCoalescent}[model]
    if model == "skyride" and "delta" in kw:
        kw = dict(kw, thetas_init=params["c.thetas"])
    jm, m = jcls(jtree.topo, "c.", **kw), cls(tree.topo, "c.", **kw)

    def jf(hh, pp):
        return jm.log_prob_from_heights(hh, pp)

    jval, (jgh, jgp) = jax.value_and_grad(jf, argnums=(0, 1))(
        jnp.asarray(h), {k: jnp.asarray(v) for k, v in params.items()})
    ht = torch.tensor(h).requires_grad_(True)
    pt = {k: torch.as_tensor(np.asarray(v, np.float64)).requires_grad_(True)
          for k, v in params.items()}
    val = m.log_prob_from_heights(ht, pt)
    gh, *gp = torch.autograd.grad(val, [ht, *pt.values()])
    np.testing.assert_allclose(float(val.detach()), float(jval), rtol=1e-12)
    np.testing.assert_allclose(gh.numpy(), np.asarray(jgh), rtol=1e-10,
                               atol=1e-10 * np.abs(jgh).max())
    for k, g in zip(pt, gp):
        np.testing.assert_allclose(g.numpy(), np.asarray(jgp[k]), rtol=1e-10,
                                   atol=1e-12)


@pytest.mark.parametrize("name", ["k80", "f81", "hky"])
def test_closed_form_p_t_matches(name):
    """P(t) and its gradient against the JAX model, and against expm of the
    model's own Q."""
    rng = np.random.default_rng(4)
    t = rng.uniform(0.01, 2.0, (5, 3))
    freqs = np.asarray([0.2, 0.3, 0.15, 0.35])
    params = {"k80": {"sm.kappa": 2.7}, "f81": {"sm.frequencies": freqs},
              "hky": {"sm.kappa": 3.1, "sm.frequencies": freqs}}[name]
    jm = {"k80": j_subst.K80, "f81": j_subst.F81, "hky": j_subst.HKY}[name](
        "sm.")
    m = {"k80": substitution.K80, "f81": substitution.F81,
         "hky": substitution.HKY}[name]("sm.", **KW)

    def jsum(pp, tt):
        return jnp.sum(jm.p_t(pp, tt) ** 2)

    jP = np.asarray(jm.p_t({k: jnp.asarray(v) for k, v in params.items()},
                           jnp.asarray(t)))
    jg = jax.grad(jsum, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(t))
    pt = {k: torch.as_tensor(np.asarray(v, np.float64)).requires_grad_(True)
          for k, v in params.items()}
    tt = torch.as_tensor(t).requires_grad_(True)
    P = m.p_t(pt, tt)
    np.testing.assert_allclose(P.detach().numpy(), jP, rtol=1e-12,
                               atol=1e-14)
    grads = torch.autograd.grad(torch.sum(P ** 2), [*pt.values(), tt])
    for k, g in zip(pt, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[0][k]),
                                   rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(grads[-1].numpy(), np.asarray(jg[1]),
                               rtol=1e-10, atol=1e-12)
    with torch.no_grad():
        Q = m.q(params_from_numpy(params, **KW))
        expm = torch.linalg.matrix_exp(Q * tt[..., None, None])
    np.testing.assert_allclose(expm.numpy(), jP, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("rsqrt_decay", [True, False])
def test_adam_matches(rsqrt_decay):
    """Five steps of ``vb.step`` (torch.optim.Adam with the eta/sqrt(t)
    schedule of ``vb.adam``, or a constant rate as ``ml.optimize_adam``
    runs it) against the JAX package's Adam on the same gradients
    (float64)."""
    rng = np.random.default_rng(5)
    p = {"a": rng.normal(size=3), "b": np.asarray(0.7)}
    grads = [{k: rng.normal(size=np.shape(v)) for k, v in p.items()}
             for _ in range(5)]
    jopt = j_adam(0.1, rsqrt_decay=rsqrt_decay)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    jstate = jopt.init(jp)
    tp = {k: v.requires_grad_(True)
          for k, v in params_from_numpy(p, **KW).items()}
    if rsqrt_decay:
        opt, schedule = vb_mod.adam(tp, 0.1)
    else:
        opt = torch.optim.Adam(list(tp.values()), lr=0.1)
        schedule = torch.optim.lr_scheduler.LambdaLR(opt, lambda t: 1.0)

    class Linear:
        """An 'ELBO' whose gradient is -g, so that the step descends g."""
        g = None

        def elbo(self, vparams, generator, n):
            return -sum(torch.sum(self.g[k] * v) for k, v in vparams.items())

    target = Linear()
    for g in grads:
        ju, jstate = jopt.update({k: jnp.asarray(v) for k, v in g.items()},
                                 jstate, jp)
        jp = {k: jp[k] + ju[k] for k in jp}
        target.g = params_from_numpy(g, **KW)
        vb_mod.step(target, tp, opt, schedule, None)
    for k in p:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-13, atol=1e-15)


# -- the CLI ------------------------------------------------------------------


def _config(data_dir, tmp_path, edit):
    with open(os.path.join(data_dir, "fluA-elbo.json")) as fh:
        cfg = json.load(fh)
    edit(cfg)
    path = tmp_path / "config.json"
    path.write_text(json.dumps(cfg))
    for f in ("fluA.fa", "fluA-rooted.nxs"):
        (tmp_path / f).symlink_to(os.path.join(data_dir, f))
    return str(path)


def test_cli_runs_elbo_on_cpu(data_dir, tmp_path):
    path = _config(data_dir, tmp_path,
                   lambda c: c["physher"][0].update(max=50))
    out = io.StringIO()
    runner = cli.run([path, "--device", "cpu", "--seed", "2"], out=out)
    lines = out.getvalue().splitlines()
    assert lines[0].startswith("ELBO: ") and "(50 iterations)" in lines[0]
    elbo = float(lines[0].split()[1])
    assert np.isfinite(elbo) and elbo < -4600
    assert runner.ctx.objects["treelikelihood"].engine_name() == "torch"
    assert runner.ctx.dtype == torch.float64


def test_cli_ml_then_logger(data_dir, tmp_path):
    """An sg (Adam) ML action over a parameter subset, then a logger."""
    def edit(c):
        c["physher"] = [
            {"id": "ml", "type": "optimizer", "algorithm": "sg",
             "model": "&posterior", "max": 20, "eta": 0.01,
             "parameters": ["&rate", "&n0"]},
            {"id": "log", "type": "logger", "models": ["&posterior"]}]
    out = io.StringIO()
    runner = cli.run([_config(data_dir, tmp_path, edit), "--device", "cpu"],
                     out=out)
    lines = out.getvalue().splitlines()
    assert lines[0].startswith("Maximum log likelihood: ")
    res = runner.results["ml"]
    assert res.history[-1] > res.history[0]
    assert set(res.params) == {"bm.rate", "coalescent.theta"}
    assert lines[1].startswith("posterior: ")
    assert abs(float(lines[1].split()[1]) - res.logp) < 5.0


def _ml_both(data_dir, tmp_path, act):
    """The ML optimizer node ``act`` on fluA-elbo.json's model through the
    JAX package's Runner and the port's CLI: (JAX result, port result)."""
    cfg = j_load_json(os.path.join(data_dir, "fluA-elbo.json"))
    cfg["physher"] = [act]
    jctx, jactions = j_build_config(cfg, base_dir=data_dir)
    jrunner = JRunner(jctx, seed=0, out=io.StringIO())
    jrunner.run(jactions)
    runner = cli.run([_config(data_dir, tmp_path,
                              lambda c: c.update(physher=[act])),
                      "--device", "cpu"], out=io.StringIO())
    jres, res = jrunner.results["ml"], runner.results["ml"]
    assert set(res.params) == set(jres.params) == {"bm.rate",
                                                   "coalescent.theta"}
    assert res.iterations == jres.iterations
    np.testing.assert_allclose(res.logp, jres.logp, rtol=1e-12)
    for k, v in jres.params.items():
        np.testing.assert_allclose(float(res.params[k]), float(v), rtol=1e-10)
    return jres, res


def test_cli_ml_matches_jax(data_dir, tmp_path):
    """The ML branch of the optimizer action in both packages on the same
    config: an sg optimizer restricted to the parameters that its
    schedule's sub-optimizers ("list") name, with Adam's defaults (no
    "max" or "eta")."""
    _ml_both(data_dir, tmp_path, {
        "id": "ml", "type": "optimizer", "algorithm": "sg",
        "model": "&posterior", "precision": 0.01,
        "list": [{"algorithm": "sg", "parameters": ["&rate"]},
                 {"algorithm": "sg", "parameters": ["&n0"]}]})


def test_cli_ml_max_and_eta_match_jax(data_dir, tmp_path):
    """A config that sets "max" and "eta": the JAX package ignores both and
    runs Adam with its defaults (a deviation from the reference, ported as
    it is), and so does the port: the same optimum, past "max" steps."""
    jres, _ = _ml_both(data_dir, tmp_path, {
        "id": "ml", "type": "optimizer", "algorithm": "sg",
        "model": "&posterior", "precision": 0.01, "max": 20, "eta": 0.5,
        "parameters": ["&rate", "&n0"]})
    assert jres.iterations > 20


def test_cli_dry_prints_json(data_dir):
    out = io.StringIO()
    assert cli.run([os.path.join(data_dir, "fluA-elbo.json"), "--dry"],
                   out=out) is None
    assert json.loads(out.getvalue())["varmodel"]["elbosamples"] == 100


def test_cli_without_cuda_exits_nonzero(data_dir, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert cli.main([os.path.join(data_dir, "fluA-elbo.json")]) == 2
    assert "no CUDA device" in capsys.readouterr().err


@pytest.mark.parametrize("what", ["sbn", "mesh", "dumper"])
def test_formerly_unported_runs(data_dir, tmp_path, what):
    """What raised until it was ported runs on the CPU: the sbn action on
    the config's tree file, pattern sharding over two shards of the CPU
    (init.devices) under a short ADVI fit, and the dumper after one,
    whose file reads back as the pool."""
    def edit(c):
        fit = dict(c["physher"][0], max=5)
        fit.pop("checkpoint")
        if what == "sbn":
            c["physher"] = [{"id": "x", "type": "sbn",
                             "file": "fluA-rooted.nxs"}]
        elif what == "mesh":
            c["init"] = {"devices": 2}
            c["physher"] = [fit]
        else:
            c["physher"] = [fit, {"id": "x", "type": "dumper",
                                  "file": "pool.json"}]
    out = io.StringIO()
    runner = cli.run([_config(data_dir, tmp_path, edit), "--device", "cpu"],
                     out=out)
    if what == "sbn":
        roots, _ = runner.results["x"].probabilities()
        assert np.isclose(sum(roots.values()), 1.0)
        assert out.getvalue().startswith("SBN: ")
    elif what == "mesh":
        tlk = runner.ctx.objects["treelikelihood"]
        assert runner.ctx.mesh.shape == {"patterns": 2}
        assert tlk.mesh is runner.ctx.mesh
        assert tlk.tip_partials.shape[-1] % 2 == 0
        assert np.isfinite(runner.results["sg"].elbo)
    else:
        dumped = json.loads((tmp_path / "pool.json").read_text())
        assert sorted(dumped) == sorted(runner.pool)
        for k, v in runner.pool.items():
            np.testing.assert_array_equal(np.asarray(dumped[k]),
                                          v.cpu().numpy())


@pytest.mark.parametrize("engine,S,expected", [
    ("pallas-fused", 4, "cuda-fused"), ("pallas-staged", 4, "cuda-staged"),
    ("pallas-wide", 4, "cuda-wide"), ("pallas-loop", 4, "cuda-loop"),
    ("xla", 4, "torch"), ("auto", 4, "auto"),
    # protein and codon: K1'/K2' in the TPU wrapper's modes, the staged
    # sweep on csrc/wide.cu's level kernels
    ("pallas-fused", 20, "cuda-fused"), ("pallas-staged", 61, "cuda-staged")],
    ids=["pallas-fused-cuda-fused", "pallas-staged-cuda-staged",
         "pallas-wide-cuda-wide", "pallas-loop-cuda-loop", "xla-torch",
         "auto-auto", "pallas-fused-S20-cuda-fused",
         "pallas-staged-S61-cuda-staged"])
def test_engine_names_map(data_dir, engine, S, expected):
    """A config's engine name is the port's ``expected`` on the card at
    S states; built on the CPU, a JAX kernel's name runs the plain
    engine."""
    cfg = load_json(os.path.join(data_dir, "fluA-elbo.json"))
    cfg["model"]["distributions"][0]["engine"] = engine
    ctx, _ = build_config(cfg, base_dir=data_dir, **KW)
    assert route_engine(engine, "cuda", S) == expected
    assert ctx.objects["treelikelihood"].engine == (
        "torch" if engine.startswith("pallas-") else expected)


@pytest.mark.parametrize("engine", ["pallas-fused", "pallas-staged",
                                    "pallas-wide", "pallas-loop"])
def test_pallas_engine_names_run_on_cpu(data_dir, tmp_path, engine):
    """The JAX package runs a config's pallas-* engine off the TPU in
    interpret mode; the port runs it on the CPU through the plain engine:
    fluA-elbo.json with the name on its tree likelihood, through the CLI's
    builder, gives the auto build's logP (1e-12) and ``engine_name()`` says
    "torch". A direct cuda-* engine on CPU tensors still raises."""
    cfg = load_json(os.path.join(data_dir, "fluA-elbo.json"))
    for name in ("fluA.fa", "fluA-rooted.nxs"):
        (tmp_path / name).symlink_to(os.path.join(data_dir, name))
    logps = {}
    for eng in ("auto", engine):
        cfg["model"]["distributions"][0]["engine"] = eng
        path = tmp_path / f"{eng}.json"
        path.write_text(json.dumps(cfg))
        ctx, _ = build_config(load_json(str(path)), base_dir=str(tmp_path),
                              **KW)
        tlk = ctx.objects["treelikelihood"]
        with torch.no_grad():
            logps[eng] = float(tlk.log_likelihood(
                tlk.param_space().init_params(**KW)))
        assert tlk.engine_name() == tlk.engine_name(4) == "torch"
    np.testing.assert_allclose(logps[engine], logps["auto"], rtol=1e-12)
    tlk.engine = "cuda-fused"
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tlk.log_likelihood(tlk.param_space().init_params(**KW))


@pytest.mark.parametrize("engine,device,S,batch,expected", [
    ("pallas-fused", "cuda", 20, None, "cuda-fused"),   # category-split
    ("pallas-staged", "cuda", 61, None, "cuda-staged"),  # on csrc/wide.cu
    ("pallas-loop", "cuda", 61, 8, "cuda-loop"),
    ("pallas-loop", "cuda", 20, None, "cuda-loop"),
    ("pallas-fused", "cuda", 4, 4, "cuda-loop"),       # chains: K5'/K6'
    ("pallas-wide", "cpu", 20, 4, "torch"),
    ("xla", "cuda", 61, 8, "torch")])
def test_engine_names_route_by_device_and_states(engine, device, S, batch,
                                                 expected):
    assert route_engine(engine, device, S, batch) == expected
