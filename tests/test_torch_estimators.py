"""The Bayesian model-comparison estimators of ``inference/marginal.py``,
``MixedMCMC`` and the ``bridgesampling``, ``is``, ``nest``, ``cpo``, ``mc``
and ``predictive`` actions, on the CPU in float64:

- importance sampling and bridge sampling equal the JAX package's at 1e-10
  on the same draws (the proposal's standard normals, the posterior
  samples), on the conjugate normal target of tests/test_inference.py;
- on that target, IS and bridge sampling come within that test's
  tolerances of the known log evidence (0.02 and 0.05), with its schedules
  (the bridge's 20 000 MCMC iterations as 4 chains of 5 000);
- nested sampling within 0.3 nats of it on three seeds: the JAX package's
  ``nested_sampling`` on the same target, its live points from the same
  prior, missed it by up to 0.295 nats over six seeds (n_live 100);
- MixedMCMC's bit frequency on tests/test_treemcmc.py's target within 0.06
  of 0.3, over a batch of 8 chains of 5 000 iterations (JAX: one chain of
  40 000);
- the six actions through ``cli.run(..., "--device", "cpu")`` on a tiny.fa
  config print their lines with finite values, and ``cpo``'s filename form
  equals the JAX package's on the same sitewise log at 1e-10.
"""

import io
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physher_tpu.config.actions import Runner as JRunner
from physher_tpu.config.builder import build_config as j_build_config
from physher_tpu.inference import marginal as j_marginal
from physher_tpu.inference import vb as j_vb
from physher_tpu.models.distributions import normal_logpdf as j_normal
from physher_tpu.models.parameters import ParamSpace as JParamSpace
from physher_tpu.models.parameters import ParamSpec as JParamSpec
from physher_tpu_torch import cli
from physher_tpu_torch.inference import marginal, mcmc, vb
from physher_tpu_torch.models.distributions import normal_logpdf
from physher_tpu_torch.models.parameters import (
    ParamSpace, ParamSpec, vparams_from_numpy)

F64 = dict(dtype=torch.float64, device="cpu")

# the conjugate normal model of tests/test_inference.py: y_i ~ N(theta, s2),
# theta ~ N(0, t2)
Y = np.array([0.3, 1.2, -0.4, 0.8, 1.9, 0.1, 0.7, 1.1])
S2, T2 = 1.0, 4.0
SPACE = ParamSpace([ParamSpec.scalar("theta", 0.0)])
J_SPACE = JParamSpace([JParamSpec.scalar("theta", 0.0)])


def log_like(params):
    """A batch of parameter dicts -> [L]."""
    return normal_logpdf(torch.as_tensor(Y), params["theta"][..., None],
                         math.sqrt(S2)).sum(-1)


def log_post(params):
    return log_like(params) + normal_logpdf(params["theta"], 0.0,
                                            math.sqrt(T2))


def j_log_post(params):
    return (jnp.sum(j_normal(jnp.asarray(Y), params["theta"], math.sqrt(S2)))
            + jnp.sum(j_normal(params["theta"], 0.0, math.sqrt(T2))))


def log_evidence():
    from scipy.stats import multivariate_normal

    n = len(Y)
    return multivariate_normal.logpdf(
        Y, np.zeros(n), S2 * np.eye(n) + T2 * np.ones((n, n)))


def test_importance_sampling_matches_jax_on_the_same_draws():
    jfam = j_vb.MeanFieldNormalVB(j_log_post, J_SPACE,
                                  J_SPACE.init_params())
    fam = vb.MeanFieldNormalVB(log_post, SPACE, SPACE.init_params(**F64))
    jvp = {"loc": jnp.asarray([0.6]), "log_scale": jnp.asarray([-1.0])}
    key = jax.random.PRNGKey(3)
    expected = j_marginal.importance_sampling_marginal(
        key, jfam, jvp, j_log_post, n_samples=500)
    # the standard normals of the JAX family's sample_unconstrained
    eps = torch.as_tensor(np.array(jax.random.normal(key, (500, 1),
                                                     dtype=jnp.float64)))
    got = marginal.importance_sampling_marginal(
        None, fam, vparams_from_numpy(
            {k: np.asarray(v) for k, v in jvp.items()}, **F64), log_post,
        eps=eps, max_chains=128)
    np.testing.assert_allclose(got, expected, rtol=1e-10)


def test_bridge_sampling_matches_jax_on_the_same_draws():
    samples = np.random.default_rng(0).normal(0.6, 0.33, (400, 1))
    key = jax.random.PRNGKey(6)

    def j_log_unnorm(z):
        up = J_SPACE.unflatten_unconstrained(z)
        return j_log_post(J_SPACE.constrain(up)) + J_SPACE.log_jacobian(up)

    expected = j_marginal.bridge_sampling_marginal(
        jnp.asarray(samples), j_log_unnorm, J_SPACE, key)
    eps = torch.as_tensor(np.array(jax.random.normal(key, (400, 1),
                                                     dtype=jnp.float64)))
    got = marginal.bridge_sampling_marginal(
        torch.as_tensor(samples),
        lambda z: marginal.batched_values(log_post, SPACE, z, 128,
                                          jacobian=True),
        SPACE, eps=eps)
    np.testing.assert_allclose(got, expected, rtol=1e-10)


def test_fullrank_vb_and_is_on_the_conjugate_target():
    """tests/test_inference.py::test_vb_fullrank_and_is's schedule."""
    fam = vb.FullRankNormalVB(log_post, SPACE, SPACE.init_params(**F64))
    gen = torch.Generator().manual_seed(2)
    res = vb.fit(fam, gen, steps=3000, learning_rate=0.05, grad_samples=4,
                 elbo_samples=2000)
    np.testing.assert_allclose(res.elbo, log_evidence(), atol=0.1)
    est = marginal.importance_sampling_marginal(
        torch.Generator().manual_seed(3), fam, res.vparams, log_post,
        n_samples=4000)
    np.testing.assert_allclose(est, log_evidence(), atol=0.02)


def test_bridge_on_the_conjugate_target():
    """tests/test_inference.py::test_bridge: 20 000 MH iterations (here 4
    chains of 5 000 as one batch), every tenth kept."""
    res = mcmc.MCMC(SPACE, log_post).run(
        torch.Generator().manual_seed(5), SPACE.init_params(**F64),
        n_iter=5000, every=10, burnin=500, n_chains=4)
    su = torch.as_tensor(res.samples_u.reshape(-1, 1))
    est = marginal.bridge_sampling_marginal(
        su, lambda z: marginal.batched_values(log_post, SPACE, z,
                                              jacobian=True),
        SPACE, torch.Generator().manual_seed(6))
    np.testing.assert_allclose(est, log_evidence(), atol=0.05)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nested_sampling_on_the_conjugate_target(seed):
    def sample_prior(generator, n):
        return math.sqrt(T2) * torch.randn((n, 1), generator=generator,
                                           **F64)

    est = marginal.nested_sampling(torch.Generator().manual_seed(seed),
                                   SPACE, log_like, sample_prior, n_live=100,
                                   max_iter=3000)
    np.testing.assert_allclose(est, log_evidence(), atol=0.3)


def test_mixed_mcmc_bit_frequency():
    """x ~ N(2 b, 1) with P(b = 1) = 0.3: the bit's posterior is its
    prior."""
    space = ParamSpace([ParamSpec.scalar("x", 0.0)])

    def log_prob(params, bits):
        b = bits[..., 0]
        return (-0.5 * (params["x"] - 2.0 * b) ** 2
                + torch.where(b == 1, math.log(0.3), math.log(0.7)))

    out = mcmc.MixedMCMC(space, log_prob, n_bits=1, p_flip=0.4).run(
        torch.Generator().manual_seed(2), {"x": torch.tensor(0.0, **F64)},
        np.zeros(1), n_iter=5000, every=10, burnin=500, n_chains=8)
    assert out["bits"].shape == (500, 8, 1)
    assert out["samples_u"].shape == (500, 8, 1)
    assert abs(out["bits"].mean() - 0.3) < 0.06
    assert np.all(np.isfinite(out["log_posterior"]))
    assert 0.0 < out["acceptance"][-1] < 1.0


def _tiny_config(data_dir):
    """fluA-elbo.json's model and variational family on tests/data/tiny.fa
    with a dated caterpillar tree over its taxa, and the six actions."""
    with open(os.path.join(data_dir, "fluA-elbo.json")) as fh:
        cfg = json.load(fh)
    tlk = cfg["model"]["distributions"][0]
    tlk["sitepattern"]["alignment"]["file"] = "tiny.fa"
    with open(os.path.join(data_dir, "tiny.fa")) as fh:
        taxa = [ln[1:].strip() for ln in fh if ln.startswith(">")]
    dates = {t: tlk["tree"]["dates"][t] for t in taxa}
    top = max(dates.values())
    order = sorted(taxa, key=lambda t: top - dates[t])
    newick, h = order[0], top - dates[order[0]]
    for t in order[1:]:
        ht = top - dates[t]
        ph = max(h, ht) + 1.5
        newick = f"({newick}:{ph - h},{t}:{ph - ht})"
        h = ph
    tlk["tree"] = {"id": "tree", "type": "tree", "time": True,
                   "newick": newick + ";", "dates": dates,
                   "reparam": "tree.scalers"}
    cfg["varmodel"]["distributions"] = []
    cfg["physher"] = [
        {"id": "mcmc", "type": "mcmc", "model": "&posterior", "length": 40,
         "chains": 2,
         "log": [{"id": "ls", "type": "logger", "every": 10,
                  "file": "mc.site", "models": ["&treelikelihood"],
                  "sitewise": True}]},
        {"id": "cpo", "type": "cpo", "mcmc": "&mcmc"},
        {"id": "cpofile", "type": "cpo", "filename": "mc.site",
         "burnin": 1},
        {"id": "bridge", "type": "bridgesampling", "model": "&posterior",
         "length": 40, "burnin": 10, "chains": 2},
        {"id": "vb", "type": "optimizer", "algorithm": "sg",
         "model": "&varnormal", "max": 10},
        {"id": "is", "type": "is", "variational": "&varnormal",
         "samples": 40},
        {"id": "mc", "type": "mc", "model": "&posterior", "length": 40,
         "chains": 2},
        {"id": "nest", "type": "nest", "model": "&posterior", "points": 6,
         "max": 10},
        {"id": "pred", "type": "predictive", "model": "&treelikelihood",
         "samples": 3}]
    return cfg


_LINES = {
    "cpo": "LPML: ", "cpofile": "LPML: ",
    "bridge": "Bridge-sampling log marginal likelihood: ",
    "is": "IS log marginal likelihood: ",
    "mc": "MC log marginal likelihood: ",
    "nest": "Nested-sampling log evidence (approx): ",
    "pred": "posterior predictive p-value (pattern diversity): "}


def test_cli_actions_print_finite_values(data_dir, tmp_path):
    cfg = _tiny_config(data_dir)
    (tmp_path / "tiny.fa").symlink_to(os.path.join(data_dir, "tiny.fa"))
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    out = io.StringIO()
    runner = cli.run([str(tmp_path / "config.json"), "--device", "cpu"],
                     out=out)
    lines = out.getvalue().splitlines()
    for prefix in _LINES.values():
        hits = [ln for ln in lines if ln.startswith(prefix)]
        assert hits, prefix
        for ln in hits:
            assert np.isfinite(float(ln[len(prefix):].split()[0])), ln
    res = runner.results
    for key in ("bridge", "is", "mc", "nest", "pred"):
        assert np.isfinite(res[key]), key
    log_cpo, lpml = res["cpo"]
    assert log_cpo.shape == (runner.ctx.objects[
        "treelikelihood"].sp.pattern_count,)
    assert 0.0 <= res["pred"] <= 1.0

    # cpo's filename form: the JAX package's Runner on the same sitewise log
    jctx, _ = j_build_config(cfg, base_dir=str(tmp_path))
    jres = JRunner(jctx, seed=0, out=io.StringIO()).run([cfg["physher"][2]])
    np.testing.assert_allclose(res["cpofile"][1], jres["cpofile"][1],
                               rtol=1e-10)
    np.testing.assert_allclose(res["cpofile"][0], jres["cpofile"][0],
                               rtol=1e-10)


class _Stop(Exception):
    pass


@pytest.mark.parametrize("action,length", [("mc", 10000),
                                           ("bridgesampling", 20000)])
def test_chain_length_defaults_match_jax(monkeypatch, action, length):
    """A node without "length" runs the JAX package's default iterations
    (``action_mc`` 10 000, ``action_bridgesampling`` 20 000): a stub MCMC
    records what the action asks for and stops it before any chain runs."""
    from physher_tpu_torch.config import actions
    from physher_tpu_torch.config.builder import Context

    asked = {}

    class StubMCMC:
        def __init__(self, space, log_prob):
            pass

        def run(self, generator, params, *, n_iter, **kw):
            asked["n_iter"] = n_iter
            raise _Stop

    class Model:
        def param_space(self):
            return SPACE

        def log_prob(self, params):
            return log_post(params)

    monkeypatch.setattr(actions.mcmc_mod, "MCMC", StubMCMC)
    runner = actions.Runner(Context(**F64), out=io.StringIO())
    with pytest.raises(_Stop):
        getattr(runner, f"action_{action}")({"model": Model()})
    assert asked["n_iter"] == length
