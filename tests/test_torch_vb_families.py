"""``inference/vb.py`` beyond the normal families' one-draw steps, on the
CPU in float64:

- the gamma and Weibull mean-field families: ``log_q``, ``entropy`` and
  ``sample`` (the constrained draws and log q less the log-Jacobian) equal
  the JAX package's at the same variational parameters and the same
  standard draws, 1e-12 relative;
- the ELBO's draws as one batch of chains: on the checkpoint B model
  (tests/data/fluA-elbo.json) the batched ELBO and its gradient equal the
  per-draw loop at 1e-12 (1e-10 for the gradient), also when the batch is
  cut into chunks; the config builder sets the chunk from
  ``ml.hessian_chunk``;
- the gamma and Weibull fits and ``fit_klpq`` converge on the tractable
  targets of tests/test_resampling_stats_vi.py (Gamma(10, 5): mean 2; a
  lognormal; the forward-KL fit's location), at those tests' tolerances
  and schedules.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physher_tpu.inference import vb as j_vb
from physher_tpu.models.parameters import ParamSpace as JParamSpace
from physher_tpu.models.parameters import ParamSpec as JParamSpec
from physher_tpu_torch.config.builder import build_config, load_json
from physher_tpu_torch.inference import ml, vb
from physher_tpu_torch.models.distributions import (
    gamma_logpdf, lognormal_logpdf)
from physher_tpu_torch.models.parameters import (
    ParamSpace, ParamSpec, vparams_from_numpy)

KW = dict(dtype=torch.float64, device="cpu")


def _space():
    return ParamSpace([ParamSpec.vector("x", np.array([1.0, 1.0]),
                                        lower=0.0)])


def _jax_standard_draws(name, vparams, key, n, dim):
    """The draws inside the JAX family's ``sample_unconstrained``."""
    if name == "GammaMeanFieldVB":
        return jax.random.gamma(key, jnp.exp(vparams["log_alpha"]), (n, dim),
                                dtype=jnp.float64)
    return jax.random.uniform(key, (n, dim), dtype=jnp.float64,
                              minval=1e-12, maxval=1.0 - 1e-12)


@pytest.mark.parametrize("name", ["GammaMeanFieldVB", "WeibullMeanFieldVB"])
def test_family_matches_jax(name):
    jspace = JParamSpace([JParamSpec.vector("x", np.array([1.0, 1.0]),
                                            lower=0.0)])
    jfam = getattr(j_vb, name)(lambda p: 0.0, jspace,
                               {"x": jnp.asarray([1.5, 0.7])})
    fam = getattr(vb, name)(lambda p: torch.zeros(()), _space(),
                            {"x": torch.tensor([1.5, 0.7], **KW)})
    jvp = {k: v + jnp.asarray([0.1, -0.2]) for k, v in jfam.init.items()}
    vp = vparams_from_numpy({k: np.asarray(v) for k, v in jvp.items()}, **KW)
    for k in jfam.init:
        np.testing.assert_allclose(fam.init[k].numpy(),
                                   np.asarray(jfam.init[k]), rtol=1e-12)
    key = jax.random.PRNGKey(4)
    jparams, jlogq = jfam.sample(jvp, key, 7)
    eps = torch.as_tensor(np.array(_jax_standard_draws(name, jvp, key, 7,
                                                         2)))
    params, logq = fam.sample(vp, n=7, eps=eps)
    np.testing.assert_allclose(params["x"].numpy(), np.asarray(jparams["x"]),
                               rtol=1e-12)
    np.testing.assert_allclose(logq.numpy(), np.asarray(jlogq), rtol=1e-12)
    z = jfam.sample_unconstrained(jvp, key, 7)
    np.testing.assert_allclose(
        fam.log_q(vp, torch.as_tensor(np.array(z))).numpy(),
        np.asarray(jfam.log_q(jvp, z)), rtol=1e-12)
    np.testing.assert_allclose(float(fam.entropy(vp)),
                               float(jfam.entropy(jvp)), rtol=1e-12)


@pytest.fixture(scope="module")
def elbo_b(data_dir):
    cfg = load_json(os.path.join(data_dir, "fluA-elbo.json"))
    ctx, _ = build_config(cfg, base_dir=data_dir, **KW)
    return ctx


def test_builder_sets_the_batch_chunk(elbo_b):
    fam = elbo_b.objects["varnormal"].family
    post = elbo_b.objects["posterior"]
    assert fam.max_chains == ml.hessian_chunk(post) > 100


def test_batched_elbo_equals_draw_loop(elbo_b):
    """The checkpoint B model: the ELBO over 5 draws as one batch (and in
    chunks of 2 rows) against the parent's loop of one-chain targets, and
    the gradient of the batch (a grad_samples = 5 step) against the mean of
    the per-draw gradients."""
    fam = elbo_b.objects["varnormal"].family
    vparams = {k: v.clone().requires_grad_(True) for k, v in
               fam.init.items()}
    eps = fam.draw(vparams, torch.Generator().manual_seed(3), 5)
    batched = fam.elbo(vparams, eps=eps)
    g_batch = torch.autograd.grad(batched, list(vparams.values()))
    z = fam.sample_unconstrained(vparams, eps)
    loop = sum(fam._target(zi) for zi in z) / 5 + fam.entropy(vparams)
    g_loop = torch.autograd.grad(loop, list(vparams.values()))
    np.testing.assert_allclose(float(batched.detach()), float(loop.detach()),
                               rtol=1e-12)
    for a, b in zip(g_batch, g_loop):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10,
                                   atol=1e-10 * float(b.abs().max()))
    chunked = vb.MeanFieldNormalVB(fam.log_prob, fam.space,
                                   elbo_b.objects["varnormal"].params,
                                   max_chains=2)
    with torch.no_grad():
        np.testing.assert_allclose(
            float(chunked.elbo(vparams, eps=eps)), float(batched),
            rtol=1e-12)


def test_variational_handle_elbo_matches_jax():
    """``VariationalHandle.elbo`` over a mean-field normal on a two-
    parameter target: at the handle's own parameters and ``elbo_samples``,
    and at given ones, against the JAX handle's at its key's standard
    draws (float64, 1e-12); from a generator, the family's ELBO over the
    generator's draws."""
    from physher_tpu.config.variational import (
        VariationalHandle as JVariationalHandle)
    from physher_tpu_torch.config.variational import VariationalHandle

    def log_prob(p):
        return -0.5 * ((p["x"] - 1.2) ** 2).sum(-1) - p["x"].sum(-1)

    jspace = JParamSpace([JParamSpec.vector("x", np.array([1.0, 1.0]),
                                            lower=0.0)])
    jparams = {"x": jnp.asarray([1.5, 0.7])}
    params = {"x": torch.tensor([1.5, 0.7], **KW)}
    jfam = j_vb.MeanFieldNormalVB(log_prob, jspace, jparams)
    fam = vb.MeanFieldNormalVB(log_prob, _space(), params)
    jh = JVariationalHandle(jfam, None, jspace, jparams, elbo_samples=6)
    h = VariationalHandle(fam, None, _space(), params, elbo_samples=6)
    key = jax.random.PRNGKey(7)
    jvp = {"loc": jnp.asarray([0.2, -0.4]),
           "log_scale": jnp.asarray([-0.5, 0.1])}
    vp = vparams_from_numpy({k: np.asarray(v) for k, v in jvp.items()},
                            **KW)
    for j_vparams, vparams, n in ((None, None, None), (jvp, vp, 9)):
        eps = jax.random.normal(key, (n or 6, 2), dtype=jnp.float64)
        np.testing.assert_allclose(
            float(h.elbo(vparams=vparams, n_samples=n,
                         eps=torch.as_tensor(np.array(eps)))),
            float(jh.elbo(key, j_vparams, n)), rtol=1e-12)
    got = h.elbo(torch.Generator().manual_seed(5), vp, 9)
    eps = fam.draw(vp, torch.Generator().manual_seed(5), 9)
    assert float(got) == float(fam.elbo(vp, eps=eps))


def test_gamma_family_recovers_gamma_target():
    def log_prob(params):
        return gamma_logpdf(params["x"], 10.0, rate=5.0).sum(-1)

    fam = vb.GammaMeanFieldVB(log_prob, _space(),
                              {"x": torch.full((2,), 2.0, **KW)})
    res = vb.fit(fam, torch.Generator().manual_seed(0), steps=800,
                 learning_rate=0.05, grad_samples=8, elbo_every=100)
    alpha = np.exp(res.vparams["log_alpha"].numpy())
    beta = np.exp(res.vparams["log_beta"].numpy())
    np.testing.assert_allclose(alpha / beta, 2.0, rtol=0.1)
    np.testing.assert_allclose(alpha, 10.0, rtol=0.35)


def test_weibull_family_moments():
    def log_prob(params):
        return lognormal_logpdf(params["x"], 0.0, 0.3).sum(-1)

    fam = vb.WeibullMeanFieldVB(log_prob, _space(),
                                {"x": torch.ones(2, **KW)})
    res = vb.fit(fam, torch.Generator().manual_seed(1), steps=800,
                 learning_rate=0.05, grad_samples=8, elbo_every=100)
    params, _ = fam.sample(res.vparams, torch.Generator().manual_seed(2),
                           4000)
    assert abs(float(params["x"].mean()) - np.exp(0.045)) < 0.12


def test_klpq_fit():
    def log_prob(params):
        # a lognormal(1.0, 0.5) target on each coordinate
        x = params["x"]
        return torch.sum(-0.5 * ((torch.log(x) - 1.0) / 0.5) ** 2
                         - torch.log(x), -1)

    fam = vb.MeanFieldNormalVB(log_prob, _space(), {"x": torch.ones(2, **KW)})
    res = vb.fit_klpq(fam, torch.Generator().manual_seed(0), steps=600,
                      learning_rate=0.05, n_samples=64)
    np.testing.assert_allclose(res.vparams["loc"].numpy(), 1.0, atol=0.2)
    assert np.isfinite(res.elbo)
