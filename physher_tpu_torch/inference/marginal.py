"""Marginal-likelihood estimation.

Port of ``physher_tpu/inference/marginal.py`` (reference:
src/phyc/marginal.c:30-140 harmonic means, stepping stone and path
sampling, src/phyc/mmcmc.c tempered chains, src/phyc/is.c importance
sampling, src/phyc/bridge.c bridge sampling, src/phyc/laplace.c Laplace,
src/phyc/nest.c nested sampling). The estimators are host-side numpy over
the recorded values. The ladder runs as ONE batched MCMC, the temperatures
on the chain axis (the reference runs them one after the other,
mmcmc.c:48-88). Where the JAX package ``vmap``s a target over many points
(importance sampling's proposal draws, bridge sampling's posterior and
proposal draws, nested sampling's live points), the port hands the model
the points as batches of chains of at most ``max_chains`` rows: on the card
one K5' launch a batch. The Laplace estimates take their second derivatives
from ``ml.hessian``'s batched central differences of the exact gradient.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..models.distributions import (
    beta_logpdf, betaprime_logpdf, gamma_logpdf, lognormal_logpdf)
from ..models.parameters import ParamBatch, ParamSpace
from ..ops.loop import MAX_CHAINS
from .mcmc import MCMC
from .ml import batched_rows, hessian


def _logsumexp(v: np.ndarray) -> float:
    m = np.max(v)
    return float(m + np.log(np.sum(np.exp(v - m))))


def log_arithmetic_mean(loglikes) -> float:
    v = np.asarray(loglikes, np.float64)
    return _logsumexp(v) - math.log(v.shape[0])


def log_harmonic_mean(loglikes) -> float:
    """(reference: marginal.c:33-47)"""
    v = np.asarray(loglikes, np.float64)
    return math.log(v.shape[0]) - _logsumexp(-v)


def log_smoothed_harmonic_mean(logP, loglikes, delta=0.01) -> float:
    """One update of the stabilized harmonic mean (reference:
    marginal.c:49-64, Newton & Raftery 1994)."""
    v = np.asarray(loglikes, np.float64)
    n = v.shape[0]
    ldelta = math.log(delta)
    l1 = math.log(1.0 - delta)
    norm = -np.logaddexp(ldelta, l1 + v - logP)
    num = np.logaddexp(math.log(n) + ldelta - l1 + logP,
                       _logsumexp(norm + v))
    denom = np.logaddexp(math.log(n) + ldelta - l1, _logsumexp(norm))
    return float(num - denom)


def log_stabilized_harmonic_mean(loglikes, delta=0.01, guess=None) -> float:
    """Fixed-point iteration (reference: marginal.c:66-75)."""
    logP = float(guess if guess is not None else log_harmonic_mean(loglikes))
    prev = np.inf
    for _ in range(10000):
        logP = log_smoothed_harmonic_mean(logP, loglikes, delta)
        if abs(logP - prev) < 1e-7:
            break
        prev = logP
    return logP


def log_stepping_stone(loglikes_per_temp, temperatures):
    """Stepping-stone estimator (reference: marginal.c:77-93; Xie et al 2011).

    ``loglikes_per_temp[i]`` are log-likelihood samples at temperatures[i];
    temperatures sorted INCREASING (prior 0.0 ... posterior 1.0). Returns
    (total log marginal-likelihood ratio, per-step contributions).
    """
    temps = np.asarray(temperatures)
    steps = []
    for i in range(1, len(temps)):
        dt = temps[i] - temps[i - 1]
        ll = np.asarray(loglikes_per_temp[i - 1], np.float64)
        m = np.max(dt * ll)
        steps.append(float(m + np.log(np.mean(np.exp(dt * ll - m)))))
    return float(np.sum(steps)), steps


def log_path_sampling(loglikes_per_temp, temperatures):
    """Trapezoidal path sampling / thermodynamic integration (reference:
    marginal.c:95-112; Lartillot & Philippe 2006)."""
    temps = np.asarray(temperatures)
    means = np.array([np.mean(np.asarray(v, np.float64))
                      for v in loglikes_per_temp])
    steps = 0.5 * (means[1:] + means[:-1]) * np.diff(temps)
    return float(steps.sum()), list(steps)


def log_path_sampling_modified(loglikes_per_temp, temperatures):
    """Modified path sampling with variance correction (reference:
    marginal.c path2 variant, second-order quadrature)."""
    temps = np.asarray(temperatures)
    means = np.array([np.mean(np.asarray(v, np.float64))
                      for v in loglikes_per_temp])
    vars_ = np.array([np.var(np.asarray(v, np.float64))
                      for v in loglikes_per_temp])
    dt = np.diff(temps)
    steps = 0.5 * (means[1:] + means[:-1]) * dt - (dt ** 2) / 12.0 * (
        vars_[1:] - vars_[:-1])
    return float(steps.sum()), list(steps)


def ladder_temperatures(n_temps: int, distribution_power: float = 0.3):
    """The Beta(power, 1) quantile spacing the reference and BEAST use:
    t_i = (i / (K - 1))^(1 / power), increasing from 0 to 1."""
    i = np.arange(n_temps)
    return (i / (n_temps - 1)) ** (1.0 / distribution_power)


def run_tempered_ladder(generator: torch.Generator, space: ParamSpace,
                        log_like, log_prior, params, *, n_temps=16,
                        n_iter=20000, every=10, burnin=2000,
                        distribution_power=0.3, log_ref=None, **mcmc_kw):
    """Run the whole temperature ladder as one batched MCMC (one chain per
    temperature). With ``log_ref`` the ladder is the generalized-stepping-
    stone path (like*prior)^T * ref^(1-T) (reference: mmcmc.c GSS mode) and
    the recorded statistic is log(like*prior/ref). Returns (temperatures,
    loglikes [K lists of S], mcmc result)."""
    temps = ladder_temperatures(n_temps, distribution_power)
    mcmc = MCMC(space, log_like=log_like, log_prior=log_prior,
                log_ref=log_ref, **mcmc_kw)
    res = mcmc.run(generator, params, n_iter=n_iter, every=every,
                   temperatures=temps, burnin=burnin)
    lls = [res.log_likelihood[:, k] for k in range(n_temps)]
    return temps, lls, res


def marginal_likelihood(generator, space, log_like, log_prior, params,
                        method="stepping", **kw):
    """End-to-end GSS/SS/PS marginal likelihood (reference: mmcmc.c +
    marginal.c orchestration). method='gss' requires ``log_ref=`` (the
    working distribution, normalized)."""
    if method == "gss" and kw.get("log_ref") is None:
        raise ValueError("gss needs log_ref")
    temps, lls, res = run_tempered_ladder(generator, space, log_like,
                                          log_prior, params, **kw)
    if method in ("stepping", "ss", "gss"):
        val, steps = log_stepping_stone(lls, temps)
    elif method in ("path", "ps"):
        val, steps = log_path_sampling(lls, temps)
    elif method in ("path2",):
        val, steps = log_path_sampling_modified(lls, temps)
    else:
        raise ValueError(method)
    return val, {"temperatures": temps, "steps": steps, "mcmc": res}


def laplace_marginal(log_prob, space: ParamSpace, map_params,
                     max_chains: int = MAX_CHAINS) -> float:
    """Laplace approximation at the MAP using the unconstrained-space
    Hessian of logP + log|J| (reference: src/phyc/laplace.c — the reference
    fits per-parameter gamma/lognormal/beta envelopes; the
    normal-on-unconstrained-space form here is its multivariate-normal
    variant)."""
    H, value, _ = hessian(log_prob, space, map_params, jacobian=True,
                          max_chains=max_chains)
    d = H.shape[0]
    _, logdet = torch.linalg.slogdet(-H)
    return float(value + 0.5 * d * math.log(2 * math.pi) - 0.5 * logdet)


def laplace_marginal_fitted(log_prob, space: ParamSpace, map_params,
                            family: str = "gamma", names=None,
                            max_chains: int = MAX_CHAINS) -> float:
    """Laplace marginal likelihood with per-parameter univariate envelopes.

    Mirrors the reference's non-Gaussian Laplace variants
    (src/phyc/laplace.c:189-330 gamma, 561-700 lognormal, 81-133 beta,
    853-918 betaprime): each selected parameter gets a density q fitted so
    that its mode and curvature at the MAP match logP, and

        log Z ~= logP(MAP) - sum_i log q_i(m_i).

    The reference refines hard cases (tiny branch lengths) with a Brent
    least-squares refit over 10 probe points; here those cases use the same
    closed-form fallbacks it starts from (exponential-shape envelopes).

    ``names``: parameter names to fit (default: every free non-simplex
    spec). The curvature is the diagonal of the constrained-space Hessian,
    the reference's per-Parameter ``d2logP``: the five-point central
    difference of the exact gradient at ``m_i (1 +- h)`` and ``m_i (1 +-
    2h)``, ``h = eps^(1/4)``, every point a row of one batch with the MAP
    itself (``ml.batched_rows``). Its truncation (h^4) and
    rounding (eps / h) keep the exact families' normalizers to 1e-10 in
    float64, where the three-point difference's eps^(2/3) does not.
    """
    specs = [s for s in space.free_specs() if s.transform != "simplex"
             and (names is None or s.name in names)]
    m = torch.cat([map_params[s.name].detach().reshape(-1) for s in specs])
    k = m.numel()
    scale = torch.where(m != 0, m.abs(), torch.ones_like(m))
    h = (torch.finfo(m.dtype).eps ** 0.25 * scale)[:, None] * torch.eye(
        k, dtype=m.dtype, device=m.device)
    rows = torch.cat([m + h, m - h, m + 2 * h, m - 2 * h, m[None]])

    def f(rows):
        L = rows.shape[0]
        p = {n: v.detach().expand((L,) + v.shape)
             for n, v in map_params.items()}
        i = 0
        for s in specs:
            shape = map_params[s.name].shape
            n = s.size
            p[s.name] = rows[:, i:i + n].reshape((L,) + shape)
            i += n
        return log_prob(ParamBatch(p, (L,)))

    values, G = batched_rows(f, rows, max_chains, grad=True)
    # the differences and the steps as the rows hold them after rounding
    g1, g2, g3, g4 = (G[i * k: (i + 1) * k].diagonal() for i in range(4))
    x1, x2, x3, x4 = (rows[i * k: (i + 1) * k].diagonal().to(
        torch.float64).cpu() for i in range(4))
    d2 = (8.0 * (g1 - g2) - (g3 - g4)) / (4.0 * (x1 - x2) + (x3 - x4))
    d1, logp0 = G[-1], values[-1]
    m = m.to(torch.float64).cpu()

    def where(c, a, b):
        return torch.where(c, torch.as_tensor(a, dtype=m.dtype),
                           torch.as_tensor(b, dtype=m.dtype))

    if family == "gamma":
        # rate = -f''(m)*m, shape = rate*m + 1 (laplace.c:189-192)
        rate = -d2 * m
        shape = rate * m + 1.0
        bad = (m < 1e-6) | (d2 >= 0)
        rate = where(bad, d1.abs(), rate)
        shape = where(bad, 1.0, shape)
        corr = gamma_logpdf(m, shape=shape, rate=rate)
    elif family == "lognormal":
        # sigma = sqrt(-1/(f''(m) m^2)), mu = log m + sigma^2 (laplace.c:561)
        var = -1.0 / (d2 * m * m)
        mu = torch.log(m) + var
        bad = (m < 1e-6) | (d2 >= 0) | (mu > 5.0)
        # gamma fallback exactly as the reference (laplace.c:584-588)
        rate = where(bad, -d2 * m, 1.0)
        shape = rate * m + 1.0
        bad2 = bad & ((m < 1e-6) | (d2 >= 0))
        rate = where(bad2, d1.abs(), rate)
        shape = where(bad2, 1.0, shape)
        corr = where(
            bad, gamma_logpdf(m, shape=shape, rate=rate),
            lognormal_logpdf(m, mu=mu, sigma=torch.sqrt(var.abs())))
    elif family == "beta":
        # mode+curvature matched Beta: mode (alpha-1)/(alpha+beta-2) = m and
        # f''(m) = -(alpha-1)/m^2 - (beta-1)/(1-m)^2 solve to the closed form
        # below (the JAX package's form; the reference's algebra at
        # laplace.c:81-111 matches the mode but not the curvature)
        beta = 1.0 - d2 * m * (1.0 - m) ** 2
        alpha = 1.0 - d2 * m * m * (1.0 - m)
        corr = beta_logpdf(m, alpha=alpha, beta=beta)
    elif family == "betaprime":
        # alpha = 1 - f''(m) m^2 (m+1), beta = -f''(m) m (m+1) - 1
        # (laplace.c:853-856)
        alpha = 1.0 - d2 * m * m * (m + 1.0)
        beta = -d2 * m * (m + 1.0) - 1.0
        bad = beta < 0
        beta = where(bad, d1.abs() - 1.0, beta)
        alpha = where(bad, 1.0, alpha)
        corr = betaprime_logpdf(m, alpha=alpha, beta=beta)
    else:
        raise ValueError(f"unknown laplace family {family!r}")
    return float(logp0 - torch.sum(corr))


def batched_values(fn, space: ParamSpace, z: torch.Tensor,
                   max_chains: int = MAX_CHAINS, *,
                   jacobian: bool = False) -> torch.Tensor:
    """``fn`` of the constrained parameters at the unconstrained rows z
    ``[n, dim]`` -> ``[n, ...]`` (plus the transform's log-Jacobian with
    ``jacobian``), forward only: each chunk of at most ``max_chains`` rows
    one batch of chains through the model (``ml.batched_rows``)."""

    def values(zi):
        up = space.unflatten_unconstrained(zi)
        v = fn(space.constrain(up))
        return v + space.log_jacobian(up) if jacobian else v

    with torch.no_grad():
        return batched_rows(values, z, max_chains)


def importance_sampling_marginal(generator: torch.Generator, vb, vparams,
                                 log_prob, n_samples: int = 1000, *,
                                 eps=None,
                                 max_chains: int = MAX_CHAINS) -> float:
    """IS estimate of the marginal likelihood with a variational proposal
    (reference: src/phyc/is.c): ``n_samples`` draws of ``vb`` at
    ``vparams`` from ``generator``, or the given standard draws ``eps``
    ``[n, dim]``, their log-densities as batches (:func:`batched_values`)."""
    if eps is None:
        eps = vb.draw(vparams, generator, n_samples)
    with torch.no_grad():
        z = vb.sample_unconstrained(vparams, eps)
        logq = vb.log_q(vparams, z) - vb.space.log_jacobian(
            vb.space.unflatten_unconstrained(z))
    logp = batched_values(log_prob, vb.space, z, max_chains)
    w = (logp - logq).to(torch.float64).cpu()
    return float(torch.logsumexp(w, 0) - math.log(w.shape[0]))


def bridge_sampling_marginal(samples_u, log_unnorm, space: ParamSpace,
                             generator: torch.Generator = None,
                             n_proposal=None, max_iter=1000, tol=1e-10, *,
                             eps=None) -> float:
    """Iterative bridge sampling with a matched normal proposal
    (reference: src/phyc/bridge.c; Meng & Wong 1996).

    ``samples_u`` ``[S, dim]`` are posterior draws in the unconstrained
    space; ``log_unnorm(z)`` gives the unnormalized log-posterior (with the
    Jacobian) at the rows of z ``[n, dim]`` -> ``[n]``, as batches of chains.
    The proposal's ``n_proposal`` (default S) standard normal draws come
    from ``generator``, or are given as ``eps``. The fixed-point iteration
    runs on the host in float64, as in the JAX package."""
    su = torch.as_tensor(samples_u)
    S, d = su.shape
    if eps is None:
        eps = torch.randn((n_proposal or S, d), generator=generator,
                          dtype=su.dtype, device=su.device)
    eps = torch.as_tensor(eps, dtype=su.dtype, device=su.device)
    n_prop = eps.shape[0]
    with torch.no_grad():
        mu = torch.mean(su, 0)
        cov = torch.cov(su.T) + 1e-10 * torch.eye(d, dtype=su.dtype,
                                                   device=su.device)
        L = torch.linalg.cholesky(cov)
        log_det = torch.sum(torch.log(torch.diagonal(L)))

        def logg(z):
            y = torch.linalg.solve_triangular(L, (z - mu).T, upper=False).T
            return (-0.5 * (d * math.log(2 * math.pi) + torch.sum(y * y, -1))
                    - log_det)

        prop = mu + eps @ L.T
        l1 = (log_unnorm(su) - logg(su)).to(torch.float64).cpu()
        l2 = (log_unnorm(prop) - logg(prop)).to(torch.float64).cpu()
    s1 = S / (S + n_prop)
    s2 = n_prop / (S + n_prop)
    ls1, ls2 = math.log(s1), math.log(s2)
    logr = 0.0
    for _ in range(max_iter):
        r = torch.tensor(ls2 + logr, dtype=torch.float64)
        num = (torch.logsumexp(l2 - torch.logaddexp(ls1 + l2, r), 0)
               - math.log(n_prop))
        den = (torch.logsumexp(-torch.logaddexp(ls1 + l1, r), 0)
               - math.log(S))
        new = float(num - den)
        if abs(new - logr) < tol:
            logr = new
            break
        logr = new
    return logr


def nested_sampling(generator: torch.Generator, space: ParamSpace,
                    log_like, sample_prior, *, n_live=100, max_iter=10000,
                    tol=1e-4, mcmc_steps=20, step=0.2,
                    max_chains: int = MAX_CHAINS) -> float:
    """Nested sampling with random-walk replacement within the likelihood
    shell (reference: src/phyc/nest.c:116 nest_run).

    ``sample_prior(generator, n)`` gives ``[n, dim]`` unconstrained starts;
    their likelihoods are one batch of chains (:func:`batched_values`). Each
    replacement's ``mcmc_steps`` random-walk proposals stay serial, one
    one-chain likelihood a step, as in the JAX package's ``lax.scan``."""
    live_u = sample_prior(generator, n_live)
    ll = batched_values(log_like, space, live_u, max_chains)
    kw = dict(dtype=live_u.dtype, device=live_u.device)

    def replace(u, threshold):
        cur = torch.full((), -math.inf, **kw)
        with torch.no_grad():
            for _ in range(mcmc_steps):
                prop = u + step * torch.randn(u.shape, generator=generator,
                                              **kw)
                llp = log_like(space.constrain(
                    space.unflatten_unconstrained(prop)))
                ok = llp > threshold
                u = torch.where(ok, prop, u)
                cur = torch.where(ok, llp, cur)
        return u, cur

    logZ = -np.inf
    logw = math.log(1.0 - math.exp(-1.0 / n_live))
    for _ in range(max_iter):
        worst = int(torch.argmin(ll))
        l_worst = float(ll[worst])
        logZ = np.logaddexp(logZ, logw + l_worst)
        logw -= 1.0 / n_live
        # replace the worst with a draw above the threshold, seeded from a
        # random live point
        seed_idx = int(torch.randint(n_live, (1,), generator=generator,
                                     device=live_u.device))
        u_new, ll_new = replace(live_u[seed_idx], l_worst)
        if float(ll_new) <= l_worst:
            continue
        live_u[worst] = u_new
        ll[worst] = ll_new
        # termination: the remaining prior mass contributes < tol
        if logw + float(torch.max(ll)) < logZ + math.log(tol):
            break
    # the final live points' contribution
    ll_host = ll.to(torch.float64).cpu()
    logZ = np.logaddexp(
        logZ, float(torch.logsumexp(ll_host, 0)) - math.log(n_live)
        + logw + math.log(n_live) - 1.0)
    return float(logZ)
