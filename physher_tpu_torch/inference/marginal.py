"""Marginal-likelihood estimation from tempered chains.

Port of the harmonic-mean, stepping-stone and path-sampling estimators, the
tempered ladder and ``marginal_likelihood`` of
``physher_tpu/inference/marginal.py`` (reference: src/phyc/marginal.c:30-140,
src/phyc/mmcmc.c tempered-chain driver). The estimators are host-side
numpy over the recorded samples. The ladder runs as ONE batched MCMC, the
temperatures on the chain axis (the reference runs them one after the
other, mmcmc.c:48-88). The Laplace estimates (reference:
src/phyc/laplace.c) take their second derivatives from ``ml.hessian``'s
batched central differences of the exact gradient. Importance sampling,
bridge sampling and nested sampling are not ported yet (ROADMAP Queue 1
item 13).
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
from .ml import batched_value_and_grad, hessian


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
    itself (``ml.batched_value_and_grad``). Its truncation (h^4) and
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

    values, G = batched_value_and_grad(f, rows, max_chains)
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
