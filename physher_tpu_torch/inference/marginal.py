"""Marginal-likelihood estimation from tempered chains.

Port of the harmonic-mean, stepping-stone and path-sampling estimators, the
tempered ladder and ``marginal_likelihood`` of
``physher_tpu/inference/marginal.py`` (reference: src/phyc/marginal.c:30-140,
src/phyc/mmcmc.c tempered-chain driver). The estimators are host-side
numpy over the recorded samples. The ladder runs as ONE batched MCMC, the
temperatures on the chain axis (the reference runs them one after the
other, mmcmc.c:48-88). Importance sampling, bridge sampling, Laplace and
nested sampling are not ported yet (ROADMAP Queue 1 item 13).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..models.parameters import ParamSpace
from .mcmc import MCMC


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
