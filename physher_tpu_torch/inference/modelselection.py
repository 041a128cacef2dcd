"""Information criteria and model comparison.

A copy of ``physher_tpu/inference/modelselection.py`` (numpy and scipy
only). Rebuild of the reference's model-selection helpers (reference:
src/phyc/modelselection.c:1-87 AIC/AICc/BIC/LRT) plus CPO and posterior
predictive checks (reference: src/phyc/cpo.c, predictive.c) computed from
sitewise log-likelihood samples, and IC-weighted model averaging (reference:
src/phyc/modelavg.c).
"""

from __future__ import annotations

import numpy as np
from scipy.stats import chi2


def aic(log_likelihood: float, k: int) -> float:
    return 2.0 * k - 2.0 * log_likelihood


def aicc(log_likelihood: float, k: int, n: int) -> float:
    return aic(log_likelihood, k) + 2.0 * k * (k + 1) / max(n - k - 1, 1)


def bic(log_likelihood: float, k: int, n: int) -> float:
    return k * np.log(n) - 2.0 * log_likelihood


def lrt(lnl_null: float, lnl_alt: float, df: int) -> dict:
    """Likelihood-ratio test (reference: modelselection.c LRT)."""
    stat = 2.0 * (lnl_alt - lnl_null)
    return {"statistic": float(stat), "df": df,
            "pvalue": float(chi2.sf(max(stat, 0.0), df))}


def ic_weights(values) -> np.ndarray:
    """Akaike/BIC weights from IC values (lower is better)."""
    v = np.asarray(values, dtype=np.float64)
    d = v - v.min()
    w = np.exp(-0.5 * d)
    return w / w.sum()


def cpo(sitewise_loglik_samples: np.ndarray, weights=None):
    """Conditional predictive ordinates from MCMC sitewise log-likelihoods.

    sitewise_loglik_samples: [S samples, P sites]; CPO_i = harmonic mean of
    per-sample site likelihoods (reference: src/phyc/cpo.c). Returns
    (per-site log CPO, sum = LPML).
    """
    m = np.asarray(sitewise_loglik_samples, dtype=np.float64)
    S = m.shape[0]
    # log CPO_i = log S - logsumexp(-loglik_i)
    mx = (-m).max(0)
    lse = mx + np.log(np.exp(-m - mx).sum(0))
    log_cpo = np.log(S) - lse
    if weights is not None:
        lpml = float((log_cpo * np.asarray(weights)).sum())
    else:
        lpml = float(log_cpo.sum())
    return log_cpo, lpml


def posterior_predictive_pvalue(observed_stat: float,
                                simulated_stats) -> float:
    """P(T(sim) >= T(obs)) (reference: src/phyc/predictive.c)."""
    sims = np.asarray(simulated_stats)
    return float((sims >= observed_stat).mean())
