"""Descriptive statistics + MCMC chain diagnostics.

A copy of ``physher_tpu/utils/stats.py`` (numpy only). Rebuild of the reference's statistics toolkit (reference:
src/phyc/statistics.c mean/variance/covariance/correlation,
src/phyc/descriptivestats.c median/quantiles/percentiles,
src/phyc/combinatorics.c choose). Adds the chain diagnostics the reference
lacks but any MCMC user needs: effective sample size (initial monotone
positive-pair estimator) and split-R-hat.
"""

from __future__ import annotations

import math

import numpy as np


# -- descriptive (statistics.c / descriptivestats.c) -------------------------

def mean(x) -> float:
    return float(np.mean(x))


def variance(x, ddof: int = 1) -> float:
    return float(np.var(x, ddof=ddof))


def standard_deviation(x, ddof: int = 1) -> float:
    return float(np.std(x, ddof=ddof))


def covariance(x, y, ddof: int = 1) -> float:
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    return float(((x - x.mean()) * (y - y.mean())).sum() / (len(x) - ddof))


def correlation(x, y) -> float:
    return float(np.corrcoef(np.asarray(x), np.asarray(y))[0, 1])


def median(x) -> float:
    return float(np.median(x))


def quantile(x, q) -> float:
    return float(np.quantile(np.asarray(x), q))


def percentiles(x, ps=(2.5, 25.0, 50.0, 75.0, 97.5)):
    return {p: float(np.percentile(np.asarray(x), p)) for p in ps}


def choose(n: int, k: int) -> int:
    """Binomial coefficient (reference: combinatorics.c)."""
    return math.comb(n, k)


# -- chain diagnostics -------------------------------------------------------

def autocorrelation(x, max_lag: int | None = None) -> np.ndarray:
    """Normalized autocorrelation function via FFT."""
    x = np.asarray(x, dtype=np.float64)
    n = len(x)
    if max_lag is None:
        max_lag = n - 1
    xc = x - x.mean()
    nfft = 1 << (2 * n - 1).bit_length()
    f = np.fft.rfft(xc, nfft)
    acov = np.fft.irfft(f * np.conj(f), nfft)[: max_lag + 1]
    if acov[0] <= 0:
        return np.zeros(max_lag + 1)
    return acov / acov[0]


def effective_sample_size(x) -> float:
    """ESS via the initial monotone positive-pair sequence (Geyer 1992)."""
    x = np.asarray(x, dtype=np.float64)
    n = len(x)
    if n < 4 or np.var(x) == 0:
        return float(n)
    rho = autocorrelation(x)
    # pair sums rho[2k] + rho[2k+1]; keep while positive and decreasing
    tau = 1.0
    prev = np.inf
    for k in range(1, (n - 1) // 2):
        pair = rho[2 * k - 1] + rho[2 * k]
        if pair < 0:
            break
        pair = min(pair, prev)
        prev = pair
        tau += 2.0 * pair
    return float(n / max(tau, 1.0))


def split_r_hat(chains) -> float:
    """Split-R-hat over [n_chains, n_samples] draws (Gelman et al.)."""
    x = np.asarray(chains, dtype=np.float64)
    if x.ndim == 1:
        x = x[None, :]
    m, n = x.shape
    half = n // 2
    halves = np.concatenate([x[:, :half], x[:, half: 2 * half]], axis=0)
    m2, n2 = halves.shape
    means = halves.mean(axis=1)
    W = halves.var(axis=1, ddof=1).mean()
    B = n2 * means.var(ddof=1)
    var_plus = (n2 - 1) / n2 * W + B / n2
    if W == 0:
        return 1.0
    return float(np.sqrt(var_plus / W))


def jenks_breaks(data, n_classes: int) -> np.ndarray:
    """Jenks natural-breaks classification: assign each value to one of
    ``n_classes`` minimizing within-class variance (reference:
    src/phyc/classification.c classification_Jenks_breaks — used to bin
    branch rates into discrete classes). Returns int class ids aligned
    with ``data``. Dynamic-programming (Fisher) exact algorithm.
    """
    x = np.sort(np.asarray(data, dtype=np.float64))
    n = len(x)
    k = min(n_classes, n)
    # dp[m][j]: minimal SSE for first m points in j classes
    csum = np.concatenate([[0.0], np.cumsum(x)])
    csum2 = np.concatenate([[0.0], np.cumsum(x * x)])

    def sse(i, j):
        # points i..j-1 (0-based, half-open)
        s = csum[j] - csum[i]
        s2 = csum2[j] - csum2[i]
        cnt = j - i
        return s2 - s * s / cnt

    INF = np.inf
    dp = np.full((k + 1, n + 1), INF)
    back = np.zeros((k + 1, n + 1), dtype=np.int64)
    dp[0, 0] = 0.0
    for j in range(1, k + 1):
        for m in range(j, n + 1):
            best, bi = INF, j - 1
            for i in range(j - 1, m):
                v = dp[j - 1, i] + sse(i, m)
                if v < best:
                    best, bi = v, i
            dp[j, m] = best
            back[j, m] = bi
    # recover break positions in sorted order
    bounds = []
    m = n
    for j in range(k, 0, -1):
        bounds.append(m)
        m = back[j, m]
    bounds = bounds[::-1]
    cls_sorted = np.zeros(n, dtype=np.int64)
    start = 0
    for ci, end in enumerate(bounds):
        cls_sorted[start:end] = ci
        start = end
    order = np.argsort(np.asarray(data, dtype=np.float64), kind="stable")
    out = np.empty(n, dtype=np.int64)
    out[order] = cls_sorted
    return out


def summarize(samples: dict, weights=None) -> dict:
    """Per-parameter {mean, sd, median, 2.5%, 97.5%, ess} table from a dict
    of [S, ...] arrays (e.g. MCMCResult.to_dict_of_arrays())."""
    out = {}
    for name, arr in samples.items():
        a = np.asarray(arr, dtype=np.float64)
        flat = a.reshape(a.shape[0], -1) if a.ndim > 1 else a[:, None]
        for j in range(flat.shape[1]):
            col = flat[:, j]
            key = name if flat.shape[1] == 1 else f"{name}[{j}]"
            out[key] = {
                "mean": float(col.mean()),
                "sd": float(col.std(ddof=1)) if len(col) > 1 else 0.0,
                "median": float(np.median(col)),
                "2.5%": float(np.percentile(col, 2.5)),
                "97.5%": float(np.percentile(col, 97.5)),
                "ess": effective_sample_size(col),
            }
    return out
