"""Pairwise distance matrices (uncorrected, JC69, K2P, Kimura-protein).

Rebuild of the reference's distance layer (reference:
src/phyc/distancematrix.c:70-330). Pairwise deletion: sites where either
sequence has an ambiguity/gap (encoding >= state_count) are skipped; fully
undefined pairs get distance 1000 (reference: distancematrix.c:101-105).
Vectorized with NumPy (host-side; distances only seed starting trees).
"""

from __future__ import annotations

import numpy as np

from .sitepattern import SitePattern


def _mismatch_fraction(sp: SitePattern):
    codes = sp.codes  # [T, P]
    w = sp.weights
    S = sp.datatype.state_count
    valid = codes < S  # [T, P]
    T = codes.shape[0]
    d = np.zeros((T, T))
    n = np.zeros((T, T))
    for i in range(T):
        vi = valid[i]
        ci = codes[i]
        both = vi[None, :] & valid  # [T, P]
        mism = both & (ci[None, :] != codes)
        n[i] = (both * w[None, :]).sum(1)
        d[i] = (mism * w[None, :]).sum(1)
    return d, n


def distance_matrix(sp: SitePattern, model: str = "uncorrected") -> np.ndarray:
    """[T, T] symmetric distances; rows follow ``sp.taxa`` order."""
    d, n = _mismatch_fraction(sp)
    with np.errstate(divide="ignore", invalid="ignore"):
        p = np.where(n > 0, d / np.maximum(n, 1), np.nan)
    model = model.lower()
    if model in ("uncorrected", "raw"):
        out = np.where(n > 0, p, 1000.0)
    elif model == "jc69":
        # d = -3/4 ln(1 - 4/3 p); saturated pairs -> 1000
        # (reference: distancematrix.c:226-260)
        with np.errstate(invalid="ignore"):
            out = np.where(
                (n > 0) & (p < 0.75), -0.75 * np.log(1.0 - (4.0 / 3.0) * p),
                1000.0,
            )
    elif model == "k2p":
        out = _k2p(sp)
    elif model == "kimura":
        # protein Kimura correction: d = -ln(1 - p - p^2/5)
        with np.errstate(invalid="ignore"):
            arg = 1.0 - p - 0.2 * p * p
            out = np.where((n > 0) & (arg > 0), -np.log(arg), 1000.0)
    else:
        raise ValueError(f"unknown distance model {model!r}")
    np.fill_diagonal(out, 0.0)
    return out


def _k2p(sp: SitePattern) -> np.ndarray:
    """Kimura 2-parameter distance (transitions vs transversions)."""
    codes = sp.codes
    w = sp.weights
    valid = codes < 4
    purine = (codes == 0) | (codes == 2)
    T = codes.shape[0]
    out = np.zeros((T, T))
    for i in range(T):
        both = valid[i][None, :] & valid
        mism = both & (codes[i][None, :] != codes)
        ts = mism & (purine[i][None, :] == purine)  # same class = transition
        n = (both * w[None, :]).sum(1)
        P = np.where(n > 0, (ts * w[None, :]).sum(1) / np.maximum(n, 1), 0)
        Q = np.where(n > 0, ((mism & ~ts) * w[None, :]).sum(1) / np.maximum(n, 1), 0)
        with np.errstate(invalid="ignore", divide="ignore"):
            a = 1.0 - 2.0 * P - Q
            b = 1.0 - 2.0 * Q
            di = -0.5 * np.log(a) - 0.25 * np.log(b)
        out[i] = np.where((n > 0) & (a > 0) & (b > 0), di, 1000.0)
    np.fill_diagonal(out, 0.0)
    return out
