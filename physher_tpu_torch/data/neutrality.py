"""Neutrality-test statistics: Watterson's theta, Tajima's D, Fu & Li D*/F*.

A copy of ``physher_tpu/data/neutrality.py`` (numpy only). Rebuild of the reference's neutrality tests (reference:
src/phyc/neutralitytest.h:22-31, neutralitytest.c:27-216). Vectorized over
sites with numpy — these are O(sequences x sites) one-shot statistics, not
device hot paths. The reference's singleton counter transposes its sequence/site
indices (neutralitytest.c:146-152); here the intended definition is used: a
site is a singleton site when its second-most-frequent nucleotide occurs in
exactly one sequence.
"""

from __future__ import annotations

import numpy as np

_NUC = {"A": 0, "C": 1, "G": 2, "T": 3}


def _matrix(seqs: dict) -> np.ndarray:
    """[n_seqs, n_sites] int8; non-ACGT -> -1 (ignored for counts)."""
    rows = []
    for s in seqs.values():
        rows.append([_NUC.get(c.upper(), -1) for c in s])
    return np.asarray(rows, dtype=np.int8)


def mean_pairwise_differences(seqs: dict) -> float:
    """pi: mean number of pairwise differences (neutralitytest.c:27-47)."""
    M = _matrix(seqs)
    n = M.shape[0]
    total = 0.0
    for i in range(n):
        total += (M[i + 1:] != M[i]).sum()
    return total / (n * (n - 1) / 2.0)


def segregating_sites(seqs: dict) -> int:
    """S: number of polymorphic columns (neutralitytest.c:49-65)."""
    M = _matrix(seqs)
    return int((M != M[0]).any(axis=0).sum()
               if M.shape[0] else 0)


def singleton_sites(seqs: dict) -> int:
    M = _matrix(seqs)
    n_sing = 0
    for col in M.T:
        counts = np.bincount(col[col >= 0], minlength=4)
        counts = np.sort(counts)[::-1]
        if counts[1] == 1:
            n_sing += 1
    return n_sing


def _harmonic(n: int):
    i = np.arange(1, n)
    return float((1.0 / i).sum()), float((1.0 / (i * i)).sum())


def watterson_theta(seqs: dict) -> float:
    """theta_W = S / a1 (reference: neutralitytest.c:141-151)."""
    a1, _ = _harmonic(len(seqs))
    return segregating_sites(seqs) / a1


def tajima_d(seqs: dict) -> float:
    """Tajima's D (reference: neutralitytest.c:104-125)."""
    n = len(seqs)
    a1, a2 = _harmonic(n)
    b1 = (n + 1.0) / (3.0 * (n - 1))
    b2 = 2.0 * (n * n + n + 3) / (9.0 * n * (n - 1))
    c1 = b1 - 1 / a1
    c2 = b2 - (n + 2) / (a1 * n) + a2 / (a1 * a1)
    e1 = c1 / a1
    e2 = c2 / (a1 * a1 + a2)
    pi = mean_pairwise_differences(seqs)
    S = segregating_sites(seqs)
    return (pi - S / a1) / np.sqrt(e1 * S + e2 * S * (S - 1))


def _fuli_common(n: float):
    a1, b_n = _harmonic(int(n))
    an1 = a1 + 1.0 / n
    cn = 2.0 * (n * a1 - 2.0 * (n - 1.0)) / ((n - 1.0) * (n - 2.0))
    dn = cn + (n - 2.0) / (n - 1.0) ** 2 + (2.0 / (n - 1.0)) * (
        1.5 - (2.0 * an1 - 3.0) / (n - 2.0) - 1.0 / n)
    return a1, b_n, an1, dn


def fu_li_d_star(seqs: dict) -> float:
    """Fu & Li's D* (reference: neutralitytest.c:153-184)."""
    n = float(len(seqs))
    eta_s = singleton_sites(seqs)
    S = segregating_sites(seqs)
    an, bn, _, dn = _fuli_common(n)
    vD = ((n / (n - 1.0)) ** 2 * bn + an * an * dn
          - 2.0 * (n * an * (an + 1.0)) / (n - 1.0) ** 2) / (an * an + bn)
    uD = (n / (n - 1.0)) * (an - n / (n - 1.0)) - vD
    return ((n / (n - 1.0)) * S - an * eta_s) / np.sqrt(uD * S + vD * S * S)


def fu_li_f_star(seqs: dict) -> float:
    """Fu & Li's F* (reference: neutralitytest.c:186-216)."""
    n = float(len(seqs))
    eta_s = singleton_sites(seqs)
    S = segregating_sites(seqs)
    pi = mean_pairwise_differences(seqs)
    an, bn, an1, dn = _fuli_common(n)
    vF = (dn + 2 * (n * n + n + 3) / (9.0 * n * (n - 1))
          - 2.0 / (n - 1) * (4.0 * bn - 6.0 + 8.0 / n)) / (an * an + bn)
    uF = (n / (n - 1.0) + (n + 1) / 3.0 / (n - 1) - 4.0 / n / (n - 1)
          + 2 * (n + 1) / (n - 1) ** 2 * (an1 - 2 * n / (n + 1))) / an - vF
    return (pi - (n - 1.0) / n * eta_s) / np.sqrt(uF * S + vF * S * S)
