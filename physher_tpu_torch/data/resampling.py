"""Bootstrap / jackknife resampling of alignments and site patterns.

A copy of ``physher_tpu/data/resampling.py`` (numpy only). Rebuild of the reference's resampling toolkit (reference:
src/phyc/phyresampling.h:24-43 — Sequences_bootstrap/jackknife[_n],
SitePattern_bootstrap/jackknife[_n]/reweight). Device-first design: resampling a
compressed SitePattern never touches the sequences — bootstrap draws a
multinomial over *sites* and folds it into the pattern ``weights`` vector, so
a resampled likelihood differs from the original only in one small weight
array (the likelihood is re-used unchanged across replicates, and many
replicates batch as a [R, P] weight matrix).
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np

from .sitepattern import SitePattern


# -- alignment-level (reference: Sequences_* phyresampling.c) ----------------

def bootstrap_alignment(seqs: "OrderedDict[str, str]", rng=None):
    """Sample alignment columns with replacement (same length)."""
    rng = np.random.default_rng(rng)
    names = list(seqs)
    L = len(next(iter(seqs.values())))
    idx = rng.integers(0, L, size=L)
    return OrderedDict((n, "".join(seqs[n][i] for i in idx)) for n in names)


def jackknife_alignment(seqs: "OrderedDict[str, str]", index: int):
    """Drop column ``index`` (reference: Sequences_jackknife)."""
    return OrderedDict(
        (n, s[:index] + s[index + 1:]) for n, s in seqs.items())


def jackknife_alignment_n(seqs: "OrderedDict[str, str]", n: int, rng=None):
    """Drop ``n`` random distinct columns (reference: Sequences_jackknife_n)."""
    rng = np.random.default_rng(rng)
    L = len(next(iter(seqs.values())))
    drop = set(rng.choice(L, size=n, replace=False).tolist())
    keep = [i for i in range(L) if i not in drop]
    return OrderedDict((nm, "".join(s[i] for i in keep))
                       for nm, s in seqs.items())


# -- site-pattern-level (weights-only; the device path) ------------------

def bootstrap_weights(sp: SitePattern, rng=None, n_replicates: int = 1):
    """Multinomial bootstrap over sites expressed as pattern weights.

    Returns float64[n_replicates, P]; each row sums to the alignment length.
    Replaces the reference's SitePattern_bootstrap (which rebuilt pattern
    arrays) — here the codes stay fixed and only the weights change, so the
    compiled likelihood is reused for every replicate.
    """
    rng = np.random.default_rng(rng)
    L = sp.site_count
    p = sp.weights / sp.weights.sum()
    w = rng.multinomial(L, p, size=n_replicates).astype(np.float64)
    return w


def jackknife_weights(sp: SitePattern, index: int) -> np.ndarray:
    """Weights with original site ``index`` removed (SitePattern_jackknife)."""
    w = sp.weights.copy()
    w[sp.indexes[index]] -= 1.0
    return w


def jackknife_weights_n(sp: SitePattern, n: int, rng=None) -> np.ndarray:
    """Weights with ``n`` random distinct sites removed."""
    rng = np.random.default_rng(rng)
    drop = rng.choice(sp.site_count, size=n, replace=False)
    w = sp.weights.copy()
    np.subtract.at(w, sp.indexes[drop], 1.0)
    return w


def reweight(sp: SitePattern, weights) -> SitePattern:
    """New SitePattern with replaced weights (SitePattern_reweight);
    zero-weight patterns are kept so the shapes stay the same."""
    return SitePattern(sp.codes, np.asarray(weights, dtype=np.float64),
                       sp.indexes, sp.taxa, sp.datatype)


def bootstrap_sitepattern(sp: SitePattern, rng=None) -> SitePattern:
    return reweight(sp, bootstrap_weights(sp, rng)[0])


def jackknife_sitepattern(sp: SitePattern, index: int) -> SitePattern:
    return reweight(sp, jackknife_weights(sp, index))
