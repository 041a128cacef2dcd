"""Site-pattern compression and tip-partial construction.

Rebuild of the reference's SitePattern (reference: src/phyc/sitepattern.c:87
``new_SitePattern``: dedupe identical alignment columns into weighted unique
patterns). On TPU the pattern axis is the data-parallel axis — it is padded to
a lane multiple and sharded across devices; padded columns carry weight 0 and
all-ones tip partials so they contribute exactly nothing to the likelihood.
"""

from __future__ import annotations

import numpy as np

from .datatype import DataType, get_datatype


class SitePattern:
    """Compressed alignment columns.

    Attributes
    ----------
    codes : int32[T, P]  per-tip encoding of each unique pattern
    weights : float64[P] pattern multiplicities (sum = alignment length)
    indexes : int32[L]   pattern index of each original site
    taxa : list[str]     taxon names (row order of ``codes``)
    """

    def __init__(self, codes, weights, indexes, taxa, datatype: DataType):
        self.codes = np.asarray(codes, dtype=np.int32)
        self.weights = np.asarray(weights, dtype=np.float64)
        self.indexes = np.asarray(indexes, dtype=np.int32)
        self.taxa = list(taxa)
        self.datatype = datatype

    @property
    def pattern_count(self) -> int:
        return self.codes.shape[1]

    @property
    def site_count(self) -> int:
        return self.indexes.shape[0]

    @staticmethod
    def from_alignment(seqs: dict, datatype="nucleotide",
                       genetic_code: int = 0) -> "SitePattern":
        dt = get_datatype(datatype, genetic_code)
        taxa = list(seqs)
        enc = np.stack([dt.encode_sequence(seqs[t]) for t in taxa])  # [T, L]
        return SitePattern.compress(enc, taxa, dt)

    @staticmethod
    def compress(enc: np.ndarray, taxa, dt: DataType) -> "SitePattern":
        enc = np.asarray(enc)
        cols = np.ascontiguousarray(enc.T)  # [L, T]
        uniq, first_idx, inverse, counts = np.unique(
            cols, axis=0, return_index=True, return_inverse=True,
            return_counts=True,
        )
        # keep first-occurrence order (like the reference's scan order)
        order = np.argsort(first_idx, kind="stable")
        rank = np.empty_like(order)
        rank[order] = np.arange(order.size)
        codes = uniq[order].T  # [T, P]
        weights = counts[order].astype(np.float64)
        indexes = rank[inverse].astype(np.int32)
        return SitePattern(codes, weights, indexes, taxa, dt)

    # -- tensors for the engine -------------------------------------------

    def tip_partials(self, *, tipstates: bool = False,
                     pad_to: int | None = None, dtype=np.float64) -> np.ndarray:
        """Dense tip partials ``[T, S, P]``.

        ``tipstates=True`` reproduces the reference's tip-state kernels where
        any ambiguity collapses to fully-unknown (all ones) (reference:
        src/phyc/treelikelihood4.c:227-268 partials_states_* treat state>=4 as
        unknown); ``False`` uses the datatype ambiguity table (reference:
        src/phyc/sitepattern.c get_partials + datatype.c _nucleotide_partial).
        """
        dt = self.datatype
        table = np.asarray(dt.partials_table, dtype=dtype)  # [n_codes, S]
        if tipstates:
            S = dt.state_count
            table = np.ones_like(table)
            table[:S] = np.eye(S, dtype=dtype)
        part = table[self.codes]  # [T, P, S]
        part = np.swapaxes(part, 1, 2)  # [T, S, P]
        if pad_to is not None and self.pattern_count < pad_to:
            padded = np.ones(
                (part.shape[0], part.shape[1], pad_to), dtype=dtype
            )
            padded[:, :, : self.pattern_count] = part
            part = padded
        return np.ascontiguousarray(part)

    def padded_weights(self, pad_to: int | None = None,
                       dtype=np.float64) -> np.ndarray:
        w = self.weights.astype(dtype)
        if pad_to is not None and w.shape[0] < pad_to:
            w = np.concatenate([w, np.zeros(pad_to - w.shape[0], dtype=dtype)])
        return w

    # -- manipulation (reference: sitepattern.c split/merge, subsetting) ---

    def subset(self, site_slice) -> "SitePattern":
        """New SitePattern restricted to a subset of original sites
        (reference: src/phyc/sitepattern.c:186 new_SitePattern2)."""
        idx = self.indexes[site_slice]
        used, inverse = np.unique(idx, return_inverse=True)
        codes = self.codes[:, used]
        weights = np.bincount(inverse, minlength=used.size).astype(np.float64)
        return SitePattern(codes, weights, inverse.astype(np.int32),
                           self.taxa, self.datatype)

    def split(self, count: int) -> "list[SitePattern]":
        """Split original sites into ``count`` contiguous chunks
        (reference: src/phyc/sitepattern.h:79 SitePattern_split)."""
        L = self.site_count
        edges = np.linspace(0, L, count + 1).astype(int)
        return [self.subset(slice(a, b)) for a, b in zip(edges[:-1], edges[1:])
                if b > a]

    def unconstrained_log_likelihood(self) -> float:
        """Multinomial log-likelihood upper bound (printed by the reference,
        src/phyc/sitepattern.c SitePattern_unconstrained_lnl)."""
        w = self.weights
        n = w.sum()
        return float(np.sum(w * np.log(w / n)))


def bootstrap(sp: SitePattern, rng: np.random.Generator) -> SitePattern:
    """Bootstrap resample original sites (reference:
    src/phyc/phyresampling.c SitePattern bootstrap)."""
    idx = rng.integers(0, sp.site_count, sp.site_count)
    return sp.subset(idx)


def jackknife(sp: SitePattern, rng: np.random.Generator,
              remove: int | None = None) -> SitePattern:
    """Delete-one (or delete-``remove``) jackknife of original sites
    (reference: src/phyc/phyresampling.c jackknife)."""
    remove = 1 if remove is None else remove
    keep = rng.permutation(sp.site_count)[: sp.site_count - remove]
    keep.sort()
    return sp.subset(keep)
