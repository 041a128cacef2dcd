"""Codon substitution models: MG94 and GY94.

Port of ``physher_tpu/models/codon.py`` (reference: src/phyc/mg94.c:63-140,
src/phyc/gy94.c:47-120) over the sense codons of a genetic code. Codon pairs
differing at exactly one nucleotide are classified statically into
{synonymous, nonsynonymous} x {transition, transversion}; the generator is

    MG94: R = kappa^ts * (alpha if synonymous else beta)
    GY94: R = kappa^ts * (1     if synonymous else omega)

with Q_ij = R_ij * pi_j, normalized to mean rate 1. Multi-nucleotide changes
have rate 0. The classification is a numpy table built once; Q assembly is
a gather and an elementwise product, and P(t) goes through
``p_t_reversible`` like every other reversible model. A batch of parameter
dicts (MCMC chains: parameters ``[L]``, frequencies ``[L, S]``) gives
``Q [L, S, S]``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..data.gcode import CODON_TRIPLETS, GENETIC_CODES, sense_codon_indices
from ..utils.profiling import span
from .parameters import ParamSpec
from .substitution import (
    SubstitutionModel, _set_diagonal_neg_rowsum, normalize_q,
)

_TRANSITIONS = {("A", "G"), ("G", "A"), ("C", "T"), ("T", "C")}


def codon_pair_classes(genetic_code: int):
    """[S, S] int8: 0=no single-nt change, 1=syn-ts, 2=syn-tv, 3=nonsyn-ts,
    4=nonsyn-tv."""
    sense = sense_codon_indices(genetic_code)
    code = GENETIC_CODES[genetic_code]
    S = len(sense)
    cls = np.zeros((S, S), dtype=np.int8)
    for a in range(S):
        for b in range(S):
            if a == b:
                continue
            ta, tb = CODON_TRIPLETS[sense[a]], CODON_TRIPLETS[sense[b]]
            diffs = [k for k in range(3) if ta[k] != tb[k]]
            if len(diffs) != 1:
                continue
            k = diffs[0]
            ts = (ta[k], tb[k]) in _TRANSITIONS
            syn = code[sense[a]] == code[sense[b]]
            cls[a, b] = (1 if syn else 3) + (0 if ts else 1)
    return cls


class _CodonModel(SubstitutionModel):
    def __init__(self, prefix="", genetic_code: int = 0, freqs_init=None,
                 fixed_freqs=False, *, dtype: torch.dtype, device):
        super().__init__(prefix, dtype=dtype, device=device)
        self.genetic_code = genetic_code
        self.state_count = len(sense_codon_indices(genetic_code))
        self.classes = codon_pair_classes(genetic_code)
        self.freqs_init = (np.full(self.state_count, 1.0 / self.state_count)
                           if freqs_init is None else np.asarray(freqs_init))
        self.fixed_freqs = fixed_freqs

    def _freq_spec(self):
        mk = ParamSpec.fixed if self.fixed_freqs else ParamSpec.simplex
        return mk(self.key("frequencies"), self.freqs_init)

    def frequencies(self, params):
        return params[self.key("frequencies")]

    def _q_from_class_rates(self, class_rates, pi):
        """class_rates: [(L,) 5] with entry 0 == 0, frequencies pi [(L,) S]
        -> Q [(L,) S, S]."""
        with span("physher.sync.h2d"):
            idx = torch.as_tensor(self.classes, dtype=torch.long,
                                  device=class_rates.device)
        Q = _set_diagonal_neg_rowsum(class_rates[..., idx]
                                     * pi[..., None, :])
        return normalize_q(Q, pi)


class MG94(_CodonModel):
    """Muse-Gaut 94 (kappa, alpha=syn rate, beta=nonsyn rate)
    (reference: src/phyc/mg94.c)."""

    name = "mg94"

    def param_specs(self):
        return [
            ParamSpec.scalar(self.key("kappa"), 1.0, lower=0.0),
            ParamSpec.scalar(self.key("alpha"), 1.0, lower=0.0),
            ParamSpec.scalar(self.key("beta"), 1.0, lower=0.0),
            self._freq_spec(),
        ]

    def q(self, params):
        kappa = params[self.key("kappa")]
        alpha = params[self.key("alpha")]
        beta = params[self.key("beta")]
        rates = torch.stack([
            torch.zeros_like(kappa), kappa * alpha, alpha, kappa * beta,
            beta], -1)
        return self._q_from_class_rates(rates, self.frequencies(params))


class GY94(_CodonModel):
    """Goldman-Yang 94 / M0 (kappa, omega) (reference: src/phyc/gy94.c)."""

    name = "gy94"

    def param_specs(self):
        return [
            ParamSpec.scalar(self.key("kappa"), 1.0, lower=0.0),
            ParamSpec.scalar(self.key("omega"), 1.0, lower=0.0),
            self._freq_spec(),
        ]

    def q(self, params):
        kappa = params[self.key("kappa")]
        omega = params[self.key("omega")]
        one = torch.ones_like(kappa)
        rates = torch.stack([
            torch.zeros_like(kappa), kappa, one, kappa * omega, omega], -1)
        return self._q_from_class_rates(rates, self.frequencies(params))
