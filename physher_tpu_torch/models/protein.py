"""Empirical amino-acid substitution models: WAG, LG, Dayhoff.

Port of ``physher_tpu/models/protein.py`` (reference: src/phyc/wag.c, lg.c,
dayhoff.c), built from the published exchangeability tables in
:mod:`physher_tpu_torch.models.protein_data`. Frequencies default to the
published equilibrium frequencies and may be freed or replaced (the
reference's +F variants).
"""

from __future__ import annotations

import numpy as np
import torch

from .parameters import ParamSpec
from .substitution import (
    SubstitutionModel, _set_diagonal_neg_rowsum, normalize_q,
)
from . import protein_data as pd

_TABLES = {
    "wag": (pd.WAG_RATES, pd.WAG_FREQS),
    "lg": (pd.LG_RATES, pd.LG_FREQS),
    "dayhoff": (pd.DAYHOFF_RATES, pd.DAYHOFF_FREQS),
}


class EmpiricalProtein(SubstitutionModel):
    state_count = 20

    def __init__(self, model: str, prefix="", freqs_init=None,
                 free_freqs: bool = False, *, dtype: torch.dtype, device):
        super().__init__(prefix, dtype=dtype, device=device)
        model = model.lower()
        if model not in _TABLES:
            raise ValueError(f"unknown protein model {model!r}")
        self.name = model
        self.R, self.default_freqs = _TABLES[model]
        self.free_freqs = free_freqs or freqs_init is not None
        if freqs_init is None:
            # the reference stores the published values via the stick-breaking
            # round trip, which renormalizes by absorbing the table's rounding
            # deficit into the LAST frequency (simplex.c set_values ->
            # get_values); golden parity depends on reproducing that
            f = np.asarray(self.default_freqs, dtype=np.float64).copy()
            f[-1] = 1.0 - f[:-1].sum()
            self.freqs_init = f
        else:
            self.freqs_init = np.asarray(freqs_init, dtype=np.float64)
            self.freqs_init = self.freqs_init / self.freqs_init.sum()

    def param_specs(self):
        mk = ParamSpec.simplex if self.free_freqs else ParamSpec.fixed
        return [mk(self.key("frequencies"), self.freqs_init)]

    def frequencies(self, params):
        return params[self.key("frequencies")]

    def q(self, params):
        pi = self.frequencies(params)
        R = torch.as_tensor(self.R, dtype=pi.dtype, device=pi.device)
        Q = _set_diagonal_neg_rowsum(R * pi[..., None, :])
        return normalize_q(Q, pi)


def WAG(prefix="", **kw):
    return EmpiricalProtein("wag", prefix, **kw)


def LG(prefix="", **kw):
    return EmpiricalProtein("lg", prefix, **kw)


def Dayhoff(prefix="", **kw):
    return EmpiricalProtein("dayhoff", prefix, **kw)
