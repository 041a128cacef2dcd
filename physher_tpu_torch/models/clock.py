"""Branch-rate (clock) models.

Port of the strict clock of ``physher_tpu/models/clock.py`` (reference:
src/phyc/branchmodel.c). A clock model maps parameters to one substitution
rate per node ``[N]`` (the root entry is unused).
"""

from __future__ import annotations

import torch

from .parameters import ParamSpec, ParamSpace


class BranchModel:
    def __init__(self, N: int, prefix: str = "", *, dtype: torch.dtype,
                 device):
        self.N = N
        self.prefix = prefix
        self.dtype = dtype
        self.device = torch.device(device)

    def key(self, k):
        return f"{self.prefix}{k}" if self.prefix else k

    def param_specs(self) -> list:
        return []

    def param_space(self) -> ParamSpace:
        return ParamSpace(self.param_specs())

    def rates(self, params) -> torch.Tensor:
        """Per-node substitution rate [(L,) N]."""
        raise NotImplementedError


class StrictClock(BranchModel):
    """One global rate (reference: branchmodel.c CLOCK_STRICT)."""

    def __init__(self, N, prefix="", rate_init=1e-3, fixed=False, *, dtype,
                 device):
        super().__init__(N, prefix, dtype=dtype, device=device)
        self.rate_init = rate_init
        self.fixed = fixed

    def param_specs(self):
        mk = ParamSpec.fixed if self.fixed else (
            lambda n, v: ParamSpec.scalar(n, v, lower=0.0))
        return [mk(self.key("rate"), self.rate_init)]

    def rates(self, params):
        r = params[self.key("rate")]
        return r[..., None].expand(r.shape + (self.N,))
