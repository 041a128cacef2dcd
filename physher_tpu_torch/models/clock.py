"""Branch-rate (clock) models: strict, discrete/local, relaxed.

Port of ``physher_tpu/models/clock.py`` (reference: src/phyc/branchmodel.c,
branchmodel.h:31-68). A clock model maps parameters to one substitution
rate per node ``[N]`` (the root entry is unused), and a batch of parameter
dicts (tensors ``[L, ...]``) to ``[L, N]``. Discrete/local clocks use a
static node->rate-class index map (the reference's DiscreteParameter map);
relaxed clocks expose one rate per branch with a lognormal/exponential
prior applied separately at the inference level.
"""

from __future__ import annotations

import numpy as np
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


class DiscreteClock(BranchModel):
    """Rate classes assigned to branches via a static index map
    (reference: branchmodel.c CLOCK_DISCRETE / CLOCK_LOCAL with a
    DiscreteParameter node->class map)."""

    def __init__(self, N, class_map, prefix="", rates_init=None, *, dtype,
                 device):
        super().__init__(N, prefix, dtype=dtype, device=device)
        self.class_map = np.asarray(class_map, dtype=np.int64)
        if self.class_map.shape != (N,):
            raise ValueError("class_map must have one entry per node")
        self.n_classes = int(self.class_map.max()) + 1
        self.rates_init = (np.full(self.n_classes, 1e-3) if rates_init is None
                           else np.asarray(rates_init))

    def param_specs(self):
        return [ParamSpec.vector(self.key("rates"), self.rates_init,
                                 lower=0.0)]

    def rates(self, params):
        return params[self.key("rates")][..., self.class_map]


class LocalClock(DiscreteClock):
    """Local molecular clocks placed by node indicators (reference:
    branchmodel.c CLOCK_LOCAL — indicator bits on nodes; every branch in the
    clade below an active node inherits that node's local rate, nearest
    active ancestor wins; branchmodel.h:64-67 SSVS indicators).

    The indicator->class map is resolved on the host (a topology walk, not
    a hot path)."""

    def __init__(self, topo, indicators, prefix="", rates_init=None, *,
                 dtype, device):
        self.topo = topo
        self.indicators = np.asarray(indicators, dtype=bool)
        if self.indicators.shape != (topo.N,):
            raise ValueError("one indicator per node required")
        class_map = self.class_map_from_indicators(topo, self.indicators)
        super().__init__(topo.N, class_map, prefix, rates_init, dtype=dtype,
                         device=device)

    @staticmethod
    def class_map_from_indicators(topo, indicators) -> np.ndarray:
        """class 0 = background; active node i gets class 1+rank(i); a
        node's class is that of its nearest active ancestor-or-self."""
        active = np.flatnonzero(indicators)
        cls_of = {int(n): i + 1 for i, n in enumerate(active)}
        cmap = np.zeros(topo.N, dtype=np.int32)
        # preorder: parents before children => walk internal nodes downward
        for k in range(topo.I - 1, -1, -1):
            node = topo.T + k
            if node in cls_of:
                cmap[node] = cls_of[node]
            for c in topo.children[k, : topo.child_count[k]]:
                cmap[c] = cls_of.get(int(c), cmap[node])
        root = topo.N - 1
        if root in cls_of:
            cmap[root] = cls_of[root]
        return cmap


class RelaxedClock(BranchModel):
    """Free per-branch rates; the distributional assumption (lognormal /
    exponential across branches) enters as a prior on these parameters
    (reference: branchmodel.c CLOCK_RELAXED). The root's entry is 0."""

    def __init__(self, N, prefix="", rate_init=1e-3, *, dtype, device):
        super().__init__(N, prefix, dtype=dtype, device=device)
        self.rate_init = rate_init

    def param_specs(self):
        return [ParamSpec.vector(self.key("rates"),
                                 np.full(self.N - 1, self.rate_init),
                                 lower=0.0)]

    def rates(self, params):
        r = params[self.key("rates")]
        return torch.cat([r, r.new_zeros(r.shape[:-1] + (1,))], -1)


class DistributionRelaxedClock(BranchModel):
    """Discretized-distribution relaxed clock (reference: branchmodel.c
    new_RelaxedClock + _relaxedclock_calculate_rates, branchmodel.h:33
    RELAXED_LOGNORMAL / RELAXED_EXPONENTIAL / RELAXED_DISCRETE).

    The distribution is discretized into ``n_cats`` quantile-midpoint rates
    (z_i = (i+0.5)/n; reference: lognormal.c:48 lognormal_discretize,
    exponential.c:55 exponential_discretize) and a static per-node
    assignment map selects which bin each branch uses.

    Free parameters: the distribution's hyper-parameters
    (lognormal: ``logmean``, ``logsigma``; exponential: ``lambda``;
    discrete: ``center`` with log-spaced bins center/10 .. center*10,
    reference branchmodel.c:1248-1258).
    """

    def __init__(self, N, distribution="lognormal", prefix="",
                 assignment=None, n_cats=None, logmean_init=-7.0,
                 logsigma_init=0.5, lambda_init=1e3, center_init=1e-3, *,
                 dtype, device):
        super().__init__(N, prefix, dtype=dtype, device=device)
        self.distribution = str(distribution).lower()
        if self.distribution not in ("lognormal", "exponential", "discrete"):
            raise ValueError(f"unknown relaxed distribution {distribution!r}")
        self.n_cats = int(n_cats or N)
        if assignment is None:
            assignment = np.arange(N) % self.n_cats
        self.assignment = np.asarray(assignment, dtype=np.int64)
        if self.assignment.shape != (N,):
            raise ValueError("assignment must have one entry per node")
        self.logmean_init = logmean_init
        self.logsigma_init = logsigma_init
        self.lambda_init = lambda_init
        self.center_init = center_init

    def param_specs(self):
        if self.distribution == "lognormal":
            return [ParamSpec.scalar(self.key("logmean"), self.logmean_init),
                    ParamSpec.scalar(self.key("logsigma"),
                                     self.logsigma_init, lower=0.0)]
        if self.distribution == "exponential":
            return [ParamSpec.scalar(self.key("lambda"), self.lambda_init,
                                     lower=0.0)]
        return [ParamSpec.scalar(self.key("center"), self.center_init,
                                 lower=0.0)]

    def bin_rates(self, params) -> torch.Tensor:
        """The n_cats quantile-midpoint rates ``[(L,) n_cats]``."""
        n = self.n_cats
        ar = torch.arange(n, dtype=self.dtype, device=self.device)
        z = (ar + 0.5) / n
        if self.distribution == "lognormal":
            mu = params[self.key("logmean")][..., None]
            sig = params[self.key("logsigma")][..., None]
            return torch.exp(mu + sig * torch.special.ndtri(z))
        if self.distribution == "exponential":
            lam = params[self.key("lambda")][..., None]
            return -torch.log1p(-z) / lam
        logc = torch.log(params[self.key("center")])[..., None]
        # log-spaced bins over [center/10, center*10] split at the center
        # (reference: branchmodel.c:1248-1258, magnitude 10)
        n_lower = n // 2
        n_upper = n - n_lower
        log10 = float(np.log(10.0))
        lo = _linspace(logc - log10, logc, n_lower, endpoint=False)
        hi = _linspace(logc, logc + log10, n_upper, endpoint=True)
        return torch.exp(torch.cat([lo, hi], -1))

    def rates(self, params):
        return self.bin_rates(params)[..., self.assignment]


def _linspace(start, stop, num, endpoint):
    """``num`` points from ``start [..., 1]`` to ``stop [..., 1]``, placed
    as ``jax.numpy.linspace`` places them: start (1 - i / div) + stop i /
    div, the end point appended as given."""
    div = (num - 1) if endpoint else num
    if num <= 1:
        return start[..., :num]
    step = torch.arange(div, dtype=start.dtype, device=start.device) / div
    out = start * (1 - step) + stop * step
    return torch.cat([out, stop], -1) if endpoint else out


def ancestor_chains(topo) -> np.ndarray:
    """[N, D] ancestor chain per node: row = (self, parent, ..., root),
    right-padded with the root id."""
    N = topo.N
    chains = []
    for n in range(N):
        chain = [n]
        while topo.parent[chain[-1]] >= 0:
            chain.append(int(topo.parent[chain[-1]]))
        chains.append(chain)
    D = max(len(c) for c in chains)
    out = np.full((N, D), topo.root, dtype=np.int64)
    for n, c in enumerate(chains):
        out[n, : len(c)] = c
    return out


class SSVSLocalClock(BranchModel):
    """Local clocks with *sampled* placements: per-node indicator bits are
    part of the MCMC state (reference: branchmodel.h:64-67 SSVS indicators +
    the bitflip operator, operator.c). A node takes the local rate of its
    nearest indicator-active ancestor-or-self, else the background rate.

    Parameters: ``rate`` (background, scalar), ``local_rates`` ([N], the
    rate a node's clade inherits while its indicator is set). The bits are
    a sampler's discrete state, not a ParamSpec.
    """

    def __init__(self, topo, prefix="", rate_init=1e-3, *, dtype, device):
        super().__init__(topo.N, prefix, dtype=dtype, device=device)
        self.topo = topo
        self.chains = torch.as_tensor(ancestor_chains(topo),
                                      device=self.device)  # [N, D]
        self.rate_init = rate_init

    def param_specs(self):
        return [
            ParamSpec.scalar(self.key("rate"), self.rate_init, lower=0.0),
            ParamSpec.vector(self.key("local_rates"),
                             np.full(self.N, self.rate_init), lower=0.0),
        ]

    def rates_from_indicators(self, params, bits) -> torch.Tensor:
        """Effective per-node rates ``[(L,) N]`` given indicator bits
        ``[(L,) N]`` (int/bool): the first set bit along each node's
        (self -> root) chain."""
        bits = torch.as_tensor(bits, device=self.device)
        b = (bits[..., self.chains] > 0).to(torch.uint8)   # [(L,) N, D]
        has = b.any(-1).bool()                             # [(L,) N]
        first = torch.argmax(b, -1, keepdim=True)          # first maximum
        src = torch.gather(self.chains.expand(b.shape), -1, first)[..., 0]
        local = params[self.key("local_rates")]
        local = torch.gather(local.expand(src.shape[:-1] + local.shape[-1:]),
                             -1, src)
        return torch.where(has, local, params[self.key("rate")][..., None])

    def rates(self, params):
        """The effective rates for the bits that ``params`` carries under
        ``key("indicators")`` (a MixedMCMC target puts them there); without
        bits a strict clock."""
        bits = params.get(self.key("indicators"))
        if bits is not None:
            return self.rates_from_indicators(params, bits)
        r = params[self.key("rate")]
        return r[..., None].expand(r.shape + (self.N,))
