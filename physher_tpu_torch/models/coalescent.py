"""Coalescent models: constant, exponential growth and skyride.

Port of ``physher_tpu/models/coalescent.py`` (reference:
src/phyc/demographicmodels.c; parameterizations theta / log-theta
demographicmodels.h:40-44; interval bookkeeping h:51-59). The interval
decomposition is a stable sort over node heights, so gradients with respect
to the population sizes and the node heights come from autograd. The
skyline, skygrid and piecewise-linear models of the JAX module are not
ported yet (ROADMAP Queue 1 item 10).

Every model has ``log_prob_from_heights(heights, params)`` and, once bound
to a tree's heights (:meth:`CoalescentModel.bind_tree`), the compound-model
protocol ``log_prob(params)``. The constant model also takes a batch of
chains (heights ``[L, N]``, theta ``[L]``); the exponential and skyride
models raise ``NotImplementedError`` for one.
"""

from __future__ import annotations

import numpy as np
import torch

from .parameters import ParamSpec, ParamSpace
from ..trees.heights import topo_constant
from ..trees.topology import Topology


def _events(topo: Topology):
    """Static event signs: +1 lineage at tips, -1 at internal (coalescent)."""
    delta = np.concatenate([np.ones(topo.T), -np.ones(topo.I)])
    is_coal = np.concatenate([np.zeros(topo.T, bool), np.ones(topo.I, bool)])
    return delta, is_coal


def interval_decomposition(heights: torch.Tensor, topo: Topology) -> dict:
    """Sort the events into intervals, per batch entry of heights
    ``[(L,) N]``.

    Returns per-interval start and duration, active lineage pairs, the
    coalescent-event flags, and the cumulative counters that index theta
    arrays; differentiable with respect to ``heights``."""
    delta, is_coal = _events(topo)
    d = topo_constant(topo, "coal_delta", lambda: delta, heights)
    c = topo_constant(topo, "coal_is_coal", lambda: is_coal, heights,
                      torch.bool)
    order = torch.argsort(heights, dim=-1, stable=True)
    t = torch.gather(heights, -1, order)
    d = d[order]
    c = c[order]
    k = torch.cumsum(d, -1)                 # lineages after event i
    pairs = k * (k - 1.0) / 2.0             # active pairs on [t_i, t_{i+1})
    dt = torch.diff(t)
    coal_incl = torch.cumsum(c.to(torch.int64), -1)
    coal_before = coal_incl - c.to(torch.int64)
    return {"t": t, "dt": dt, "pairs": pairs[..., :-1], "is_coal": c,
            "coal_before": coal_before, "coal_incl": coal_incl,
            "start": t[..., :-1]}


class CoalescentModel:
    """Base: a theta(t) model over a time tree's heights."""

    def __init__(self, topo: Topology, prefix: str = "coalescent.",
                 log_space: bool = False):
        self.topo = topo
        self.prefix = prefix
        self.log_space = log_space
        self.tree_param_fn = None  # set by bind_tree

    def key(self, k):
        return f"{self.prefix}{k}" if self.prefix else k

    def param_specs(self) -> list:
        return []

    def param_space(self):
        return ParamSpace(self.param_specs())

    def bind_tree(self, heights_fn):
        """Attach a callable params -> heights (a TreeLikelihood's
        ``node_heights`` or a config TreeHandle's ``heights``)."""
        self.tree_param_fn = heights_fn
        return self

    # whether log_prob_from_heights takes heights [L, N] (a batch of chains)
    batched = False

    def log_prob(self, params):
        if self.tree_param_fn is None:
            raise ValueError("coalescent not bound to a tree; call bind_tree")
        heights = self.tree_param_fn(params)
        if heights.dim() > 1 and not self.batched:
            raise NotImplementedError(
                f"{type(self).__name__} takes no batch of chains yet "
                "(ROADMAP Queue 1 item 10)")
        return self.log_prob_from_heights(heights, params)

    __call__ = log_prob

    def _thetas(self, params):
        th = params[self.key("thetas")]
        return torch.exp(th) if self.log_space else th

    def log_prob_from_heights(self, heights, params):
        raise NotImplementedError


class ConstantCoalescent(CoalescentModel):
    """theta(t) = N (reference: demographicmodels.c new_ConstantCoalescent)."""

    batched = True

    def __init__(self, topo, prefix="coalescent.", theta_init=1.0,
                 log_space=False):
        super().__init__(topo, prefix, log_space)
        self.theta_init = theta_init

    def param_specs(self):
        if self.log_space:
            return [ParamSpec.scalar(self.key("theta"),
                                     np.log(self.theta_init))]
        return [ParamSpec.scalar(self.key("theta"), self.theta_init,
                                 lower=0.0)]

    def log_prob_from_heights(self, heights, params):
        theta = params[self.key("theta")]
        if self.log_space:
            theta = torch.exp(theta)
        iv = interval_decomposition(heights, self.topo)
        integral = torch.sum(iv["pairs"] * iv["dt"], -1) / theta
        return -integral - self.topo.I * torch.log(theta)


class ExponentialCoalescent(CoalescentModel):
    """theta(t) = N0 exp(-r t) (reference: demographicmodels.c exponential
    growth)."""

    def __init__(self, topo, prefix="coalescent.", n0_init=1.0,
                 rate_init=0.0):
        super().__init__(topo, prefix)
        self.n0_init = n0_init
        self.rate_init = rate_init

    def param_specs(self):
        return [ParamSpec.scalar(self.key("n0"), self.n0_init, lower=0.0),
                ParamSpec.scalar(self.key("rate"), self.rate_init)]

    def log_prob_from_heights(self, heights, params):
        n0 = params[self.key("n0")]
        r = params[self.key("rate")]
        iv = interval_decomposition(heights, self.topo)
        t0 = iv["start"]
        t1 = iv["start"] + iv["dt"]
        # int dt / (N0 e^{-rt}) = (e^{r t1} - e^{r t0}) / (N0 r); dt/N0 as r->0
        small = torch.abs(r) < 1e-12
        rs = torch.where(small, torch.ones_like(r), r)
        seg = torch.where(small, iv["dt"] / n0,
                          (torch.exp(rs * t1) - torch.exp(rs * t0)) / (n0 * rs))
        integral = torch.sum(iv["pairs"] * seg)
        coal_t = heights[self.topo.T:]
        return -integral - torch.sum(torch.log(n0) - r * coal_t)


class SkyrideCoalescent(CoalescentModel):
    """One theta per inter-coalescent interval (reference:
    demographicmodels.c new_SkyrideCoalescent).

    Parameterizations (reference: demographicmodels.h:40-44): theta /
    logtheta, per-interval (possibly logged) population sizes; delta,
    v[0] = theta_0 and log theta_i = log theta_{i-1} + zeta (zgam / tau)
    v[i] with zeta = 0.015 and (zgam, tau) the last two entries (reference:
    _coalescent_skyride_calculate_deltas, demographicmodels.c:1337-1373).
    """

    ZETA = 0.015

    def __init__(self, topo, prefix="coalescent.", thetas_init=None,
                 log_space=True, delta: bool = False):
        super().__init__(topo, prefix, log_space)
        self.delta = bool(delta)
        n = topo.I + 2 if self.delta else topo.I
        self.thetas_init = (np.zeros(n) if thetas_init is None
                            else np.asarray(thetas_init))
        if self.delta and len(self.thetas_init) != n:
            raise ValueError(
                f"delta parameterization needs {n} values "
                f"(theta0, {topo.I - 1} increments, zgam, tau)")

    def param_specs(self):
        if self.delta or self.log_space:
            return [ParamSpec.vector(self.key("thetas"), self.thetas_init)]
        return [ParamSpec.vector(self.key("thetas"), self.thetas_init,
                                 lower=0.0)]

    def _thetas(self, params):
        if not self.delta:
            return super()._thetas(params)
        v = params[self.key("thetas")]
        gam = v[-2] / v[-1]
        incr = self.ZETA * gam * v[1:-2]
        log_thetas = torch.log(v[0]) + torch.cat(
            [v.new_zeros(1), torch.cumsum(incr, 0)])
        return torch.exp(log_thetas)

    def log_prob_from_heights(self, heights, params):
        thetas = self._thetas(params)
        iv = interval_decomposition(heights, self.topo)
        theta_iv = thetas[iv["coal_incl"][:-1]]
        integral = torch.sum(iv["pairs"] * iv["dt"] / theta_iv)
        # one -log theta per coalescent event, the theta of its interval
        ev = torch.where(iv["is_coal"], torch.log(thetas[iv["coal_before"]]),
                         torch.zeros_like(iv["t"]))
        return -integral - torch.sum(ev)
