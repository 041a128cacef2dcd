"""Coalescent models: constant, exponential growth, skyride, skyline,
skygrid and piecewise-linear grid.

Port of ``physher_tpu/models/coalescent.py`` (reference:
src/phyc/demographicmodels.c; parameterizations theta / log-theta
demographicmodels.h:40-44; interval bookkeeping h:51-59). The interval
decomposition is a stable sort over node heights (and a grid's fixed
lines), so gradients with respect to the population sizes and the node
heights come from autograd.

Every model has ``log_prob_from_heights(heights, params)`` and, once bound
to a tree's heights (:meth:`CoalescentModel.bind_tree`), the compound-model
protocol ``log_prob(params)``. Every model takes a batch of chains: heights
``[L, N]`` with parameters ``[L, ...]`` give ``[L]``; the per-interval
population sizes are gathered along the last axis (``torch.gather``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.profiling import spanned
from .parameters import ParamSpec, ParamSpace
from ..trees.heights import topo_constant
from ..trees.topology import Topology


def _events(topo: Topology):
    """Static event signs: +1 lineage at tips, -1 at internal (coalescent)."""
    delta = np.concatenate([np.ones(topo.T), -np.ones(topo.I)])
    is_coal = np.concatenate([np.zeros(topo.T, bool), np.ones(topo.I, bool)])
    return delta, is_coal


def interval_decomposition(heights: torch.Tensor, topo: Topology,
                           extra_times: torch.Tensor = None) -> dict:
    """Sort the events, and the grid lines ``extra_times`` ``[G]`` if any,
    into intervals, per batch entry of heights ``[(L,) N]``.

    Returns per-interval start and duration, active lineage pairs, the
    coalescent-event and grid-line flags, and the cumulative counters that
    index theta arrays; differentiable with respect to ``heights``."""
    delta, is_coal = _events(topo)
    G = 0 if extra_times is None else extra_times.shape[-1]
    d = topo_constant(topo, f"coal_delta_{G}",
                      lambda: np.concatenate([delta, np.zeros(G)]), heights)
    c = topo_constant(topo, f"coal_is_coal_{G}",
                      lambda: np.concatenate([is_coal, np.zeros(G, bool)]),
                      heights, torch.bool)
    g = topo_constant(topo, f"coal_is_grid_{G}",
                      lambda: np.arange(topo.N + G) >= topo.N, heights,
                      torch.bool)
    times = heights
    if G:
        times = torch.cat([heights, extra_times.expand(
            heights.shape[:-1] + (G,))], -1)
    order = torch.argsort(times, dim=-1, stable=True)
    t = torch.gather(times, -1, order)
    d, c, g = d[order], c[order], g[order]
    k = torch.cumsum(d, -1)                 # lineages after event i
    pairs = k * (k - 1.0) / 2.0             # active pairs on [t_i, t_{i+1})
    dt = torch.diff(t)
    coal_incl = torch.cumsum(c.to(torch.int64), -1)
    coal_before = coal_incl - c.to(torch.int64)
    grid_before = torch.cumsum(g.to(torch.int64), -1)
    return {"t": t, "dt": dt, "pairs": pairs[..., :-1], "is_coal": c,
            "is_grid": g, "coal_before": coal_before, "coal_incl": coal_incl,
            "grid_before": grid_before, "start": t[..., :-1]}


def _take(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``values[..., idx]`` per batch entry: values ``[(L,) n]`` at indices
    ``[(L,) M]`` -> ``[(L,) M]``."""
    lead = torch.broadcast_shapes(values.shape[:-1], idx.shape[:-1])
    return torch.gather(values.expand(lead + values.shape[-1:]), -1,
                        idx.expand(lead + idx.shape[-1:]))


def _clip(x: torch.Tensor, lo: float, hi: float = None) -> torch.Tensor:
    """``jnp.clip`` as the JAX package's models use it: maximum then
    minimum, whose derivative at a tie is one half (``torch.clamp``'s is
    one)."""
    x = torch.maximum(x, torch.full_like(x, lo))
    return x if hi is None else torch.minimum(x, torch.full_like(x, hi))


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

    @spanned("physher.coalescent")
    def log_prob(self, params):
        if self.tree_param_fn is None:
            raise ValueError("coalescent not bound to a tree; call bind_tree")
        return self.log_prob_from_heights(self.tree_param_fn(params), params)

    __call__ = log_prob

    def _thetas(self, params):
        th = params[self.key("thetas")]
        return torch.exp(th) if self.log_space else th

    def log_prob_from_heights(self, heights, params):
        raise NotImplementedError


class ConstantCoalescent(CoalescentModel):
    """theta(t) = N (reference: demographicmodels.c new_ConstantCoalescent)."""

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
        n0 = params[self.key("n0")][..., None]
        r = params[self.key("rate")][..., None]
        iv = interval_decomposition(heights, self.topo)
        t0 = iv["start"]
        t1 = iv["start"] + iv["dt"]
        # int dt / (N0 e^{-rt}) = (e^{r t1} - e^{r t0}) / (N0 r); dt/N0 as r->0
        small = torch.abs(r) < 1e-12
        rs = torch.where(small, torch.ones_like(r), r)
        seg = torch.where(small, iv["dt"] / n0,
                          (torch.exp(rs * t1) - torch.exp(rs * t0)) / (n0 * rs))
        integral = torch.sum(iv["pairs"] * seg, -1)
        coal_t = heights[..., self.topo.T:]
        return -integral - torch.sum(torch.log(n0) - r * coal_t, -1)


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
        gam = v[..., -2:-1] / v[..., -1:]
        incr = self.ZETA * gam * v[..., 1:-2]
        log_thetas = torch.log(v[..., :1]) + torch.cat(
            [torch.zeros_like(v[..., :1]), torch.cumsum(incr, -1)], -1)
        return torch.exp(log_thetas)

    def _interval_log_prob(self, thetas, heights):
        """The skyride density with theta_i on the i-th inter-coalescent
        interval."""
        iv = interval_decomposition(heights, self.topo)
        theta_iv = _take(thetas, iv["coal_incl"][..., :-1])
        integral = torch.sum(iv["pairs"] * iv["dt"] / theta_iv, -1)
        # one -log theta per coalescent event, the theta of its interval
        ev = torch.where(iv["is_coal"],
                         torch.log(_take(thetas, iv["coal_before"])),
                         torch.zeros_like(iv["t"]))
        return -integral - torch.sum(ev, -1)

    def log_prob_from_heights(self, heights, params):
        return self._interval_log_prob(self._thetas(params), heights)


class SkylineCoalescent(SkyrideCoalescent):
    """Grouped skyline: consecutive coalescent intervals share thetas by a
    static group-size map (reference: demographicmodels.c classic and
    Bayesian skyline)."""

    def __init__(self, topo, groups, prefix="coalescent.", thetas_init=None,
                 log_space=True):
        self.groups = np.asarray(groups, dtype=np.int64)
        if self.groups.sum() != topo.I:
            raise ValueError("skyline group sizes must sum to #coalescences")
        n = len(self.groups)
        CoalescentModel.__init__(self, topo, prefix, log_space)
        self.delta = False
        self.thetas_init = (np.zeros(n) if thetas_init is None
                            else np.asarray(thetas_init))
        # coalescent-interval index -> group index
        self.interval_group = np.repeat(np.arange(n), self.groups)

    def log_prob_from_heights(self, heights, params):
        th = self._thetas(params)
        group = topo_constant(self.topo, f"skyline_{tuple(self.groups)}",
                              lambda: self.interval_group, th, torch.int64)
        return self._interval_log_prob(th.index_select(-1, group), heights)


class SkygridCoalescent(CoalescentModel):
    """Piecewise-constant theta on a fixed grid [0, cutoff] (reference:
    demographicmodels.c new_GridCoalescent; Gill et al skygrid).

    ``grid`` thetas; edges at k cutoff / (grid - 1), k = 1 .. grid - 1; the
    last theta extends beyond the cutoff.
    """

    def __init__(self, topo, grid: int, cutoff: float, prefix="coalescent.",
                 thetas_init=None, log_space=True):
        super().__init__(topo, prefix, log_space)
        self.grid = int(grid)
        self.cutoff = float(cutoff)
        self.edges = np.linspace(0.0, cutoff, grid)[1:]  # grid - 1 edges
        self.thetas_init = (np.zeros(self.grid) if thetas_init is None
                            else np.asarray(thetas_init))

    def param_specs(self):
        if self.log_space:
            return [ParamSpec.vector(self.key("thetas"), self.thetas_init)]
        return [ParamSpec.vector(self.key("thetas"), self.thetas_init,
                                 lower=0.0)]

    def log_prob_from_heights(self, heights, params):
        thetas = self._thetas(params)
        edges = topo_constant(self.topo, f"edges_{self.grid}_{self.cutoff}",
                              lambda: self.edges, heights)
        iv = interval_decomposition(heights, self.topo, edges)
        cell = iv["grid_before"][..., :-1]  # theta index per interval
        integral = torch.sum(iv["pairs"] * iv["dt"] / _take(thetas, cell),
                             -1)
        ev = torch.where(iv["is_coal"],
                         torch.log(_take(thetas, iv["grid_before"])),
                         torch.zeros_like(iv["t"]))
        return -integral - torch.sum(ev, -1)


class PiecewiseLinearCoalescent(CoalescentModel):
    """theta linear between grid points, constant beyond the cutoff
    (reference: demographicmodels.c new_PiecewiseLinearGridCoalescent)."""

    def __init__(self, topo, grid: int, cutoff: float, prefix="coalescent.",
                 thetas_init=None, log_space=False):
        super().__init__(topo, prefix, log_space)
        self.grid = int(grid)
        self.cutoff = float(cutoff)
        self.points = np.linspace(0.0, cutoff, grid)  # theta at these times
        self.thetas_init = (np.ones(self.grid) if thetas_init is None
                            else np.asarray(thetas_init))

    def param_specs(self):
        if self.log_space:
            return [ParamSpec.vector(self.key("thetas"),
                                     np.log(self.thetas_init))]
        return [ParamSpec.vector(self.key("thetas"), self.thetas_init,
                                 lower=0.0)]

    def _theta_at(self, thetas, t):
        pts = topo_constant(self.topo, f"points_{self.grid}_{self.cutoff}",
                            lambda: self.points, t)
        step = self.points[1] - self.points[0]
        i = torch.clamp(torch.floor(t / step).to(torch.int64), 0,
                        self.grid - 2)
        frac = _clip((t - pts[i]) / step, 0.0)
        frac = torch.where(t >= self.cutoff, torch.ones_like(frac), frac)
        th_i = _take(thetas, i)
        return th_i + (_take(thetas, i + 1) - th_i) * _clip(frac, 0.0, 1.0)

    def log_prob_from_heights(self, heights, params):
        thetas = self._thetas(params)
        # the grid lines past 0: the skygrid's edges for the same grid
        edges = topo_constant(self.topo, f"edges_{self.grid}_{self.cutoff}",
                              lambda: self.points[1:], heights)
        iv = interval_decomposition(heights, self.topo, edges)
        t0 = iv["start"]
        t1 = iv["start"] + iv["dt"]
        th0 = self._theta_at(thetas, t0)
        th1 = self._theta_at(thetas, t1)
        # int_{t0}^{t1} dt / theta(t), theta linear:
        # (t1 - t0) ln(th1 / th0) / (th1 - th0)
        near = torch.abs(th1 - th0) < 1e-12 * torch.maximum(th0, th1)
        denom = torch.where(near, torch.ones_like(th0), th1 - th0)
        seg = torch.where(near, iv["dt"] / th0,
                          iv["dt"] * (torch.log(th1) - torch.log(th0))
                          / denom)
        integral = torch.sum(iv["pairs"] * seg, -1)
        th_ev = self._theta_at(thetas, iv["t"])
        ev = torch.where(iv["is_coal"], torch.log(th_ev),
                         torch.zeros_like(th_ev))
        return -integral - torch.sum(ev, -1)
