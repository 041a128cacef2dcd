"""Probability distributions: priors over entries of the parameter dict.

Port of ``physher_tpu/models/distributions.py`` (reference:
src/phyc/distmodel.c, distmodelfactory.c:51-117 and the per-density files
distnormal.c, distlognormal.c, distgamma.c, distexp.c, distbeta.c,
distbetaprime.c, distcauchy.c, distdirichlet.c, distkumaraswamy.c,
distmultinormal.c, distoneonx.c, ctmcscale.c, gmrf.c). Each density is a
function of tensors, parameterized the ways the reference supports (gamma
shape/rate or shape/scale, normal sigma or tau, exponential rate or mean;
reference: distmodel.h:26-35). :func:`sample` draws from a
``torch.Generator``, which gives other numbers than the JAX key of the same
seed.

``PriorModel`` binds a density to target parameter names in the parameter
dict; ``CompoundModel`` sums its components' log-probabilities (the
posterior = likelihood + priors). Given a batch of parameter dicts (a
``ParamBatch``, tensors ``[L, ...]``), both return ``[L]`` log-densities.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .parameters import ParamSpec, ParamSpace, batch_shape

LOG_2PI = math.log(2.0 * math.pi)


def _t(x, like: torch.Tensor) -> torch.Tensor:
    """A hyper-parameter as a tensor of ``like``'s dtype and device."""
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def _betaln(a, b):
    return torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)


# -- densities (elementwise; callers sum) -----------------------------------


def normal_logpdf(x, mean, sigma=None, tau=None):
    mean = _t(mean, x)
    sigma = 1.0 / torch.sqrt(_t(tau, x)) if sigma is None else _t(sigma, x)
    z = (x - mean) / sigma
    return -0.5 * (LOG_2PI + z * z) - torch.log(sigma)


def halfnormal_logpdf(x, sigma=None, tau=None):
    sigma = 1.0 / torch.sqrt(_t(tau, x)) if sigma is None else _t(sigma, x)
    z = x / sigma
    return math.log(2.0) - 0.5 * LOG_2PI - torch.log(sigma) - 0.5 * z * z


def lognormal_logpdf(x, mu, sigma):
    mu, sigma = _t(mu, x), _t(sigma, x)
    lx = torch.log(x)
    z = (lx - mu) / sigma
    return -0.5 * (LOG_2PI + z * z) - torch.log(sigma) - lx


def gamma_logpdf(x, shape, rate=None, scale=None):
    shape = _t(shape, x)
    rate = 1.0 / _t(scale, x) if rate is None else _t(rate, x)
    return (shape * torch.log(rate) - torch.lgamma(shape)
            + (shape - 1.0) * torch.log(x) - rate * x)


def exponential_logpdf(x, rate=None, mean=None):
    rate = 1.0 / _t(mean, x) if rate is None else _t(rate, x)
    return torch.log(rate) - rate * x


def beta_logpdf(x, alpha, beta):
    alpha, beta = _t(alpha, x), _t(beta, x)
    return ((alpha - 1.0) * torch.log(x) + (beta - 1.0) * torch.log1p(-x)
            - _betaln(alpha, beta))


def betaprime_logpdf(x, alpha, beta):
    alpha, beta = _t(alpha, x), _t(beta, x)
    return ((alpha - 1.0) * torch.log(x) - (alpha + beta) * torch.log1p(x)
            - _betaln(alpha, beta))


def cauchy_logpdf(x, location, scale):
    location, scale = _t(location, x), _t(scale, x)
    z = (x - location) / scale
    return -math.log(math.pi) - torch.log(scale) - torch.log1p(z * z)


def kumaraswamy_logpdf(x, a, b):
    a, b = _t(a, x), _t(b, x)
    return (torch.log(a) + torch.log(b) + (a - 1.0) * torch.log(x)
            + (b - 1.0) * torch.log1p(-(x ** a)))


def weibull_logpdf(x, shape, scale=1.0):
    shape, scale = _t(shape, x), _t(scale, x)
    z = x / scale
    return (torch.log(shape) - torch.log(scale) + (shape - 1.0) * torch.log(z)
            - z ** shape)


def dirichlet_logpdf(x, alpha):
    alpha = torch.broadcast_to(_t(alpha, x), x.shape)
    return (torch.sum((alpha - 1.0) * torch.log(x), -1)
            + torch.lgamma(torch.sum(alpha, -1))
            - torch.sum(torch.lgamma(alpha), -1))


def oneonx_logpdf(x):
    """Improper 1/x prior (reference: src/phyc/distoneonx.c)."""
    return -torch.log(x)


def uniform_logpdf(x, lower=0.0, upper=1.0):
    lower, upper = _t(lower, x), _t(upper, x)
    inside = (x >= lower) & (x <= upper)
    return torch.where(inside, -torch.log(upper - lower),
                       torch.full_like(x, -math.inf))


def multivariate_normal_logpdf(x, mean, cov=None, scale_tril=None):
    mean = _t(mean, x)
    scale_tril = (torch.linalg.cholesky(_t(cov, x)) if scale_tril is None
                  else _t(scale_tril, x))
    d = x.shape[-1]
    y = torch.linalg.solve_triangular(scale_tril, (x - mean)[..., None],
                                      upper=False)[..., 0]
    logdet = torch.sum(torch.log(torch.abs(torch.diagonal(scale_tril))))
    return -0.5 * (d * LOG_2PI + torch.sum(y * y, -1)) - logdet


def student_t_logpdf(x, df, loc=0.0, scale=1.0):
    df, loc, scale = _t(df, x), _t(loc, x), _t(scale, x)
    z = (x - loc) / scale
    return (torch.lgamma((df + 1) / 2) - torch.lgamma(df / 2)
            - 0.5 * torch.log(df * math.pi) - torch.log(scale)
            - (df + 1) / 2 * torch.log1p(z * z / df))


def gmrf_logpdf(log_thetas, precision):
    """Gaussian Markov random field over successive differences (reference:
    src/phyc/gmrf.c, the skyride/skygrid smoothing prior)."""
    precision = _t(precision, log_thetas)
    d = torch.diff(log_thetas)
    n = d.shape[-1]
    return (0.5 * n * (torch.log(precision) - LOG_2PI)
            - 0.5 * precision * torch.sum(d * d, -1))


def ctmc_scale_logpdf(rate, tree_length):
    """CTMC reference prior on the clock rate (reference:
    src/phyc/ctmcscale.c:28-31): p(r) proportional to sqrt(T/r) exp(-r T),
    a Gamma(1/2, T) form."""
    total = tree_length
    return (0.5 * torch.log(total) - 0.5 * torch.log(math.pi * rate)
            - rate * total)


# -- sampling ---------------------------------------------------------------


def _gamma(generator, shape, sample_shape, like):
    alpha = torch.broadcast_to(_t(shape, like), sample_shape).contiguous()
    return torch._standard_gamma(alpha, generator=generator)


def sample(name: str, generator: torch.Generator, sample_shape, *,
           dtype: torch.dtype = torch.float64, **kw):
    """Draw samples of the named distribution from ``generator`` (on its
    device)."""
    sample_shape = tuple(sample_shape)
    like = torch.empty((), dtype=dtype, device=generator.device)

    def rand(shape=sample_shape):
        return torch.rand(shape, generator=generator, dtype=dtype,
                          device=generator.device)

    if name == "normal":
        return kw["mean"] + kw["sigma"] * torch.randn(
            sample_shape, generator=generator, dtype=dtype,
            device=generator.device)
    if name == "lognormal":
        return torch.exp(kw["mu"] + kw["sigma"] * torch.randn(
            sample_shape, generator=generator, dtype=dtype,
            device=generator.device))
    if name == "gamma":
        rate = kw.get("rate") or 1.0 / kw["scale"]
        return _gamma(generator, kw["shape"], sample_shape, like) / rate
    if name == "exponential":
        rate = kw.get("rate") or 1.0 / kw["mean"]
        return -torch.log1p(-rand()) / rate
    if name == "beta":
        a = _gamma(generator, kw["alpha"], sample_shape, like)
        b = _gamma(generator, kw["beta"], sample_shape, like)
        return a / (a + b)
    if name == "dirichlet":
        g = _gamma(generator, kw["alpha"], sample_shape, like)
        return g / g.sum(-1, keepdim=True)
    if name == "cauchy":
        return kw["location"] + kw["scale"] * torch.tan(
            math.pi * (rand() - 0.5))
    if name == "uniform":
        lo, hi = kw.get("lower", 0.0), kw.get("upper", 1.0)
        return lo + (hi - lo) * rand()
    if name == "kumaraswamy":
        u = rand()
        return (1.0 - (1.0 - u) ** (1.0 / kw["b"])) ** (1.0 / kw["a"])
    raise ValueError(f"sampling not implemented for {name!r}")


LOGPDFS = {
    "normal": normal_logpdf,
    "halfnormal": halfnormal_logpdf,
    "lognormal": lognormal_logpdf,
    "gamma": gamma_logpdf,
    "exponential": exponential_logpdf,
    "beta": beta_logpdf,
    "betaprime": betaprime_logpdf,
    "cauchy": cauchy_logpdf,
    "kumaraswamy": kumaraswamy_logpdf,
    "weibull": weibull_logpdf,
    "dirichlet": dirichlet_logpdf,
    "oneonx": oneonx_logpdf,
    "uniform": uniform_logpdf,
    "multivariatenormal": multivariate_normal_logpdf,
    "student": student_t_logpdf,
    "gmrf": gmrf_logpdf,
}


class PriorModel:
    """A distribution over entries of the parameter dict.

    ``targets`` — list of (param_name, index_or_None); values are gathered,
    flattened and scored elementwise (dirichlet, multivariate normal and
    gmrf score the vector). Hyper-parameters are constants (``hyper``) or
    free parameters with their own ParamSpecs (``hyper_free``).
    """

    def __init__(self, dist: str, targets, hyper: dict, prefix: str = "",
                 hyper_free: dict | None = None, shift: float = 0.0):
        self.dist = dist
        self.targets = list(targets)
        self.hyper = dict(hyper)
        self.prefix = prefix
        self.hyper_free = dict(hyper_free or {})
        # location offset: logP evaluated at x - shift (reference:
        # src/phyc/distmodel.h:83 ``double shift``, applied in e.g.
        # distgamma.c:31)
        self.shift = float(shift)
        # specs of x-parameters declared inline by the distribution's config
        # node (set by config/compound.py build_distribution)
        self.extra_param_specs = []
        if dist not in LOGPDFS:
            raise ValueError(f"unknown distribution {dist!r}")

    def key(self, k):
        return f"{self.prefix}{k}" if self.prefix else k

    def param_specs(self):
        specs = []
        for hname, init in self.hyper_free.items():
            specs.append(ParamSpec.scalar(
                self.key(hname), init,
                lower=0.0 if hname not in ("mean", "mu", "location")
                else -np.inf))
        return specs + list(self.extra_param_specs)

    def param_space(self):
        return ParamSpace(self.param_specs())

    def gather(self, params):
        """The targets' values, flattened: ``[(L,) n]``."""
        lead = batch_shape(params)
        vals = []
        for name, idx in self.targets:
            v = params[name]
            if idx is not None:
                v = v[..., idx] if lead else v[idx]
            vals.append(torch.reshape(v, lead + (-1,)))
        return torch.cat(vals, -1)

    def hyper_values(self, params):
        out = dict(self.hyper)
        lead = batch_shape(params)
        for hname in self.hyper_free:
            v = params[self.key(hname)]
            out[hname] = v[..., None] if lead else v
        return out

    def log_prob(self, params):
        """One log-density per batch entry of ``params``."""
        x = self.gather(params)
        if self.shift:
            x = x - self.shift
        lp = LOGPDFS[self.dist](x, **self.hyper_values(params))
        return torch.sum(lp.reshape(batch_shape(params) + (-1,)), -1)

    __call__ = log_prob


class CompoundModel:
    """Sum of component log-probabilities (reference:
    src/phyc/compoundmodel.c: the posterior = likelihood + priors)."""

    def __init__(self, components: list):
        self.components = list(components)

    def param_specs(self):
        specs = []
        for c in self.components:
            specs.extend(c.param_specs())
        return specs

    def param_space(self) -> ParamSpace:
        return ParamSpace(self.param_specs())

    def log_prob(self, params):
        total = 0.0
        for c in self.components:
            fn = getattr(c, "log_prob", None) or getattr(c, "log_likelihood")
            total = total + fn(params)
        return total

    __call__ = log_prob
