"""Site models: across-site rate heterogeneity (rate categories + weights).

Port of ``physher_tpu/models/sitemodel.py`` (reference:
src/phyc/sitemodel.c:573-800): a single rate, +I, free discrete rates, and
discretized Gamma / Weibull / LogNormal distributions (optionally +I) with
the median, mean, beta and Kumaraswamy quadratures. Rates are normalized so
that sum_c prop_c * rate_c = 1, and an optional ``mu`` multiplies all
rates. The discretizations are differentiable w.r.t. the shape parameter
through :mod:`physher_tpu_torch.utils.special`. Every model takes a batch
of parameter dicts: parameters ``[L, ...]`` give rates and proportions
``[L, C]``.
"""

from __future__ import annotations

import torch

import numpy as np

from .parameters import ParamSpec, ParamSpace
from ..utils.special import (
    betaincinv, gammainc, qgamma, qgamma_fixed_p, qlognormal, qweibull1)


class SiteModel:
    """Base: ``rates_props(params) -> (rates [(L,) C], props [(L,) C])``;
    both carry the batch axes of a batch of parameter dicts where they
    depend on its parameters (constant proportions stay ``[C]``)."""

    cat_count: int = 1

    def __init__(self, prefix: str = "", mu: bool = False,
                 mu_init: float = 1.0, *, dtype: torch.dtype, device):
        self.prefix = prefix
        self.use_mu = mu
        self.mu_init = mu_init
        self.dtype = dtype
        self.device = torch.device(device)

    def key(self, k):
        return f"{self.prefix}{k}" if self.prefix else k

    def param_specs(self) -> list:
        if self.use_mu:
            return [ParamSpec.scalar(self.key("mu"), self.mu_init, lower=0.0)]
        return []

    def param_space(self) -> ParamSpace:
        return ParamSpace(self.param_specs())

    def _mu(self, params):
        """mu ``[(L,) 1]``, or 1.0 without one."""
        return params[self.key("mu")][..., None] if self.use_mu else 1.0

    def rates_props(self, params):
        raise NotImplementedError


class ConstantSiteModel(SiteModel):
    """Single rate category (reference: sitemodel.c:497)."""

    def rates_props(self, params):
        one = torch.ones(1, dtype=self.dtype, device=self.device)
        return one * self._mu(params), one


class InvariantSiteModel(SiteModel):
    """+I: proportion pinv of invariable sites (reference:
    sitemodel.c:646-652: rates [0, 1/(1-pinv)])."""

    cat_count = 2

    def __init__(self, prefix="", pinv_init=0.1, *, dtype, device, **kw):
        super().__init__(prefix, dtype=dtype, device=device, **kw)
        self.pinv_init = pinv_init

    def param_specs(self):
        return super().param_specs() + [
            ParamSpec.simplex(self.key("proportions"),
                              [self.pinv_init, 1.0 - self.pinv_init])
        ]

    def rates_props(self, params):
        props = params[self.key("proportions")]
        rates = torch.stack([torch.zeros_like(props[..., 0]),
                             1.0 / props[..., 1]], -1)
        return rates * self._mu(params), props


class DiscreteSiteModel(SiteModel):
    """Free rates + proportions (+G+D style general discrete distribution,
    reference: sitemodel.c QUADRATURE_DISCRETE with explicit rates)."""

    def __init__(self, cat_count, prefix="", rates_init=None, props_init=None,
                 normalize=True, *, dtype, device, **kw):
        super().__init__(prefix, dtype=dtype, device=device, **kw)
        self.cat_count = cat_count
        self.rates_init = (np.linspace(0.5, 1.5, cat_count)
                           if rates_init is None else np.asarray(rates_init))
        self.props_init = (np.full(cat_count, 1.0 / cat_count)
                           if props_init is None else np.asarray(props_init))
        self.normalize = normalize

    def param_specs(self):
        return super().param_specs() + [
            ParamSpec.vector(self.key("rates"), self.rates_init, lower=0.0),
            ParamSpec.simplex(self.key("proportions"), self.props_init),
        ]

    def rates_props(self, params):
        rates = params[self.key("rates")]
        props = params[self.key("proportions")]
        if self.normalize:
            rates = rates / torch.sum(rates * props, -1, keepdim=True)
        return rates * self._mu(params), props


class QuantileSiteModel(SiteModel):
    """Discretized parametric rate distribution (+G / +W / +LN, optionally
    +I).

    distribution in {'gamma','weibull','lognormal'};
    quadrature in {'median','mean','laguerre','beta','kumaraswamy'}. The
    Gauss-Laguerre quadrature raises, as in the JAX package.
    """

    def __init__(self, cat_count, distribution="gamma", invariant=False,
                 quadrature="median", prefix="", shape_init=0.5,
                 pinv_init=0.1, *, dtype, device, **kw):
        super().__init__(prefix, dtype=dtype, device=device, **kw)
        self.gamma_cats = cat_count
        self.cat_count = cat_count + (1 if invariant else 0)
        self.distribution = distribution
        self.invariant = invariant
        self.quadrature = quadrature
        self.shape_init = shape_init
        self.pinv_init = pinv_init
        if quadrature in ("laguerre",) and distribution != "gamma":
            raise ValueError("Gauss-Laguerre quadrature requires gamma")

    def param_specs(self):
        specs = super().param_specs() + [
            ParamSpec.scalar(self.key("shape"), self.shape_init, lower=0.0)
        ]
        if self.quadrature in ("beta", "kumaraswamy"):
            specs.append(
                ParamSpec.scalar(self.key("quad_beta"), 1.0, lower=0.0))
        if self.invariant:
            specs.append(ParamSpec.simplex(
                self.key("proportions"), [self.pinv_init, 1 - self.pinv_init]))
        return specs

    def _quantile_rates(self, alpha, quantiles, static_p=None):
        """Quantiles ``[(L,) K]`` of the distribution at shape ``alpha
        [(L,) 1]``."""
        if self.distribution == "gamma":
            if static_p is not None and alpha.dtype != torch.float64:
                # float32: host-tabulated quantiles at the fixed
                # probabilities; float64 (the golden path) keeps the Newton
                # inverse
                return qgamma_fixed_p(static_p, alpha[..., 0])
            return qgamma(quantiles, alpha, alpha)
        if self.distribution == "weibull":
            return qweibull1(quantiles, alpha)
        if self.distribution == "lognormal":
            return qlognormal(quantiles, -alpha * alpha / 2.0, alpha)
        raise ValueError(self.distribution)

    def rates_props(self, params):
        alpha = params[self.key("shape")][..., None]     # [(L,) 1]
        K = self.gamma_cats
        if self.invariant:
            props01 = params[self.key("proportions")]
            pinv, pvar = props01[..., :1], props01[..., 1:]
        else:
            pinv, pvar = None, 1.0
        ar = torch.arange(K, dtype=alpha.dtype, device=alpha.device)
        flat = torch.full((K,), 1.0 / K, dtype=alpha.dtype,
                          device=alpha.device)

        if self.quadrature == "median":
            static_p = tuple((2.0 * k + 1.0) / (2.0 * K) for k in range(K))
            rates = self._quantile_rates(alpha, (2.0 * ar + 1.0) / (2.0 * K),
                                         static_p=static_p)
            rates = rates / (pvar * torch.sum(rates, -1, keepdim=True) / K)
            props = flat * pvar
        elif self.quadrature == "mean":
            # mean of each equal-probability gamma slice
            # (reference: sitemodel.c:760-776)
            edges = qgamma((ar[:-1] + 1.0) / K, alpha, alpha)
            cum = gammainc(alpha + 1.0, edges * alpha)
            cum = torch.cat([torch.zeros_like(cum[..., :1]), cum,
                             torch.ones_like(cum[..., :1])], -1)
            rates = (cum[..., 1:] - cum[..., :-1]) * K
            props = flat * pvar
            rates = rates / (pvar * torch.sum(rates, -1, keepdim=True) / K)
        elif self.quadrature == "laguerre":
            raise NotImplementedError(
                "laguerre quadrature: use 'median' or 'mean'")
        elif self.quadrature in ("beta", "kumaraswamy"):
            b = params[self.key("quad_beta")][..., None]
            grid = ar / K
            if self.quadrature == "beta":
                qs = betaincinv(alpha, b, grid)
            else:
                qs = (1.0 - (1.0 - grid) ** (1.0 / b)) ** (1.0 / alpha)
            props_var = torch.diff(torch.cat(
                [qs, torch.ones_like(qs[..., :1])], -1), dim=-1)
            mids = qs + props_var / 2.0
            rates = self._quantile_rates(alpha, mids)
            props = props_var * pvar
            rates = rates / torch.sum(rates * props, -1, keepdim=True)
        else:
            raise ValueError(self.quadrature)

        if self.invariant:
            rates = torch.cat([torch.zeros_like(rates[..., :1]), rates], -1)
            props = torch.cat([pinv, props.expand(rates.shape[:-1] + (K,))],
                              -1)
        rates = rates * self._mu(params)
        return rates, props.expand(rates.shape)


def GammaSiteModel(cat_count=4, invariant=False, *, dtype, device, **kw):
    return QuantileSiteModel(cat_count, "gamma", invariant, dtype=dtype,
                             device=device, **kw)


def WeibullSiteModel(cat_count=4, invariant=False, *, dtype, device, **kw):
    return QuantileSiteModel(cat_count, "weibull", invariant, dtype=dtype,
                             device=device, **kw)
