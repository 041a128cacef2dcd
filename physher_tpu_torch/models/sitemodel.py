"""Site models: across-site rate heterogeneity (rate categories + weights).

Port of ``physher_tpu/models/sitemodel.py`` (reference:
src/phyc/sitemodel.c:573-800): a single rate, or a discretized Gamma with
the median quadrature. Rates are normalized so that
sum_c prop_c * rate_c = 1, and an optional ``mu`` multiplies all rates.
The discretization is differentiable w.r.t. the shape parameter through
:mod:`physher_tpu_torch.utils.special`.
"""

from __future__ import annotations

import torch

from .parameters import ParamSpec, ParamSpace
from ..utils.special import qgamma, qgamma_fixed_p


class SiteModel:
    """Base: ``rates_props(params) -> (rates [(L,) C], props [C])``; the
    rates carry the batch axes of a batch of parameter dicts."""

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


class QuantileSiteModel(SiteModel):
    """Discretized parametric rate distribution (+G).

    Only ``distribution='gamma'`` with ``quadrature='median'`` and no
    invariant category is ported; the others raise NotImplementedError.
    """

    def __init__(self, cat_count, distribution="gamma", invariant=False,
                 quadrature="median", prefix="", shape_init=0.5,
                 pinv_init=0.1, *, dtype, device, **kw):
        super().__init__(prefix, dtype=dtype, device=device, **kw)
        if distribution != "gamma" or quadrature != "median" or invariant:
            raise NotImplementedError(
                f"the {distribution}/{quadrature}"
                f"{' +I' if invariant else ''} site model is not ported to "
                "physher_tpu_torch yet (ROADMAP Queue 1 item 9); only the "
                "median Gamma quadrature is")
        self.gamma_cats = cat_count
        self.cat_count = cat_count
        self.distribution = distribution
        self.invariant = invariant
        self.quadrature = quadrature
        self.shape_init = shape_init
        self.pinv_init = pinv_init

    def param_specs(self):
        return super().param_specs() + [
            ParamSpec.scalar(self.key("shape"), self.shape_init, lower=0.0)
        ]

    def _quantile_rates(self, alpha, quantiles, static_p):
        """[(L,) K] quantiles for shapes alpha [(L)]."""
        if alpha.dtype == torch.float64:
            # float64 (the golden path) keeps the Newton inverse
            a = alpha[..., None]
            return qgamma(quantiles, a, a)
        # float32: host-tabulated quantiles at the fixed probabilities
        return qgamma_fixed_p(static_p, alpha)

    def rates_props(self, params):
        alpha = params[self.key("shape")]
        K = self.gamma_cats
        static_p = tuple((2.0 * k + 1.0) / (2.0 * K) for k in range(K))
        quantiles = (2.0 * torch.arange(K, dtype=alpha.dtype,
                                        device=alpha.device) + 1.0) / (2.0 * K)
        rates = self._quantile_rates(alpha, quantiles, static_p)
        rates = rates / (torch.sum(rates, -1, keepdim=True) / K)
        props = torch.full((K,), 1.0 / K, dtype=alpha.dtype,
                           device=alpha.device)
        return rates * self._mu(params), props


def GammaSiteModel(cat_count=4, invariant=False, *, dtype, device, **kw):
    return QuantileSiteModel(cat_count, "gamma", invariant, dtype=dtype,
                             device=device, **kw)
