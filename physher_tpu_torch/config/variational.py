"""Config builder for variational models.

Port of ``physher_tpu/config/variational.py`` (reference: src/phyc/vb.c
new_Variational_from_json: per-block "distributions" with normal or
multivariatenormal families over transformed parameters). Normal blocks map
to one mean-field normal on the unconstrained space with per-block initial
locations and scales; a multivariatenormal block or a full-rank family maps
to FullRankNormalVB. As in the JAX package, no config builds the gamma or
Weibull family.
"""

from __future__ import annotations

import numpy as np
import torch

from ..inference.ml import hessian_chunk
from ..inference.vb import MeanFieldNormalVB, FullRankNormalVB
from .builder import Context, _param_value


class VariationalHandle:
    """A built variational model: the family and the posterior it
    targets."""

    def __init__(self, family, posterior, space, params, elbo_samples=100,
                 grad_samples=1):
        self.family = family
        self.posterior = posterior
        self.space = space
        self.params = params
        self.elbo_samples = elbo_samples
        self.grad_samples = grad_samples
        self.vparams = family.init  # updated by the optimizer action

    def elbo(self, generator: torch.Generator = None, vparams=None,
             n_samples=None, eps=None):
        """The family's Monte-Carlo ELBO at ``vparams`` (the handle's own by
        default) over ``n_samples`` draws (``elbo_samples`` by default) from
        ``generator``, or over the given standard draws ``eps``."""
        return self.family.elbo(vparams or self.vparams, generator,
                                n_samples or self.elbo_samples, eps=eps)


def build_variational(node, ctx: Context):
    node = ctx.resolve(node)
    if isinstance(node, VariationalHandle):
        return node
    posterior = ctx.resolve(node.get("posterior"))
    log_prob = getattr(posterior, "log_prob", None) or posterior.log_likelihood
    space = posterior.param_space()
    params = space.init_params(**ctx.kw)

    blocks = node.get("distributions", [])
    fullrank = any(
        str(b.get("distribution", "")).lower() == "multivariatenormal"
        for b in blocks) or str(node.get("family", "")).lower() in (
            "fullrank", "multivariatenormal")
    cls = FullRankNormalVB if fullrank else MeanFieldNormalVB
    # an ELBO's draws run as batches of chains within the Hessian's budget
    fam = cls(log_prob, space, params, max_chains=hessian_chunk(posterior))

    # per-block initial mu and sigma on the unconstrained space
    slices = space.unconstrained_slices()
    scale_key = "log_diag" if fullrank else "log_scale"
    loc = fam.init["loc"].detach().cpu().numpy().astype(np.float64)
    log_scale = fam.init[scale_key].detach().cpu().numpy().astype(np.float64)
    for b in blocks:
        x = b.get("x")
        if x is None:
            continue
        idx = []
        for n in ctx.resolve_target(x):
            if n in slices:
                off, size = slices[n]
                idx.extend(range(off, off + size))
        idx = np.asarray(idx, dtype=np.int64)
        pnode = b.get("parameters", {})
        initialize = bool(b.get("initialize", False))
        mu_node = pnode.get("mu") if isinstance(pnode, dict) else None
        sigma_node = pnode.get("sigma") if isinstance(pnode, dict) else None
        # as in the JAX package, only a "value" (not "values") sets the
        # block's mu or sigma
        if mu_node is not None and not initialize:
            mu = np.ravel(np.asarray(_param_value(mu_node, ctx, 0.0)))
            if mu.size in (1, idx.size) and "value" in (
                    mu_node if isinstance(mu_node, dict) else {"value": 1}):
                loc[idx] = mu if mu.size == idx.size else mu[0]
        if sigma_node is not None:
            sg = np.ravel(np.asarray(_param_value(sigma_node, ctx, 0.1)))
            if isinstance(sigma_node, dict) and "value" in sigma_node:
                log_scale[idx] = np.log(sg if sg.size == idx.size else sg[0])

    fam.init["loc"] = torch.as_tensor(loc, **ctx.kw)
    fam.init[scale_key] = torch.as_tensor(log_scale, **ctx.kw)

    handle = VariationalHandle(
        fam, posterior, space, params,
        elbo_samples=int(node.get("elbosamples", 100)),
        grad_samples=int(node.get("gradsamples", 1)))
    ctx.register(node.get("id"), handle)
    return handle
