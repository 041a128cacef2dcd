"""Config builders for compound models, distribution priors and coalescents.

Port of ``physher_tpu/config/compound.py``: the reference's JSON shapes
(reference: src/phyc/compoundmodel.c new_CompoundModel_from_json with
"distributions", src/phyc/distmodelfactory.c:51-117 "distribution"
dispatch, src/phyc/demographicmodels.c coalescent factories) onto model
objects sharing one parameter dict.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.coalescent import (
    ConstantCoalescent, ExponentialCoalescent, PiecewiseLinearCoalescent,
    SkygridCoalescent, SkylineCoalescent, SkyrideCoalescent,
)
from ..models.distributions import (
    CompoundModel, PriorModel, ctmc_scale_logpdf,
)
from .builder import (
    BUILDERS, Context, _param_value, build_parameter_spec, build_simplex_spec,
    build_treelikelihood,
)


class CTMCScalePrior:
    """CTMC reference prior on clock rate(s), tied to a tree's total time
    (reference: src/phyc/ctmcscale.c)."""

    def __init__(self, target_names, tree_handle):
        self.targets = list(target_names)
        self.tree = tree_handle

    def param_specs(self):
        return []

    def log_prob(self, params):
        """One log-density per batch entry: the tree length T has the
        batch shape of ``params``."""
        T = self.tree.tree_length(params)
        total = 0.0
        for name in self.targets:
            r = params[name].reshape(T.shape + (-1,))
            total = total + torch.sum(ctmc_scale_logpdf(r, T[..., None]), -1)
        return total

    __call__ = log_prob


# distribution JSON key -> (our name, hyper-parameter key mapping)
_DIST_KEYMAP = {
    "normal": ("normal", {"mean": "mean", "mu": "mean", "sigma": "sigma",
                          "tau": "tau", "sd": "sigma"}),
    "halfnormal": ("halfnormal", {"sigma": "sigma", "tau": "tau",
                                  "sd": "sigma"}),
    "lognormal": ("lognormal", {"mu": "mu", "mean": "mu", "sigma": "sigma",
                                "sd": "sigma"}),
    "gamma": ("gamma", {"shape": "shape", "alpha": "shape", "rate": "rate",
                        "beta": "rate", "scale": "scale"}),
    "exponential": ("exponential", {"lambda": "rate", "rate": "rate",
                                    "mean": "mean"}),
    "beta": ("beta", {"alpha": "alpha", "beta": "beta"}),
    "betaprime": ("betaprime", {"alpha": "alpha", "beta": "beta"}),
    "cauchy": ("cauchy", {"location": "location", "scale": "scale"}),
    "kumaraswamy": ("kumaraswamy", {"a": "a", "b": "b", "alpha": "a",
                                    "beta": "b"}),
    "dirichlet": ("dirichlet", {"concentration": "alpha", "alpha": "alpha"}),
    "oneonx": ("oneonx", {}),
    "uniform": ("uniform", {"lower": "lower", "upper": "upper"}),
    "gmrf": ("gmrf", {"precision": "precision"}),
    "weibull": ("weibull", {"shape": "shape", "scale": "scale"}),
    "multivariatenormal": ("multivariatenormal", {"mean": "mean",
                                                  "covariance": "cov"}),
}


class _TopologyPrior(PriorModel):
    """Uniform prior over topologies: constant 0 for a fixed topology
    (reference: distmodel.h:94 new_UniformTreeDistribution)."""

    def __init__(self):
        super().__init__("uniform", [], {"lower": 0.0, "upper": 1.0})

    def log_prob(self, params):
        return 0.0

    __call__ = log_prob


def build_distribution(node, ctx: Context):
    node = ctx.resolve(node)
    if not isinstance(node, dict):
        return node
    dist = str(node.get("distribution", "normal")).lower()
    did = node.get("id", f"prior.{dist}")

    # the targets
    x = node.get("x", node.get("tree"))
    targets, x_specs = [], []
    if x is not None:
        if isinstance(x, str) and x.startswith("&") and x[1:] in ctx.objects \
                and hasattr(ctx.objects[x[1:]], "is_time_tree"):
            # a distribution over a tree's branch lengths
            targets = [ctx.objects[x[1:]].key("distances")]
        else:
            # inline x definitions declare new parameters owned by this
            # distribution (reference: distmodel.c builds x from JSON)
            for xi in x if isinstance(x, list) else [x]:
                if isinstance(xi, dict):
                    typ = str(xi.get("type", "parameter")).lower()
                    spec = (build_simplex_spec(xi, ctx) if typ == "simplex"
                            else build_parameter_spec(xi, ctx))
                    ctx.extra_specs.append(spec)
                    x_specs.append(spec)
                    targets.append(spec.name)
                else:
                    targets.extend(ctx.resolve_target(xi))

    if dist == "ctmcscale":
        prior = CTMCScalePrior(targets, ctx.resolve(node.get("tree")))
        ctx.register(did, prior)
        return prior

    if dist == "topology":
        prior = _TopologyPrior()
        ctx.register(did, prior)
        return prior

    name, keymap = _DIST_KEYMAP[dist]
    hyper = {}
    pnode = node.get("parameters")
    if isinstance(pnode, dict):
        for k, sub in pnode.items():
            lk = keymap.get(k.lower())
            if lk is None:
                continue
            # register inline hyper-parameter ids so that later '&id'
            # references resolve
            if isinstance(sub, dict) and sub.get("id"):
                build_parameter_spec(sub, ctx)
            hyper[lk] = np.asarray(_param_value(sub, ctx))
    elif isinstance(pnode, list) and dist == "dirichlet":
        hyper["alpha"] = np.asarray(pnode, dtype=np.float64)
    if dist == "dirichlet" and "alpha" not in hyper:
        hyper["alpha"] = 1.0

    prior = PriorModel(name, [(t, None) for t in targets], hyper,
                       shift=float(node.get("shift", 0.0)))
    prior.extra_param_specs = list(x_specs)
    ctx.register(did, prior)
    return prior


_COAL_LOG = {"theta": False, "logtheta": True, "log": True}


def build_coalescent(node, ctx: Context):
    node = ctx.resolve(node)
    if not isinstance(node, dict):
        return node
    model = str(node.get("model", "constant")).lower()
    cid = node.get("id", "coalescent")
    prefix = f"{cid}."
    handle = ctx.resolve(node.get("tree"))
    topo = handle.topo
    pnode = node.get("parameters", {})
    space = str(node.get("parameterization", "theta")).lower()
    log_space = _COAL_LOG.get(space, False)

    def reg(pn, spec_name):
        if isinstance(pn, dict) and pn.get("id"):
            ctx.param_names[pn["id"]] = spec_name

    if model == "constant":
        theta_node = None
        if isinstance(pnode, dict):
            theta_node = (pnode.get("n0") or pnode.get("theta")
                          or pnode.get("N"))
        init = (float(_param_value(theta_node, ctx, 1.0))
                if theta_node is not None else 1.0)
        coal = ConstantCoalescent(topo, prefix, theta_init=init,
                                  log_space=log_space)
        reg(theta_node, coal.key("theta"))
    elif model == "exponential":
        n0 = pnode.get("n0") if isinstance(pnode, dict) else None
        rate = (pnode.get("rate", pnode.get("growth"))
                if isinstance(pnode, dict) else None)
        coal = ExponentialCoalescent(
            topo, prefix,
            n0_init=float(_param_value(n0, ctx, 1.0)) if n0 is not None
            else 1.0,
            rate_init=float(_param_value(rate, ctx, 0.0)) if rate is not None
            else 0.0)
        reg(n0, coal.key("n0"))
        reg(rate, coal.key("rate"))
    elif model == "skyride":
        thetas = pnode.get("thetas") if isinstance(pnode, dict) else pnode
        delta = space == "delta"
        init = (np.asarray(_param_value(thetas, ctx)) if thetas is not None
                else np.ones(topo.I + 2 if delta else topo.I))
        coal = SkyrideCoalescent(topo, prefix, thetas_init=init,
                                 log_space=log_space, delta=delta)
        reg(thetas, coal.key("thetas"))
    elif model in ("skygrid", "grid"):
        thetas = pnode.get("thetas") if isinstance(pnode, dict) else pnode
        init = np.asarray(_param_value(thetas, ctx))
        coal = SkygridCoalescent(topo, int(node.get("grid", len(init))),
                                 float(node["cutoff"]), prefix,
                                 thetas_init=init, log_space=log_space)
        reg(thetas, coal.key("thetas"))
    elif model in ("piecewise-linear", "piecewiselinear", "skyglide"):
        thetas = pnode.get("thetas") if isinstance(pnode, dict) else pnode
        init = np.asarray(_param_value(thetas, ctx))
        coal = PiecewiseLinearCoalescent(
            topo, int(node.get("grid", len(init))), float(node["cutoff"]),
            prefix, thetas_init=init, log_space=log_space)
        reg(thetas, coal.key("thetas"))
    elif model == "skyline":
        thetas = pnode.get("thetas") if isinstance(pnode, dict) else pnode
        init = np.asarray(_param_value(thetas, ctx))
        coal = SkylineCoalescent(topo, node.get("groups"), prefix,
                                 thetas_init=init, log_space=log_space)
        reg(thetas, coal.key("thetas"))
    else:
        raise ValueError(f"unknown coalescent model {model!r}")

    coal.bind_tree(handle.heights)
    ctx.register(cid, coal)
    return coal


def build_compound(node, ctx: Context):
    node = ctx.resolve(node)
    if isinstance(node, CompoundModel):
        return node
    comps = []
    for sub in node.get("distributions", []):
        sub_r = ctx.resolve(sub)
        if not isinstance(sub_r, dict):
            comps.append(sub_r)
            continue
        typ = str(sub_r.get("type", "distribution")).lower()
        if typ == "treelikelihood":
            comps.append(build_treelikelihood(sub_r, ctx))
        elif typ == "coalescent":
            comps.append(build_coalescent(sub_r, ctx))
        elif typ == "compound":
            comps.append(build_compound(sub_r, ctx))
        elif typ in ("distribution", "ctmcscale"):
            comps.append(build_distribution(sub_r, ctx))
        elif typ == "parsimony":
            comps.append(BUILDERS["parsimony"](sub_r, ctx))
        else:
            raise ValueError(f"unknown compound component type {typ!r}")
    comp = CompoundModel(comps)
    ctx.register(node.get("id"), comp)
    return comp
