"""Action execution: the ``physher`` run list of a config.

Port of the ``optimizer`` and ``logger`` actions of
``physher_tpu/config/actions.py`` (reference: src/physher.c:207-305).
Actions share one parameter pool, so sequential actions see each other's
results (the reference's shared Parameter objects in its hashtable). The
random draws come from one ``torch.Generator`` on the context's device,
seeded once. Every other action type, and every optimizer algorithm but
``sg`` / ``adam``, raises ``NotImplementedError`` naming its ROADMAP item.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..inference import ml, vb as vb_mod
from ..models.parameters import ParamSpace
from .builder import Context
from .variational import VariationalHandle

# the JAX package's actions that are not ported yet -> ROADMAP Queue 1 item
_UNPORTED_ACTIONS = {
    "mcmc": 13, "mmcmc": 13, "marginallikelihood": 13, "laplace": 13,
    "bridgesampling": 13, "is": 13, "nest": 13, "cpo": 13, "mc": 13,
    "predictive": 13, "hessian": 8, "asr": 14, "ppsite": 14, "cat": 14,
    "simultron": 14, "sbn": 17, "dumper": 17,
}
# optimizer algorithms -> ROADMAP Queue 1 item, for the unported ones
_UNPORTED_ALGORITHMS = {"meta": 8, "lbfgs": 8, "bfgs": 8, "cg": 8,
                        "brent": 8, "serial": 8, "serialbrent": 8,
                        "topology": 16}


class Runner:
    def __init__(self, ctx: Context, seed: int = 0, out=None):
        self.ctx = ctx
        self.seed = seed
        self.generator = torch.Generator(device=ctx.device).manual_seed(seed)
        self.pool: dict = {}
        self.out = out or sys.stdout
        self.results: dict = {}

    # -- parameter pool ----------------------------------------------------

    def params_for(self, space: ParamSpace) -> dict:
        init = space.init_params(**self.ctx.kw)
        return {k: self.pool.get(k, v) for k, v in init.items()}

    def update_pool(self, params: dict):
        self.pool.update({k: v.detach() for k, v in params.items()})

    @staticmethod
    def model_logprob(model):
        return getattr(model, "log_prob", None) or model.log_likelihood

    # -- dispatch ----------------------------------------------------------

    def run(self, actions: list):
        for node in actions:
            typ = str(node.get("type", "")).lower()
            handler = getattr(self, f"action_{typ}", None)
            if handler is not None:
                handler(node)
            elif typ in _UNPORTED_ACTIONS:
                raise NotImplementedError(
                    f"action {typ!r} is not ported to physher_tpu_torch yet "
                    f"(ROADMAP Queue 1 item {_UNPORTED_ACTIONS[typ]})")
            else:
                raise ValueError(f"unknown action type {typ!r}")
        return self.results

    # -- actions -----------------------------------------------------------

    def action_optimizer(self, node):
        model = self.ctx.resolve(node.get("model"))
        algorithm = str(node.get("algorithm", "meta")).lower()
        max_iter = int(node.get("max", 1000))
        tol = float(node.get("precision", node.get("tol", 1e-3)))
        sub_algs = {str(s.get("algorithm", "")).lower()
                    for s in node.get("list", [])}
        for alg in sub_algs | {algorithm}:
            if alg in _UNPORTED_ALGORITHMS:
                raise NotImplementedError(
                    f"optimizer algorithm {alg!r} is not ported to "
                    f"physher_tpu_torch yet (ROADMAP Queue 1 item "
                    f"{_UNPORTED_ALGORITHMS[alg]}); use 'sg' or 'adam'")
        if algorithm not in ("sg", "adam"):
            raise ValueError(f"unknown optimizer algorithm {algorithm!r}")

        if isinstance(model, VariationalHandle):
            # SG/Adam on the ELBO (reference: optimizer.c OPT_SG/OPT_SG_ADAM
            # driving the variational model, JC69-time-ELBO.json)
            res = vb_mod.fit(
                model.family, self.generator, steps=max_iter,
                learning_rate=float(node.get("eta", 0.05)),
                grad_samples=model.grad_samples,
                elbo_samples=model.elbo_samples, tol=tol)
            model.vparams = res.vparams
            self.results[node.get("id", "vb")] = res
            print(f"ELBO: {res.elbo:.6f} ({res.iterations} iterations)",
                  file=self.out)
            return res

        if node.get("checkpoint"):
            raise NotImplementedError(
                "the ML optimizer's CSV checkpoint is not ported to "
                "physher_tpu_torch yet (ROADMAP Queue 1 item 8)")
        log_prob = self.model_logprob(model)
        space = model.param_space()
        params = self.params_for(space)
        # The JAX package runs Adam with its defaults here and ignores "max"
        # and "eta"; the port honours them when the config gives them, as
        # the reference's optimizer does (src/phyc/optimizer.c). Without
        # them both run the same Adam.
        kw = {"tol": tol}
        if "max" in node:
            kw["max_iter"] = max_iter
        if "eta" in node:
            kw["learning_rate"] = float(node["eta"])
        restrict = node.get("parameters")
        if not restrict and node.get("list"):
            restrict = self._schedule_scope(node)
        if restrict:
            names = self.ctx.resolve_target(restrict)
            sub_specs = [space.by_name[n] for n in names if n in space.by_name]
            sub_space = ParamSpace(sub_specs)
            keep = {s.name for s in sub_specs}
            fixed = {k: v for k, v in params.items() if k not in keep}

            def fn(p):
                return log_prob({**fixed, **p})

            res = ml.optimize(fn, sub_space,
                              {k: params[k] for k in sub_space.names},
                              method="adam", **kw)
            params.update(res.params)
        else:
            res = ml.optimize(log_prob, space, params, method="adam", **kw)
            params = dict(res.params)
        self.update_pool(params)
        self.results[node.get("id", "optimizer")] = res
        print(f"Maximum log likelihood: {res.logp:.6f} "
              f"({res.iterations} iterations)", file=self.out)
        return res

    def _schedule_scope(self, node):
        """The union of the parameters that the schedule's sub-optimizers
        name, or None (the full space) if one of them names none: the JAX
        package's ``_schedule_scope`` for the sub-optimizers the port runs
        (``sg`` / ``adam``; the Brent ones raise above). The reference's
        meta-optimizer runs only its schedule (optimizer.c:154-210)."""
        names: list = []
        for s in node.get("list", []):
            if not s.get("parameters"):
                return None
            names += self.ctx.resolve_target(s["parameters"])
        return names or None

    def action_logger(self, node):
        """One-shot logger (reference: src/phyc/logger.c): a tree as newick,
        and each listed model's log-probability at the pool's values."""
        tree = self.ctx.resolve(node.get("tree")) if node.get("tree") else None
        if tree is not None and hasattr(tree, "is_time_tree"):
            from ..io.treeio import write_newick
            from ..trees.heights import branch_durations

            holder = self.ctx.objects.get("treelikelihood")
            if tree.is_time_tree and holder is not None:
                with torch.no_grad():
                    params = self.params_for(holder.param_space())
                    dist = branch_durations(tree.heights(params), tree.topo)
                dist = dist.cpu().numpy().astype(np.float64)
            else:
                dist = self.pool.get(tree.key("distances"))
                dist = (np.asarray(tree.distances)[: tree.topo.N - 1]
                        if dist is None else dist.cpu().numpy())
                dist = np.concatenate([np.asarray(dist, np.float64),
                                       [np.nan]])
            print(write_newick(tree.topo, dist), file=self.out)
        models = node.get("models", [])
        if isinstance(models, str):
            models = [models]
        for m in models:
            obj = self.ctx.resolve(m)
            if hasattr(obj, "log_prob") or hasattr(obj, "log_likelihood"):
                with torch.no_grad():
                    value = float(self.model_logprob(obj)(
                        self.params_for(obj.param_space())))
                print(f"{m.lstrip('&')}: {value:.6f}", file=self.out)
