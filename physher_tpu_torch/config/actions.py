"""Action execution: the ``physher`` run list of a config.

Port of the ``optimizer`` (with the ``topology`` search), ``logger``,
``mcmc`` (with the ``nni`` tree MCMC), ``mmcmc``, ``marginallikelihood``,
``laplace``, ``hessian``, ``bridgesampling``, ``is``, ``nest``, ``cpo``,
``mc``, ``predictive``, ``asr``, ``ppsite``, ``cat``, ``simultron``,
``sbn`` and ``dumper`` actions of ``physher_tpu/config/actions.py`` (reference:
src/physher.c:207-305).
Actions share one parameter pool, so sequential actions see each other's
results (the reference's shared Parameter objects in its hashtable). The
random draws come from one ``torch.Generator`` on the context's device,
seeded once. The chains of an ``mcmc``, ``bridgesampling`` or ``mc`` node
(``"chains"``), the temperatures of an ``mmcmc`` node, the starts of a meta
optimizer, the difference points of the Hessian and the points at which an
estimator evaluates the model (proposal draws, posterior or prior samples,
live points) run as batches of chains through the model
(``inference/mcmc.py``, ``inference/ml.py``, ``inference/marginal.py``),
where the JAX package ``vmap``s them.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from ..inference import marginal, mcmc as mcmc_mod, ml, modelselection
from ..inference import vb as vb_mod
from ..models.distributions import CompoundModel
from ..models.parameters import ParamSpace
from ..models.treelikelihood import TreeLikelihood
from .builder import Context
from .variational import VariationalHandle

# chains evaluated at once when a logger recomputes values over samples
_LOG_BATCH = 256


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
            if handler is None:
                raise ValueError(f"unknown action type {typ!r}")
            handler(node)
        return self.results

    # -- actions -----------------------------------------------------------

    def action_optimizer(self, node):
        model = self.ctx.resolve(node.get("model"))
        algorithm = str(node.get("algorithm", "meta")).lower()
        max_iter = int(node.get("max", 1000))
        tol = float(node.get("precision", node.get("tol", 1e-3)))
        # a meta schedule with a topology sub-optimizer runs the tree search
        # (which interleaves branch-length optimization itself; reference:
        # optimizer.c meta with OPT_TOPOLOGY + topologyopt.c)
        sub_algs = [str(s.get("algorithm", "")).lower()
                    for s in node.get("list", [])]
        if algorithm == "topology" or "topology" in sub_algs:
            move = "nni"
            for s in node.get("list", []) + [node]:
                if str(s.get("algorithm", "")).lower() == "topology":
                    move = str(s.get("move", "nni")).lower()
            return self._run_topology_search(node, model, move, tol)

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

        log_prob = self.model_logprob(model)
        space = model.param_space()
        params = self.params_for(space)
        # As the JAX package does (a deviation from the reference's
        # optimizer, ported as it is): each method with its defaults,
        # whatever "max" and "eta" say.
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

            method = {"sg": "adam", "adam": "adam"}.get(algorithm, "meta")
            res = ml.optimize(fn, sub_space,
                              {k: params[k] for k in sub_space.names},
                              method=method, tol=tol)
            params.update(res.params)
        else:
            method = {"sg": "adam", "adam": "adam", "lbfgs": "lbfgs",
                      "bfgs": "lbfgs", "cg": "lbfgs"}.get(algorithm, "meta")
            kw = {}
            if node.get("checkpoint"):
                kw["checkpoint"] = node["checkpoint"]
            if method == "meta":
                # meta on the full space gets the batched multistart warmup
                # (robust to bad scalar inits like gamma shape 0.1)
                kw["n_starts"] = int(node.get("starts", 6))
            res = ml.optimize(log_prob, space, params, method=method,
                              tol=tol, **kw)
            params = dict(res.params)
        self.update_pool(params)
        self.results[node.get("id", "optimizer")] = res
        print(f"Maximum log likelihood: {res.logp:.6f} "
              f"({res.iterations} iterations)", file=self.out)
        return res

    def _schedule_scope(self, node):
        """Union of the parameter names that the meta schedule's
        sub-optimizers target, or None for the full space (a sub-optimizer
        without a recognizable restricted target).

        The reference's meta-optimizer runs only its schedule's
        sub-optimizers (optimizer.c:154-210); a config whose schedule covers
        a subset of the parameters (jc69-time.json: one "serial"
        sub-optimizer over the tree likelihood's branch parameters,
        optimizer.c:100-152) leaves the rest (the clock rate) fixed.
        Optimizing everything jointly is both wrong and, with the ratio
        transform's Jacobian and no prior, unbounded (rate -> 0, root height
        -> inf). A Brent sub-optimizer's branch parameters are the
        distances of an unrooted tree, and the height reparameterization of
        a time tree: its ratios and root height, or its shifts.
        """
        names: list = []
        for s in node.get("list", []):
            alg = str(s.get("algorithm", "")).lower()
            if s.get("parameters"):
                names += self.ctx.resolve_target(s["parameters"])
                continue
            if alg in ("serial", "brent", "serialbrent"):
                tgt = self.ctx.resolve(s.get("treelikelihood")
                                       or s.get("model") or node.get("model"))
                tlk = getattr(tgt, "tlk", tgt)
                if isinstance(tlk, TreeLikelihood):
                    if tlk.time_data is None:
                        names.append(tlk.key("distances"))
                    elif tlk.height_transform == "shift":
                        names.append(tlk.key("shifts"))
                    else:
                        names += [tlk.key("ratios"), tlk.key("root_height")]
                    continue
            return None
        return names or None

    def _run_topology_search(self, node, tlk, move, tol):
        """NNI or SPR search from the model's tree (``"rounds"`` caps the
        rounds, 50 by default); the final tree's likelihood then replaces
        the registered one, and its distances go to the pool."""
        from ..inference.topology_search import TopologySearch

        def factory(topo, dist):
            return TreeLikelihood(
                tlk.sp, topo, tlk.subst, tlk.site_model,
                distances_init=np.nan_to_num(
                    np.asarray(dist)[: topo.N - 1], nan=0.05),
                tipstates=False, prefix=tlk.prefix, engine=tlk.engine,
                batch_engine=tlk.batch_engine, **self.ctx.kw)

        search = TopologySearch(factory, algorithm=move, tol=max(tol, 1e-3),
                                max_rounds=int(node.get("rounds", 50)))
        dist0 = np.concatenate([np.asarray(tlk.distances_init), [np.nan]])
        res = search.run(tlk.topo, dist0)
        # replace the registered likelihood with the final tree's
        final = factory(res.topology, res.distances)
        for key, obj in list(self.ctx.objects.items()):
            if obj is tlk:
                self.ctx.objects[key] = final
            if hasattr(obj, "is_time_tree") and obj.topo is tlk.topo:
                obj.topo = res.topology
                obj.distances = res.distances
        self.update_pool({tlk.key("distances"): torch.as_tensor(
            np.nan_to_num(res.distances[: res.topology.N - 1], nan=0.0),
            **self.ctx.kw)})
        self.results[node.get("id", "topology")] = res
        print(f"Topology search ({move}): logP {res.logp:.6f}, "
              f"{res.moves_accepted} moves accepted in {res.rounds} rounds",
              file=self.out)
        return res

    def action_hessian(self, node):
        """The Hessian of the model's logP in the unconstrained space at the
        pool's values (reference: src/phyc/hessian.c, a finite difference
        too): ``ml.hessian``, the difference points as one batch."""
        model = self.ctx.resolve(node.get("model"))
        space = model.param_space()
        H, _, _ = ml.hessian(self.model_logprob(model), space,
                             self.params_for(space),
                             max_chains=ml.hessian_chunk(model))
        H = H.numpy()
        self.results[node.get("id", "hessian")] = H
        print("Hessian (unconstrained space):", file=self.out)
        print(np.array2string(H, precision=6), file=self.out)
        return H

    def action_laplace(self, node):
        """Laplace marginal likelihood. "distribution" selects the envelope
        family (reference: src/phyc/laplace.c:965-1050 dispatch —
        gamma/lognormal/beta/betaprime per-parameter fits or the
        multivariate-normal default)."""
        model = self.ctx.resolve(node.get("model"))
        space = model.param_space()
        params = self.params_for(space)
        dist = node.get("distribution")
        if isinstance(dist, dict):
            dist = dist.get("distribution")
        dist = str(dist or "multivariatenormal").lower()
        chunk = ml.hessian_chunk(model)
        if dist in ("multivariatenormal", "normal", "mvn"):
            val = marginal.laplace_marginal(self.model_logprob(model), space,
                                            params, max_chains=chunk)
        else:
            names = None
            if node.get("x") is not None:
                names = set(self.ctx.resolve_target(node["x"]))
            val = marginal.laplace_marginal_fitted(
                self.model_logprob(model), space, params, family=dist,
                names=names, max_chains=chunk)
        print(f"Laplace log marginal likelihood: {val:.6f}", file=self.out)
        self.results[node.get("id", "laplace")] = val
        return val

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

    # -- MCMC and marginal likelihood --------------------------------------

    def _mesh_chains(self, n_chains: int) -> int:
        """The chains of a batch of ``n_chains`` (0: the mesh's chain
        groups, or 1): on a mesh with a chain axis they split into one
        group a mesh row, so a count that the rows do not divide raises,
        as the JAX package's does."""
        mesh = self.ctx.mesh
        rows = mesh.shape.get("chains", 1) if mesh is not None else 1
        n_chains = n_chains or rows
        if n_chains % rows:
            raise ValueError(f"n_chains={n_chains} not divisible by mesh "
                             f"axis chains={rows}")
        return n_chains

    def action_mcmc(self, node):
        """Block Metropolis-Hastings over the model's parameters, all
        chains (``"chains"``) as one batch (reference: src/phyc/mcmc.c;
        operators' weights per parameter, logging every smallest logger
        ``every``)."""
        model = self.ctx.resolve(node.get("model"))
        log_prob = self.model_logprob(model)
        space = model.param_space()
        params = self.params_for(space)
        length = int(node.get("length", 100000))
        # operator weights -> per-spec proposal weights
        weights: dict = {}
        for op in node.get("operators", []):
            if str(op.get("algorithm", "")).lower() == "vb" \
                    or op.get("x") is None:
                continue  # vb/topology operators carry no parameter block
            w = float(op.get("weight", 1.0))
            for n in self.ctx.resolve_target(op.get("x")):
                weights[n] = weights.get(n, 0.0) + w
        # logging granularity = smallest logger "every"
        logs = node.get("log", [])
        every = min([int(lg.get("every", 1000)) for lg in logs] or [1000])
        # topology operators route to the tree MCMC (reference:
        # operator.c:584 "nni" operator inside the MCMC loop)
        algs = {str(op.get("algorithm", "")).lower()
                for op in node.get("operators", [])}
        if "nni" in algs and isinstance(model, TreeLikelihood):
            return self._run_tree_mcmc(node, model, length, every)
        # "vb" operator: independence proposals from a fitted variational
        # distribution (reference: src/phyc/opvb.c, operator.c:419)
        vb_prop, vb_w = None, 1.0
        for op in node.get("operators", []):
            if str(op.get("algorithm", "")).lower() != "vb":
                continue
            vh = self.ctx.resolve(op.get("var", op.get("x")))
            if getattr(vh, "vparams", None) is None:
                # fit on the fly (reference: opvb.c:96-150)
                vh.vparams = vb_mod.fit(vh.family, self.generator,
                                        steps=2000, tol=1e-4).vparams
            if vh.family.space.unconstrained_size != \
                    space.unconstrained_size:
                raise ValueError(
                    "vb operator: variational space does not match the "
                    "MCMC model's parameter space")
            vb_prop = mcmc_mod.vb_proposal_from(vh.family, vh.vparams)
            vb_w = float(op.get("weight", 1.0))
        sampler = mcmc_mod.MCMC(space, log_prob, weights=weights or None,
                                vb_proposal=vb_prop, vb_weight=vb_w)
        n_chains = self._mesh_chains(int(node.get("chains", 0)))
        res = sampler.run(self.generator, params, n_iter=length,
                          every=every, n_chains=n_chains)
        self.results[node.get("id", "mcmc")] = res
        if res.interrupted:
            print(f"MCMC interrupted: finalizing logs with "
                  f"{len(res.samples_u)} samples", file=self.out)
        self._write_mcmc_logs(node, res, space, every)
        # leave the pool at the last sample
        self.update_pool(res.params_at(-1))
        acc = ", ".join(f"{b}:{a:.2f}" for b, a in
                        zip(sampler.blocks, res.acceptance))
        print(f"MCMC finished: {length} iterations; acceptance {acc}",
              file=self.out)
        return res

    def _run_tree_mcmc(self, node, tlk, length, every):
        """MCMC with NNI topology moves (reference: operator.c nni operator;
        the chain samples topology, branch lengths and model parameters).
        ``"chains": B > 1`` routes to the batched sampler on the device
        (``BatchedTreeMCMC``; ``"incremental": true`` also carries the
        partials as state on parameter-free models)."""
        n_chains = int(node.get("chains", 0))
        if n_chains > 1:
            return self._run_tree_mcmc_batched(node, tlk, length, every,
                                               n_chains)
        from ..inference.treemcmc import TreeMCMC

        sampler = TreeMCMC(tlk)
        res = sampler.run(self.generator, self.params_for(sampler.space),
                          n_iter=length, every=every)
        self.results[node.get("id", "mcmc")] = res
        states = (np.arange(len(res.trees)) + 1) * every
        for log_node in node.get("log", []):
            fname = log_node.get("file")
            if not fname:
                continue
            with open(self._path(fname), "w") as fh:
                if _is_tree_log(log_node):
                    for t in res.trees:
                        fh.write((t if t.endswith(";") else t + ";") + "\n")
                else:
                    fh.write("state\tposterior\n")
                    for s, lp in zip(states, res.log_posterior):
                        fh.write(f"{int(s)}\t{lp:.10g}\n")
        self.update_pool(res.params_at(-1) if len(res.trees) else {})
        acc = ", ".join(f"{k}:{v:.2f}" for k, v in res.acceptance.items())
        print(f"MCMC finished: {length} iterations; acceptance {acc}",
              file=self.out)
        return res

    def _run_tree_mcmc_batched(self, node, tlk, length, every, n_chains):
        """The batched tree MCMC from a config. Chain 0's draws feed the
        tree and posterior logs (the reference logs one chain,
        src/phyc/logmcmc.c); every chain's samples stay in ``results[id]``.

        Four deviations of the JAX package's route from the reference,
        ported as they are (ROADMAP Queue 3): the operators' weights are
        not read (the sampler's own move mix runs); the tree log is bare
        newick, where physher writes a NEXUS trees block; every logger
        writes at the mcmc node's smallest ``every``, not its own; and
        ``"incremental": true`` is dropped without a word when the model
        has free parameters."""
        from ..inference.treemcmc import BatchedTreeMCMC, children_to_newick

        sampler = BatchedTreeMCMC(tlk)
        # deviation: incremental silently off for a model with parameters
        incremental = bool(node.get("incremental", False)) and not sampler.dim
        params = self.params_for(sampler.space) if sampler.dim else None
        res = sampler.run(self.generator, params, n_iter=length, every=every,
                          n_chains=n_chains, incremental=incremental)
        self.results[node.get("id", "mcmc")] = res
        S = res["logp"].shape[0]
        states = (np.arange(S) + 1) * every
        taxa = tlk.topo.taxa
        for log_node in node.get("log", []):
            fname = log_node.get("file")
            if not fname:
                continue
            # deviation: each logger at the smallest "every", bare newick
            with open(self._path(fname), "w") as fh:
                if _is_tree_log(log_node):
                    for s in range(S):
                        fh.write(children_to_newick(
                            taxa, res["children"][s, 0], res["bl"][s, 0])
                            + "\n")
                else:
                    fh.write("state\tposterior\n")
                    for s in range(S):
                        fh.write(f"{int(states[s])}\t"
                                 f"{float(res['logp'][s, 0]):.10g}\n")
        if sampler.dim:
            space = res["space"]
            u_last = torch.as_tensor(res["u"][-1, 0], **self.ctx.kw)
            self.update_pool(space.constrain(
                space.unflatten_unconstrained(u_last)))
        acc = ", ".join(f"{k}:{v:.2f}" for k, v in res["acceptance"].items())
        print(f"MCMC finished: {length} iterations x {n_chains} chains "
              f"(device-side topology moves); acceptance {acc}",
              file=self.out)
        return res

    @staticmethod
    def _batched(fn, space, z: np.ndarray, like: torch.Tensor,
                 max_chains: int = _LOG_BATCH) -> np.ndarray:
        """``fn`` over a batch of parameter dicts made from the unconstrained
        samples ``z`` [n, dim], ``max_chains`` chains at a time."""
        zt = torch.as_tensor(z, dtype=like.dtype, device=like.device)
        return marginal.batched_values(fn, space, zt,
                                       max_chains).cpu().numpy()

    def _write_mcmc_logs(self, node, res, space, base_every):
        """The mcmc node's loggers, from chain 0 as the reference logs one
        chain: tabular (models' log-densities and parameters), tree (NEXUS)
        and sitewise (per-pattern log-likelihoods) files."""
        cons = res.to_dict_of_arrays()
        S = res.samples_u.shape[0]
        like = torch.empty(0, **self.ctx.kw)
        for log_node in node.get("log", []):
            every = int(log_node.get("every", 1000))
            stride = max(1, every // base_every)
            idx = np.arange(0, S, stride)
            states = idx * base_every
            fname = log_node.get("file")
            models = log_node.get("models", [])
            if isinstance(models, str):
                models = [models]
            xs = log_node.get("x", [])
            if isinstance(xs, str):
                xs = [xs]
            zsel = res.samples_u[idx, 0]
            # sitewise log-likelihood logger (reference: logmcmc.c Log with
            # per-site output consumed by cpo.c/predictive.c)
            if log_node.get("sitewise") and fname:
                tlk = None
                for m in models:
                    obj = self.ctx.resolve(m) if isinstance(m, str) else m
                    if hasattr(obj, "site_log_likelihoods"):
                        tlk = obj
                if tlk is not None:
                    site = self._batched(tlk.site_log_likelihoods, space,
                                         zsel, like)
                    w = np.asarray(tlk.sp.weights)
                    lines = ["#" + "\t".join(f"{x:g}" for x in w),
                             "\t".join(["state"] + [
                                 f"site{i}" for i in range(site.shape[1])])]
                    for s, row in zip(states, site):
                        lines.append("\t".join(
                            [str(int(s))] + [f"{v:.10g}" for v in row]))
                    with open(self._path(fname), "w") as fh:
                        fh.write("\n".join(lines) + "\n")
                    continue
            # tree logger?
            tree_handle = None
            for m in models:
                obj = self.ctx.resolve(m) if isinstance(m, str) else m
                if hasattr(obj, "is_time_tree"):
                    tree_handle = obj
            if tree_handle is not None and fname:
                self._write_tree_log(fname, tree_handle, res, idx, states)
                continue
            # tabular logger
            cols: list = ["state"]
            series: list = [states]
            for m in models:
                obj = self.ctx.resolve(m) if isinstance(m, str) else m
                if hasattr(obj, "log_prob") or hasattr(obj, "log_likelihood"):
                    series.append(self._batched(self.model_logprob(obj),
                                                space, zsel, like))
                    cols.append(m.lstrip("&$%"))
                elif isinstance(m, str):
                    for name in self.ctx.resolve_target(m):
                        if name in cons:
                            arr2 = cons[name][idx, 0].reshape(len(idx), -1)
                            for j in range(arr2.shape[1]):
                                cols.append(f"{name}.{j}" if arr2.shape[1] > 1
                                            else name)
                                series.append(arr2[:, j])
            for x in xs:
                for name in self.ctx.resolve_target(x):
                    if name not in cons:
                        continue
                    arr = cons[name][idx, 0].reshape(len(idx), -1)
                    for j in range(arr.shape[1]):
                        cols.append(f"{name}.{j}" if arr.shape[1] > 1
                                    else name)
                        series.append(arr[:, j])
            table = np.column_stack(series)
            lines = ["\t".join(cols)]
            for row in table:
                lines.append("\t".join(
                    str(int(row[0])) if c == 0 else f"{v:.10g}"
                    for c, v in enumerate(row)))
            text = "\n".join(lines) + "\n"
            if fname:
                with open(self._path(fname), "w") as fh:
                    fh.write(text)
            else:
                print(text[:2000], file=self.out)

    def _write_tree_log(self, fname, handle, res, idx, states):
        from ..io.treeio import write_newick
        from ..trees.heights import branch_durations

        topo = handle.topo
        lines = ["#NEXUS", "begin trees;"]
        for s, i in zip(states, idx):
            p = res.params_at(int(i))
            with torch.no_grad():
                if handle.is_time_tree:
                    dist = branch_durations(handle.heights(p), topo)
                    dist = dist.cpu().numpy().astype(np.float64)
                else:
                    d = p[handle.key("distances")].cpu().numpy()
                    dist = np.concatenate([np.asarray(d, np.float64),
                                           [np.nan]])
            lines.append(
                f"tree STATE_{int(s)} = {write_newick(topo, dist)}")
        lines += ["end;", ""]
        with open(self._path(fname), "w") as fh:
            fh.write("\n".join(lines))

    def _path(self, p):
        return p if os.path.isabs(p) else os.path.join(self.ctx.base_dir, p)

    def action_mmcmc(self, node):
        """Tempered-ladder MCMC, the temperatures as one batch of chains
        (reference: src/phyc/mmcmc.c, which runs them one after another)."""
        model = self.ctx.resolve(node.get("model"))
        like, prior = self._split_like_prior(model)
        space = model.param_space()
        params = self.params_for(space)
        n_temps = self._mesh_chains(
            int(node.get("temperatures", node.get("steps", 16))))
        length = int(node.get("length", 10000))
        temps, lls, res = marginal.run_tempered_ladder(
            self.generator, space, like, prior, params, n_temps=n_temps,
            n_iter=length, every=int(node.get("every", 10)),
            burnin=int(node.get("burnin", length // 10)),
            distribution_power=float(node.get("power", 0.3)))
        self.results[node.get("id", "mmcmc")] = (temps, lls, res)
        ss, _ = marginal.log_stepping_stone(lls, temps)
        ps, _ = marginal.log_path_sampling(lls, temps)
        print(f"log marginal likelihood: stepping-stone {ss:.4f}, "
              f"path-sampling {ps:.4f}", file=self.out)
        return temps, lls, res

    def _split_like_prior(self, model):
        """Split a compound model into (likelihood, prior) callables."""
        if isinstance(model, CompoundModel):
            likes = [c for c in model.components
                     if isinstance(c, TreeLikelihood)]
            priors = [c for c in model.components
                      if not isinstance(c, TreeLikelihood)]

            def like(p):
                return sum(lk.log_likelihood(p) for lk in likes)

            def prior(p):
                return sum((c.log_prob(p) for c in priors), 0.0)

            return like, prior
        return self.model_logprob(model), lambda p: 0.0

    def action_marginallikelihood(self, node):
        """Marginal-likelihood estimates from a stored mmcmc result
        (reference: marginal.c _marginal_likelihood_run reads logs)."""
        ref = node.get("mmcmc", "mmcmc")
        stored = self.results.get(ref.lstrip("&") if isinstance(ref, str)
                                  else "mmcmc")
        if stored is None:
            raise ValueError("marginallikelihood needs a prior mmcmc action")
        temps, lls, _ = stored
        methods = node.get("methods",
                           ["stepping", "path", "harmonic", "stabilized"])
        out = {}
        for m in methods:
            if m in ("stepping", "ss"):
                out[m] = marginal.log_stepping_stone(lls, temps)[0]
            elif m in ("path", "ps"):
                out[m] = marginal.log_path_sampling(lls, temps)[0]
            elif m == "path2":
                out[m] = marginal.log_path_sampling_modified(lls, temps)[0]
            elif m == "harmonic":
                out[m] = marginal.log_harmonic_mean(lls[-1])
            elif m == "stabilized":
                out[m] = marginal.log_stabilized_harmonic_mean(lls[-1])
            elif m == "arithmetic":
                out[m] = marginal.log_arithmetic_mean(lls[0])
        for m, v in out.items():
            print(f"{m}: {v:.6f}", file=self.out)
        self.results[node.get("id", "marginal")] = out
        return out

    # -- Bayesian model comparison (reference: physher.c:207-305) ----------

    def _chain_samples(self, node, log_prob, space, params, length: int,
                       burnin: int):
        """A ``mcmc.MCMC`` run of ``log_prob`` for an estimator, ``length``
        iterations unless the node gives them, its chains (``"chains"``)
        one batch as in :meth:`action_mcmc`: every chain's unconstrained
        samples ``[S * L, dim]`` on the context's device."""
        res = mcmc_mod.MCMC(space, log_prob).run(
            self.generator, params, n_iter=int(node.get("length", length)),
            every=10, burnin=burnin, n_chains=int(node.get("chains", 0)) or 1)
        z = res.samples_u.reshape(-1, res.samples_u.shape[-1])
        return torch.as_tensor(z, **self.ctx.kw)

    def action_bridgesampling(self, node):
        """Bridge sampling from an MCMC run of the posterior (reference:
        src/phyc/bridge.c): the samples and the normal proposal's draws each
        as batches of chains."""
        model = self.ctx.resolve(node.get("model"))
        space = model.param_space()
        log_prob = self.model_logprob(model)
        chunk = ml.hessian_chunk(model)
        su = self._chain_samples(node, log_prob, space,
                                 self.params_for(space), 20000,
                                 int(node.get("burnin", 2000)))

        def log_unnorm(z):
            return marginal.batched_values(log_prob, space, z, chunk,
                                           jacobian=True)

        val = marginal.bridge_sampling_marginal(su, log_unnorm, space,
                                                self.generator)
        print(f"Bridge-sampling log marginal likelihood: {val:.6f}",
              file=self.out)
        self.results[node.get("id", "bridge")] = val
        return val

    def action_is(self, node):
        """Importance-sampling marginal with a variational proposal
        (reference: src/phyc/is.c, action 'is'/'vbis')."""
        var = self.ctx.resolve(node.get("variational", node.get("model")))
        val = marginal.importance_sampling_marginal(
            self.generator, var.family, var.vparams,
            self.model_logprob(var.posterior),
            n_samples=int(node.get("samples", 1000)),
            max_chains=ml.hessian_chunk(var.posterior))
        print(f"IS log marginal likelihood: {val:.6f}", file=self.out)
        self.results[node.get("id", "is")] = val
        return val

    def action_nest(self, node):
        """Nested sampling over the likelihood (reference: src/phyc/nest.c),
        its live points started around the pool's values, as in the JAX
        package."""
        model = self.ctx.resolve(node.get("model"))
        like, _ = self._split_like_prior(model)
        space = model.param_space()
        with torch.no_grad():
            u0 = space.flatten_unconstrained(space.unconstrain(
                self.params_for(space)))

        def sample_prior(generator, n):
            # a diffuse overdispersed start around the current point
            return u0 + 2.0 * torch.randn((n, u0.shape[0]),
                                          generator=generator, **self.ctx.kw)

        val = marginal.nested_sampling(
            self.generator, space, like, sample_prior,
            n_live=int(node.get("points", 100)),
            max_iter=int(node.get("max", 5000)),
            max_chains=ml.hessian_chunk(model))
        print(f"Nested-sampling log evidence (approx): {val:.6f}",
              file=self.out)
        self.results[node.get("id", "nest")] = val
        return val

    def action_cpo(self, node):
        """CPO / LPML from per-site log-likelihood samples (reference:
        src/phyc/cpo.c): a sitewise log file (``"filename"``), or chain 0 of
        a prior ``mcmc`` action's samples, their site log-likelihoods as
        batches of chains."""
        if node.get("filename"):
            # the reference's file: a '#'-prefixed weight line, a header,
            # then state\tsite... rows (cpo.c:16-75)
            weights, site_lls = _read_sitewise_log(
                self._path(node["filename"]), int(node.get("burnin", 0)))
        else:
            res = self.results.get(str(node.get("mcmc", "mcmc")).lstrip("&"))
            if res is None:
                raise ValueError("cpo needs a prior mcmc action")
            tlk = self.ctx.resolve(node.get("treelikelihood",
                                            "&treelikelihood"))
            site_lls = self._batched(
                tlk.site_log_likelihoods, res.space, res.samples_u[:, 0],
                torch.empty(0, **self.ctx.kw), ml.hessian_chunk(tlk))
            weights = tlk.sp.weights
        log_cpo, lpml = modelselection.cpo(site_lls, weights)
        print(f"LPML: {lpml:.6f}", file=self.out)
        self.results[node.get("id", "cpo")] = (log_cpo, lpml)
        return log_cpo, lpml

    def action_mc(self, node):
        """Plain Monte Carlo marginal: the mean likelihood over prior draws
        from an MCMC run of the prior (reference: src/phyc/mc.c), the
        likelihoods as batches of chains."""
        model = self.ctx.resolve(node.get("model"))
        like, prior = self._split_like_prior(model)
        space = model.param_space()
        z = self._chain_samples(node, prior, space, self.params_for(space),
                                10000, burnin=1000)
        lls = marginal.batched_values(like, space, z, ml.hessian_chunk(model))
        val = marginal.log_arithmetic_mean(lls.cpu().numpy())
        print(f"MC log marginal likelihood: {val:.6f}", file=self.out)
        self.results[node.get("id", "mc")] = val
        return val

    # -- likelihood analyses (reference: physher.c:289-305 actions) --------

    def _tlk_and_params(self, node):
        tlk = self.ctx.resolve(node.get("model", node.get(
            "treelikelihood", "&treelikelihood")))
        return tlk, self.params_for(tlk.param_space())

    def action_asr(self, node):
        """Marginal ancestral reconstruction: the MAP sequence of every
        internal node, to a FASTA ``"file"`` (reference: src/phyc/asr.c)."""
        from ..io.seqio import write_fasta
        from ..likelihood.analysis import ancestral_sequences

        seqs = ancestral_sequences(*self._tlk_and_params(node))
        self.results[node.get("id", "asr")] = seqs
        if node.get("file"):
            write_fasta(seqs, self._path(node["file"]))
        else:
            for k in list(seqs)[:3]:
                print(f">{k}\n{seqs[k][:60]}...", file=self.out)
        return seqs

    def action_ppsite(self, node):
        """Per-pattern rate-category posteriors [C, P] (reference:
        src/phyc/ppsites.c), to a tab-separated ``"file"``, a pattern a
        line."""
        from ..likelihood.analysis import site_rate_posteriors

        post = site_rate_posteriors(*self._tlk_and_params(node))
        self.results[node.get("id", "ppsite")] = post
        if node.get("file"):
            np.savetxt(self._path(node["file"]), post.T, fmt="%.6g",
                       delimiter="\t")
        return post

    def action_cat(self, node):
        """Each site's MAP rate category (reference: src/phyc/cat.c)."""
        from ..likelihood.analysis import cat_assignment

        cats = cat_assignment(*self._tlk_and_params(node))
        self.results[node.get("id", "cat")] = cats
        if node.get("file"):
            np.savetxt(self._path(node["file"]), cats, fmt="%d")
        return cats

    def action_simultron(self, node):
        """Sequence simulation at the pool's values (reference:
        physher.c:289-292, physim.c), ``"length"`` sites (the data's by
        default), to ``"output"`` as FASTA or ``"format": "nexus"``."""
        from ..io.seqio import write_fasta, write_nexus_alignment
        from ..likelihood.analysis import simulate_alignment

        tlk, params = self._tlk_and_params(node)
        n_sites = int(node.get("length", node.get("sites",
                                                  tlk.sp.site_count)))
        with torch.no_grad():
            bl = tlk.branch_lengths(params)
        seqs = simulate_alignment(self.generator, tlk.topo, tlk.subst,
                                  tlk.site_model, params, bl, n_sites)
        fname = node.get("output", node.get("file"))
        if fname:
            if str(node.get("format", "fasta")).lower() == "nexus":
                write_nexus_alignment(seqs, self._path(fname))
            else:
                write_fasta(seqs, self._path(fname))
        self.results[node.get("id", "simultron")] = seqs
        return seqs

    def action_sbn(self, node):
        """SBN estimation from a tree log (reference: physher.c:293,
        sbn.c): rootsplit and subsplit frequencies of the trees in
        ``"file"`` (or ``"trees"``) after the ``"burnin"`` fraction."""
        from ..inference.sbn import SBN
        from ..io.treeio import TreeFileIterator

        fname = node.get("file", node.get("trees"))
        sbn = SBN()
        trees = list(TreeFileIterator(self._path(fname)))
        start = int(len(trees) * float(node.get("burnin", 0.0)))
        for topo, _ in trees[start:]:
            sbn.add_tree(topo)
        roots, conds = sbn.probabilities()
        print(f"SBN: {len(roots)} rootsplits, {len(conds)} parent clades "
              f"from {sbn.n_trees:.0f} trees", file=self.out)
        self.results[node.get("id", "sbn")] = sbn
        return sbn

    def action_dumper(self, node):
        """Dump the pool's current values as JSON for a restart (reference:
        src/phyc/logger.c Dumper), to ``"file"`` or the first 1000
        characters to the output; returns the dict written."""
        import json

        out = {}
        for name, val in self.pool.items():
            arr = val.detach().cpu().numpy()
            out[name] = arr.tolist() if arr.ndim else float(arr)
        fname = node.get("file")
        if fname:
            with open(self._path(fname), "w") as fh:
                json.dump(out, fh, indent=1)
        else:
            print(json.dumps(out)[:1000], file=self.out)
        return out

    def action_predictive(self, node):
        """Posterior-predictive simulation check (reference:
        src/phyc/predictive.c): the pattern count of alignments simulated at
        the pool's values against the data's."""
        from ..data.sitepattern import SitePattern
        from ..likelihood.analysis import simulate_alignment

        tlk = self.ctx.resolve(node.get("model", node.get(
            "treelikelihood", "&treelikelihood")))
        params = self.params_for(tlk.param_space())
        with torch.no_grad():
            bl = tlk.branch_lengths(params)
        sims = []
        for _ in range(int(node.get("samples", 100))):
            seqs = simulate_alignment(self.generator, tlk.topo, tlk.subst,
                                      tlk.site_model, params, bl,
                                      tlk.sp.site_count)
            sims.append(SitePattern.from_alignment(
                seqs, tlk.sp.datatype).pattern_count)
        p = modelselection.posterior_predictive_pvalue(tlk.sp.pattern_count,
                                                       sims)
        print(f"posterior predictive p-value (pattern diversity): {p:.3f}",
              file=self.out)
        self.results[node.get("id", "predictive")] = p
        return p


def _is_tree_log(log_node) -> bool:
    """A tree MCMC logger that writes trees (by its file's extension or a
    tree among its models), not the posterior."""
    models = log_node.get("models", [])
    if isinstance(models, str):
        models = [models]
    return (str(log_node["file"]).endswith((".trees", ".nex", ".nxs"))
            or any("tree" in str(m).lower() for m in models))


def _read_sitewise_log(path: str, burnin: int = 0):
    """Parse the reference's sitewise log format: a first '#'-prefixed line
    of tab-separated site weights, a header, then state\tvalue rows
    (reference: cpo.c:26-52, predictive.c:25-55)."""
    with open(path) as fh:
        lines = [ln.rstrip("\n") for ln in fh if ln.strip()]
    weights = np.asarray([float(x) for x in lines[0][1:].split("\t")])
    rows = [[float(x) for x in ln.split("\t")[1:]] for ln in lines[2:]]
    return weights, np.asarray(rows[burnin:])
