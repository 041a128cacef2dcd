"""Topology MCMC: Metropolis-Hastings over topologies, branch lengths and
substitution/site parameters.

Port of ``physher_tpu/inference/treemcmc.py`` (reference:
src/phyc/operator.c:419-626 ``_operator_nni`` / scaler / slider entries,
dispatched from the mcmc.c:112-142 store/propose/accept loop). Proposals mix
three move families: NNI on a uniformly chosen internal edge (symmetric:
every binary topology on T taxa has the same number of rooted-NNI
rearrangements, so log q ratio = 0), a log-space scaler on one branch length
(Hastings ratio log m), and a Gaussian random walk on one unconstrained
parameter block. Trees are logged as newick strings.

Two samplers:

- :class:`TreeMCMC`, one chain with the NNI done on the host on nested
  trees, as in the JAX package. Each proposal is one forward call of the
  fixed-topology engine that ``select_engine`` picks for its
  ``Topology`` (``TreeLikelihood.topology_log_likelihood``; on the card
  K1'/K2' or K3'/K4' at S = 4), the tip partials permuted on the device.
  Its numpy seed comes from the ``torch.Generator``.
- :class:`BatchedTreeMCMC`, a batch of chains whose whole state lives on
  the device (children ``[B, I, 2]``, branch lengths ``[B, N]``, parameters
  ``[B, dim]`` through the models' leading chain axis): NNI is two row
  edits (``ops/dynamic_pruning.propose_nni_device``), the evaluation order
  comes from ``postorder_from_children``, and the chains' different
  topologies go through the dynamic engine in one call. With
  ``incremental=True`` the partials are state too, and a proposal
  recomputes only its root path.
"""

from __future__ import annotations

import math
import sys
from dataclasses import dataclass, field

import numpy as np
import torch

from ..io.treeio import write_newick
from ..models.parameters import ParamSpace
from ..ops.dynamic_pruning import (
    parent_array, postorder_from_children, propose_nni_device,
    root_loglik_from_partials, tree_loglik_dynamic_ordered,
    tree_partials_dynamic_ordered, update_path_partials)
from ..trees.topology import Topology
from .topology_search import apply_nni, nni_moves, to_nested


@dataclass
class TreeMCMCResult:
    trees: list                  # newick strings, every `every` iterations
    samples_u: np.ndarray        # [S, dim] unconstrained parameter samples
    branch_lengths: np.ndarray   # [S, N] per-node branch lengths
    log_posterior: np.ndarray    # [S]
    acceptance: dict             # per move family
    space: ParamSpace = None
    final_topology: Topology = None
    final_distances: np.ndarray = None
    history: list = field(default_factory=list)
    # where params_at puts the constrained values
    dtype: torch.dtype = torch.float64
    device: torch.device = torch.device("cpu")

    def params_at(self, i) -> dict:
        u = torch.as_tensor(self.samples_u[i], dtype=self.dtype,
                            device=self.device)
        return self.space.constrain(self.space.unflatten_unconstrained(u))


def _tree_space(tlk) -> ParamSpace:
    """The model's parameters but its branch lengths (the samplers move
    those themselves)."""
    return ParamSpace([s for s in tlk.param_space().specs
                       if s.name != tlk.key("distances")])


def _flat_u(space: ParamSpace, params: dict, like: torch.Tensor):
    """The unconstrained vector of ``params`` (empty without free
    parameters)."""
    if not space.free_specs():
        return like.new_zeros(0)
    with torch.no_grad():
        return space.flatten_unconstrained(space.unconstrain(params))


class TreeMCMC:
    """MH over (topology, branch lengths, model parameters) for an unrooted
    ``TreeLikelihood`` (binary rooted representation; reversible models are
    root-placement invariant).

    ``log_prior(params, bl)`` is an optional joint prior over the
    constrained model parameters and the per-node branch-length vector; by
    default an exponential(10) prior is placed on branch lengths (the
    reference configs' usual choice) and the parameter prior is flat.
    """

    def __init__(self, tlk, *, log_prior=None, bl_prior_rate: float = 10.0):
        self.tlk = tlk
        self.space = _tree_space(tlk)
        self.log_prior = log_prior
        self.bl_prior_rate = float(bl_prior_rate)

    def _eval(self, u: np.ndarray, topo: Topology, tips: torch.Tensor,
              bl: np.ndarray) -> float:
        """The log posterior of one state: one forward call of the fixed
        topology's engine."""
        tlk, space = self.tlk, self.space
        kw = dict(dtype=tlk.dtype, device=tlk.tip_partials.device)
        with torch.no_grad():
            up = space.unflatten_unconstrained(torch.as_tensor(u, **kw))
            params = space.constrain(up)
            blt = torch.as_tensor(bl, **kw)
            lp = tlk.topology_log_likelihood(
                params, topo, tips, torch.clamp(blt, min=0.0))
            lp = lp + space.log_jacobian(up)
            if self.log_prior is not None:
                lp = lp + self.log_prior(params, blt)
            else:
                r = self.bl_prior_rate
                lp = lp + (bl.shape[0] - 1) * math.log(r) \
                    - r * torch.sum(blt[:-1])
            return float(lp)

    def _propose_nni(self, rng, nested):
        # one of nni_neighbors(nested), uniformly, built alone
        moves = nni_moves(nested)
        if not moves:
            return None
        return apply_nni(nested, moves[rng.integers(len(moves))]), 0.0

    def run(self, generator: torch.Generator, params: dict, *,
            n_iter: int = 10000, every: int = 100, burnin: int = 0,
            p_topo: float = 0.2, p_bl: float = 0.4, init_step: float = 0.1,
            bl_lambda: float = 1.0, adapt: bool = True,
            adapt_interval: int = 200, seed: int = 0) -> TreeMCMCResult:
        tlk, space = self.tlk, self.space
        rng = np.random.default_rng(int(torch.randint(
            0, 2**31 - 1, (1,), generator=generator,
            device=generator.device)) ^ seed)
        topo = tlk.topo
        dist = np.array(tlk.distances_init, dtype=np.float64)
        # per-node branch lengths (root entry unused)
        bl = np.zeros(topo.N)
        bl[: dist.shape[0]] = dist
        nested = to_nested(topo, bl)

        u = _flat_u(space, params, tlk.tip_partials).to(
            torch.float64).cpu().numpy()
        blocks = list(space.free_specs())
        block_slices = []
        off = 0
        for s in blocks:
            block_slices.append((off, off + s.unconstrained_size))
            off += s.unconstrained_size
        sigmas = np.full(len(blocks), init_step)
        lam = bl_lambda

        tips = tlk.tips_for(topo)
        logp = self._eval(u, topo, tips, bl)

        acc = {"nni": [0, 0], "branch": [0, 0], "param": [0, 0]}
        acc_win = {"branch": [0, 0], "param": [0, 0]}
        trees, samples, bls, lps = [], [], [], []

        if not blocks:
            # no free model parameters: renormalize over topology+branch
            tot = p_topo + p_bl
            p_topo, p_bl = p_topo / tot, p_bl / tot

        for it in range(n_iter):
            r = rng.random()
            if r < p_topo and topo.I > 1:
                prop = self._propose_nni(rng, nested)
                if prop is not None:
                    cand_nested, log_hr = prop
                    topo_c, dist_c = Topology.from_nested(cand_nested)
                    tips_c = tlk.tips_for(topo_c)
                    bl_c = np.nan_to_num(np.asarray(dist_c, np.float64),
                                         nan=0.0)
                    logp_new = self._eval(u, topo_c, tips_c, bl_c)
                    if (np.isfinite(logp_new)
                            and np.log(rng.random())
                            < logp_new - logp + log_hr):
                        nested, topo, tips, bl = cand_nested, topo_c, \
                            tips_c, bl_c
                        logp = logp_new
                        acc["nni"][0] += 1
                    acc["nni"][1] += 1
            elif r < p_topo + p_bl:
                j = rng.integers(topo.N - 1)
                m = np.exp(lam * (rng.random() - 0.5))
                bl_new = bl.copy()
                bl_new[j] = bl[j] * m
                logp_new = self._eval(u, topo, tips, bl_new)
                if (np.isfinite(logp_new)
                        and np.log(rng.random()) < logp_new - logp
                        + np.log(m)):
                    bl = bl_new
                    logp = logp_new
                    acc["branch"][0] += 1
                    acc_win["branch"][0] += 1
                acc["branch"][1] += 1
                acc_win["branch"][1] += 1
                self._sync_nested_lengths(nested, topo, bl)
            else:
                b = rng.integers(len(blocks))
                lo, hi = block_slices[b]
                u_new = u.copy()
                u_new[lo:hi] = u[lo:hi] + sigmas[b] * rng.standard_normal(
                    hi - lo)
                logp_new = self._eval(u_new, topo, tips, bl)
                if (np.isfinite(logp_new)
                        and np.log(rng.random()) < logp_new - logp):
                    u = u_new
                    logp = logp_new
                    acc["param"][0] += 1
                    acc_win["param"][0] += 1
                acc["param"][1] += 1
                acc_win["param"][1] += 1

            if adapt and (it + 1) % adapt_interval == 0:
                for name, arr in acc_win.items():
                    if arr[1] == 0:
                        continue
                    f = np.exp(np.clip(arr[0] / arr[1] - 0.24, -0.5, 0.5))
                    if name == "branch":
                        lam *= f
                    else:
                        sigmas *= f
                    arr[0] = arr[1] = 0

            if it >= burnin and (it + 1) % every == 0:
                trees.append(write_newick(topo, bl))
                samples.append(u.copy())
                bls.append(bl.copy())
                lps.append(logp)

        return TreeMCMCResult(
            trees=trees,
            samples_u=np.asarray(samples) if samples else np.empty((0, u.size)),
            branch_lengths=np.asarray(bls) if bls else np.empty((0, topo.N)),
            log_posterior=np.asarray(lps),
            acceptance={k: (v[0] / v[1] if v[1] else np.nan)
                        for k, v in acc.items()},
            space=space, final_topology=topo, final_distances=bl,
            dtype=tlk.dtype, device=tlk.tip_partials.device)

    @staticmethod
    def _sync_nested_lengths(nested, topo: Topology, bl):
        """Write the per-node branch lengths back into the nested dict (kept
        in lockstep so NNI proposals carry current lengths)."""

        def walk(node, node_id):
            if node_id != topo.root:
                node["length"] = float(bl[node_id])
            if node_id >= topo.T:
                k = node_id - topo.T
                for j, c in enumerate(node["children"]):
                    walk(c, int(topo.children[k, j]))

        walk(nested, topo.root)


def children_to_newick(taxa, children, bl=None) -> str:
    """Newick string from a device-sampler [I, 2] children array.

    Node ids follow the BatchedTreeMCMC convention (tips ``< T``, internal
    row ``k`` = id ``T + k``, root = last row). NNI edits can break the
    children-before-parents rank invariant, so this walks ids rather than
    building a :class:`Topology` (whose validator enforces postorder)."""
    taxa = list(taxa)
    T = len(taxa)
    I = len(children)
    root = T + I - 1
    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 10 * (T + I) + 100))
    try:
        def fmt(nid):
            if nid < T:
                s = taxa[nid]
            else:
                s = "(" + ",".join(fmt(int(c))
                                   for c in children[nid - T]) + ")"
            if bl is not None and nid != root:
                s += f":{float(bl[nid]):.10g}"
            return s

        return fmt(root) + ";"
    finally:
        sys.setrecursionlimit(old)


class BatchedTreeMCMC:
    """Batched-chain topology MCMC with NNI as index edits on the device.

    The whole sampler state lives on the device: per-chain children arrays
    ``[B, I, 2]``, branch lengths ``[B, N]`` and unconstrained model
    parameters ``[B, dim]``. An iteration is one proposal a chain, every
    chain's evaluated in one call of the dynamic engine:

    - NNI is two row edits on the children array
      (``ops/dynamic_pruning.propose_nni_device``, the reference's NNI
      operator src/phyc/operator.c:419-626 inside the mcmc.c loop),
    - the evaluation order is recomputed per proposal from the edited
      children (``postorder_from_children``), so nothing is renumbered,
    - branch-length moves are the reference's log-space scaler (Hastings
      ratio log m), parameter moves a Gaussian walk on the unconstrained
      block, through the models' leading chain axis.

    The per-chain branch-length prior is exponential(``bl_prior_rate``),
    the reference configs' usual choice. The JAX package runs ``every``
    iterations as one compiled scan between reads; here they are a loop
    whose state never leaves the device until a sample is read.
    """

    def __init__(self, tlk, *, bl_prior_rate: float = 10.0,
                 p_nni: float = 0.4, p_bl: float = 0.4):
        self.tlk = tlk
        self.space = _tree_space(tlk)
        self.dim = self.space.unconstrained_size
        self.bl_prior_rate = float(bl_prior_rate)
        self.p_nni = float(p_nni)
        # with no free parameters the walk slot folds into the scaler
        self.p_bl = float(p_bl) if self.dim else 1.0 - float(p_nni)

    def _logpost(self, children, bl, u):
        """Log posteriors [B] of children [B, I, 2], bl [B, N], u [B,
        dim]."""
        tlk, space = self.tlk, self.space
        if self.dim:
            up = space.unflatten_unconstrained(u)
            params = space.constrain(up)
            jac = space.log_jacobian(up)
        else:
            params, jac = {}, 0.0
        rates, props = tlk.site_model.rates_props(params)
        freqs = tlk.subst.frequencies(params).to(tlk.dtype)
        blc = torch.clamp(bl, min=0.0)[..., None] * rates[..., None, :]
        pmats = tlk.subst.p_t(params, blc).to(tlk.dtype)
        order = postorder_from_children(children, tlk.topo.T)
        ll = tree_loglik_dynamic_ordered(
            tlk.tip_partials, pmats, children, order, freqs,
            props.to(tlk.dtype), tlk.weights, rescale=tlk.rescale)[0]
        r = self.bl_prior_rate
        return (ll + jac + (bl.shape[1] - 1) * math.log(r)
                - r * bl[:, :-1].sum(-1))

    def _start(self, n_chains):
        """The start's children [B, I, 2] and branch lengths [B, N] (the
        model's tree; a missing length 0.1, the root's 0)."""
        tlk = self.tlk
        dev = tlk.tip_partials.device
        ch0 = torch.as_tensor(tlk.topo.children[:, :2], dtype=torch.long,
                              device=dev)
        bl0 = torch.as_tensor(np.concatenate([
            np.nan_to_num(tlk.distances_init, nan=0.1), [0.0]]),
            dtype=tlk.dtype, device=dev)
        return (ch0.expand(n_chains, -1, -1).clone(),
                bl0.expand(n_chains, -1).clone())

    def _scale_one(self, generator, bl, bl_lambda):
        """One branch j [B] a chain scaled by m [B]: (j, m, scaled bl)."""
        B, N = bl.shape
        dev = bl.device
        j = torch.randint(0, N - 1, (B,), generator=generator, device=dev)
        m = torch.exp(bl_lambda * (torch.rand(B, generator=generator,
                                              device=dev,
                                              dtype=bl.dtype) - 0.5))
        scaled = bl.clone()
        rows = torch.arange(B, device=dev)
        scaled[rows, j] = bl[rows, j] * m
        return j, m, scaled

    def run(self, generator: torch.Generator, params: dict = None, *,
            n_iter: int = 2000, every: int = 20, n_chains: int = 8,
            burnin: int = 0, bl_lambda: float = 0.6,
            param_step: float = 0.1, init_jitter: float = 0.0,
            incremental: bool = False):
        """Returns a dict of samples of children/bl/u/logp stacked as
        ``[n_samples, n_chains, ...]`` (numpy), one every ``every``
        iterations, and the acceptance rates.

        ``incremental=True`` (parameter-free models only) carries the
        per-chain partials as sampler state and recomputes only the root
        path after each move (reference: dirty-flag incremental recompute
        with O(1) store/restore, src/phyc/treelikelihood.c:126-161):
        O(depth) node updates a proposal instead of O(N)."""
        if incremental:
            if self.dim:
                raise ValueError("incremental tree-MCMC supports "
                                 "parameter-free models (substitution/"
                                 "site parameters held fixed)")
            return self._run_incremental(
                generator, n_iter=n_iter, every=every, n_chains=n_chains,
                burnin=burnin, bl_lambda=bl_lambda)
        tlk, space = self.tlk, self.space
        T = tlk.topo.T
        dev, dt = tlk.tip_partials.device, tlk.dtype
        B = n_chains
        rows = torch.arange(B, device=dev)
        p_nni, p_bl = self.p_nni, self.p_bl
        if params is None:
            params = space.init_params(dtype=dt, device=dev)
        u0 = _flat_u(space, params, tlk.tip_partials)
        chs, bls = self._start(B)
        with torch.no_grad():
            us = u0.expand(B, -1).clone()
            if init_jitter and self.dim:
                us = us + init_jitter * torch.randn(
                    us.shape, generator=generator, device=dev, dtype=dt)
            lps = self._logpost(chs, bls, us)
            acc = torch.zeros((B, 3, 2), dtype=dt, device=dev)
            n_samples = max(n_iter // every, 1)
            burn_chunks = burnin // every
            out = {"children": [], "bl": [], "u": [], "logp": []}
            for ci in range(n_samples + burn_chunks):
                for _ in range(every):
                    mv = torch.rand(B, generator=generator, device=dev,
                                    dtype=dt)
                    is_nni = mv < p_nni
                    is_bl = (mv >= p_nni) & (mv < p_nni + p_bl)
                    ch_new, _ = propose_nni_device(generator, chs, T)
                    ch_p = torch.where(is_nni[:, None, None], ch_new, chs)
                    _, m, scaled = self._scale_one(generator, bls,
                                                   bl_lambda)
                    bl_p = torch.where(is_bl[:, None], scaled, bls)
                    u_p = torch.where(
                        (is_nni | is_bl)[:, None], us,
                        us + param_step * torch.randn(
                            us.shape, generator=generator, device=dev,
                            dtype=dt))
                    log_hr = torch.where(is_bl, torch.log(m), 0.0)
                    lp_new = self._logpost(ch_p, bl_p, u_p)
                    ok = (torch.log(torch.rand(B, generator=generator,
                                               device=dev, dtype=dt))
                          < lp_new - lps + log_hr) & torch.isfinite(lp_new)
                    chs = torch.where(ok[:, None, None], ch_p, chs)
                    bls = torch.where(ok[:, None], bl_p, bls)
                    us = torch.where(ok[:, None], u_p, us)
                    lps = torch.where(ok, lp_new, lps)
                    slot = torch.where(is_nni, 0, torch.where(is_bl, 1, 2))
                    acc[rows, slot, 0] += ok.to(dt)
                    acc[rows, slot, 1] += 1.0
                if ci >= burn_chunks:
                    for k, v in (("children", chs), ("bl", bls), ("u", us),
                                 ("logp", lps)):
                        out[k].append(v.cpu().numpy())
            acc = acc.sum(0).cpu().numpy()
        res = {k: np.stack(v) for k, v in out.items()}
        res["acceptance"] = {
            name: float(acc[i, 0] / max(acc[i, 1], 1.0))
            for i, name in enumerate(("nni", "branch", "params"))}
        res["space"] = space
        return res

    def _run_incremental(self, generator, *, n_iter, every, n_chains,
                         burnin, bl_lambda):
        """Partials-as-state sampler (see ``run(incremental=True)``)."""
        tlk = self.tlk
        T = tlk.topo.T
        dev, dt = tlk.tip_partials.device, tlk.dtype
        B = n_chains
        rows = torch.arange(B, device=dev)
        w = tlk.weights
        rates, props = tlk.site_model.rates_props({})
        freqs = tlk.subst.frequencies({}).to(dt)
        props = props.to(dt)
        r = self.bl_prior_rate
        rescale = tlk.rescale

        def pmats_of(bl):                       # [B, N] -> [B, N, C, S, S]
            blc = torch.clamp(bl, min=0.0)[..., None] * rates
            return tlk.subst.p_t({}, blc).to(dt)

        def logpost_of(buf, scal, bl):
            ll = root_loglik_from_partials(buf, scal, freqs, props, w,
                                           rescale=rescale)[0]
            return ll + (bl.shape[1] - 1) * math.log(r) \
                - r * bl[:, :-1].sum(-1)

        chs, bls = self._start(B)
        with torch.no_grad():
            pmats = pmats_of(bls)
            buf, scal = tree_partials_dynamic_ordered(
                tlk.tip_partials, pmats, chs,
                postorder_from_children(chs, T), rescale=rescale)
            lps = logpost_of(buf, scal, bls)
            acc = torch.zeros((B, 2, 2), dtype=dt, device=dev)
            n_samples = max(n_iter // every, 1)
            burn_chunks = burnin // every
            out = {"children": [], "bl": [], "logp": []}
            for ci in range(n_samples + burn_chunks):
                for _ in range(every):
                    is_nni = torch.rand(B, generator=generator, device=dev,
                                        dtype=dt) < self.p_nni
                    ch_nni, c = propose_nni_device(generator, chs, T)
                    ch_p = torch.where(is_nni[:, None, None], ch_nni, chs)
                    j, m, scaled = self._scale_one(generator, bls,
                                                   bl_lambda)
                    bl_p = torch.where(is_nni[:, None], bls, scaled)
                    pm_scaled = pmats.clone()
                    pm_scaled[rows, j] = pmats_of(bl_p[rows, j][:, None])[:, 0]
                    pm_p = torch.where(is_nni[:, None, None, None, None],
                                       pmats, pm_scaled)
                    parent = parent_array(ch_p, T)
                    start = torch.where(is_nni, c, parent[rows, j])
                    buf_p, scal_p = update_path_partials(
                        buf, scal, pm_p, ch_p, start, T, rescale=rescale,
                        parent=parent)
                    lp_new = logpost_of(buf_p, scal_p, bl_p)
                    log_hr = torch.where(is_nni, 0.0, torch.log(m))
                    ok = (torch.log(torch.rand(B, generator=generator,
                                               device=dev, dtype=dt))
                          < lp_new - lps + log_hr) & torch.isfinite(lp_new)
                    chs = torch.where(ok[:, None, None], ch_p, chs)
                    bls = torch.where(ok[:, None], bl_p, bls)
                    pmats = torch.where(ok[:, None, None, None, None], pm_p,
                                        pmats)
                    buf = torch.where(ok[:, None, None, None, None], buf_p,
                                      buf)
                    scal = torch.where(ok[:, None, None], scal_p, scal)
                    lps = torch.where(ok, lp_new, lps)
                    slot = torch.where(is_nni, 0, 1)
                    acc[rows, slot, 0] += ok.to(dt)
                    acc[rows, slot, 1] += 1.0
                if ci >= burn_chunks:
                    for k, v in (("children", chs), ("bl", bls),
                                 ("logp", lps)):
                        out[k].append(v.cpu().numpy())
            acc = acc.sum(0).cpu().numpy()
        res = {k: np.stack(v) for k, v in out.items()}
        res["acceptance"] = {
            name: float(acc[i, 0] / max(acc[i, 1], 1.0))
            for i, name in enumerate(("nni", "branch"))}
        res["space"] = self.space
        return res
