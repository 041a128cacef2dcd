"""Tree topology search: NNI and SPR with batched candidate scoring.

Port of ``physher_tpu/inference/topology_search.py`` (reference:
src/phyc/topologyopt.c:26-44 TopologyOptimizer, nniopt.c:160-380 NNI rounds,
spropt.c:1128-1380 radius-limited SPR with a parsimony prescreen,
treesearch.h:37-39 move primitives). Moves are generated on the host on
nested tree structures (branch lengths ride with their subtrees;
:func:`to_nested`, :func:`nni_neighbors` and :func:`spr_candidates` are the
JAX package's, copied); candidates are renumbered to canonical postorder by
``Topology.from_nested``.

Two engines compute what the search needs:

- a neighbourhood, B candidate topologies at the current branch lengths,
  is scored as one batch by the dynamic-topology engine
  (``ops/dynamic_pruning``), chunked by memory (``ml.batched_rows``,
  ``ml.hessian_chunk``); the SPR prescreen's Fitch scores too, in chunks
  of 64 as in the JAX package;
- one candidate, a ``Topology``, is re-optimized through the fixed-topology
  engine that ``select_engine`` picks for it
  (``TreeLikelihood.topology_log_likelihood``; on the card K1'/K2' or
  K3'/K4' at S = 4, K7'/K8' at S != 4): each of the 200 Adam steps on the
  log branch lengths is one forward and one backward call, with the tip
  partials permuted on the device. The start and the final polish are
  L-BFGS through ``ml.optimize`` on a model that the factory builds.

``optax.adam(0.05)`` becomes ``torch.optim.Adam(lr=0.05)``, the same update.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field

import numpy as np
import torch

from ..likelihood.parsimony import tip_state_sets
from ..ops.dynamic_pruning import batched_fitch, batched_tree_loglik
from ..trees.topology import Topology
from . import ml

# Fitch prescreen: scored this many candidates a chunk, past this many
# candidates, keeping max(PRESCREEN_KEEP, B / 4)
FITCH_CHUNK = 64
PRESCREEN_ABOVE = 64
PRESCREEN_KEEP = 32


def to_nested(topo: Topology, distances):
    """Topology + branch lengths -> nested dict tree (inverse of
    Topology.from_nested)."""

    def build(node):
        if node < topo.T:
            ch = []
        else:
            k = node - topo.T
            ch = [build(int(topo.children[k, j]))
                  for j in range(topo.child_count[k])]
        d = None
        if node != topo.root and distances is not None:
            d = float(distances[node])
            if np.isnan(d):
                d = None
        return {"name": topo.taxa[node] if node < topo.T else None,
                "length": d, "children": ch}

    return build(topo.root)


def _get(tree, path):
    n = tree
    for i in path:
        n = n["children"][i]
    return n


def nni_moves(nested) -> list:
    """The NNI rearrangements of ``nested`` as (parent path, index of v
    under its parent, index of v's child), in :func:`nni_neighbors`' order:
    v internal and non-root with a binary parent, each child of v once."""
    moves = []

    def walk(node, path, parent):
        if node["children"] and path and len(parent["children"]) == 2:
            moves.extend((path[:-1], path[-1], ci)
                         for ci in range(len(node["children"])))
        for i, c in enumerate(node["children"]):
            walk(c, path + (i,), node)

    walk(nested, (), None)
    return moves


def apply_nni(nested, move):
    """A copy of ``nested`` with one move of :func:`nni_moves`: v's sibling
    and v's child swap places. Branch lengths stay attached to their
    subtrees; the central edge keeps its length."""
    parent_path, vi, ci = move
    cand = copy.deepcopy(nested)
    parent = _get(cand, parent_path)
    v = parent["children"][vi]
    si = 1 - vi
    parent["children"][si], v["children"][ci] = \
        v["children"][ci], parent["children"][si]
    return cand


def nni_neighbors(nested):
    """All NNI rearrangements (2 per internal non-root edge): for edge (v,
    parent), v's sibling swapped with each child of v, in the JAX
    package's order."""
    return [apply_nni(nested, m) for m in nni_moves(nested)]


def spr_candidates(nested, max_radius: int | None = None):
    """SPR rearrangements: prune each subtree, regraft on edges within
    ``max_radius`` hops of the pruning point (reference: spropt.c)."""
    out = []
    root = copy.deepcopy(nested)

    def paths(node, path=()):
        yield path, node
        for i, c in enumerate(node["children"]):
            yield from paths(c, path + (i,))

    def get(tree, path):
        n = tree
        for i in path:
            n = n["children"][i]
        return n

    all_paths = [p for p, n in paths(root)]
    for prune_path in all_paths:
        if prune_path == ():
            continue
        parent_path = prune_path[:-1]
        for target_path in all_paths:
            if target_path == () or target_path == prune_path:
                continue
            # target must not be inside the pruned subtree nor its parent edge
            if target_path[: len(prune_path)] == prune_path:
                continue
            if target_path == parent_path:
                continue
            if max_radius is not None:
                # topological distance between edge midpoints (path metric)
                common = 0
                for a, b in zip(prune_path, target_path):
                    if a != b:
                        break
                    common += 1
                dist = (len(prune_path) - common) + (len(target_path) - common)
                if dist > max_radius:
                    continue
            cand = copy.deepcopy(root)
            pruned = get(cand, prune_path)
            pparent = get(cand, parent_path)
            sibs = [c for i, c in enumerate(pparent["children"])
                    if i != prune_path[-1]]
            if len(sibs) != 1:
                continue  # binary only
            sib = sibs[0]
            # collapse parent: sibling absorbs the parent's branch
            if pparent is cand:
                # parent is root: sibling becomes the new root
                sib = copy.deepcopy(sib)
                new_root = sib
                if not new_root["children"]:
                    continue
                cand = new_root
                cand["length"] = None
            else:
                gp = get(cand, parent_path[:-1])
                l1 = pparent.get("length") or 0.0
                l2 = sib.get("length") or 0.0
                sib["length"] = l1 + l2
                gp["children"][parent_path[-1]] = sib
            # locate target in the modified tree by identity-walk: recompute
            # paths in cand (structure changed above prune point only if
            # target shares prefix; we skipped those cases)
            try:
                tgt_parent = get(cand, target_path[:-1])
                tgt = tgt_parent["children"][target_path[-1]]
            except (IndexError, KeyError):
                continue
            half = (tgt.get("length") or 0.0) / 2.0
            tgt2 = copy.deepcopy(tgt)
            tgt2["length"] = half
            new_node = {"name": None, "length": half,
                        "children": [tgt2, copy.deepcopy(pruned)]}
            tgt_parent["children"][target_path[-1]] = new_node
            out.append(cand)
    return out


@dataclass
class SearchResult:
    topology: Topology
    distances: np.ndarray
    logp: float
    rounds: int
    moves_accepted: int
    history: list = field(default_factory=list)


def _tip_rows(base: Topology, topo: Topology) -> list:
    """Rows of ``base``'s tips in ``topo``'s tip order."""
    row = {t: i for i, t in enumerate(base.taxa)}
    return [row[t] for t in topo.taxa]


class TopologySearch:
    """NNI/SPR hill climbing over topologies for a tree likelihood.

    ``tlk_factory(topo, distances)`` builds a TreeLikelihood for a topology
    (the same data and models), for the start's and the final polish's
    L-BFGS fits. Candidates are scored at their current branch lengths,
    and the best few re-optimized by Adam on their log branch lengths."""

    def __init__(self, tlk_factory, *, algorithm: str = "nni",
                 spr_radius: int = 6, prescreen_parsimony: bool = True,
                 max_rounds: int = 50, tol: float = 1e-3,
                 bl_opt_steps: int = 200):
        self.factory = tlk_factory
        self.algorithm = algorithm
        self.spr_radius = spr_radius
        self.prescreen = prescreen_parsimony
        self.max_rounds = max_rounds
        self.tol = tol
        self.bl_opt_steps = bl_opt_steps
        # (TreeLikelihood, params) of the start's fit: the model the
        # candidates are scored and re-optimized with
        self._base = None

    def _score_candidates(self, candidates):
        """Log-likelihoods [B] of candidate (topology, distances) pairs at
        their branch lengths: one batch through the dynamic engine,
        chunked by ``ml.hessian_chunk``."""
        tlk, params = self._base
        dev = tlk.tip_partials.device
        children = torch.as_tensor(
            np.stack([t.children[:, :2] for t, _ in candidates]),
            dtype=torch.long, device=dev)
        bls = torch.as_tensor(
            np.stack([np.nan_to_num(d, nan=0.0) for _, d in candidates]),
            dtype=tlk.dtype, device=dev)
        perms = torch.as_tensor(
            [_tip_rows(tlk.topo, t) for t, _ in candidates], device=dev)
        rates, props = tlk.site_model.rates_props(params)
        freqs = tlk.subst.frequencies(params).to(tlk.dtype)
        props = props.to(tlk.dtype)

        def score(rows):
            idx = rows[:, 0].to(torch.long)
            pmats = tlk.subst.p_t(
                params, bls[idx][:, :, None] * rates[None, None, :]).to(
                    tlk.dtype)
            return batched_tree_loglik(
                tlk.tip_partials[perms[idx]], pmats, children[idx], freqs,
                props, tlk.weights, rescale=tlk.rescale)

        rows = torch.arange(len(candidates), dtype=tlk.dtype,
                            device=dev)[:, None]
        with torch.no_grad():
            return ml.batched_rows(score, rows, ml.hessian_chunk(tlk)).to(
                torch.float64).cpu().numpy()

    def _prescreen(self, candidates):
        """The SPR candidates kept by their Fitch scores: the
        max(PRESCREEN_KEEP, B / 4) most parsimonious."""
        tlk = self._base[0]
        dev = tlk.tip_partials.device
        tips = torch.as_tensor(tip_state_sets(tlk.sp, tlk.topo), device=dev)
        w = torch.as_tensor(tlk.sp.weights, dtype=tlk.dtype, device=dev)
        scores = []
        with torch.no_grad():
            for s0 in range(0, len(candidates), FITCH_CHUNK):
                chunk = candidates[s0: s0 + FITCH_CHUNK]
                tps = tips[torch.as_tensor(
                    [_tip_rows(tlk.topo, c[0]) for c in chunk], device=dev)]
                chs = torch.as_tensor(
                    np.stack([c[0].children[:, :2] for c in chunk]),
                    dtype=torch.long, device=dev)
                scores.append(batched_fitch(tps, chs, w).cpu().numpy())
        pars = np.concatenate(scores)
        keep = np.argsort(pars)[: max(PRESCREEN_KEEP, len(candidates) // 4)]
        return [candidates[i] for i in keep]

    def _reoptimize(self, topo, dist):
        """L-BFGS on a model that the factory builds (start and final
        polish): (model, params, logP, distances [N])."""
        dist = self._reopen(dist)
        tlk = self.factory(topo, dist)
        space = tlk.param_space()
        res = ml.optimize(tlk.log_likelihood, space, space.init_params(
            dtype=tlk.dtype, device=tlk.tip_partials.device),
            method="lbfgs", max_iter=200)
        d = res.params[tlk.key("distances")].to(torch.float64).cpu().numpy()
        return tlk, res.params, float(res.logp), np.concatenate([d, [np.nan]])

    @staticmethod
    def _reopen(dist):
        # reopen collapsed edges: bl -> 0 kills the log-space gradient
        # (d logL / d log bl = bl * d logL / d bl), so a candidate whose
        # rearranged edge starts near zero could never move off it
        dist = np.asarray(dist, dtype=np.float64).copy()
        dist[np.isnan(dist)] = 0.05
        dist[dist < 2e-3] = 2e-2
        return dist

    def _reoptimize_dynamic(self, topo_c, dist_c):
        """Adam (lr 0.05, ``bl_opt_steps`` steps) on the log branch lengths
        of candidate ``topo_c``, the model's parameters held at the start's
        fit: (logP at the last step's lengths, distances [N])."""
        tlk, params = self._base
        dev = tlk.tip_partials.device
        tips = tlk.tips_for(topo_c)
        bl0 = torch.as_tensor(self._reopen(dist_c), dtype=tlk.dtype,
                              device=dev)
        log_bl = torch.log(torch.clamp(bl0[:-1], min=1e-6)).requires_grad_()
        # the root's entry gets no gradient in the JAX package: it stays
        root = torch.clamp(bl0[-1:], min=1e-6)
        opt = torch.optim.Adam([log_bl], lr=0.05)

        def loglik():
            return tlk.topology_log_likelihood(
                params, topo_c, tips, torch.cat([torch.exp(log_bl), root]))

        for _ in range(self.bl_opt_steps):
            opt.zero_grad(set_to_none=True)
            (-loglik()).backward()
            opt.step()
        with torch.no_grad():
            logp = float(loglik())
            d = torch.exp(log_bl).to(torch.float64).cpu().numpy()
        return logp, np.concatenate([d, [np.nan]])

    def run(self, topo: Topology, distances) -> SearchResult:
        tlk, params, best, dist = self._reoptimize(topo, distances)
        self._base = (tlk, params)
        # rebase 'best' onto the Adam re-optimization's scale, so that the
        # candidates are compared on the same objective
        best_dyn, dist_dyn = self._reoptimize_dynamic(tlk.topo, dist)
        if best_dyn > best:
            best, dist = best_dyn, dist_dyn
        history = [best]
        accepted = 0
        rounds = 0
        for rounds in range(1, self.max_rounds + 1):
            nested = to_nested(topo, dist)
            if self.algorithm == "nni":
                cand_nested = nni_neighbors(nested)
            else:
                cand_nested = spr_candidates(nested, self.spr_radius)
            candidates = [Topology.from_nested(c) for c in cand_nested]
            if not candidates:
                break
            if (self.algorithm == "spr" and self.prescreen
                    and len(candidates) > PRESCREEN_ABOVE):
                candidates = self._prescreen(candidates)
            scores = self._score_candidates(candidates)
            order = np.argsort(scores)[::-1]
            improved = False
            # candidates tied with the best score (zero-length edges make NNI
            # neighborhoods score identically at shared branch lengths) all
            # deserve a branch-length re-optimization
            n_try = max(3, int(np.sum(scores >= scores.max() - 1e-6)))
            for bi in order[: min(n_try, 16)]:
                topo_c, dist_c = candidates[bi]
                if scores[bi] < best - 50.0:
                    break
                logp_c, dist_opt = self._reoptimize_dynamic(topo_c, dist_c)
                if logp_c > best + self.tol:
                    topo, dist, best = topo_c, dist_opt, logp_c
                    improved = True
                    accepted += 1
                    break
            history.append(best)
            if not improved:
                break
        # final polish with the full optimizer on the winning topology
        tlk, params, final_lnl, dist = self._reoptimize(topo, dist)
        best = max(best, final_lnl)
        history.append(best)
        return SearchResult(topo, dist, best, rounds, accepted, history)
