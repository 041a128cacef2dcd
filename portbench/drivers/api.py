"""The Interface API as torchtree drives it: one client in a closed loop of
evaluations through ``api.TreeLikelihoodInterface`` with the GTR, Gamma4
and strict-clock interfaces on a reparameterized time tree. An evaluation
is ``SetParameters`` on each interface with new values, then
``LogLikelihood()``, then ``Gradient()``, each returning to the caller.

The values come from a seeded random walk around the start, drawn before
the window; every evaluation's time is kept, and the check recomputes a
sample of the evaluations, drawn from the seed, in the plain reference."""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from physher_tpu_torch import api
from physher_tpu_torch.io.seqio import read_alignment

from .. import manifest, plain

# the interfaces' buffers in the order SetParameters takes them
API_ORDER = ("ratios", "root_height", "rates", "frequencies", "shape",
             "rate")
# the API's parameter names -> the reference's
NAMES = {"tree.ratios": "ratios", "tree.root_height": "root_height",
         "rates": "rates", "frequencies": "frequencies", "shape": "shape",
         "rate": "rate"}


@dataclass
class Session:
    tlk: object
    tree: object
    subst: object
    site: object
    clock: object
    pool: Walk
    n_answers: int
    blocks: list                   # (API name, size) in Gradient()'s order
    next: int = 0
    done: list = field(default_factory=list)   # (row, logL, gradient)


class Walk:
    """``n`` parameter sets: a random walk in unconstrained coordinates,
    each step pulled back toward the start by ``pull``; kept as one array
    of the interfaces' buffers (few objects for the collector to visit)."""

    def __init__(self, start: dict, n: int, scale: float, pull: float,
                 seed: int, low_root: float):
        I = len(start["ratios"]) + 1
        self.layout = [("ratios", "logit", I - 1, 0.0),
                       ("root_height", "shifted_log", 1, low_root),
                       ("rates", "log", 6, 0.0),
                       ("frequencies", "simplex", 4, 0.0),
                       ("shape", "log", 1, 0.0), ("rate", "log", 1, 0.0)]
        u0 = plain.unconstrain(self.layout, start)
        rng = np.random.default_rng(seed)
        u = u0.copy()
        self.rows = np.empty((n, I + 12))
        for i in range(n):
            u = u0 + (1.0 - pull) * (u - u0) + scale * rng.standard_normal(
                u0.shape)
            v, _ = plain.constrain(self.layout, torch.as_tensor(u))
            self.rows[i] = np.concatenate(
                [np.atleast_1d(v[k].numpy()) for k in API_ORDER])
        # the interfaces' buffers: tree (I), GTR (10), site (1), clock (1)
        self.cuts = np.cumsum([0, I, 10, 1, 1])

    def __len__(self):
        return len(self.rows)

    def values(self, i: int) -> dict:
        """Row ``i`` by the reference's names."""
        r = self.rows[i]
        I = self.cuts[1]
        return {"ratios": r[:I - 1], "root_height": r[I - 1],
                "rates": r[I:I + 6], "frequencies": r[I + 6:I + 10],
                "shape": r[I + 10], "rate": r[I + 11]}


def setup(case, traffic, seed, device, dtype) -> Session:
    seqs = read_alignment(case.fasta)
    start = case.api_start()
    tree = api.ReparameterizedTimeTreeModelInterface(
        case.newick, None, case.dates, device=device, dtype=dtype)
    subst = api.GTRInterface(start["rates"], start["frequencies"])
    site = api.GammaSiteModelInterface(float(start["shape"]),
                                       case.cfg["categories"])
    clock = api.StrictClockModelInterface(float(start["rate"]), tree)
    tlk = api.TreeLikelihoodInterface(seqs, tree, subst, site, clock,
                                      include_jacobian=True, device=device,
                                      dtype=dtype)
    blocks = [(k, tlk._slices[k].stop - tlk._slices[k].start)
              for k in sorted(tlk._slices)]
    if sorted(k for k, _ in blocks) != sorted(NAMES):
        raise ValueError(f"the API's parameters {blocks} are not "
                         f"{sorted(NAMES)}")
    pool = Walk(start, int(traffic["pool"]), float(traffic["walk_scale"]),
                float(traffic["walk_pull"]), seed,
                float(case.low[case.tree.root]))
    s = Session(tlk, tree, subst, site, clock, pool, int(traffic["answers"]),
                blocks)
    for _ in range(int(traffic["warm_evals"])):
        evaluate(s)
    s.done.clear()
    return s


def evaluate(s: Session):
    i = s.next % len(s.pool)
    s.next += 1
    row, c = s.pool.rows[i], s.pool.cuts
    s.tree.SetParameters(row[c[0]:c[1]])
    s.subst.SetParameters(row[c[1]:c[2]])
    s.site.SetParameters(row[c[2]:c[3]])
    s.clock.SetParameters(row[c[3]:c[4]])
    logl = s.tlk.LogLikelihood()
    grad = s.tlk.Gradient()
    return i, logl, grad


def window(s: Session, seconds: float) -> dict:
    lat, failed = [], 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        t = time.perf_counter()
        try:
            row, logl, grad = evaluate(s)
        except RuntimeError:
            failed += 1
            lat.append((time.perf_counter() - t) * 1e3)
            continue
        lat.append((time.perf_counter() - t) * 1e3)
        s.done.append((row, logl, grad))
        if not (math.isfinite(logl) and np.all(np.isfinite(grad))):
            failed += 1
    return {"attempted": len(lat), "failed": failed,
            "seconds": time.perf_counter() - t0, "latencies_ms": lat,
            "metrics": {"api_eval_ms_p95": float(np.percentile(lat, 95))}}


def traced(s: Session, n: int) -> int:
    from torch.profiler import record_function

    for _ in range(n):
        with record_function("api.evaluation"):
            evaluate(s)
    return n


def answers(s: Session) -> dict:
    return {"done": [(s.pool.values(i), logl, g) for i, logl, g in s.done],
            "blocks": s.blocks, "n": s.n_answers}


def check(ans: dict, case, limits: dict, seed, device) -> dict:
    model = manifest.module("models", case.cfg["model"])
    done = ans["done"]
    if not done:
        return {k: {"value": math.inf, "limit": limits[k]}
                for k in ("logl_gap", "grad_gap")}
    rng = np.random.default_rng(seed)
    pick = rng.choice(len(done), size=min(ans["n"], len(done)),
                      replace=False)
    logl_gap = grad_gap = 0.0
    for i in pick:
        v, logl, grad = done[int(i)]
        ref, gref = model.api_loglik(case, v, torch.float64, device)
        d = abs(logl - ref) / abs(ref)
        logl_gap = max(logl_gap, d if math.isfinite(d) else math.inf)
        parts, at = {}, 0
        for k, n in ans["blocks"]:
            parts[NAMES[k]] = np.asarray(grad[at:at + n])
            at += n
        norms = {k: float(np.linalg.norm(g)) for k, g in gref.items()}
        med = float(np.median(list(norms.values())))
        for k, g in gref.items():
            d = float(np.linalg.norm(parts[k] - g)) / max(norms[k], med)
            grad_gap = max(grad_gap, d if math.isfinite(d) else math.inf)
    values = {"logl_gap": logl_gap, "grad_gap": grad_gap}
    return {k: {"value": v, "limit": limits[k]} for k, v in values.items()}
