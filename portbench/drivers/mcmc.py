"""MH over a batch of chains: ``inference.mcmc.MCMC`` built as
``config/actions.Runner.action_mcmc`` builds it (the operators' weights
a parameter block, the other blocks weighted by their sizes), run in
blocks of ``MCMC.run``, each continuing every chain from where the last
block left it.

Set-up runs the traffic's ``warm_blocks`` blocks: they build and warm
every shape, and carry the chains past the start, whose degenerate
generator (kappa = omega = 1, uniform frequencies) the eigensolver
decomposes faster than the posterior's. The window runs blocks until its
time is up. A block's answer is, for each chain, its state at the block's
end and the log target the program carries for it; the check recomputes a
sample of them, drawn from the seed, in the plain reference, and counts
the chains that never moved over the window."""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from physher_tpu_torch.config.builder import build_config
from physher_tpu_torch.inference.mcmc import MCMC

from .. import manifest

# a chain whose every coordinate moved less than this over the window has
# not moved (the round trip between blocks through the constrained values
# moves a float32 state by rounding only)
STILL = 1e-3


@dataclass
class Session:
    sampler: MCMC
    generator: torch.Generator
    params: dict
    chains: int
    block: int
    device: torch.device
    n_answers: int
    start: np.ndarray = None
    ends: list = field(default_factory=list)     # [chains, dim] a block
    logps: list = field(default_factory=list)    # [chains] a block


def sampler_for(ctx, model, operators) -> MCMC:
    """The sampler of ``action_mcmc``: each operator's weight goes to the
    parameter blocks it names."""
    log_prob = getattr(model, "log_prob", None) or model.log_likelihood
    weights = {}
    for op in operators:
        for n in ctx.resolve_target(op["x"]):
            weights[n] = weights.get(n, 0.0) + float(op["weight"])
    return MCMC(model.param_space(), log_prob, weights=weights or None)


def _run(s: Session):
    res = s.sampler.run(s.generator, s.params, n_iter=s.block,
                        every=s.block, n_chains=s.chains)
    s.params = res.constrain(res.samples_u[-1])
    return res


def setup(case, traffic, seed, device, dtype) -> Session:
    ctx, _ = build_config(case.physher, base_dir=case.base_dir, dtype=dtype,
                          device=device)
    model = ctx.objects[traffic["model"]]
    sampler = sampler_for(ctx, model, traffic.get("operators", []))
    space = model.param_space()
    got = [(n, size) for n, (_, size) in
           space.unconstrained_slices().items()]
    want = [(n, size - 1 if t == "simplex" else size)
            for n, t, size, _ in case.layout]
    if got != want:
        raise ValueError(f"the program's parameters {got} are not the "
                         f"reference's {want}")
    gen = torch.Generator(device=device).manual_seed(seed)
    s = Session(sampler, gen, space.init_params(**ctx.kw),
                int(traffic["chains"]), int(traffic["block"]), device,
                int(traffic["answers"]))
    for _ in range(int(traffic["warm_blocks"])):
        res = _run(s)
    s.start = res.samples_u[-1].copy()
    return s


def window(s: Session, seconds: float) -> dict:
    """Blocks until ``seconds`` have passed; the rate is every chain's MH
    iterations over the time until the last block's samples are on the
    host."""
    steps, failed = 0, 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        steps += s.block
        try:
            res = _run(s)
        except RuntimeError:
            failed += s.block
            break
        s.ends.append(res.samples_u[-1].copy())
        s.logps.append(res.log_posterior[-1].copy())
        if not np.all(np.isfinite(res.log_posterior[-1])):
            failed += s.block
    wall = time.perf_counter() - t0
    return {"attempted": steps, "failed": failed, "seconds": wall,
            "metrics": {"mcmc_samples_per_s": steps * s.chains / wall}}


def traced(s: Session, n: int) -> int:
    from torch.profiler import record_function

    block, s.block = s.block, n
    try:
        with record_function("mcmc.run"):
            _run(s)
    finally:
        s.block = block
    return n


def answers(s: Session) -> dict:
    return {"start": s.start, "ends": s.ends, "logps": s.logps,
            "n": s.n_answers}


def check(ans: dict, case, limits: dict, seed, device) -> dict:
    model = manifest.module("models", case.cfg["model"])
    ends, logps = ans["ends"], ans["logps"]
    if not ends:
        return {k: {"value": math.inf, "limit": limits[k]}
                for k in ("logp_gap", "still_chains")}
    rng = np.random.default_rng(seed)
    n_blocks, n_chains = len(ends), ends[0].shape[0]
    pairs = [(n_blocks - 1, int(rng.integers(n_chains)))]
    k = min(ans["n"], n_blocks * n_chains) - 1
    flat = rng.choice(n_blocks * n_chains, size=k, replace=False)
    pairs += [(int(i) // n_chains, int(i) % n_chains) for i in flat]
    gap = 0.0
    for b, c in pairs:
        ref, _ = model.log_target(case, ends[b][c], torch.float64, device)
        d = abs(float(logps[b][c]) - ref) / abs(ref)
        gap = max(gap, d if math.isfinite(d) else math.inf)
    moved = np.abs(ends[-1] - ans["start"]).max(axis=1)
    values = {"logp_gap": gap,
              "still_chains": float(np.sum(moved < STILL))}
    return {k: {"value": v, "limit": limits[k]} for k, v in values.items()}
