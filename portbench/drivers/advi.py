"""ADVI: a closed loop of ``inference.vb.step`` on the mean-field normal
family that ``config/builder`` builds, with the fit's own Adam and
eta/sqrt(t) schedule (``vb.adam``), as the optimizer action runs it
without its ELBO checks.

Set-up builds the one optimizer state, drives it through its first steps
(recording each step's draws and loss, the first gradient from Adam's
state after one step and the parameters after the third) and hands the
same objects to the window. The check replays those steps in the plain
reference (float64, the same draws) and compares each step's loss, the
first gradient's norm and the change of the parameters over the steps,
each by the worst of the family's two leaves."""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from physher_tpu_torch.config.builder import build_config
from physher_tpu_torch.inference import vb

from .. import manifest

# Adam's defaults, which vb.adam takes
BETAS = (0.9, 0.999)
EPS = 1e-8
LEAVES = ("loc", "log_scale")


@dataclass
class Session:
    family: object
    vparams: dict
    opt: object
    schedule: object
    generator: torch.Generator
    grad_samples: int
    device: torch.device
    check_every: int
    eta: float
    first_steps: int = 3
    draws: list = field(default_factory=list)
    losses: list = field(default_factory=list)
    before: dict = None
    first_grad: dict = None
    after: dict = None


def setup(case, traffic, seed, device, dtype) -> Session:
    ctx, _ = build_config(case.physher, base_dir=case.base_dir, dtype=dtype,
                          device=device)
    handle = ctx.objects["varnormal"]
    fam = handle.family
    vparams = {k: v.detach().clone().requires_grad_(True)
               for k, v in fam.init.items()}
    opt, schedule = vb.adam(vparams, float(traffic["eta"]))
    gen = torch.Generator(device=device).manual_seed(seed)
    s = Session(fam, vparams, opt, schedule, gen,
                int(traffic["grad_samples"]), device,
                int(traffic["check_every"]), float(traffic["eta"]),
                int(traffic["first_steps"]))
    cls = type(fam)

    def draw(vp, generator, n):
        eps = cls.draw(fam, vp, generator, n)
        s.draws.append(eps.detach().to("cpu", torch.float64).numpy())
        return eps

    def elbo(vp, generator=None, n_samples=1, eps=None):
        e = cls.elbo(fam, vp, generator, n_samples, eps)
        s.losses.append(-float(e.detach()))
        return e

    def host(n):
        return vparams[n].detach().to("cpu", torch.float64).numpy()

    def first_gradient(n):
        # Adam's first moment after one step is (1 - beta1) g
        state = opt.state.get(vparams[n], {})
        if "exp_avg" not in state:
            return np.zeros(vparams[n].shape)
        return (state["exp_avg"] / (1 - BETAS[0])).to(
            "cpu", torch.float64).numpy()

    # the first steps through the window's own call, their draws and
    # losses recorded on the way
    s.before = {n: host(n) for n in LEAVES}
    fam.draw, fam.elbo = draw, elbo
    try:
        for k in range(s.first_steps):
            vb.step(fam, vparams, opt, schedule, gen, s.grad_samples)
            if k == 0:
                s.first_grad = {n: first_gradient(n) for n in LEAVES}
    finally:
        del fam.draw, fam.elbo
    s.after = {n: host(n) for n in LEAVES}
    for _ in range(int(traffic["warm_steps"])):
        vb.step(fam, vparams, opt, schedule, gen, s.grad_samples)
    return s


def _finite(s: Session) -> torch.Tensor:
    return torch.stack([torch.isfinite(s.vparams[n]).all() for n in LEAVES]
                       ).all()


def window(s: Session, seconds: float) -> dict:
    """Steps until ``seconds`` have passed; the rate is all the steps over
    the time until the last of them has finished on the device."""
    flags, raised = [], 0
    n = 0
    if s.device.type == "cuda":
        torch.cuda.synchronize(s.device)
    t0 = time.perf_counter()
    try:
        while True:
            vb.step(s.family, s.vparams, s.opt, s.schedule, s.generator,
                    s.grad_samples)
            n += 1
            if n % s.check_every == 0:
                flags.append((n, _finite(s)))
            if time.perf_counter() - t0 >= seconds:
                break
    except RuntimeError:
        raised = 1
    flags.append((n, _finite(s)))
    if s.device.type == "cuda":
        torch.cuda.synchronize(s.device)
    wall = time.perf_counter() - t0
    # steps after the last checkpoint with finite parameters have failed
    last_ok = max([k for k, f in flags if bool(f)], default=0)
    return {"attempted": n + raised, "failed": n - last_ok + raised,
            "seconds": wall,
            "metrics": {"advi_steps_per_s": n / wall}}


def traced(s: Session, n: int) -> int:
    from torch.profiler import record_function

    for _ in range(n):
        with record_function("vb.step"):
            vb.step(s.family, s.vparams, s.opt, s.schedule, s.generator,
                    s.grad_samples)
    return n


def answers(s: Session) -> dict:
    return {"draws": s.draws, "losses": s.losses, "before": s.before,
            "first_grad": s.first_grad, "after": s.after, "eta": s.eta,
            "steps": s.first_steps}


def _leaf_gap(prog: dict, ref: dict) -> float:
    """The worst leaf's |norm(program) - norm(reference)| over the larger
    of that leaf's reference norm and the median leaf's."""
    norms = {n: float(np.linalg.norm(ref[n])) for n in LEAVES}
    med = float(np.median(list(norms.values())))
    return max(abs(float(np.linalg.norm(prog[n])) - norms[n])
               / max(norms[n], med) for n in LEAVES)


def reference_steps(case, draws, eta, dtype, device, target=None):
    """The plain reference's Adam on the negative ELBO from the family's
    start, one step a recorded draw: (losses, first gradient, parameters
    after the last step, start). ``target`` stands in for the model's
    log target (the control's faults)."""
    model = case_model(case)
    target = target or model.log_target
    start = model.vb_init(case)
    p = {n: start[n].copy() for n in LEAVES}
    m = {n: np.zeros_like(p[n]) for n in LEAVES}
    v = {n: np.zeros_like(p[n]) for n in LEAVES}
    losses, first = [], None
    d = p["loc"].shape[0]
    for k, eps in enumerate(draws, start=1):
        eps = eps.reshape(-1, d)
        scale = np.exp(p["log_scale"])
        g = {n: np.zeros(d) for n in LEAVES}
        total = 0.0
        for e in eps:
            z = p["loc"] + scale * e
            t, gz = target(case, z, dtype, device, want_grad=True)
            total += t / len(eps)
            g["loc"] -= gz / len(eps)
            g["log_scale"] -= gz * scale * e / len(eps)
        entropy = float(np.sum(p["log_scale"])) + 0.5 * d * (
            1.0 + math.log(2.0 * math.pi))
        g["log_scale"] -= 1.0
        losses.append(-(total + entropy))
        if k == 1:
            first = {n: g[n].copy() for n in LEAVES}
        lr = eta / math.sqrt(k)
        for n in LEAVES:
            m[n] = BETAS[0] * m[n] + (1 - BETAS[0]) * g[n]
            v[n] = BETAS[1] * v[n] + (1 - BETAS[1]) * g[n] ** 2
            denom = np.sqrt(v[n] / (1 - BETAS[1] ** k)) + EPS
            p[n] = p[n] - lr / (1 - BETAS[0] ** k) * m[n] / denom
    return losses, first, p, start


def case_model(case):
    return manifest.module("models", case.cfg["model"])


def check(ans: dict, case, limits: dict, seed, device) -> dict:
    if len(ans["draws"]) != ans["steps"]:
        # the program drew for fewer steps than it was asked to take
        return {k: {"value": math.inf, "limit": limits[k]}
                for k in ("loss_gap", "grad1_gap", "change3_gap")}
    losses, first, after, start = reference_steps(
        case, ans["draws"], ans["eta"], torch.float64, device)
    # a step whose loss the program never computed is a missing answer
    loss_gap = (max(abs(a - b) / abs(b) for a, b in zip(ans["losses"],
                                                          losses))
                if len(ans["losses"]) == len(losses) else math.inf)
    grad_gap = _leaf_gap(ans["first_grad"], first)
    change_gap = _leaf_gap(
        {n: ans["after"][n] - ans["before"][n] for n in LEAVES},
        {n: after[n] - start[n] for n in LEAVES})
    values = {"loss_gap": loss_gap, "grad1_gap": grad_gap,
              "change3_gap": change_gap}
    return {k: {"value": v, "limit": limits[k]} for k, v in values.items()}
