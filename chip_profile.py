"""Where the time goes in an ADVI step of the port's CLI configs, on the card.

For the reference's fluA ADVI config (``tests/data/fluA-elbo.json``, through
K1'/K2') and for the 128-taxon GTR+G4 config that ``chip_smoke.py`` simulates
(about 16 000 patterns, through K3'/K4'), in float32: the host time of one
ADVI step (one-sample ELBO gradient and the Adam update), its device time
and launches from ``torch.profiler`` (kernel rows only), the device's busy
share of the step, the top kernel rows, and the host time of one
multi-sample convergence check (forward-only calls under ``no_grad``).
Then K3'/K4' and K1'/K2', each kernel alone by CUDA events against the plain
version, on the balanced 128 x 16384 and the caterpillar 64 x 8192 trees
(C = 4) in float32 and float64.

With ``--gate``, only the measurement behind ``select_engine``'s choice
between K3'/K4' and K1'/K2': one forward and one backward sweep (the launch
wrappers, CUDA events, median of 20) through each pair, float32, on
balanced, caterpillar and random binary trees and the fluA tree, from 16
to 512 taxa, 256 to 32 768 patterns, C = 1 and 4: one JSON line per shape
on standard output (and in the file ``--out`` names). Then, end
to end, the Adam step and value-and-gradient of three models through each
pair forced (fused, staged, staged, fused): JC69 on the fluA time tree,
GTR+G4 on the fluA tree and GTR+G4 on a random 128-taxon tree with 16 384
patterns.

With ``--mcmc``, only the Metropolis-Hastings step of the checkpoint B
model's tempered target (``inference/mcmc.MCMC``, float32) against the
number of chains L = 1, 4, 16, 64: host time per step (mean of at least
200), device time, launches and busy share per step from the profiler, and
the engine (K1'/K2' as one dict at L = 1, K5' from L = 2).

With ``--wide-backward``, only K5'/K6' at S != 4 alone (CUDA events, median
of 100) against the plain version, with their bounds, on chains of GY94 M0
32 x 4096 (L = 8) and WAG+G4 64 x 8192 (L = 4), float32, then HMC with 4
chains on WAG+G4 (``chip_smoke.hmc_wag``, its ms per leapfrog step), and
nvcc's register and spill lines for ``csrc/loop.cu``. It uses only the
entry points of ``ops/loop.py`` and ``chip_smoke.py``, so the same script
also times an older checkout of the port (run it from that checkout's
root).

With ``--wide-forward``, only K5' at S != 4 and K7' (their shared forward
node step): K5'/K6' alone (CUDA events, median of 100) against the plain
version on chains of GY94 M0 32 x 4096 (L = 8) and WAG+G4 64 x 8192
(L = 4), K7'/K8' alone at one chain of each, WAG+G4's and GY94's
value-and-gradient through K7'/K8', the device time of each of K7''s
launches (the levels, leaves first, then the root) from torch.profiler,
then HMC with 4 chains on WAG+G4 (``chip_smoke.hmc_wag``), nvcc's register
and spill lines for both forward kernels and, where the checkout has them,
the most clusters resident at once. Like ``--wide-backward`` it uses only
entry points that older checkouts have, so a copy run from an older
checkout's root times that checkout.

With ``--k8``, only K7'/K8' alone (CUDA events, median of 100) against the
plain version, with their bounds, at GY94 M0 32 x 4096 (C = 1) and WAG+G4
64 x 8192 (C = 4), float32, beside each model's value-and-gradient through
them and its Adam step (host clock), and nvcc's register and spill lines
for K8'. Then the device time of each of K8''s launches (the root seed,
then the levels root first) from torch.profiler. Like ``--wide-backward``
it uses only entry points that older checkouts have, so a copy run from an
older checkout's root times that checkout.

With ``--staged``, only K3'/K4' alone (CUDA events, median of 100) against
the plain version, with their bounds and the design's floors (the bytes it
must move through device memory; the level-by-level design's beside the
walk's), at the 128-taxon GTR+G4 config model that ``chip_smoke.py``
simulates (16 291 patterns, 14 levels), the balanced 128 x 16384 tree
(C = 4) and the GTR+G4 fluA golden's model, float32 and float64, beside
the staged value-and-gradient, each sweep's device time in a CUDA graph
of 20 calls (``graph_launch_us``), the wrappers' host time, K3''s kernel
launches a sweep, the device time of each of K3''s and K4''s launches
(torch.profiler; K3''s levels below the switch leaves first, then the
walk; K4''s root first), K3' through each walk at other switch levels, and
nvcc's register and spill lines. Like
``--wide-backward`` it uses only entry points that older checkouts have, so
a copy run from an older checkout's root times that checkout.

With ``--switch``, only K3' (float32, device time in a CUDA graph) through
each of its walks at each switch level (each level up to the first of one
node, and none) over the gate's trees, pattern counts and C = 1 and 4: the
measurement behind ``ops/staged.py``'s ``walk_level``; ``--out`` names a
file for its lines.

With ``--k4-variants``, only K4' (float32) at the config model and the
balanced 128 x 16384 tree through ``csrc/staged.cu`` as committed and
rebuilt with no, two and six patterns staged ahead (``BWD_DEPTH``) and at
three blocks an SM (``BWD_BLOCKS``): each build's registers and spills, K4'
alone (median of 50, three rounds in turns) and its launches' device time;
then the committed build at other ``MAX_PPT`` and ``FIXED`` of
``ops/staged.level_ppt``.

With ``--k8-blocks``, only K8' (float32) at GY94 M0 32 x 4096 with
``csrc/wide.cu`` as committed (128 patterns a block) and rebuilt with
``BWD_P`` at 64 and 32 (the dP scratch grows as the block shrinks): each
build's registers and spills, K8' alone (median of 100, three rounds in
turns), each launch's device time and each build's largest difference
from the committed one.

With ``--k6-bounds``, only the float32 register budget of K6' at S != 4:
``csrc/loop.cu`` as committed (2 blocks an SM where a step takes four
tiles, 3 where it takes one) and rebuilt with its kernel's
``__launch_bounds__`` asking for 1, 2 or 3 blocks an SM at every step
shape, each build's registers and spills, and K6' alone through each
(median of 50, three rounds in turns) at the two shapes above.

With ``--k5-bounds``, the same for K5' at S != 4: ``csrc/loop.cu`` as
committed (float32 at 4 blocks an SM) and rebuilt at 2 and 3, and K5'
alone through each at the two shapes above.

With ``--s4-backward``, only K6' at S = 4 and K2' (their shared reverse
step, ``csrc/s4_backward.cuh``) alone (CUDA events, median of 100) against
the plain version, float32 and float64: K6' at the checkpoint B model's
chains (L = 4 and 16) and GTR+G4 fluA (L = 8), K2' at both models and the
128-taxon caterpillar at 16 384 patterns (C = 1 and 2); each launch's
device time (torch.profiler), the wrappers' host time, the design floor
(preorder levels x one dependent L2 round trip and barrier, measured here,
plus the dP pass at its byte bound), K6' at S = 4 through the S != 4
design, nvcc's register lines, the cost of a level on caterpillars, then
HMC on the checkpoint B model and the fluA ADVI step. ``--s4-trace``
stamps each level of K2''s and K1''s walks with clock64(); ``--s4-host``
gives only the wrappers' host time. ``--s4-backward`` and ``--s4-host`` use
only entry points that older checkouts have, so a copy run from an older
checkout's root times that checkout.

With ``--s4-forward``, only K1' and K5' at S = 4 (their shared forward
step, ``csrc/s4_forward.cuh``) alone (CUDA events, median of 100) against
the plain version, float32 and float64: K5' at the checkpoint B model's
chains (L = 16 and 4), GTR+G4 fluA (L = 8) and the fluA polytomy tree
(L = 4), K1' at both models and the 128-taxon caterpillar at 16 384
patterns (C = 1 and 2); each launch's device time (torch.profiler, under
the parent's kernel names and the new one, and one of 20 calls in a CUDA
graph), the wrappers' host time, the bound, the design floor (postorder
levels x one dependent L2 round trip and barrier, measured here, plus the
bytes at 3.35 TB/s), nvcc's register lines and the cost of a level on
caterpillars. Like ``--s4-backward`` a copy run from an older checkout's
root times that checkout.

With ``--fused-wide``, only K1' and K2' at S != 4 alone (one sweep each,
device time in a CUDA graph of 20 calls and by CUDA events, median of 50)
beside K7' and K8' on the same inputs, with their bounds, at WAG+G4 64 x
8192 and GY94 M0 32 x 4096 (category-split), WAG 64 x 8192 and WAG on a
128-taxon caterpillar at 8192 patterns (packed), float32 and float64; the
kernel launches a sweep from the C code's counter
(``fused.kernel_launches``, where the checkout has it: the profiler stops
seeing kernels after a few sessions) and, where the checkout has them,
each kernel walked and on the tree's schedule (``fused.SCHEDULE``), the
rule's choice and whether the two agree bit for bit; and nvcc's register
and spill lines of both kernels. It uses only ``fused.fused_wide_forward`` /
``fused_wide_backward``, which older checkouts have, so a copy run from an
older checkout's root times that checkout.

With ``--calibrated-settings``, only the estimators of
``tests/data/fluA-calibrated.json`` in float64 against their chain
settings, over four seeds, in the config's order: the config's
ladder of 5 000 iterations (500 burnt) with stepping stone
and path sampling from its first 1 000, 2 500 and 5 000; one batch of 64 MH
chains of 5 000 iterations (1 000 burnt), both from the config's values,
with bridge sampling over the first 16, 32 or 64 chains and their first
625, 1 250, 2 500 or 5 000 iterations; then the L-BFGS fit and ADVI of at
most 1 000 and 2 500 steps from its optimum, each followed by the config's
IS; each run's host time. The spread over the seeds at each setting bounds
how short the config's settings can be.

With ``--ladder-spread``, only that config's own ladder (its
temperatures, length and burn-in, from its values) over twelve seeds:
stepping stone and path sampling, their spread over the seeds, and each
run's host time. With ``--ladder-plain``, seeds 1 to 4 of that ladder
through K5' and then through the plain engine (the config's ``"engine":
"xla"``): the same generator and seeds give the same chains, so the two
estimates of a seed differ only where K5' and the plain engine disagree.

    python3 chip_profile.py [--steps 20] [--gate [--out sweep.jsonl]]
                            [--mcmc] [--wide-forward] [--wide-backward]
                            [--k8] [--k8-blocks] [--k6-bounds] [--k5-bounds]
                            [--staged] [--k4-variants] [--s4-backward]
                            [--s4-forward] [--s4-trace] [--s4-host]
                            [--fused-wide]
                            [--calibrated-settings] [--ladder-spread]
                            [--ladder-plain]

Needs one NVIDIA GPU and nvcc; exits non-zero without them. Prints one JSON
line per config and per kernel shape, then the card's name and power limit from nvidia-smi.
"""

from __future__ import annotations

import argparse
import functools
import inspect
import json
import os
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke as cs
from physher_tpu_torch.config.builder import build_config, load_json
from physher_tpu_torch.inference import vb
import numpy as np

from physher_tpu_torch.io.treeio import read_newick
from physher_tpu_torch.models.protein import WAG
from physher_tpu_torch.models.sitemodel import GammaSiteModel
from physher_tpu_torch.models.substitution import GTR
from physher_tpu_torch.models.treelikelihood import TreeLikelihood
from physher_tpu_torch.ops import cuda_build, fused, loop, staged, wide
from physher_tpu_torch.utils.synthetic import (
    balanced_topology, caterpillar_topology, random_sitepattern)


def profile_advi(name, config: Path, dev, n_steps: int):
    ctx, _ = build_config(load_json(str(config)), base_dir=str(config.parent),
                          dtype=torch.float32, device=dev)
    tlk = ctx.objects["treelikelihood"]
    handle = ctx.objects["varnormal"]
    fam = handle.family
    gen = torch.Generator(device=dev).manual_seed(1)
    vparams = {k: v.clone().requires_grad_(True) for k, v in fam.init.items()}
    opt, schedule = vb.adam(vparams, 0.05)
    for _ in range(5):
        vb.step(fam, vparams, opt, schedule, gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        vb.step(fam, vparams, opt, schedule, gen)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_steps):
            vb.step(fam, vparams, opt, schedule, gen)
        torch.cuda.synchronize()
    device_ms, launches, top = cs.kernel_rows(prof, n_steps)
    vparams = {k: v.detach() for k, v in vparams.items()}
    eps = fam.draw(vparams, gen, handle.elbo_samples)
    with torch.no_grad():
        fam.elbo(vparams, eps=eps)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fam.elbo(vparams, eps=eps)
        torch.cuda.synchronize()
    check_ms = (time.perf_counter() - t0) * 1e3
    print(json.dumps({
        "config": name, "engine": tlk.engine_name(),
        "taxa": tlk.topo.T, "patterns": tlk.sp.pattern_count,
        "dim": fam.dim, "steps": n_steps, "step_ms": step_ms,
        "device_ms_per_step": device_ms,
        "busy_share": device_ms / step_ms if device_ms else None,
        "kernel_launches_per_step": launches,
        "check_samples": handle.elbo_samples, "check_ms": check_ms,
        "top_kernels": top}), flush=True)


def kernel_times(dev):
    for name, make, P, C in cs.STAGED_SHAPES[:2]:
        topo = make()
        for dtype in (torch.float32, torch.float64):
            inputs = cs.random_inputs(topo, P, C, 7, dtype, dev)
            print(json.dumps({
                "shape": name, "dtype": str(dtype).replace("torch.", ""),
                "levels": len(topo.levels),
                "staged": cs.kernels_alone(staged, topo, *inputs),
                "fused": cs.kernels_alone(fused, topo, *inputs)}),
                flush=True)


def device_inputs(topo, P, C, dtype, dev, seed=0):
    """Random one-hot tips, row-stochastic pmats, freqs, props and a site
    cotangent, made on the card."""
    kw = dict(dtype=dtype, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    states = torch.randint(0, 4, (topo.T, P), generator=g, device=dev)
    tips = torch.nn.functional.one_hot(states, 4).to(dtype).transpose(1, 2)
    Q = torch.rand((topo.N, C, 4, 4), generator=g, **kw) + 0.1
    return (tips.contiguous(), Q / Q.sum(-1, keepdim=True),
            torch.tensor([0.3, 0.2, 0.25, 0.25], **kw),
            torch.full((C,), 1.0 / C, **kw),
            torch.rand(P, generator=g, **kw) + 0.5)


def sweep_ms(mod, topo, tips, pmats, freqs, props, cot):
    """Median device time of one forward and one backward sweep through the
    launch wrappers of ``mod`` (ops.fused or ops.staged)."""
    forward, backward = cs.WRAPPERS[mod]
    children = torch.as_tensor(topo.children, dtype=torch.int32,
                               device=tips.device)
    rootw = (props[:, None] * freqs[None, :]).reshape(-1).contiguous()
    if mod is fused:
        extra, bwd_extra = fwd_schedule(topo, tips), s4_schedule(topo, tips)
    else:
        extra = bwd_extra = (cuda_build.level_schedule(topo, tips),)

    def sweep():
        _, partials, scale = forward(tips, pmats, children, rootw, *extra)
        backward(tips, pmats, children, rootw, *bwd_extra, partials, scale,
                 cot)
    return cs.median_ms(sweep, reps=20)


def gate_trees():
    """(kind, topology) of the sweep: balanced, caterpillar and random
    binary trees (random pairs of lineages merge, ``random_dated_tree``),
    and the fluA tree."""
    trees = [("balanced", balanced_topology(n))
             for n in (16, 32, 64, 128, 256, 512)]
    trees += [("caterpillar", caterpillar_topology(n))
              for n in (16, 32, 64, 128)]
    trees += [("random", read_newick(cs.random_dated_tree(n, 13)[0])[0])
              for n in (32, 64, 128, 256, 512)]
    trees.append(("fluA", cs.load_fluA_time(torch.float64, "cpu").topo))
    return trees


def gate_sweep(dev, out: Path):
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []
    with out.open("w") as fh:
        for kind, topo in gate_trees():
            for P in (256, 1024, 4096, 8192, 16384, 32768):
                for C in (1, 4):
                    inputs = device_inputs(topo, P, C, torch.float32, dev)
                    row = {"tree": kind, "taxa": topo.T,
                           "internal": topo.I, "levels": len(topo.levels),
                           "max_children": int(topo.children.shape[1]),
                           "patterns": P, "categories": C, "sms": sms,
                           "staged_ms": sweep_ms(staged, topo, *inputs),
                           "fused_ms": sweep_ms(fused, topo, *inputs)}
                    line = json.dumps(row)
                    print(line, flush=True)
                    fh.write(line + "\n")
                    rows.append(row)
                    del inputs
            torch.cuda.empty_cache()
    print(json.dumps(gate_summary(rows)), flush=True)


def gate_summary(rows, gates=(2, 3, 4, 5, 6, 8, 12, 16)) -> dict:
    """The sweep's summed time (ms) under each gate G on C x internal nodes
    / levels (K3'/K4' at or above G, K1'/K2' below), and the shapes each
    pair won, by that work."""
    work = [r["categories"] * r["internal"] / r["levels"] for r in rows]
    summed = {str(G): sum(r["staged_ms"] if w >= G else r["fused_ms"]
                          for r, w in zip(rows, work)) for G in gates}
    won = {}
    for r, w in zip(rows, work):
        key = f"{w:.2f}"
        n = won.setdefault(key, {"staged": 0, "fused": 0})
        n["staged" if r["staged_ms"] < r["fused_ms"] else "fused"] += 1
    return {"gate_summed_ms": summed, "best_gate": min(summed,
                                                       key=summed.get),
            "wins_by_work": won}


def gate_end_to_end(dev):
    """Adam steps (host clock) and value-and-gradient (CUDA events) of
    models on either side of the gate, through each pair forced."""
    kw = dict(dtype=torch.float32, device=dev)
    topo, dist = read_newick(cs.random_dated_tree(128, 13)[0])
    large = TreeLikelihood(
        random_sitepattern(128, 16384, seed=3), topo, GTR(**kw),
        GammaSiteModel(4, **kw),
        distances_init=np.nan_to_num(dist[: topo.N - 1], nan=1.0) * 0.01,
        **kw)
    models = [("fluA JC69 time tree", cs.load_fluA_time(torch.float32, dev)),
              ("fluA GTR+G4", cs.load_gtrg4_fluA(torch.float32, dev)),
              ("random 128 x 16384 GTR+G4", large)]
    for name, tlk in models:
        params = tlk.param_space().init_params(**kw)

        def value_and_grad():
            p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
            torch.autograd.grad(tlk.log_likelihood(p), list(p.values()),
                                allow_unused=True)
        row = {"model": name, "auto": tlk.engine_name(),
               "categories": tlk.site_model.cat_count,
               "nodes_per_level": tlk.topo.I / len(tlk.topo.levels),
               "patterns": tlk.sp.pattern_count}
        for engine in ("cuda-fused", "cuda-staged", "cuda-staged",
                       "cuda-fused"):
            tlk.engine = engine
            row.setdefault(f"{engine}_adam_step_ms", []).append(
                cs.adam_step_ms(tlk, params, n_steps=30))
            row.setdefault(f"{engine}_value_and_grad_ms", []).append(
                cs.median_ms(value_and_grad))
        tlk.engine = "auto"
        print(json.dumps(row), flush=True)


def profile_mcmc(dev, n_steps: int):
    """The MH step of the checkpoint B model's tempered target against the
    number of chains L (float32): host time per step (mean over
    ``n_steps``), device time and launches per step from the profiler, the
    busy share, and the engine the batch takes."""
    from physher_tpu_torch.config.actions import Runner
    from physher_tpu_torch.inference.marginal import ladder_temperatures
    from physher_tpu_torch.inference.mcmc import MCMC

    ctx, _ = build_config(load_json(str(cs.DATA / "fluA-elbo.json")),
                          base_dir=str(cs.DATA), dtype=torch.float32,
                          device=dev)
    post = ctx.objects["posterior"]
    tlk = ctx.objects["treelikelihood"]
    like, prior = Runner(ctx)._split_like_prior(post)
    space = post.param_space()
    params = space.init_params(dtype=torch.float32, device=dev)
    sampler = MCMC(space, log_like=like, log_prior=prior)
    for L in (1, 4, 16, 64):
        temps = ladder_temperatures(L) if L > 1 else None
        gen = torch.Generator(device=dev).manual_seed(L)

        def run(n):
            return sampler.run(gen, params, n_iter=n, every=n,
                               temperatures=temps, adapt=False)
        run(20)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(n_steps)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / n_steps
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run(n_steps)
            torch.cuda.synchronize()
        device_ms, launches, top = cs.kernel_rows(prof, n_steps)
        print(json.dumps({
            "mcmc": "fluA-elbo tempered target", "chains": L,
            "engine": tlk.engine_name(L if L > 1 else None),
            "steps": n_steps, "step_ms": step_ms,
            "step_ms_per_chain": step_ms / L,
            "device_ms_per_step": device_ms,
            "busy_share": device_ms / step_ms if device_ms else None,
            "kernel_launches_per_step": launches, "top_kernels": top}),
            flush=True)


def wide_backward(dev):
    """K5'/K6' at S != 4 alone against plain at the sixth slice's shapes
    (float32), then HMC on WAG+G4."""
    by_kernel = getattr(cs, "ptxas_by_kernel", None)  # not in older trees
    print(json.dumps({"ptxas_loop": by_kernel(loop.build_log,
                                              "loop_wide_backward")
                      if by_kernel else cs.ptxas_lines(loop.build_log)}),
          flush=True)
    for name, make, L, seed in (
            ("gy94-32x4096-L8", cs.gy94_m0_fit_model, 8, 5),
            ("wag-g4-64x8192-L4", cs.wag_g4_large, 4, 6)):
        tlk = make(torch.float32, dev)
        tips, pm, fr, pr, w = cs.engine_inputs(tlk, cs.chain_params(tlk, L,
                                                                    seed))
        cs.loop_alone(name, tlk.topo, tips, pm, fr, pr,
                      w.expand(L, -1).contiguous(), timed=True,
                      tol=cs.TOL[torch.float32], phase="wide_backward")
        del tlk, tips, pm, fr, pr, w
        torch.cuda.empty_cache()
    cs.hmc_wag(dev)


def wide_forward(dev):
    """K5' at S != 4 and K7' alone against plain at both main shapes
    (float32), WAG+G4's value-and-gradient, the device time of K7''s
    launches, then HMC on WAG+G4."""
    print(json.dumps({
        "ptxas_k5": cs.ptxas_by_kernel(loop.build_log, "loop_wide_forward"),
        "ptxas_k7": cs.ptxas_by_kernel(wide.build_log, "forward_level")}),
        flush=True)
    occupancy = getattr(cs, "cluster_occupancy", None)  # not in older trees
    if occupancy:
        print(json.dumps({"max_active_clusters": occupancy()}), flush=True)
    kw = dict(dtype=torch.float32, device=dev)
    for name, make, L, seed in (
            ("gy94-32x4096", cs.gy94_m0_fit_model, 8, 5),
            ("wag-g4-64x8192", cs.wag_g4_large, 4, 6)):
        tlk = make(torch.float32, dev)
        tips, pm, fr, pr, w = cs.engine_inputs(tlk, cs.chain_params(tlk, L,
                                                                    seed))
        cs.loop_alone(f"{name}-L{L}", tlk.topo, tips, pm, fr, pr,
                      w.expand(L, -1).contiguous(), timed=True,
                      tol=cs.TOL[torch.float32], phase="wide_forward_k5")
        del tips, pm, fr, pr, w
        inputs = cs.engine_inputs(tlk, tlk.param_space().init_params(**kw))
        tips, pm, fr, pr, _ = inputs
        children = cs.topo_constant(tlk.topo, "children",
                                    lambda: tlk.topo.children, tips,
                                    torch.int32)
        rootw = (pr[:, None] * fr[None, :]).reshape(-1).contiguous()
        schedule = cuda_build.level_schedule(tlk.topo, tips)
        rec = {"phase": "wide_forward_k7", "shape": name,
               "patterns": tlk.sp.pattern_count,
               "kernel_alone": cs.kernels_alone(wide, tlk.topo, *inputs),
               "value_and_grad_kernel_ms": cs.median_ms(
                   lambda: cs.value_and_grad(wide.wide_site_log, tlk.topo,
                                             *inputs), reps=100),
               # the levels, leaves first, then the root
               "level_nodes": [len(lv) for lv in tlk.topo.levels],
               "launch_us": launch_device_us(
                   lambda: wide.wide_forward(tips, pm, children, rootw,
                                             schedule),
                   ("forward_level", "forward_root"))}
        print(json.dumps(rec), flush=True)
        del tlk, inputs, tips, pm
        torch.cuda.empty_cache()
    cs.hmc_wag(dev)


def launch_device_us(run, names, n_runs=20):
    """Device time (us, mean over ``n_runs`` calls of ``run()``) of each
    kernel launch whose name contains one of ``names``, in launch order, from
    torch.profiler; None where the profiler saw no such kernel."""
    from torch.autograd import DeviceType

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_runs):
            run()
        torch.cuda.synchronize()
    evs = sorted((e for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and any(n in e.name for n in names)),
                 key=lambda e: e.time_range.start)
    if not evs or len(evs) % n_runs:
        return None
    per_run = len(evs) // n_runs
    return [sum(evs[r * per_run + i].time_range.elapsed_us()
                for r in range(n_runs)) / n_runs for i in range(per_run)]


def graph_launch_us(run, n=20):
    """Device time (us) of one call of ``run()``: ``n`` calls captured in a
    CUDA graph, the graph replayed (CUDA events, least of five replays) and
    the time divided by ``n``, so that the wrapper's host time drops out
    and each launch's gap in the graph (about a microsecond) stays in."""
    run()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            run()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    del graph
    return min(times) * 1e3 / n


def k8(dev):
    """K7'/K8' alone against plain, value-and-gradient and the Adam step at
    GY94 M0 and WAG+G4 (float32), and the device time of K8''s launches."""
    print(json.dumps({"ptxas_k8": cs.ptxas_by_kernel(wide.build_log,
                                                     "backward_level")}),
          flush=True)
    kw = dict(dtype=torch.float32, device=dev)
    for name, make in (("gy94-32x4096", cs.gy94_m0_fit_model),
                       ("wag-g4-64x8192", cs.wag_g4_large)):
        tlk = make(torch.float32, dev)
        params = tlk.param_space().init_params(**kw)
        inputs = cs.engine_inputs(tlk, params)
        rec = {"k8": name, "patterns": tlk.sp.pattern_count,
               "kernel_alone": cs.kernels_alone(wide, tlk.topo, *inputs),
               "value_and_grad_kernel_ms": cs.median_ms(
                   lambda: cs.value_and_grad(wide.wide_site_log, tlk.topo,
                                             *inputs), reps=100),
               "adam_step_ms": cs.adam_step_ms(tlk, params, n_steps=50)}
        bwd = k8_call(tlk, inputs)
        # the root seed, then the levels root first
        rec["level_nodes"] = [len(lv) for lv in tlk.topo.levels][::-1]
        rec["launch_us"] = launch_device_us(bwd, ("backward_root",
                                                  "backward_level"))
        print(json.dumps(rec), flush=True)
        del tlk, inputs, bwd
        torch.cuda.empty_cache()


def k8_call(tlk, inputs):
    """K8' on one model's inputs, after K7', as a call without arguments."""
    tips, pm, fr, pr, w = inputs
    children = cs.topo_constant(tlk.topo, "children",
                                lambda: tlk.topo.children, tips, torch.int32)
    rootw = (pr[:, None] * fr[None, :]).reshape(-1).contiguous()
    schedule = cuda_build.level_schedule(tlk.topo, tips)
    _, part, sc = wide.wide_forward(tips, pm, children, rootw, schedule)
    return lambda: wide.wide_backward(tips, pm, children, rootw, schedule,
                                      part, sc, w)


def host_us(run, n=50):
    """Host time (us, median of ``n``) of one call of ``run()`` started on
    an idle card: the wrapper's Python and its launches."""
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        times.append((time.perf_counter() - t0) * 1e6)
        torch.cuda.synchronize()
    return sorted(times)[n // 2]


def staged_design_floor_ms(T, I, C, P, itemsize, read_back=None):
    """(K3', K4') floors of the staged design, ms at 3.35 TB/s: the bytes it
    must move through device memory. K3': tips read, every node's partials
    and scalers written, and the partials of the ``read_back`` internal
    nodes read again by a later launch (all I - 1 children in the
    level-by-level design; those below the switch where the walk hands the
    rest on in shared memory). K4': tips, partials, scalers and the site
    cotangent read, every node's cotangent written and read."""
    read_back = I - 1 if read_back is None else read_back
    fwd = 4 * T * P + 4 * C * P * read_back + 4 * C * P * I + I * P
    bwd = 4 * T * P + 3 * 4 * C * P * I + I * P + P
    return tuple(n * itemsize / cs.PEAK_BYTES_PER_S * 1e3 for n in (fwd, bwd))


def staged_shapes(dev, dtype, path):
    """(name, topology, inputs) of ``--staged``: the 128-taxon GTR+G4
    config model (written to ``path`` by ``chip_smoke.large_config``), the
    balanced 128 x 16384 tree and the GTR+G4 fluA golden's model."""
    ctx, _ = build_config(load_json(str(path)), base_dir=str(path.parent),
                          dtype=dtype, device=dev)
    tlk = ctx.objects["treelikelihood"]
    gtr = cs.load_gtrg4_fluA(dtype, dev)
    topo128 = balanced_topology(128)
    kw = dict(dtype=dtype, device=dev)
    return [("config-128", tlk.topo, cs.engine_inputs(
                 tlk, tlk.param_space().init_params(**kw))),
            ("balanced-128x16384", topo128, cs.random_inputs(
                topo128, 16384, 4, 7, dtype, dev)),
            ("fluA-gtrg4", gtr.topo, cs.engine_inputs(
                gtr, gtr.param_space().init_params(**kw)))]


def staged_kernels(dev):
    """K3'/K4' alone against plain (CUDA events, median of 100), the bound
    and the design's floors, each K3' sweep's device time in a CUDA graph
    of 20 calls, its launches' device times (torch.profiler) and count,
    the wrappers' host time and the staged value-and-gradient, at the
    128-taxon GTR+G4 config model, balanced 128 x 16384 and GTR+G4 fluA,
    float32 and float64; where the tree has K3''s walks, also the sweep
    through each at other switch levels."""
    print(json.dumps({
        "card": cs.nvidia_smi(),
        "ptxas_k3": cs.ptxas_by_kernel(staged.build_log, "forward"),
        "ptxas_k4": cs.ptxas_by_kernel(staged.build_log, "backward")}),
        flush=True)
    walk = getattr(staged, "walk_level", None)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    with tempfile.TemporaryDirectory() as tmp:
        path, _ = cs.large_config(Path(tmp), 128, 20480, dev)
        for dtype in (torch.float32, torch.float64):
            for name, topo, inputs in staged_shapes(dev, dtype, path):
                tips, pm, fr, pr, w = inputs
                children = cs.topo_constant(topo, "children",
                                            lambda: topo.children, tips,
                                            torch.int32)
                rootw = (pr[:, None] * fr[None, :]).reshape(-1).contiguous()
                schedule = cuda_build.level_schedule(topo, tips)
                offsets = schedule[1]
                P, C = tips.shape[2], pm.shape[1]

                def fwd(*switch):
                    return staged.staged_forward(tips, pm, children, rootw,
                                                 schedule, *switch)
                _, part, ls = fwd()

                def bwd():
                    return staged.staged_backward(tips, pm, children, rootw,
                                                  schedule, part, ls, w)
                top, kind = (walk(offsets, C, P, sms) if walk
                             else (len(offsets) - 1, None))
                level_floor = staged_design_floor_ms(
                    topo.T, topo.I, C, P, tips.element_size())
                rec = {"phase": "staged", "shape": name,
                       "dtype": str(dtype).replace("torch.", ""),
                       "patterns": P, "categories": C,
                       "level_nodes": [len(lv) for lv in topo.levels],
                       "switch_level": top, "walk": kind,
                       "kernel_alone": cs.kernels_alone(staged, topo,
                                                        *inputs),
                       "level_design_floor_ms": level_floor,
                       "forward_design_floor_ms": staged_design_floor_ms(
                           topo.T, topo.I, C, P, tips.element_size(),
                           min(offsets[top], topo.I - 1))[0],
                       "backward_design_floor_ms": level_floor[1],
                       "forward_graph_us": graph_launch_us(fwd),
                       "backward_graph_us": graph_launch_us(bwd),
                       "forward_host_us": host_us(fwd),
                       "backward_host_us": host_us(bwd),
                       "value_and_grad_ms": cs.median_ms(
                           lambda: cs.value_and_grad(
                               staged.staged_site_log, topo, *inputs),
                           reps=100)}
                k0 = getattr(staged, "STAGED_FORWARD_KERNELS", None)
                if k0 is not None:
                    fwd()
                    rec["forward_kernels_a_sweep"] = (
                        staged.STAGED_FORWARD_KERNELS - k0)
                if walk:
                    # each walk with the switch a level or two either side
                    # of walk_level's, and none
                    near = sorted({*range(max(0, top - 2),
                                          min(len(offsets) - 1, top + 3)),
                                   len(offsets) - 1})
                    rec["switch_graph_us"] = {
                        f"{w}-{t}": graph_launch_us(
                            functools.partial(fwd, t, w))
                        for w in staged.WALKS for t in near}
                # the levels below the switch leaves first, then the walk;
                # K4''s root seed, the levels root first, the last sum
                rec["forward_launch_us"] = launch_device_us(
                    fwd, ("forward_level", "s4_forward_kernel",
                          "forward_chain"))
                rec["backward_launch_us"] = launch_device_us(
                    bwd, ("backward_root", "backward_level",
                          "backward_sum"))
                print(json.dumps(rec), flush=True)
                del inputs, tips, pm, part, ls
            torch.cuda.empty_cache()


def switch_candidates(widths) -> list:
    """K3''s switch levels worth timing on a tree of these level widths:
    each level up to the first of one node, and past the last."""
    first_one = next(i for i, n in enumerate(widths) if n == 1)
    return sorted({*range(first_one + 1), len(widths)})


def switch_sweep(dev, out: Path):
    """K3' alone (float32, device time in a CUDA graph of 20 calls) through
    each walk at each switch level of ``switch_candidates`` (the last: no
    walk) over the gate's trees, pattern counts and C = 1 and 4: the
    measurement behind ``ops/staged.py`` walk_level. A line a shape, also
    written to ``out``."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    with out.open("w") as fh:
        for kind, topo in gate_trees():
            widths = [len(lv) for lv in topo.levels]
            for P in (256, 1024, 4096, 8192, 16384, 32768):
                for C in (1, 4):
                    tips, pm, fr, pr, _ = device_inputs(topo, P, C,
                                                        torch.float32, dev)
                    children = torch.as_tensor(topo.children,
                                               dtype=torch.int32, device=dev)
                    rootw = (pr[:, None] * fr[None, :]).reshape(-1)
                    schedule = cuda_build.level_schedule(topo, tips)
                    row = {"tree": kind, "taxa": topo.T, "widths": widths,
                           "patterns": P, "categories": C, "sms": sms,
                           "walk_level": staged.walk_level(schedule[1], C,
                                                           P, sms),
                           "forward_us": {
                               f"{w}-{t}": graph_launch_us(functools.partial(
                                   staged.staged_forward, tips, pm,
                                   children, rootw, schedule, t, w))
                               for w in staged.WALKS
                               for t in switch_candidates(widths)}}
                    line = json.dumps(row)
                    print(line, flush=True)
                    fh.write(line + "\n")
                    del tips, pm
            torch.cuda.empty_cache()


# One dependent round trip through L2 (a single thread chasing pointers
# through 8 MB, past L1 and inside L2, by ld.global.cg) and one barrier of
# a 256-thread block, each timed by CUDA events over many steps
PROBE_SOURCE = r"""
#include <cuda_runtime.h>
__global__ void chase(const unsigned* __restrict__ next, int steps,
                      unsigned* out) {
  unsigned i = 0;
  for (int s = 0; s < steps; ++s) i = __ldcg(next + i);
  *out = i;
}
__global__ void barriers(int steps, int* out) {
  int v = threadIdx.x;
  for (int s = 0; s < steps; ++s) {
    __syncthreads();
    v += s;
  }
  if (v == -1) *out = v;
}
extern "C" int probe_chase(const void* next, int steps, void* out,
                           void* stream) {
  chase<<<1, 1, 0, (cudaStream_t)stream>>>((const unsigned*)next, steps,
                                           (unsigned*)out);
  return cudaGetLastError();
}
extern "C" int probe_barriers(int steps, void* out, void* stream) {
  barriers<<<1, 256, 0, (cudaStream_t)stream>>>(steps, (int*)out);
  return cudaGetLastError();
}
// A value handed on `steps` times across barriers, as the walk hands a
// cotangent from a level to the next: at step i one lane of warp i % 8
// (warp 0 with `same`) reads slot i - 1 and writes slot i, in device memory
// (mode 0: plain loads, 1: loads past L1) or in shared memory (mode 2)
__global__ void handoff(float* buf, int steps, int same, int mode) {
  __shared__ float sbuf[4096];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) sbuf[0] = 0.0f;
  __syncthreads();
  for (int i = 1; i <= steps; ++i) {
    if (w == (same ? 0 : i % 8) && lane == 0) {
      if (mode == 2)
        sbuf[i & 4095] = sbuf[(i - 1) & 4095] + 1.0f;
      else
        buf[i] = (mode == 1 ? __ldcg(buf + i - 1) : buf[i - 1]) + 1.0f;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0 && mode == 2) buf[0] = sbuf[steps & 4095];
}
extern "C" int probe_handoff(void* buf, int steps, int same, int mode,
                             void* stream) {
  handoff<<<1, 256, 0, (cudaStream_t)stream>>>((float*)buf, steps, same,
                                               mode);
  return cudaGetLastError();
}
"""


def level_step_us(dev) -> dict:
    """The time of one dependent L2 round trip and of one 256-thread block
    barrier on this card (us), each the difference of two runs (2n and n
    steps) over n, so that the launch cancels; and of one hand-off of a
    value across a barrier through device or shared memory, to another
    warp or the same one."""
    import ctypes

    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "level_probe.cu"
        path.write_text(PROBE_SOURCE)
        lib, _ = cuda_build.build_library(path)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.probe_chase.argtypes = [ptr, i32, ptr, ptr]
    lib.probe_barriers.argtypes = [i32, ptr, ptr]
    lib.probe_handoff.argtypes = [ptr, i32, i32, i32, ptr]
    # a random cycle through 65 536 slots 128 bytes apart (8 MB)
    slots, stride = 65536, 32
    perm = np.random.default_rng(0).permutation(slots)
    nxt = np.zeros(slots * stride, dtype=np.uint32)
    nxt[perm * stride] = np.roll(perm, -1) * stride
    nxt_d = torch.as_tensor(nxt.view(np.int32), device=dev)
    out = torch.zeros(1, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def per_step(launch, n):
        times = {}
        for steps in (n, 2 * n, n, 2 * n):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            err = launch(steps)
            end.record()
            end.synchronize()
            if err:
                raise RuntimeError(f"probe launch failed: cudaError {err}")
            times.setdefault(steps, []).append(start.elapsed_time(end))
        return (min(times[2 * n]) - min(times[n])) * 1e3 / n
    l2 = per_step(lambda k: lib.probe_chase(nxt_d.data_ptr(), k,
                                            out.data_ptr(), stream), 100000)
    bar = per_step(lambda k: lib.probe_barriers(k, out.data_ptr(), stream),
                   1000000)
    buf = torch.zeros(2 * 20000 + 1, dtype=torch.float32, device=dev)
    handoff = {
        f"{where}_{who}_us": per_step(
            lambda k: lib.probe_handoff(buf.data_ptr(), k, same, mode,
                                        stream), 20000)
        for where, mode in (("global", 0), ("global_cg", 1), ("shared", 2))
        for who, same in (("other_warp", 0), ("same_warp", 1))}
    return {"l2_round_trip_us": l2, "barrier_us": bar, "step_us": l2 + bar,
            "handoff": handoff}


def s4_design_floor_ms(levels, T, I, C, P, L, itemsize, step_us):
    """The floor of the two-launch S = 4 reverse sweep (ms): the walk's
    preorder levels, one dependent L2 round trip and barrier each
    (``step_us``), plus the dP pass at 3.35 TB/s reading each chain's
    cotangents, partials and scalers, the tips and 1 / site once and
    writing the dP rows and d rootw."""
    N = T + I
    nbytes = (L * (8 * C * I * P + I * P + P + N * C * 16 + 4 * C)
              + 4 * T * P) * itemsize
    return levels * step_us * 1e-3 + nbytes / cs.PEAK_BYTES_PER_S * 1e3


def wide_design_k6(tips, pmats, children, freqs, props, partials, scale, g):
    """K6' at S = 4 through the S != 4 design (``loop_wide_backward``,
    csrc/wide_backward.cuh) as a call without arguments: the wrapper's S !=
    4 path at S = 4."""
    L, N, C = pmats.shape[:3]
    T, _, P = tips.shape
    I, maxc = children.shape
    nb = -(-P // loop.WIDE_BACKWARD_BLOCK)
    fn = loop._entry(loop.build(), "loop_wide_backward", tips)

    def run():
        gbuf = tips.new_empty((L, I, C, 4, P))
        dP_part = tips.new_empty((L, nb, N, C, 16))
        dP_part[:, :, N - 1].zero_()
        drootw_part = tips.new_empty((L, nb, C, 4))
        err = fn(tips.data_ptr(), pmats.data_ptr(), children.data_ptr(),
                 freqs.data_ptr(), props.data_ptr(), partials.data_ptr(),
                 scale.data_ptr(), g.data_ptr(), gbuf.data_ptr(),
                 dP_part.data_ptr(), drootw_part.data_ptr(), T, I, C, 4,
                 maxc, P, L, loop.stream(tips))
        if err:
            raise RuntimeError(f"loop_wide_backward at S = 4: cudaError "
                               f"{err}")
        drootw = drootw_part.sum(1)
        return (dP_part.sum(1).view(L, N, C, 4, 4),
                (props[:, :, None] * drootw).sum(1),
                (freqs[:, None, :] * drootw).sum(2))
    return run


# the S = 4 reverse sweeps' kernels by name: the parent's one kernel each
# (loop_backward_kernel, backward_kernel), the shared step's two launches
S4_NAMES = ("backward_kernel", "s4_walk", "s4_dp")


def s4_schedule(topo, tips) -> tuple:
    """The preorder schedule that this checkout's K2'/K6' wrappers take
    (after rootw / props), as a tuple to splice into their arguments; empty
    where the checkout's wrappers take none."""
    if "schedule" in inspect.signature(fused.pruning_backward).parameters:
        return (cuda_build.preorder_schedule(topo, tips),)
    return ()


def fwd_schedule(topo, tips) -> tuple:
    """The postorder schedule that this checkout's K1'/K5' wrappers take
    (after rootw / props), as a tuple to splice into their arguments; empty
    where the checkout's wrappers take none."""
    if "schedule" in inspect.signature(fused.pruning_forward).parameters:
        return (cuda_build.postorder_schedule(topo, tips),)
    return ()


def s4_backward(dev):
    """K6' at S = 4 and K2' alone against plain, their launches' device
    time, their wrappers' host time and the design floor, float32 and
    float64; the S != 4 design at S = 4 beside K6' (where the tree has the
    shared step); the HMC leapfrog step on the checkpoint B model and the
    fluA ADVI step."""
    step = level_step_us(dev)
    new = hasattr(cuda_build, "preorder_schedule")
    print(json.dumps({"phase": "s4_level_step", "tree": "change" if new
                      else "parent", **step}), flush=True)
    print(json.dumps({"phase": "s4_ptxas", "k6": cs.ptxas_by_kernel(
        loop.build_log, "s4_" if new else "loop_backward_kernel"),
        "k2": cs.ptxas_by_kernel(fused.build_log, "s4_" if new
                                 else "backward_kernel")}), flush=True)
    for dtype in (torch.float32, torch.float64):
        dt = str(dtype).replace("torch.", "")
        jc, gtr = cs.load_fluA_time(dtype, dev), cs.load_gtrg4_fluA(dtype, dev)
        for name, tlk, L, seed in (("fluA-jc69-L4", jc, 4, 2),
                                   ("fluA-jc69-L16", jc, 16, 1),
                                   ("fluA-gtrg4-L8", gtr, 8, 3)):
            topo = tlk.topo
            tips, pm, fr, pr, w = cs.engine_inputs(tlk, cs.chain_params(
                tlk, L, seed))
            g = w.expand(L, -1).contiguous()
            rec = cs.loop_alone(name, topo, tips, pm, fr, pr, g, timed=True,
                                phase="s4_k6")
            children = cs.topo_constant(topo, "children",
                                        lambda: topo.children, tips,
                                        torch.int32)
            _, part, sc = loop.loop_forward(tips, pm, children, fr, pr,
                                            *fwd_schedule(topo, tips))
            sched = s4_schedule(topo, tips)

            def bwd():
                return loop.loop_backward(tips, pm, children, fr, pr, *sched,
                                          part, sc, g)
            out = {"phase": "s4_k6_launches", "shape": name, "dtype": dt,
                   "levels": len(topo.preorder_levels),
                   "backward_ms": rec["backward_ms"],
                   "backward_bound_ms": rec["backward_bound_ms"],
                   "design_floor_ms": s4_design_floor_ms(
                       len(topo.preorder_levels), topo.T, topo.I,
                       pm.shape[2], tips.shape[2], L, tips.element_size(),
                       step["step_us"]),
                   "launch_us": launch_device_us(bwd, S4_NAMES),
                   "host_us": host_us(bwd)}
            if new:
                wide_run = wide_design_k6(tips, pm, children, fr, pr, part,
                                          sc, g)
                out["wide_design_ms"] = cs.median_ms(wide_run, reps=100)
                out["wide_design_err"] = max(
                    cs.max_err(a, b)[0] for a, b in zip(wide_run(), bwd()))
                out["wide_design_launch_us"] = launch_device_us(
                    wide_run, ("loop_wide_backward",))
            print(json.dumps(out), flush=True)
        cat = caterpillar_topology(128)
        kw = dict(dtype=dtype, device=dev)
        cases = [("fluA-jc69", jc.topo, cs.engine_inputs(
                     jc, jc.param_space().init_params(**kw))),
                 ("fluA-gtrg4", gtr.topo, cs.engine_inputs(
                     gtr, gtr.param_space().init_params(**kw)))]
        cases += [(f"caterpillar-128x16384-C{C}", cat,
                   cs.random_inputs(cat, 16384, C, 7, dtype, dev))
                  for C in (1, 2)]
        for name, topo, inputs in cases:
            tips, pm, fr, pr, w = inputs
            children = cs.topo_constant(topo, "children",
                                        lambda: topo.children, tips,
                                        torch.int32)
            rootw = (pr[:, None] * fr[None, :]).reshape(-1).contiguous()
            _, part, sc = fused.pruning_forward(tips, pm, children, rootw,
                                                *fwd_schedule(topo, tips))
            sched = s4_schedule(topo, tips)

            def bwd():
                return fused.pruning_backward(tips, pm, children, rootw,
                                              *sched, part, sc, w)
            alone = cs.kernels_alone(fused, topo, *inputs)
            print(json.dumps({
                "phase": "s4_k2", "shape": name, "dtype": dt,
                "patterns": tips.shape[2], "categories": pm.shape[1],
                "levels": len(topo.preorder_levels), "kernel_alone": alone,
                "design_floor_ms": s4_design_floor_ms(
                    len(topo.preorder_levels), topo.T, topo.I, pm.shape[1],
                    tips.shape[2], 1, tips.element_size(), step["step_us"]),
                "launch_us": launch_device_us(bwd, S4_NAMES),
                "host_us": host_us(bwd)}), flush=True)
        del jc, gtr, cases
        torch.cuda.empty_cache()
    # the cost of one level: K2''s launches on caterpillars (one node a
    # preorder level) at 256 patterns, float32; the slope of their device
    # time against the levels
    rows = []
    for n in (16, 32, 64, 128):
        topo = caterpillar_topology(n)
        tips, pm, fr, pr, w = cs.random_inputs(topo, 256, 1, 7,
                                               torch.float32, dev)
        children = cs.topo_constant(topo, "children", lambda: topo.children,
                                    tips, torch.int32)
        rootw = (pr[:, None] * fr[None, :]).reshape(-1).contiguous()
        _, part, sc = fused.pruning_forward(tips, pm, children, rootw,
                                            *fwd_schedule(topo, tips))
        sched = s4_schedule(topo, tips)
        rows.append((len(topo.preorder_levels), launch_device_us(
            lambda: fused.pruning_backward(tips, pm, children, rootw, *sched,
                                           part, sc, w), S4_NAMES)))
    fit = {}
    if all(r[1] for r in rows):
        # the walk's launch, or the parent's one kernel
        slope, intercept = np.polyfit([r[0] for r in rows],
                                      [r[1][0] for r in rows], 1)
        fit = {"us_per_level": slope, "us_at_0_levels": intercept}
    print(json.dumps({"phase": "s4_level_cost",
                      "levels": [r[0] for r in rows],
                      "launch_us": [r[1] for r in rows], **fit}), flush=True)
    cs.hmc_checkpoint_b(dev)
    profile_advi("fluA-elbo", cs.DATA / "fluA-elbo.json", dev, 50)


def s4_forward_floor_ms(levels, T, I, C, P, L, itemsize, step_us):
    """The floor of the S = 4 forward walk by postorder level (ms): its
    levels, one dependent L2 round trip and barrier each (``step_us``), plus
    at 3.35 TB/s the tips and each chain's P matrices read, its partials,
    scalers and site logs written and each internal child's partials read
    back once."""
    N = T + I
    nbytes = (4 * T * P + L * (N * C * 16 + 4 * C * P * I + I * P + P
                               + 4 * C * P * (I - 1))) * itemsize
    return levels * step_us * 1e-3 + nbytes / cs.PEAK_BYTES_PER_S * 1e3


# the S = 4 forward sweeps' kernels by name: the parent's forward_kernel and
# loop_forward_kernel, the shared step's s4_forward_kernel
S4F_NAMES = ("forward_kernel", "s4_forward")


def s4_forward(dev):
    """K1' and K5' at S = 4 alone against plain (CUDA events, median of
    100), their launch's device time (torch.profiler), their wrappers' host
    time, the bound and the design floor, float32 and float64: K1' at the
    checkpoint B model, GTR+G4 fluA and the 128-taxon caterpillar at 16 384
    patterns (C = 1 and 2), K5' at the checkpoint B model's chains (L = 16
    and 4), GTR+G4 fluA (L = 8) and the fluA polytomy tree (L = 4); then
    the cost of one level on caterpillars."""
    step = level_step_us(dev)
    new = hasattr(cuda_build, "postorder_schedule")
    tree = "change" if new else "parent"
    print(json.dumps({"phase": "s4f_level_step", "tree": tree, **step}),
          flush=True)
    print(json.dumps({"phase": "s4f_ptxas", "tree": tree,
                      "k1": cs.ptxas_by_kernel(fused.build_log, "s4_forward"
                                               if new else "forward_kernel"),
                      "k5": cs.ptxas_by_kernel(loop.build_log, "s4_forward"
                                               if new
                                               else "loop_forward_kernel")}),
          flush=True)

    def floor(topo, pm, tips, L):
        return s4_forward_floor_ms(len(topo.levels), topo.T, topo.I,
                                   pm.shape[-3], tips.shape[2], L,
                                   tips.element_size(), step["step_us"])
    for dtype in (torch.float32, torch.float64):
        dt = str(dtype).replace("torch.", "")
        kw = dict(dtype=dtype, device=dev)
        jc, gtr = cs.load_fluA_time(dtype, dev), cs.load_gtrg4_fluA(dtype, dev)
        poly = cs.collapsed_topology(jc.topo)
        chains = [(name, tlk.topo, cs.engine_inputs(tlk, cs.chain_params(
                      tlk, L, seed)))
                  for name, tlk, L, seed in (("fluA-jc69-L16", jc, 16, 1),
                                             ("fluA-jc69-L4", jc, 4, 2),
                                             ("fluA-gtrg4-L8", gtr, 8, 3))]
        chains.append(("fluA-polytomy-L4", poly,
                       cs.random_chains(poly, 238, 4, 4, 15, dtype, dev)))
        for name, topo, (tips, pm, fr, pr, w) in chains:
            L = pm.shape[0]
            g = w.expand(L, -1).contiguous()
            rec = cs.loop_alone(name, topo, tips, pm, fr, pr, g, timed=True,
                                phase="s4f_k5_alone")
            children = cs.topo_constant(topo, "children",
                                        lambda: topo.children, tips,
                                        torch.int32)
            sched = fwd_schedule(topo, tips)

            def fwd():
                return loop.loop_forward(tips, pm, children, fr, pr, *sched)
            print(json.dumps({
                "phase": "s4f_k5", "tree": tree, "shape": name, "dtype": dt,
                "chains": L, "categories": pm.shape[2],
                "levels": len(topo.levels), "internal": topo.I,
                "forward_ms": rec["forward_ms"],
                "forward_plain_ms": rec["forward_plain_ms"],
                "forward_bound_ms": rec["forward_bound_ms"],
                "design_floor_ms": floor(topo, pm, tips, L),
                "launch_us": launch_device_us(fwd, S4F_NAMES),
                "graph_us": graph_launch_us(fwd),
                "host_us": host_us(fwd)}), flush=True)
        cat = caterpillar_topology(128)
        singles = [("fluA-jc69", jc.topo, cs.engine_inputs(
                       jc, jc.param_space().init_params(**kw))),
                   ("fluA-gtrg4", gtr.topo, cs.engine_inputs(
                       gtr, gtr.param_space().init_params(**kw)))]
        singles += [(f"caterpillar-128x16384-C{C}", cat,
                     cs.random_inputs(cat, 16384, C, 7, dtype, dev))
                    for C in (1, 2)]
        for name, topo, inputs in singles:
            tips, pm, fr, pr, w = inputs
            children = cs.topo_constant(topo, "children",
                                        lambda: topo.children, tips,
                                        torch.int32)
            rootw = (pr[:, None] * fr[None, :]).reshape(-1).contiguous()
            sched = fwd_schedule(topo, tips)

            def fwd():
                return fused.pruning_forward(tips, pm, children, rootw,
                                             *sched)
            alone = cs.kernels_alone(fused, topo, *inputs)
            print(json.dumps({
                "phase": "s4f_k1", "tree": tree, "shape": name, "dtype": dt,
                "patterns": tips.shape[2], "categories": pm.shape[1],
                "levels": len(topo.levels), "internal": topo.I,
                "forward_ms": alone["forward_ms"],
                "forward_plain_ms": alone["forward_plain_ms"],
                "forward_bound_ms": alone["forward_bound_ms"],
                "forward_err": alone["forward_err"],
                "design_floor_ms": floor(topo, pm, tips, 1),
                "launch_us": launch_device_us(fwd, S4F_NAMES),
                "graph_us": graph_launch_us(fwd),
                "host_us": host_us(fwd)}), flush=True)
        del jc, gtr, chains, singles
        torch.cuda.empty_cache()
    # the cost of one level: K1''s launch on caterpillars (one node a
    # postorder level) at 256 patterns, float32; the slope of its device
    # time (in a CUDA graph) against the levels
    rows = []
    for n in (16, 32, 64, 128):
        topo = caterpillar_topology(n)
        tips, pm, fr, pr, w = cs.random_inputs(topo, 256, 1, 7,
                                               torch.float32, dev)
        children = cs.topo_constant(topo, "children", lambda: topo.children,
                                    tips, torch.int32)
        rootw = (pr[:, None] * fr[None, :]).reshape(-1).contiguous()
        sched = fwd_schedule(topo, tips)
        rows.append((len(topo.levels), graph_launch_us(
            lambda: fused.pruning_forward(tips, pm, children, rootw,
                                          *sched))))
    slope, intercept = np.polyfit([r[0] for r in rows], [r[1] for r in rows],
                                  1)
    print(json.dumps({"phase": "s4f_level_cost", "tree": tree,
                      "levels": [r[0] for r in rows],
                      "graph_us": [r[1] for r in rows],
                      "us_per_level": slope, "us_at_0_levels": intercept}),
          flush=True)


def wag_caterpillar(dtype, dev):
    """WAG (packed) on a 128-taxon caterpillar at 8192 patterns (as
    ``chip_smoke.wag_caterpillar``, which older checkouts lack)."""
    sp = random_sitepattern(128, 8192, seed=19, datatype="aminoacid")
    kw = dict(dtype=dtype, device=dev)
    return TreeLikelihood(sp, caterpillar_topology(128), WAG(**kw), **kw)


def schedule_variants(k1, k2, topo, tips, C, S) -> dict:
    """The candidates of K1'/K2''s schedule on one shape (device time in a
    CUDA graph): each kernel walked (the walk kernels) and on the tree's
    schedule (the tree kernels); the rule's choice; and whether each
    kernel's outputs agree bit for bit across the schedules."""
    P = tips.shape[2]
    rec, outs = {}, {}
    res_f = fused.resident_blocks(tips.device, S, tips.dtype, False)
    res_b = fused.resident_blocks(tips.device, S, tips.dtype, True)
    chain = fused.is_chain(topo.children, topo.T)
    rec["resident_blocks"] = [res_f, res_b]
    rec["rule_walks"] = [
        fused.walks(-(-P // (128 if S <= 32 else 32)), C, res_f, chain),
        fused.walks(-(-P // 128), C, res_b, chain)]
    try:
        for sched in ("walk", "tree"):
            fused.SCHEDULE = sched
            outs[sched] = (k1(), k2())
            rec[f"forward_{sched}_graph_us"] = graph_launch_us(k1)
            rec[f"backward_{sched}_graph_us"] = graph_launch_us(k2)
    finally:
        fused.SCHEDULE = None
    torch.cuda.synchronize()
    for i, kind in enumerate(("forward", "backward")):
        rec[f"{kind}_walk_equals_tree"] = all(
            torch.equal(a, b)
            for a, b in zip(outs["walk"][i], outs["tree"][i]))
    return rec


def fused_wide(dev):
    """K1'/K2' at S != 4 alone beside K7'/K8' (CUDA graph of 20 and CUDA
    events) at the three phase-46 shapes and the caterpillar, float32 and
    float64, with the bounds, the C code's launches a sweep, each kernel
    walked and on the tree's schedule, and nvcc's register lines."""
    tree = "change" if hasattr(fused, "backward_plan") else "parent"
    print(json.dumps({"phase": "fw_ptxas", "tree": tree,
                      "k1": cs.ptxas_by_kernel(fused.build_log,
                                               "fused_wide_forward"),
                      "k2": cs.ptxas_by_kernel(fused.build_log,
                                               "fused_wide_backward")}),
          flush=True)
    shapes = (("wag-g4-64x8192", cs.wag_g4_large, True),
              ("gy94-32x4096", cs.gy94_m0_fit_model, True),
              ("wag-64x8192", cs.wag_large, False),
              ("wag-caterpillar-128x8192", wag_caterpillar, False))
    for dtype in (torch.float32, torch.float64):
        dt = str(dtype).replace("torch.", "")
        kw = dict(dtype=dtype, device=dev)
        for name, make, split in shapes:
            tlk = make(dtype, dev)
            tips, pm, fr, pr, w = cs.engine_inputs(
                tlk, tlk.param_space().init_params(**kw))
            topo = tlk.topo
            children = cs.topo_constant(topo, "children",
                                        lambda: topo.children, tips,
                                        torch.int32)
            rootw = (pr[:, None] * fr[None, :]).reshape(-1).contiguous()

            def k1():
                return fused.fused_wide_forward(tips, pm, children, rootw,
                                                split)
            out, part, sc = k1()
            site = torch.logsumexp(out, 0) if split else out
            g = (w * torch.exp(out - site)).contiguous() if split else w

            def k2():
                return fused.fused_wide_backward(tips, pm, children, rootw,
                                                 split, part, sc, g)
            sched = cuda_build.level_schedule(topo, tips)

            def k7():
                return wide.wide_forward(tips, pm, children, rootw, sched)
            _, wpart, wsc = k7()

            def k8():
                return wide.wide_backward(tips, pm, children, rootw, sched,
                                          wpart, wsc, w)
            T, S, P = tips.shape
            C = pm.shape[1]
            dims = (T, topo.I, C, S, children.shape[1], P,
                    tips.element_size())
            rec = {"phase": "fw_kernels", "tree": tree, "shape": name,
                   "dtype": dt, "split": split, "categories": C,
                   "states": S, "patterns": P, "internal": topo.I}
            if hasattr(fused, "kernel_launches"):
                n0 = fused.kernel_launches()
                k2()
                k1()
                rec["kernel_launches_a_sweep_pair"] = \
                    fused.kernel_launches() - n0
                rec.update(schedule_variants(k1, k2, topo, tips, C, S))
            for kind, run, other in (("forward", k1, k7),
                                     ("backward", k2, k8)):
                rec[f"{kind}_graph_us"] = graph_launch_us(run)
                rec[f"{kind}_ms"] = cs.median_ms(run, reps=50)
                rec[f"{kind}_k7k8_graph_us"] = graph_launch_us(other)
                rec[f"{kind}_k7k8_ms"] = cs.median_ms(other, reps=50)
                ms, by = cs.bound(*cs.pruning_work(kind == "backward",
                                                   *dims))
                rec[f"{kind}_bound_ms"], rec[f"{kind}_bound_by"] = ms, by
            print(json.dumps(rec), flush=True)
            del tlk, tips, pm, part, sc, wpart, wsc
            torch.cuda.empty_cache()


# where --s4-trace stamps each S = 4 walk (thread 0 of block 0): (line,
# stamp, before) in each header, and the names of the three spans a level
# has between its stamps [0], [1], [2] and the next level's [0]. The
# backward: to its parent's cotangent (the stage's wait, gbuf[k] through
# L1), to the end of its step, to the next level (the barrier). The
# forward: its first round's step (indices and tips ahead, the hand-off,
# the product, the max, the stores), its further rounds and the barrier,
# to the next level. The forward's entry and end are stamped in row 4095.
_TRACE_START = ("    const bool tr_ = blockIdx.x == 0 && blockIdx.y == 0 && "
                "blockIdx.z == 0 && threadIdx.x == 0 && d < 4095;\n"
                "    if (tr_) s4_trace[d][0] = clock64();\n")
S4_TRACE_AT = {
    "s4_backward.cuh": ((
        ("    __pipeline_wait_prior(1);  // every group but level d + 1's "
         "has landed\n", _TRACE_START, True),
        ("    if (t0 < items) gk = d == 0 ? seed() : valid ? gb[at(cur.k)] : "
         "scalar_t(0);\n",
         "    if (tr_) {\n      if (gk == scalar_t(-12345)) gb[0] = 1;\n"
         "      s4_trace[d][1] = clock64();\n    }\n", False),
        ("    if (t0 < items) pair_cotangents(ch, cur, gk, gb, c, s, p, valid, "
         "q0);\n",
         "    if (tr_) s4_trace[d][2] = clock64();\n", False)),
        ("to_cotangent", "to_step_end", "to_next_level")),
    "s4_forward.cuh": ((
        ("  extern __shared__ __align__(16) unsigned char smem_raw[];\n",
         "  const long long t_in_ = clock64();\n", False),
        ("  for (int d = d0; d < n_levels; ++d) {\n", _TRACE_START, False),
        ("    x_root = x;  // the last level holds the root alone\n",
         "    if (tr_) {\n      if (x == scalar_t(-12345)) w.part[0] = 1;\n"
         "      s4_trace[d][1] = clock64();\n    }\n", True),
        ("    next = next2;\n    __syncthreads();\n",
         "    if (tr_) s4_trace[d][2] = clock64();\n", False),
        ("      site_log[(size_t)l * P + q] = log_(site > tiny ? site : tiny) + "
         "acc;\n    }\n  }\n",
         "  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) {\n"
         "    s4_trace[4095][0] = t_in_;\n"
         "    s4_trace[4095][1] = clock64();\n  }\n", False)),
        ("to_step_end", "to_barrier_end", "to_next_level"))}


def traced_pruning_lib(header: str):
    """``csrc/pruning.cu`` built with ``header`` stamped at S4_TRACE_AT,
    and a reader of the stamps (``s4_trace_read``)."""
    csrc = cuda_build.PKG / "csrc"
    text = (csrc / header).read_text()
    for at, stamp, before in S4_TRACE_AT[header][0]:
        if text.count(at) != 1:
            raise SystemExit(f"csrc/{header} no longer has the lines this "
                             f"measurement stamps")
        text = text.replace(at, stamp + at if before else at + stamp)
    text = text.replace("namespace {\n", "namespace {\n__device__ long long "
                        "s4_trace[4096][3];\n", 1)
    reader = ('\nextern "C" int s4_trace_read(void* host) {\n'
              "  return cudaMemcpyFromSymbol(host, s4_trace, "
              "sizeof(s4_trace));\n}\n")
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        for f in csrc.glob("*.cuh"):
            (d / f.name).write_text(text if f.name == header
                                    else f.read_text())
        (d / "pruning.cu").write_text("// traced\n" + (
            csrc / "pruning.cu").read_text() + reader)
        lib, _ = cuda_build.build_library(d / "pruning.cu")
    return lib


def s4_trace(dev):
    """Where a level of K2''s and of K1''s walks goes: ``csrc/pruning.cu``
    rebuilt with clock64() stamps in each walk's loop (thread 0 of block 0,
    float32, at the fluA JC69 model): each level's cycles in the spans of
    S4_TRACE_AT; for the forward also the whole kernel and its parts before
    and after the levels."""
    import ctypes

    jc = cs.load_fluA_time(torch.float32, dev)
    tips, pm, fr, pr, w = cs.engine_inputs(jc, jc.param_space().init_params(
        dtype=torch.float32, device=dev))
    children = cs.topo_constant(jc.topo, "children", lambda: jc.topo.children,
                                tips, torch.int32)
    rootw = (pr[:, None] * fr[None, :]).reshape(-1).contiguous()
    postorder = fwd_schedule(jc.topo, tips)
    _, part, sc = fused.pruning_forward(tips, pm, children, rootw, *postorder)
    preorder = s4_schedule(jc.topo, tips)
    for header, run, n in (
            ("s4_backward.cuh", lambda: fused.pruning_backward(
                tips, pm, children, rootw, *preorder, part, sc, w),
             len(jc.topo.preorder_levels)),
            ("s4_forward.cuh", lambda: fused.pruning_forward(
                tips, pm, children, rootw, *postorder),
             len(jc.topo.levels))):
        lib = traced_pruning_lib(header)
        fused._lib = fused.bind(lib)
        for _ in range(5):
            run()
        torch.cuda.synchronize()
        fused._lib = None
        stamps = np.zeros((4096, 3), dtype=np.int64)
        if lib.s4_trace_read(ctypes.c_void_p(stamps.ctypes.data)):
            raise RuntimeError("reading the walk's stamps failed")
        t = stamps[:n]
        spans = S4_TRACE_AT[header][1]
        rec = {"phase": "s4_trace", "walk": header, "levels": n,
               spans[0]: (t[:, 1] - t[:, 0]).tolist(),
               spans[1]: (t[:, 2] - t[:, 1]).tolist(),
               spans[2]: (t[1:, 0] - t[:-1, 2]).tolist(),
               "cycles": int(t[n - 1, 2] - t[0, 0])}
        if header == "s4_forward.cuh":
            entry, end = stamps[4095, :2]
            rec.update(kernel_cycles=int(end - entry),
                       before_levels=int(t[0, 0] - entry),
                       after_levels=int(end - t[n - 1, 2]))
        print(json.dumps(rec), flush=True)


def s4_host(dev):
    """The host time of K2''s and K6''s wrappers at S = 4 (``host_us``:
    median of 200 calls, each started on an idle card; three rounds),
    float32, K2' at the checkpoint B model, K6' at its L = 4 chains and at
    GTR+G4 fluA's L = 8. It uses only entry points that older checkouts
    have, so a copy run from an older checkout's root times that
    checkout."""
    jc, gtr = cs.load_fluA_time(torch.float32, dev), cs.load_gtrg4_fluA(
        torch.float32, dev)
    cases = []
    for name, tlk, L, seed in (("k6-fluA-jc69-L4", jc, 4, 2),
                               ("k6-fluA-gtrg4-L8", gtr, 8, 3)):
        topo = tlk.topo
        tips, pm, fr, pr, w = cs.engine_inputs(tlk, cs.chain_params(
            tlk, L, seed))
        children = cs.topo_constant(topo, "children", lambda: topo.children,
                                    tips, torch.int32)
        _, part, sc = loop.loop_forward(tips, pm, children, fr, pr,
                                        *fwd_schedule(topo, tips))
        cases.append((name, functools.partial(
            loop.loop_backward, tips, pm, children, fr, pr,
            *s4_schedule(topo, tips), part, sc, w.expand(L, -1).contiguous())))
    tips, pm, fr, pr, w = cs.engine_inputs(jc, jc.param_space().init_params(
        dtype=torch.float32, device=dev))
    children = cs.topo_constant(jc.topo, "children", lambda: jc.topo.children,
                                tips, torch.int32)
    rootw = (pr[:, None] * fr[None, :]).reshape(-1).contiguous()
    _, part, sc = fused.pruning_forward(tips, pm, children, rootw,
                                        *fwd_schedule(jc.topo, tips))
    cases.append(("k2-fluA-jc69", functools.partial(
        fused.pruning_backward, tips, pm, children, rootw,
        *s4_schedule(jc.topo, tips), part, sc, w)))
    for rnd in range(3):
        print(json.dumps({"phase": "s4_host", "round": rnd,
                          "schedule_argument": bool(s4_schedule(jc.topo,
                                                                tips)),
                          **{f"{name}_us": host_us(run, n=200)
                             for name, run in cases}}), flush=True)


K4_DEPTH = "constexpr int BWD_DEPTH = 4;"
K4_BLOCKS = "constexpr int BWD_BLOCKS = 2;"


def k4_variants(dev):
    """K4' (float32) at the config model and balanced 128 x 16384 through
    ``csrc/staged.cu`` as committed (BWD_DEPTH 4, BWD_BLOCKS 2) and
    rebuilt with no patterns staged ahead (depth 1), two and six, and at
    three blocks an SM; each build's registers and spills, K4' alone
    (median of 50, three rounds in turns) and its launches' device time;
    then the committed build at other MAX_PPT and FIXED of level_ppt."""
    src = (cuda_build.PKG / "csrc" / "staged.cu").read_text()
    if K4_DEPTH not in src or K4_BLOCKS not in src:
        raise SystemExit("csrc/staged.cu no longer has the constants this "
                         "measurement varies")
    variants = {"depth4-blocks2": src, "depth1-blocks2": src.replace(
        K4_DEPTH, "constexpr int BWD_DEPTH = 1;"),
        "depth2-blocks2": src.replace(K4_DEPTH, "constexpr int BWD_DEPTH = 2;"),
        "depth6-blocks2": src.replace(K4_DEPTH, "constexpr int BWD_DEPTH = 6;"),
        "depth4-blocks3": src.replace(K4_BLOCKS,
                                      "constexpr int BWD_BLOCKS = 3;")}
    with tempfile.TemporaryDirectory() as tmp:
        paths = {}
        for label, text in variants.items():
            d = Path(tmp) / label
            d.mkdir()
            # a first line of its own: each build is compiled here
            (d / "staged.cu").write_text(f"// {label}\n" + text)
            paths[label] = d / "staged.cu"
        with ThreadPoolExecutor(len(paths)) as pool:
            built = dict(zip(paths, pool.map(cuda_build.build_library,
                                             paths.values())))
    libs = {}
    for label, (lib, log) in built.items():
        libs[label] = staged.bind(lib)
        print(json.dumps({"k4_build": label, "ptxas": {
            k: v for k, v in cs.ptxas_by_kernel(log, "backward_level").items()
            if "Li4E" in k}}), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        path, _ = cs.large_config(Path(tmp), 128, 20480, dev)
        ctx, _ = build_config(load_json(str(path)), base_dir=str(path.parent),
                              dtype=torch.float32, device=dev)
    tlk = ctx.objects["treelikelihood"]
    topo128 = balanced_topology(128)
    cases = []
    for name, topo, inputs in (
            ("config-128", tlk.topo, cs.engine_inputs(
                tlk, tlk.param_space().init_params(dtype=torch.float32,
                                                   device=dev))),
            ("balanced-128x16384", topo128, cs.random_inputs(
                topo128, 16384, 4, 7, torch.float32, dev))):
        tips, pm, fr, pr, w = inputs
        children = cs.topo_constant(topo, "children", lambda: topo.children,
                                    tips, torch.int32)
        rootw = (pr[:, None] * fr[None, :]).reshape(-1).contiguous()
        schedule = cuda_build.level_schedule(topo, tips)
        _, part, ls = staged.staged_forward(tips, pm, children, rootw,
                                            schedule)
        cases.append((name, functools.partial(
            staged.staged_backward, tips, pm, children, rootw, schedule,
            part, ls, w)))
    saved = staged._lib
    try:
        for rnd in range(3):
            for label, lib in libs.items():
                staged._lib = lib
                row = {"k4_build": label, "round": rnd}
                for name, run in cases:
                    row[f"{name}_ms"] = cs.median_ms(run, reps=50)
                    if rnd == 0:
                        row[f"{name}_launch_us"] = launch_device_us(
                            run, ("backward_root", "backward_level",
                                  "backward_sum"))
                print(json.dumps(row), flush=True)
        staged._lib = libs["depth4-blocks2"]
        rule = (staged.MAX_PPT, staged.FIXED)
        for rnd in range(2):
            for most, fixed in ((16, 4), (8, 4), (32, 4), (64, 4), (16, 1),
                                (16, 16)):
                staged.MAX_PPT, staged.FIXED = most, fixed
                row = {"max_ppt": most, "fixed": fixed, "round": rnd}
                for name, run in cases:
                    row[f"{name}_ms"] = cs.median_ms(run, reps=50)
                print(json.dumps(row), flush=True)
        staged.MAX_PPT, staged.FIXED = rule
    finally:
        staged._lib = saved


K8_BLOCK = "constexpr int BWD_P = TP * BWD_CHUNKS;"


def k8_blocks(dev):
    """K8' (float32) at GY94 M0 32 x 4096 with ``csrc/wide.cu`` as
    committed (128 patterns a block) and rebuilt at 64 and 32."""
    tiles = (cuda_build.PKG / "csrc" / "tiles.cuh").read_text()
    if K8_BLOCK not in tiles:
        raise SystemExit("csrc/tiles.cuh no longer has the block size "
                         "this measurement varies")
    source = (cuda_build.PKG / "csrc" / "wide.cu").read_text()
    # a rebuilt block is a multiple of the step's 32 patterns only at
    # S > 32 (at S <= 32 a step takes 128): these builds run GY94 alone
    with tempfile.TemporaryDirectory() as tmp:
        paths = {}
        for block in (64, 32):
            d = Path(tmp) / f"block-{block}"
            d.mkdir()
            for h in (cuda_build.PKG / "csrc").glob("*.cuh"):
                (d / h.name).write_text(h.read_text().replace(
                    K8_BLOCK, f"constexpr int BWD_P = {block};"))
            (d / "wide.cu").write_text(f"// patterns a block: {block}\n"
                                       + source)
            paths[block] = d / "wide.cu"
        with ThreadPoolExecutor(len(paths)) as pool:
            built = dict(zip(paths, pool.map(cuda_build.build_library,
                                             paths.values())))
    libs = {wide.BWD_PATTERNS: wide.build()}
    print(json.dumps({"k8_block": wide.BWD_PATTERNS,
                      "ptxas": cs.ptxas_by_kernel(wide.build_log,
                                                  "backward_levelIf")}),
          flush=True)
    for block, (lib, log) in built.items():
        libs[block] = wide.bind(lib)
        print(json.dumps({"k8_block": block,
                          "ptxas": cs.ptxas_by_kernel(log,
                                                      "backward_levelIf")}),
              flush=True)
    tlk = cs.gy94_m0_fit_model(torch.float32, dev)
    inputs = cs.engine_inputs(tlk, tlk.param_space().init_params(
        dtype=torch.float32, device=dev))
    bwd = k8_call(tlk, inputs)
    saved = wide._lib, wide.BWD_PATTERNS
    try:
        ref = None
        for rnd in range(3):
            for block, lib in libs.items():
                wide._lib, wide.BWD_PATTERNS = lib, block
                row = {"k8_block": block, "round": rnd,
                       "gy94-32x4096_ms": cs.median_ms(bwd, reps=100)}
                if rnd == 0:
                    dP, drootw = bwd()
                    ref = ref or (dP, drootw)
                    row["max_abs_err_vs_128"] = max(
                        cs.max_err(dP, ref[0])[0],
                        cs.max_err(drootw, ref[1])[0])
                    row["launch_us"] = launch_device_us(
                        bwd, ("backward_root", "backward_level"))
                    row["dP_scratch_bytes"] = (
                        -(-tlk.sp.pattern_count // block) * dP.numel()
                        * dP.element_size())
                print(json.dumps(row), flush=True)
    finally:
        wide._lib, wide.BWD_PATTERNS = saved


K6_BOUNDS = ("__launch_bounds__(THREADS,\n"
             "                                  sizeof(scalar_t) == 4 ? "
             "(CP == 4 ? 2 : 3)\n")
K5_BOUNDS = ("__launch_bounds__(THREADS, sizeof(scalar_t) == 4 ? 4 : 2)\n"
             "    loop_wide_forward_kernel(")


def loop_builds(marker: str, budgets: dict, kernel: str) -> dict:
    """``csrc/loop.cu`` rebuilt with ``marker`` replaced by each of
    ``budgets`` ({label: text}, None for the committed source), bound
    (``ops/loop.bind``); prints each build's registers and spills of the
    kernels whose name contains ``kernel``. Returns {label: library}."""
    src = (cuda_build.PKG / "csrc" / "loop.cu").read_text()
    if marker not in src:
        raise SystemExit("csrc/loop.cu no longer has the launch bounds "
                         "this measurement varies")
    with tempfile.TemporaryDirectory() as tmp:
        paths = {}
        for label, text in budgets.items():
            d = Path(tmp) / f"blocks-{label}"
            d.mkdir()
            for h in (cuda_build.PKG / "csrc").glob("*.cuh"):
                (d / h.name).write_text(h.read_text())
            # a first line of its own, so that each build is compiled here
            # (and its registers printed) even where the committed source
            # was built before
            body = src if text is None else src.replace(marker, text)
            (d / "loop.cu").write_text(f"// blocks an SM: {label}\n" + body)
            paths[label] = d / "loop.cu"
        with ThreadPoolExecutor(len(paths)) as pool:
            built = dict(zip(paths, pool.map(cuda_build.build_library,
                                             paths.values())))
    libs = {}
    for label, (lib, log) in built.items():
        libs[label] = loop.bind(lib)
        print(json.dumps({"blocks_per_sm": label, "kernel": kernel,
                          "ptxas": cs.ptxas_by_kernel(log, kernel)}),
              flush=True)
    return libs


def loop_cases(dev):
    """(name, K5' arguments, K6' arguments) at GY94 M0 32 x 4096, L = 8 and
    WAG+G4 64 x 8192, L = 4 (float32)."""
    cases = []
    for name, make, L, seed in (
            ("gy94-32x4096-L8", cs.gy94_m0_fit_model, 8, 5),
            ("wag-g4-64x8192-L4", cs.wag_g4_large, 4, 6)):
        tlk = make(torch.float32, dev)
        tips, pm, fr, pr, w = cs.engine_inputs(tlk, cs.chain_params(tlk, L,
                                                                    seed))
        children = cs.topo_constant(tlk.topo, "children",
                                    lambda: tlk.topo.children, tips,
                                    torch.int32)
        _, part, sc = loop.loop_forward(tips, pm, children, fr, pr,
                                        *fwd_schedule(tlk.topo, tips))
        cases.append((name, (tips, pm, children, fr, pr,
                             *fwd_schedule(tlk.topo, tips)),
                      (tips, pm, children, fr, pr,
                       *s4_schedule(tlk.topo, tips), part, sc,
                       w.expand(L, -1).contiguous())))
    return cases


def time_builds(libs: dict, cases, fn, label: str, reps: int):
    """``fn(*args)`` through each build (median of ``reps``, three rounds in
    turns) at each case."""
    saved = loop._lib
    try:
        for rnd in range(3):
            for blocks, lib in libs.items():
                loop._lib = lib
                row = {label: blocks, "round": rnd}
                for name, args in cases:
                    row[f"{name}_ms"] = cs.median_ms(lambda: fn(*args),
                                                     reps=reps)
                print(json.dumps(row), flush=True)
    finally:
        loop._lib = saved


def k6_bounds(dev):
    """K6' at S != 4 (float32) as committed and at 1, 2 and 3 blocks an SM
    for every step shape."""
    libs = loop_builds(K6_BOUNDS, {"committed": None, **{
        b: K6_BOUNDS.replace("(CP == 4 ? 2 : 3)", str(b)) for b in (1, 2, 3)}},
        "loop_wide_backward_kernelIf")
    cases = [(name, bwd) for name, _, bwd in loop_cases(dev)]
    time_builds(libs, cases, loop.loop_backward, "k6_blocks_per_sm", 50)


def k5_bounds(dev):
    """K5' at S != 4 (float32) as committed (four blocks an SM) and at 2
    and 3."""
    libs = loop_builds(K5_BOUNDS, {"committed": None, **{
        b: K5_BOUNDS.replace("? 4 : 2", f"? {b} : 2") for b in (2, 3)}},
        "loop_wide_forward_kernelIf")
    cases = [(name, fwd) for name, fwd, _ in loop_cases(dev)]
    time_builds(libs, cases, loop.loop_forward, "k5_blocks_per_sm", 50)


ROWS_LOAD = "      Vec<scalar_t>::load(M + (r0 + step * i) * SP + b0, m);\n"


def k5_loads(dev):
    """K5' at S != 4 (float32) as committed and rebuilt with the products'
    P rows read as four 4-byte broadcasts (volatile, so not merged) in
    place of one 16-byte broadcast: if a 16-byte broadcast costs a
    shared-memory wavefront per quarter-warp, both builds move the same
    wavefronts per FMA and time alike."""
    tiles = (cuda_build.PKG / "csrc" / "tiles.cuh").read_text()
    if ROWS_LOAD not in tiles:
        raise SystemExit("csrc/tiles.cuh no longer has the load this "
                         "measurement varies")
    scalar = ("#pragma unroll\n      for (int v = 0; v < V; ++v)\n"
              "        m[v] = static_cast<const volatile scalar_t*>(M)"
              "[(r0 + step * i) * SP + b0 + v];\n")
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp) / "scalar"
        d.mkdir()
        for h in (cuda_build.PKG / "csrc").glob("*.cuh"):
            text = h.read_text()
            (d / h.name).write_text(text.replace(ROWS_LOAD, scalar))
        (d / "loop.cu").write_text(
            "// P rows as 4-byte loads\n"
            + (cuda_build.PKG / "csrc" / "loop.cu").read_text())
        lib, log = cuda_build.build_library(d / "loop.cu")
    print(json.dumps({"p_loads": "4-byte", "ptxas": cs.ptxas_by_kernel(
        log, "loop_wide_forward_kernelIf")}), flush=True)
    libs = {"16-byte": loop.build(), "4-byte": loop.bind(lib)}
    cases = [(name, fwd) for name, fwd, _ in loop_cases(dev)]
    time_builds(libs, cases, loop.loop_forward, "p_loads", 50)


def calibrated_settings(dev, seeds=(1, 2, 3, 4), n_chains=64, length=5000,
                        burnin=1000, prefixes=(625, 1250, 2500, 5000),
                        chain_counts=(16, 32, 64), ladder=5000,
                        ladder_burnin=500, ladder_prefixes=(1000, 2500, 5000),
                        vb_max=(1000, 2500)):
    """The calibrated config's estimators against their chain settings,
    over seeds (``--calibrated-settings``)."""
    import io

    from physher_tpu_torch.config.actions import Runner
    from physher_tpu_torch.inference import marginal, mcmc

    cfg = load_json(str(cs.DATA / "fluA-calibrated.json"))
    acts = {a["id"]: a for a in cfg["physher"]}
    rows = []
    for seed in seeds:
        ctx, _ = build_config(cfg, base_dir=str(cs.DATA),
                              dtype=torch.float64, device=dev)
        runner = Runner(ctx, seed=seed, out=io.StringIO())
        post = ctx.objects["posterior"]
        space = post.param_space()
        rec = {"seed": seed, "seconds": {}}
        t0 = time.perf_counter()
        runner.run([dict(acts["mmcmc"], length=ladder, burnin=ladder_burnin)])
        torch.cuda.synchronize()
        rec["seconds"]["ladder"] = time.perf_counter() - t0
        temps, lls, _ = runner.results["mmcmc"]
        lls = np.asarray(lls)
        rec["ladder"] = {str(n): {
            "stepping_stone": marginal.log_stepping_stone(
                lls[:, : n // 10], temps)[0],
            "path_sampling": marginal.log_path_sampling(
                lls[:, : n // 10], temps)[0]} for n in ladder_prefixes}
        t0 = time.perf_counter()
        res = mcmc.MCMC(space, post.log_prob).run(
            runner.generator, runner.params_for(space), n_iter=length,
            every=10, burnin=burnin, n_chains=n_chains)
        torch.cuda.synchronize()
        rec["seconds"]["chains"] = time.perf_counter() - t0

        def log_unnorm(z):
            return marginal.batched_values(post.log_prob, space, z,
                                           jacobian=True)

        rec["bridge"] = {}
        for c in chain_counts:
            for n in prefixes:
                z = torch.as_tensor(
                    res.samples_u[: n // 10, :c].reshape(
                        -1, res.samples_u.shape[-1]),
                    dtype=torch.float64, device=dev)
                rec["bridge"][f"{c}x{n}"] = marginal.bridge_sampling_marginal(
                    z, log_unnorm, space,
                    torch.Generator(device=dev).manual_seed(seed))
        rec["log_posterior_mean_a_500"] = [
            float(res.log_posterior[k: k + 50].mean())
            for k in range(0, len(res.log_posterior), 50)]
        runner.run([acts["map"]])
        rec["is"] = {}
        for m in vb_max:
            t0 = time.perf_counter()
            runner.run([dict(acts["vb"], max=m), acts["is"]])
            torch.cuda.synchronize()
            rec["seconds"][f"vb{m}_is"] = time.perf_counter() - t0
            rec["is"][str(m)] = {"is": runner.results["is"],
                                 "elbo": runner.results["vb"].elbo,
                                 "iterations": runner.results["vb"].iterations}
        print(json.dumps(rec), flush=True)
        rows.append(rec)

    def spread(vals):
        return {"mean": float(np.mean(vals)),
                "spread": float(np.max(vals) - np.min(vals)), "values": vals}

    summary = {"mode": "calibrated_settings", "seeds": list(seeds),
               "ladder": {n: {k: spread([r["ladder"][n][k] for r in rows])
                              for k in ("stepping_stone", "path_sampling")}
                          for n in rows[0]["ladder"]},
               "bridge": {k: spread([r["bridge"][k] for r in rows])
                          for k in rows[0]["bridge"]},
               "is": {k: spread([r["is"][k]["is"] for r in rows])
                      for k in rows[0]["is"]},
               "seconds": {k: float(np.mean([r["seconds"][k] for r in rows]))
                           for k in rows[0]["seconds"]}}
    print(json.dumps(summary), flush=True)


def ladder_spread(dev, seeds=tuple(range(1, 13)), engine="auto"):
    """The calibrated config's ladder over seeds, its tree likelihood
    through ``engine`` (``--ladder-spread``, ``--ladder-plain``)."""
    import io

    from physher_tpu_torch.config.actions import Runner
    from physher_tpu_torch.inference import marginal

    cfg = load_json(str(cs.DATA / "fluA-calibrated.json"))
    cfg["model"]["distributions"][0]["engine"] = engine
    node = next(a for a in cfg["physher"] if a["id"] == "mmcmc")
    est = {"stepping_stone": [], "path_sampling": []}
    for seed in seeds:
        ctx, _ = build_config(cfg, base_dir=str(cs.DATA),
                              dtype=torch.float64, device=dev)
        runner = Runner(ctx, seed=seed, out=io.StringIO())
        t0 = time.perf_counter()
        runner.run([node])
        torch.cuda.synchronize()
        temps, lls, _ = runner.results["mmcmc"]
        rec = {"seed": seed, "engine": engine,
               "seconds": time.perf_counter() - t0}
        for k, fn in (("stepping_stone", marginal.log_stepping_stone),
                      ("path_sampling", marginal.log_path_sampling)):
            rec[k] = fn(lls, temps)[0]
            est[k].append(rec[k])
        print(json.dumps(rec), flush=True)
    print(json.dumps({
        "mode": "ladder_spread", "engine": engine, "seeds": list(seeds),
        "ladder": {k: node[k] for k in ("temperatures", "length", "burnin")},
        "estimates": {k: {"mean": float(np.mean(v)),
                          "spread": float(np.ptp(v)),
                          "sd": float(np.std(v, ddof=1)) if len(v) > 1
                          else None}
                      for k, v in est.items()}}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--gate", action="store_true",
                    help="only the staged-against-fused measurement")
    ap.add_argument("--mcmc", action="store_true",
                    help="only the MH step against the number of chains")
    ap.add_argument("--wide-backward", action="store_true",
                    help="only K5'/K6' at S != 4 and HMC on WAG+G4")
    ap.add_argument("--wide-forward", action="store_true",
                    help="only K5' at S != 4 and K7', and HMC on WAG+G4")
    ap.add_argument("--k8", action="store_true",
                    help="only K7'/K8' and their models' steps")
    ap.add_argument("--k8-blocks", action="store_true",
                    help="only K8' at GY94 at 128, 64, 32 patterns a block")
    ap.add_argument("--k6-bounds", action="store_true",
                    help="only K6' at S != 4 at 1, 2, 3 blocks an SM")
    ap.add_argument("--k5-bounds", action="store_true",
                    help="only K5' at S != 4 at 2, 3, 4 blocks an SM")
    ap.add_argument("--k5-loads", action="store_true",
                    help="only K5' at S != 4 with P rows as 4-byte loads")
    ap.add_argument("--k4-variants", action="store_true",
                    help="only K4' at other pipeline depths, register "
                         "budgets and patterns a thread")
    ap.add_argument("--staged", action="store_true",
                    help="only K3'/K4' alone, their launches and "
                         "value-and-gradient")
    ap.add_argument("--switch", action="store_true",
                    help="only K3' at each switch level to its walk over "
                         "the gate's trees and pattern counts")
    ap.add_argument("--s4-backward", action="store_true",
                    help="only K6' at S = 4 and K2' alone, their launches, "
                         "HMC and the ADVI step")
    ap.add_argument("--s4-forward", action="store_true",
                    help="only K1' and K5' at S = 4 alone and their launches")
    ap.add_argument("--s4-trace", action="store_true",
                    help="only K2''s and K1''s walks with clock64() stamps "
                         "a level")
    ap.add_argument("--s4-host", action="store_true",
                    help="only the host time of K2''s and K6''s wrappers")
    ap.add_argument("--fused-wide", action="store_true",
                    help="only K1'/K2' at S != 4 alone beside K7'/K8'")
    ap.add_argument("--calibrated-settings", action="store_true",
                    help="only the calibrated config's estimators against "
                         "their chain settings, over four seeds")
    ap.add_argument("--ladder-spread", action="store_true",
                    help="only the calibrated config's ladder over twelve "
                         "seeds")
    ap.add_argument("--ladder-plain", action="store_true",
                    help="only four seeds of that ladder through K5' and "
                         "through the plain engine")
    ap.add_argument("--out", type=Path, default=Path(os.devnull),
                    help="with --gate or --switch, also write the sweep's "
                         "lines here")
    args = ap.parse_args()
    dev = cs.cuda_device()
    smi = cs.nvidia_smi()
    if args.fused_wide:
        with ThreadPoolExecutor(2) as pool:
            list(pool.map(lambda m: m.build(), (fused, wide)))
        fused_wide(dev)
        print(smi, flush=True)
        return 0
    with ThreadPoolExecutor(4) as pool:
        list(pool.map(lambda m: m.build(), (fused, staged, loop, wide)))
    if args.calibrated_settings:
        calibrated_settings(dev)
        print(smi, flush=True)
        return 0
    if args.ladder_spread:
        ladder_spread(dev)
        print(smi, flush=True)
        return 0
    if args.ladder_plain:
        for engine in ("auto", "xla"):
            ladder_spread(dev, seeds=(1, 2, 3, 4), engine=engine)
        print(smi, flush=True)
        return 0
    if args.k4_variants:
        k4_variants(dev)
        print(smi, flush=True)
        return 0
    if args.staged:
        staged_kernels(dev)
        print(smi, flush=True)
        return 0
    if args.switch:
        switch_sweep(dev, args.out)
        print(smi, flush=True)
        return 0
    if args.s4_backward:
        s4_backward(dev)
        print(smi, flush=True)
        return 0
    if args.s4_forward:
        s4_forward(dev)
        print(smi, flush=True)
        return 0
    if args.s4_host:
        s4_host(dev)
        print(smi, flush=True)
        return 0
    if args.s4_trace:
        s4_trace(dev)
        print(smi, flush=True)
        return 0
    if args.k6_bounds:
        k6_bounds(dev)
        print(smi, flush=True)
        return 0
    if args.k5_bounds:
        k5_bounds(dev)
        print(smi, flush=True)
        return 0
    if args.k5_loads:
        k5_loads(dev)
        print(smi, flush=True)
        return 0
    if args.wide_forward:
        wide_forward(dev)
        print(smi, flush=True)
        return 0
    if args.wide_backward:
        wide_backward(dev)
        print(smi, flush=True)
        return 0
    if args.k8:
        k8(dev)
        print(smi, flush=True)
        return 0
    if args.k8_blocks:
        k8_blocks(dev)
        print(smi, flush=True)
        return 0
    if args.mcmc:
        profile_mcmc(dev, max(args.steps, 200))
        print(smi, flush=True)
        return 0
    if args.gate:
        gate_sweep(dev, args.out)
        gate_end_to_end(dev)
        print(smi, flush=True)
        return 0
    profile_advi("fluA-elbo", cs.DATA / "fluA-elbo.json", dev, args.steps)
    with tempfile.TemporaryDirectory() as tmp:
        path, _ = cs.large_config(Path(tmp), 128, 20480, dev)
        profile_advi("gtrg4-128-large", path, dev, args.steps)
    kernel_times(dev)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
