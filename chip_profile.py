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

With ``--k8``, only K7'/K8' alone (CUDA events, median of 100) against the
plain version, with their bounds, at GY94 M0 32 x 4096 (C = 1) and WAG+G4
64 x 8192 (C = 4), float32, beside each model's value-and-gradient through
them and its Adam step (host clock), and nvcc's register and spill lines
for K8'. Then the device time of each of K8''s launches (the root seed,
then the levels root first) from torch.profiler. Like ``--wide-backward``
it uses only entry points that older checkouts have, so a copy run from an
older checkout's root times that checkout.

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

    python3 chip_profile.py [--steps 20] [--gate [--out sweep.jsonl]]
                            [--mcmc] [--wide-backward] [--k8]
                            [--k8-blocks] [--k6-bounds]

Needs one NVIDIA GPU and nvcc; exits non-zero without them. Prints one JSON
line per config and per kernel shape, then the card's name and power limit from nvidia-smi.
"""

from __future__ import annotations

import argparse
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
    extra = (() if mod is fused
             else (cuda_build.level_schedule(topo, tips),))

    def sweep():
        _, partials, scale = forward(tips, pmats, children, rootw, *extra)
        backward(tips, pmats, children, rootw, *extra, partials, scale, cot)
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
                    del inputs
            torch.cuda.empty_cache()


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


def k6_bounds(dev):
    """K6' at S != 4 (float32) as committed and at 1, 2 and 3 blocks an SM
    for every step shape."""
    src = (cuda_build.PKG / "csrc" / "loop.cu").read_text()
    if K6_BOUNDS not in src:
        raise SystemExit("csrc/loop.cu no longer has the launch bounds "
                         "this measurement varies")
    budgets = ("committed", 1, 2, 3)
    with tempfile.TemporaryDirectory() as tmp:
        paths = {}
        for blocks in budgets:
            d = Path(tmp) / f"blocks-{blocks}"
            d.mkdir()
            for h in (cuda_build.PKG / "csrc").glob("*.cuh"):
                (d / h.name).write_text(h.read_text())
            # a first line of its own, so that each build is compiled here
            # (and its registers printed) even where the committed source
            # was built before
            text = src if blocks == "committed" else src.replace(
                K6_BOUNDS, K6_BOUNDS.replace("(CP == 4 ? 2 : 3)",
                                             str(blocks)))
            (d / "loop.cu").write_text(f"// blocks an SM: {blocks}\n" + text)
            paths[blocks] = d / "loop.cu"
        with ThreadPoolExecutor(len(paths)) as pool:
            built = dict(zip(paths, pool.map(cuda_build.build_library,
                                             paths.values())))
    libs = {}
    for blocks, (lib, log) in built.items():
        loop.bind(lib)
        libs[blocks] = lib
        print(json.dumps({"k6_blocks_per_sm": blocks,
                          "ptxas": cs.ptxas_by_kernel(
                              log, "loop_wide_backward_kernelIf")}), flush=True)
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
        _, part, sc = loop.loop_forward(tips, pm, children, fr, pr)
        cases.append((name, (tips, pm, children, fr, pr, part, sc,
                             w.expand(L, -1).contiguous())))
    saved = loop._lib
    try:
        for rnd in range(3):
            for blocks, lib in libs.items():
                loop._lib = lib
                row = {"k6_blocks_per_sm": blocks, "round": rnd}
                for name, args in cases:
                    row[f"{name}_ms"] = cs.median_ms(
                        lambda: loop.loop_backward(*args), reps=50)
                print(json.dumps(row), flush=True)
    finally:
        loop._lib = saved


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--gate", action="store_true",
                    help="only the staged-against-fused measurement")
    ap.add_argument("--mcmc", action="store_true",
                    help="only the MH step against the number of chains")
    ap.add_argument("--wide-backward", action="store_true",
                    help="only K5'/K6' at S != 4 and HMC on WAG+G4")
    ap.add_argument("--k8", action="store_true",
                    help="only K7'/K8' and their models' steps")
    ap.add_argument("--k8-blocks", action="store_true",
                    help="only K8' at GY94 at 128, 64, 32 patterns a block")
    ap.add_argument("--k6-bounds", action="store_true",
                    help="only K6' at S != 4 at 1, 2, 3 blocks an SM")
    ap.add_argument("--out", type=Path, default=Path(os.devnull),
                    help="with --gate, also write the sweep's lines here")
    args = ap.parse_args()
    dev = cs.cuda_device()
    smi = cs.nvidia_smi()
    with ThreadPoolExecutor(4) as pool:
        list(pool.map(lambda m: m.build(), (fused, staged, loop, wide)))
    if args.k6_bounds:
        k6_bounds(dev)
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
