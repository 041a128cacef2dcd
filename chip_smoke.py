"""On-card check of physher_tpu_torch: builds the CUDA pruning kernels from
this checkout, holds them against their plain PyTorch version, runs the
slice's main path (fluA likelihoods, gradients and Adam steps) through them,
and times kernel against plain.

    python3 chip_smoke.py

Needs one NVIDIA GPU (sm_90a) and nvcc; exits non-zero without them or on
any failed phase. Each phase prints one JSON line; the line before the last
is the card's name and power limit from nvidia-smi, and the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

import physher_tpu_torch  # noqa: F401  (sets the TF32 policy)
from physher_tpu_torch.data.sitepattern import SitePattern
from physher_tpu_torch.inference.ml import optimize_adam
from physher_tpu_torch.io.seqio import read_alignment
from physher_tpu_torch.io.treeio import read_newick
from physher_tpu_torch.models.clock import StrictClock
from physher_tpu_torch.models.sitemodel import GammaSiteModel
from physher_tpu_torch.models.substitution import GTR, JC69
from physher_tpu_torch.models.treelikelihood import TreeLikelihood
from physher_tpu_torch.ops import fused
from physher_tpu_torch.trees.heights import topo_constant
from physher_tpu_torch.trees.timetree import TimeTreeData
from physher_tpu_torch.utils.synthetic import (
    balanced_topology, random_sitepattern)

ROOT = Path(__file__).resolve().parent
DATA = ROOT / "tests" / "data"

# Tolerances, kernel against plain on the same inputs. float64: rounding
# only (different summation orders over <= 16384 patterns), relative to the
# largest entry. float32: those of tests/test_fused_engine.py for the TPU
# kernel: logL rtol 2e-5, site logs rtol 5e-4 / atol 1e-4, gradients rtol
# 5e-3 with an absolute floor of 1e-3 of the largest entry.
TOL = {
    torch.float64: dict(logl=1e-12, site=1e-12, grad=1e-12),
    torch.float32: dict(logl=2e-5, site=5e-4, grad=5e-3),
}
# Checkpoint A and the GTR+G4 golden in float64: the reference's goldens at
# the JAX package's test tolerances.
GOLDEN_LOGP, GOLDEN_RATE_GRAD = -4777.616349713985, 328017.6732813406
# Checkpoint A in float32: 24-bit products over 137 nodes and 238 weighted
# site terms drift about 1e-6 relative; 1e-5 relative (0.05 nats) bounds it.
F32_LOGP_ATOL = 0.05


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"FAILED: {what}")


def nvidia_smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def median_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """Median device time of ``fn()`` in ms (CUDA events around each call)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def random_inputs(topo, P, C, seed, dtype, device):
    """Tips [T,4,P] of random states, row-stochastic pmats [N,C,4,4],
    freqs, props, pattern weights (numpy seed)."""

    sp = random_sitepattern(topo.T, P, seed=seed)
    rng = np.random.default_rng(seed)
    Q = rng.random((topo.N, C, 4, 4)) + 0.1
    arrays = (sp.tip_partials(), Q / Q.sum(-1, keepdims=True),
              np.asarray([0.3, 0.2, 0.25, 0.25]),
              np.arange(1, C + 1) / (C * (C + 1) / 2),
              rng.uniform(0.5, 2.0, P))
    return [torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                            device=device) for a in arrays]


def value_and_grad(site_log_fn, topo, tips, pm, freqs, props, w):
    leaves = [x.detach().clone().requires_grad_(True)
              for x in (pm, freqs, props)]
    site = site_log_fn(tips, leaves[0], topo, leaves[1], leaves[2])
    logl = torch.sum(w * site)
    grads = torch.autograd.grad(logl, leaves)
    return logl.detach(), site.detach(), [g.detach() for g in grads]


def max_err(a: torch.Tensor, b: torch.Tensor):
    """(max abs error, max abs error relative to the largest |b|)."""
    abs_err = float((a - b).abs().max())
    return abs_err, abs_err / max(float(b.abs().max()), 1e-300)


def compare(name, topo, inputs, dtype):
    """Kernel against plain on one shape; returns the error record."""
    tol = TOL[dtype]
    k = value_and_grad(fused.fused_site_log, topo, *inputs)
    p = value_and_grad(fused.fused_site_log_reference, topo, *inputs)
    torch.cuda.synchronize()
    rec = {"shape": name, "dtype": str(dtype).replace("torch.", "")}
    logl_rel = abs(float(k[0]) - float(p[0])) / abs(float(p[0]))
    site_abs = float((k[1] - p[1]).abs().max())
    site_ok = bool(torch.all((k[1] - p[1]).abs()
                             <= tol["site"] * (p[1].abs() + 0.2)))
    rec.update(logl_rel_err=logl_rel, site_max_abs_err=site_abs)
    ok = logl_rel <= tol["logl"] and site_ok
    for gname, gk, gp in zip(("d_pmats", "d_freqs", "d_props"), k[2], p[2]):
        a, r = max_err(gk, gp)
        rec[f"{gname}_max_abs_err"], rec[f"{gname}_max_rel_err"] = a, r
        ok = ok and r <= tol["grad"]
        check(bool(torch.isfinite(gk).all()), f"{name} {gname} finite")
    rec["tolerance"] = tol
    rec["ok"] = ok
    emit("kernel_vs_plain", **rec)
    check(ok, f"kernel against plain on {name} {dtype}")
    return rec


def load_fluA_time(dtype, device):

    with open(DATA / "jc69-time.json") as fh:
        tree_cfg = json.load(fh)["model"]["tree"]
    topo, dist = read_newick(tree_cfg["newick"])
    td = TimeTreeData.from_dated_tree(topo, dist, tree_cfg["dates"])
    sp = SitePattern.from_alignment(read_alignment(str(DATA / "fluA.fa")))
    kw = dict(dtype=dtype, device=device)
    return TreeLikelihood(sp, topo, JC69(**kw),
                          clock=StrictClock(topo.N, rate_init=1e-3, **kw),
                          time_data=td, tipstates=True, **kw)


def load_gtrg4_fluA(dtype, device):

    with open(DATA / "goldens" / "gtrg4_fluA.json") as fh:
        m = json.load(fh)["model"]
    sm = m["sitemodel"]["substitutionmodel"]
    rates = [sm["rates"][k]["value"] if k in sm["rates"] else 1.0
             for k in ("ac", "ag", "at", "cg", "ct", "gt")]
    dist_cfg = m["sitemodel"]["distribution"]
    topo, dist = read_newick(m["tree"]["newick"])
    aln = DATA / os.path.basename(m["sitepattern"]["alignment"]["file"])
    sp = SitePattern.from_alignment(read_alignment(str(aln)))
    kw = dict(dtype=dtype, device=device)
    return TreeLikelihood(
        sp, topo, GTR("sm.", rates_init=rates,
                      freqs_init=sm["frequencies"]["values"], **kw),
        GammaSiteModel(dist_cfg["categories"], prefix="sitemodel.",
                       shape_init=dist_cfg["parameters"]["value"], **kw),
        distances_init=np.nan_to_num(dist[: topo.N - 1], nan=0.1),
        tipstates=True, **kw)


def golden_lines():
    logp, node_ids, fd = None, [], []
    with open(DATA / "goldens" / "gtrg4_fluA.txt") as fh:
        for line in fh:
            if line.startswith("logP "):
                logp = float(line.split()[1])
            elif line.startswith("node "):
                node_ids.append(int(line.split()[3]))
            elif line.startswith("dlogP_fd "):
                fd.append(float(line.split()[2]))
    return logp, node_ids, fd


# kernel-against-plain shapes: (name, n_tips, patterns, categories); n_tips
# None is the fluA tree (69 taxa), else a balanced tree
SHAPES = [("fluA-69x256-C1", None, 256, 1),
          ("fluA-69x256-C4", None, 256, 4),
          ("balanced-128x16384-C4", 128, 16384, 4)]


def cuda_device():
    """The card, or exit 1 (no fallback to the CPU)."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        raise SystemExit(1)
    return torch.device("cuda", 0)


def main() -> int:
    # ---- 1. device
    dev = cuda_device()
    smi = nvidia_smi()
    emit("device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0])


    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32, "TF32 off")

    # ---- 2. build
    t0 = time.perf_counter()
    fused.build()
    build_s = time.perf_counter() - t0
    regs = [ln.strip() for ln in fused.build_log.splitlines()
            if "registers" in ln]
    emit("build", seconds=build_s, ptxas=regs)

    # ---- 3. kernel against plain, on the card
    flu_topo = load_fluA_time(torch.float64, "cpu").topo
    shapes = [(name, flu_topo if n is None else balanced_topology(n), P, C)
              for name, n, P, C in SHAPES]
    for dtype in (torch.float32, torch.float64):
        for name, topo, P, C in shapes:
            compare(name, topo, random_inputs(topo, P, C, 7, dtype,
                                                     dev), dtype)
            torch.cuda.synchronize()

    # ---- 4. checkpoint A on the card
    tlk64 = load_fluA_time(torch.float64, dev)
    params = {k: v.requires_grad_(True) for k, v in
              tlk64.param_space().init_params(dtype=torch.float64,
                                              device=dev).items()}
    logp64 = tlk64.log_likelihood_only(params)
    (g_rate,) = torch.autograd.grad(logp64, [params["rate"]])
    tlk32 = load_fluA_time(torch.float32, dev)
    logp32 = float(tlk32.log_likelihood_only(
        tlk32.param_space().init_params(dtype=torch.float32, device=dev)))
    torch.cuda.synchronize()
    logp64 = logp64.detach()
    rec = dict(logp_f64=float(logp64), rate_grad_f64=float(g_rate),
               logp_f64_err=float(logp64) - GOLDEN_LOGP,
               rate_grad_f64_rel_err=float(g_rate) / GOLDEN_RATE_GRAD - 1,
               logp_f32=logp32, logp_f32_drift=logp32 - GOLDEN_LOGP,
               tolerance=dict(logp_f64_atol=1e-8, rate_grad_f64_rtol=1e-8,
                              logp_f32_atol=F32_LOGP_ATOL))
    ok = (abs(rec["logp_f64_err"]) <= 1e-8
          and abs(rec["rate_grad_f64_rel_err"]) <= 1e-8
          and abs(rec["logp_f32_drift"]) <= F32_LOGP_ATOL)
    emit("checkpoint_a", ok=ok, **rec)
    check(ok, "checkpoint A on the card")

    # ---- 5. GTR+G4 fluA golden on the card (float64)
    gtr64 = load_gtrg4_fluA(torch.float64, dev)
    p64 = {k: v.requires_grad_(True) for k, v in gtr64.param_space(
    ).init_params(dtype=torch.float64, device=dev).items()}
    lp = gtr64.log_likelihood(p64)
    (g_dist,) = torch.autograd.grad(lp, [p64["tree.distances"]])
    torch.cuda.synchronize()
    logp_ref, node_ids, fd_ref = golden_lines()
    g_dist = g_dist.cpu().numpy()
    nonroot = [i for i in node_ids if i != gtr64.topo.root]
    fd_err = [abs(g_dist[i] - fd) - (5e-2 + 5e-4 * abs(fd))
              for i, fd in zip(nonroot, fd_ref)]
    lp = lp.detach()
    ok = bool(abs(float(lp) - logp_ref) <= 2e-8 + 5e-9 * abs(logp_ref)
              and len(nonroot) == len(fd_ref) and max(fd_err) <= 0)
    emit("gtrg4_fluA", ok=ok, logp=float(lp), logp_ref=logp_ref,
         logp_err=float(lp) - logp_ref, n_fd=len(fd_ref),
         worst_fd_margin=float(max(fd_err)),
         tolerance=dict(logp_rtol=5e-9, logp_atol=2e-8, fd_rtol=5e-4,
                        fd_atol=5e-2))
    check(ok, "GTR+G4 fluA golden on the card")

    # ---- 6. the main path: 20 Adam steps, GTR+G4 fluA, float32
    gtr32 = load_gtrg4_fluA(torch.float32, dev)
    space = gtr32.param_space()
    start = space.init_params(dtype=torch.float32, device=dev)
    fused.FORWARD_LAUNCHES = fused.BACKWARD_LAUNCHES = 0
    t0 = time.perf_counter()
    res = optimize_adam(gtr32.log_likelihood, space, start,
                        learning_rate=0.01, max_iter=20, patience=1000)
    torch.cuda.synchronize()
    adam_s = time.perf_counter() - t0
    launches = {"forward": fused.FORWARD_LAUNCHES,
                "backward": fused.BACKWARD_LAUNCHES}
    hist = res.history
    ok = bool(len(hist) == 20 and all(np.isfinite(hist))
              and hist[-1] > hist[0] and min(launches.values()) >= 20)
    emit("adam", ok=ok, steps=len(hist), logp_first=hist[0],
         logp_last=hist[-1], best_logp=res.logp, launches=launches,
         seconds=adam_s)
    check(ok, "20 Adam steps through the kernels with rising logP")

    # ---- 7. times
    times = {"card": smi}
    for name, topo, P, C in shapes[1:]:
        inputs = random_inputs(topo, P, C, 7, torch.float32, dev)
        times[name] = {
            "value_and_grad_kernel_ms": median_ms(lambda: value_and_grad(
                fused.fused_site_log, topo, *inputs)),
            "value_and_grad_plain_ms": median_ms(lambda: value_and_grad(
                fused.fused_site_log_reference, topo, *inputs)),
        }
    # each kernel alone at the main path's shapes (GTR+G4 fluA, float32)
    with torch.no_grad():
        rates, props = gtr32.site_model.rates_props(start)
        bl = gtr32.branch_lengths(start)
        pmats = gtr32.subst.p_t(start, bl[:, None] * rates[None, :])
        pmats = pmats.contiguous()
        freqs = gtr32.subst.frequencies(start)
    topo, tips = gtr32.topo, gtr32.tip_partials
    children = topo_constant(topo, "children", lambda: topo.children, tips,
                             torch.int32)
    rootw = (props[:, None] * freqs[None, :]).reshape(-1).contiguous()
    site_k, partials, scale = fused.pruning_forward(tips, pmats, children,
                                                    rootw)
    g = gtr32.weights
    dP_k, drootw_k = fused.pruning_backward(tips, pmats, children, rootw,
                                            partials, scale, g)
    leaves = [x.clone().requires_grad_(True) for x in (pmats, freqs, props)]
    site_graph = fused.fused_site_log_reference(tips, leaves[0], topo,
                                                leaves[1], leaves[2])
    dP_p, dfreqs_p, dprops_p = torch.autograd.grad(site_graph, leaves, g,
                                                   retain_graph=True)
    site_p = site_graph
    # d rootw -> d freqs, d props through rootw = props (x) freqs
    dr = drootw_k.view(-1, 4)
    dfreqs_k = (props[:, None] * dr).sum(0)
    dprops_k = (freqs[None, :] * dr).sum(1)
    site_p = site_p.detach()
    fwd_err = float((site_k - site_p).abs().max())
    bwd_err = max(float((a - b).abs().max()) for a, b in (
        (dP_k, dP_p), (dfreqs_k, dfreqs_p), (dprops_k, dprops_p)))
    tol = TOL[torch.float32]
    check(bool(torch.all((site_k - site_p).abs()
                         <= tol["site"] * (site_p.abs() + 0.2)))
          and all(max_err(a, b)[1] <= tol["grad"] for a, b in (
              (dP_k, dP_p), (dfreqs_k, dfreqs_p), (dprops_k, dprops_p))),
          "kernels against plain at the main path's shapes")
    ms = {
        "forward": median_ms(lambda: fused.pruning_forward(
            tips, pmats, children, rootw), reps=100),
        "backward": median_ms(lambda: fused.pruning_backward(
            tips, pmats, children, rootw, partials, scale, g), reps=100),
    }
    with torch.no_grad():
        plain_fwd = median_ms(lambda: fused.fused_site_log_reference(
            tips, pmats, topo, freqs, props), reps=100)
    plain_bwd = median_ms(lambda: torch.autograd.grad(
        site_graph, leaves, g, retain_graph=True), reps=100)
    n_steps = 50
    optimize_adam(gtr32.log_likelihood, space, start, learning_rate=0.01,
                  max_iter=3, patience=1000)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    optimize_adam(gtr32.log_likelihood, space, start, learning_rate=0.01,
                  max_iter=n_steps, patience=1000)
    torch.cuda.synchronize()
    times["adam_step_ms_gtrg4_fluA_f32"] = (time.perf_counter() - t0) \
        * 1e3 / n_steps
    times["kernel_alone_gtrg4_fluA_f32"] = {
        "forward_ms": ms["forward"], "forward_plain_ms": plain_fwd,
        "backward_ms": ms["backward"], "backward_plain_ms": plain_bwd}
    times["build_seconds"] = build_s
    emit("times", **times)

    src = "physher_tpu_torch/csrc/pruning.cu"
    print(json.dumps({"kernels": [
        {"name": "pruning_forward", "route": "cuda", "source": src,
         "replaces": "physher_tpu/ops/pallas_fused.py:245",
         "launches": launches["forward"], "max_abs_err": fwd_err,
         "ms": ms["forward"], "plain_ms": plain_fwd},
        {"name": "pruning_backward", "route": "cuda", "source": src,
         "replaces": "physher_tpu/ops/pallas_fused.py:390",
         "launches": launches["backward"], "max_abs_err": bwd_err,
         "ms": ms["backward"], "plain_ms": plain_bwd},
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
