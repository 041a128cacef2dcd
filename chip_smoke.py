"""On-card check of physher_tpu_torch: builds the CUDA pruning kernels from
this checkout, holds them against their plain PyTorch version, runs the
slices' main paths through them and times kernel against plain:

- nucleotide (K1'/K2', ``csrc/pruning.cu``): fluA likelihoods, gradients
  and the GTR+G4 golden, and Adam steps of GTR+G4 fluA through the pair
  that ``select_engine`` picks;
- codon and protein (K7'/K8', ``csrc/wide.cu``): the libphyc and WAG
  goldens, a GY94 M0 fit to data simulated on the card at 32 taxa x 4096
  codons, and Adam steps of WAG+G4 at 64 taxa x 8192 patterns; K7' and K8'
  (redesigned around K5''s and K6''s node steps, ``csrc/wide_forward.cuh``
  and ``csrc/wide_backward.cuh``) also on one small case per tile shape and
  cluster size and a WAG tree with polytomies, K8' twice on the same
  inputs (bit for bit), with its registers, spills and dP scratch;
- large nucleotide alignments (K3'/K4', ``csrc/staged.cu``) and the
  JSON-config CLI: checkpoint A and the GTR+G4 golden through K3'/K4',
  the reference's fluA ADVI config to checkpoint B (through K1'/K2'), and
  ADVI and ML of a GTR+G4 config on 128 taxa x about 16 000 patterns
  simulated on the card (through K3'/K4');
- MCMC and marginal likelihood over a batch of chains (K5'/K6',
  ``csrc/loop.cu``): the kernels against plain on chains of the fluA
  models and on a fluA tree with polytomies, mmcmc (16 temperatures as one
  batch) and marginallikelihood through the CLI on the checkpoint B model,
  mcmc with 8 chains and its loggers on GTR+G4 fluA, and HMC on the
  checkpoint B model;
- codon and protein MCMC over a batch of chains (K5'/K6' at S != 4, the
  same ``csrc/loop.cu``): the kernels against plain on chains of GY94 M0 at
  32 taxa x 4096 codons, WAG+G4 at 64 taxa x 8192 patterns and a WAG tree
  with polytomies, mcmc with 8 chains through the CLI on a GY94 config over
  data simulated on the card, HMC with 4 chains on WAG+G4 through the API,
  and the config engine names pallas-fused and pallas-loop on the card;
  K5' and K6' at S != 4 also on one small case per instantiation and
  cluster size; K6', K5' and K7' twice on the same inputs (bit for bit; the
  forward's rescaled partials peaking at exactly 1), with their registers,
  spills and the most clusters of K5' and K7' resident at once.

    python3 chip_smoke.py

Needs one NVIDIA GPU (sm_90a) and nvcc; exits non-zero without them or on
any failed phase. Each phase prints one JSON line; the line before the last
is the card's name and power limit from nvidia-smi, and the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import time
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

import physher_tpu_torch  # noqa: F401  (sets the TF32 policy)
from physher_tpu_torch import cli
from physher_tpu_torch.data.distance import distance_matrix
from physher_tpu_torch.data.sitepattern import SitePattern
from physher_tpu_torch.inference.ml import optimize_adam
from physher_tpu_torch.io.seqio import read_alignment
from physher_tpu_torch.io.treeio import read_newick
from physher_tpu_torch.likelihood.analysis import simulate_alignment
from physher_tpu_torch.models.clock import StrictClock
from physher_tpu_torch.models.codon import GY94, MG94
from physher_tpu_torch.models.protein import WAG
from physher_tpu_torch.models.sitemodel import (
    ConstantSiteModel, GammaSiteModel)
from physher_tpu_torch.models.substitution import GTR, JC69
from physher_tpu_torch.models.treelikelihood import TreeLikelihood
from physher_tpu_torch.ops import cuda_build, fused, loop, staged, wide
from physher_tpu_torch.trees.build import nj
from physher_tpu_torch.trees.heights import topo_constant
from physher_tpu_torch.trees.timetree import TimeTreeData
from physher_tpu_torch.utils.synthetic import (
    balanced_topology, caterpillar_topology, random_sitepattern)

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
# codon and protein goldens in float64: libphyc's GY94 / MG94 logP on
# codon_small (tests/data/goldens/codon_small.txt) at rtol 5e-9 / atol 1e-7,
# and WAG on tiny_aa (tests/data/goldens/wag.json) at atol 1e-8, the
# tolerances of tests/test_codon_protein.py
WAG_GOLDEN_LOGP = -1297.2958256864874
# the GY94 M0 fit: simulated kappa 2, omega 0.2; recovered within these
M0_TRUTH = {"kappa": 2.0, "omega": 0.2}
M0_ATOL = {"kappa": 0.5, "omega": 0.05}
# the NVIDIA H100 SXM's published peaks (at 700 W): device-memory bandwidth
# and the float32 rate of the CUDA cores; the kernels' bounds use them
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12


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


def random_inputs(topo, P, C, seed, dtype, device, datatype="nucleotide"):
    """Tips [T,S,P] of random states, row-stochastic pmats [N,C,S,S],
    freqs, props, pattern weights (numpy seed)."""

    sp = random_sitepattern(topo.T, P, seed=seed, datatype=datatype)
    S = sp.datatype.state_count
    rng = np.random.default_rng(seed)
    Q = rng.random((topo.N, C, S, S)) + 0.1
    freqs = (np.asarray([0.3, 0.2, 0.25, 0.25]) if S == 4
             else rng.dirichlet(np.full(S, 5.0)))
    arrays = (sp.tip_partials(), Q / Q.sum(-1, keepdims=True), freqs,
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


# each kernel module's entry point and its plain version
SITE_LOG = {fused: (fused.fused_site_log, fused.fused_site_log_reference),
            staged: (staged.staged_site_log,
                     staged.staged_site_log_reference),
            wide: (wide.wide_site_log, wide.wide_site_log_reference)}


def compare(name, topo, inputs, dtype, mod=fused, phase="kernel_vs_plain"):
    """Kernel against plain on one shape (``mod`` is ops.fused, ops.staged
    or ops.wide); returns the error record."""
    tol = TOL[dtype]
    kernel, plain = SITE_LOG[mod]
    k = value_and_grad(kernel, topo, *inputs)
    p = value_and_grad(plain, topo, *inputs)
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
    emit(phase, **rec)
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


def codon_small(model, dtype, device):
    """GY94 or MG94 on codon_small at the golden's parameters; returns
    (model, params, golden logP)."""
    seqs = read_alignment(str(DATA / "codon_small.fa"))
    topo, dist = read_newick((DATA / "codon_small.nwk").read_text().strip())
    sp = SitePattern.from_alignment(seqs, "codon")
    golden = (DATA / "goldens" / "codon_small.txt").read_text()
    maker, values = {"gy94": (GY94, {"kappa": 2.5, "omega": 0.3}),
                     "mg94": (MG94, {"alpha": 1.0, "beta": 0.4,
                                     "kappa": 2.0})}[model]
    logp = next(float(ln.split()[-1]) for ln in golden.splitlines()
                if ln.startswith(model + " "))
    kw = dict(dtype=dtype, device=device)
    tlk = TreeLikelihood(sp, topo, maker(fixed_freqs=True, **kw),
                         distances_init=dist, **kw)
    params = tlk.param_space().init_params(**kw)
    params.update({k: torch.tensor(v, **kw) for k, v in values.items()})
    return tlk, params, logp


def wag_tiny_aa(dtype, device):
    """The WAG golden's model as tests/data/goldens/wag.json builds it: NJ
    over Kimura distances (the port's own), tip states on."""
    sp = SitePattern.from_alignment(read_alignment(str(DATA / "tiny_aa.fa")),
                                    "aa")
    topo, dist = nj(sp.taxa, distance_matrix(sp, "kimura"))
    kw = dict(dtype=dtype, device=device)
    return TreeLikelihood(sp, topo, WAG(**kw),
                          distances_init=np.nan_to_num(dist[: topo.N - 1],
                                                       nan=0.1),
                          tipstates=True, **kw)


def wag_g4_large(dtype, device):
    """WAG+G4 at the JAX package's benchmark size (bench.py): a balanced
    64-taxon tree, 8192 random amino-acid patterns."""
    sp = random_sitepattern(64, 8192, seed=9, datatype="aminoacid")
    kw = dict(dtype=dtype, device=device)
    return TreeLikelihood(sp, balanced_topology(64), WAG(**kw),
                          GammaSiteModel(4, prefix="sitemodel.", **kw), **kw)


def gy94_m0_fit_model(dtype, device, seed=11):
    """GY94 M0 data simulated on the card (kappa 2, omega 0.2, fixed
    frequencies, branch lengths 0.3) on a balanced 32-taxon tree, 4096
    codons, and the model that fits it."""
    kw = dict(dtype=dtype, device=device)
    topo = balanced_topology(32)
    subst = GY94(fixed_freqs=True, **kw)
    params = subst.param_space().init_params(**kw)
    params.update({k: torch.tensor(v, **kw) for k, v in M0_TRUTH.items()})
    bl = np.full(topo.N, 0.3)
    bl[topo.root] = 0.0
    gen = torch.Generator(device=device).manual_seed(seed)
    seqs = simulate_alignment(gen, topo, subst, ConstantSiteModel(**kw),
                              params, bl, 4096, datatype="codon")
    sp = SitePattern.from_alignment(seqs, "codon")
    return TreeLikelihood(sp, topo, GY94(fixed_freqs=True, **kw),
                          distances_init=np.full(topo.N - 1, 0.3), **kw)


def engine_inputs(tlk, params):
    """(tips, pmats, freqs, props, weights) of a model at ``params``, as its
    engine gets them, detached; for a batch of parameter dicts, pmats
    [L, N, C, S, S], freqs [L, S] and props [L, C]."""
    with torch.no_grad():
        rates, props = tlk.site_model.rates_props(params)
        bl = tlk.branch_lengths(params)
        pmats = tlk.subst.p_t(params, bl[..., :, None] * rates[..., None, :])
        freqs = tlk.subst.frequencies(params)
    if bl.dim() == 2:
        freqs = freqs.expand(bl.shape[0], -1)
        props = props.expand(bl.shape[0], -1)
    return (tlk.tip_partials, pmats.to(tlk.dtype).contiguous(),
            freqs.to(tlk.dtype).contiguous(),
            props.to(tlk.dtype).contiguous(), tlk.weights)


def chain_params(tlk, L, seed, scale=0.05):
    """A batch of L parameter dicts around the model's initial values (numpy
    noise of sd ``scale`` in the unconstrained space)."""
    space = tlk.param_space()
    kw = dict(dtype=tlk.dtype, device=tlk.tip_partials.device)
    with torch.no_grad():
        u0 = space.flatten_unconstrained(space.unconstrain(
            space.init_params(**kw)))
        noise = np.random.default_rng(seed).normal(0.0, scale, (L, len(u0)))
        return space.constrain(space.unflatten_unconstrained(
            u0 + torch.as_tensor(noise, **kw)))


def random_chains(topo, P, C, L, seed, dtype, device, S=4):
    """Random one-hot tips [T,S,P] and L chains' row-stochastic pmats
    [L,N,C,S,S], freqs [L,S], props [L,C], and a cotangent [L,P] (numpy
    seed)."""
    rng = np.random.default_rng(seed)
    tips = np.eye(S)[rng.integers(0, S, (topo.T, P))].transpose(0, 2, 1)
    Q = rng.random((L, topo.N, C, S, S)) + 0.1
    arrays = (tips, Q / Q.sum(-1, keepdims=True),
              rng.dirichlet(np.full(S, 5.0), L),
              rng.dirichlet(np.full(C, 5.0), L), rng.uniform(0.5, 2.0, (L, P)))
    return [torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                            device=device) for a in arrays]


def collapsed_topology(topo, every=7):
    """``topo`` with the branch above every ``every``-th non-root internal
    node collapsed: its children hang from its parent, so the tree has
    polytomies."""
    from physher_tpu_torch.trees.topology import Topology

    T = topo.T
    gone = {T + k for k in range(0, topo.I - 1, every)}

    def nested(node):
        if node < T:
            return {"name": topo.taxa[node], "length": 0.1, "children": []}
        kids = []
        for ch in topo.children[node - T, : topo.child_count[node - T]]:
            sub = nested(int(ch))
            kids += sub["children"] if int(ch) in gone else [sub]
        return {"name": None, "length": 0.1, "children": kids}
    return Topology.from_nested(nested(topo.root))[0]


# each kernel module's launch wrappers (forward, backward); the staged and
# wide ones take the level schedule after rootw
WRAPPERS = {fused: (fused.pruning_forward, fused.pruning_backward),
            staged: (staged.staged_forward, staged.staged_backward),
            wide: (wide.wide_forward, wide.wide_backward)}


def pruning_work(backward, T, I, C, S, maxc, P, itemsize):
    """(bytes, FLOPs) of one forward or backward sweep: each input read once
    and each output written once (forward: tips, pmats, rootw, children in;
    partials, scalers, site logs out; backward: tips, pmats, rootw,
    children, partials, scalers, cotangent in; d pmats, d rootw out), and
    2 S^2 + S operations per (branch, category, pattern) forward; backward
    6 S^2 + S above an internal node (the sibling's product again, the dP
    outer product, the child's cotangent) and 4 S^2 + S above a tip, which
    takes no cotangent; plus the rescaling and the root."""
    N = T + I
    pm, parts = N * C * S * S, I * C * S * P
    if backward:
        n = T * S * P + pm + C * S + parts + I * P + P + pm + C * S
        flops = P * (C * ((I - 1) * (6 * S * S + S) + T * (4 * S * S + S))
                     + 4 * C * S)
    else:
        n = T * S * P + pm + C * S + parts + I * P + P
        flops = P * ((N - 1) * C * (2 * S * S + S) + I * 2 * C * S
                     + 2 * C * S)
    return n * itemsize + 4 * I * (maxc + 1), flops


def bound(nbytes, flops):
    """(bound ms, "bytes" or "operations") on the NVIDIA H100 SXM."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernels_alone(mod, topo, tips, pmats, freqs, props, g):
    """Each kernel of ``mod`` (ops.fused, ops.staged or ops.wide) alone
    against the plain version on one model's inputs: max abs errors, median
    times and the bounds."""
    T, S, P = tips.shape
    children = topo_constant(topo, "children", lambda: topo.children, tips,
                             torch.int32)
    rootw = (props[:, None] * freqs[None, :]).reshape(-1).contiguous()
    forward, backward = WRAPPERS[mod]
    schedule = cuda_build.level_schedule(topo, tips)
    extra = () if mod is fused else (schedule,)

    def fwd():
        return forward(tips, pmats, children, rootw, *extra)

    def bwd(partials, scale):
        return backward(tips, pmats, children, rootw, *extra, partials,
                        scale, g)
    reference = SITE_LOG[mod][1]
    site_k, partials, scale = fwd()
    dP_k, drootw_k = bwd(partials, scale)
    leaves = [x.clone().requires_grad_(True) for x in (pmats, freqs, props)]
    site_graph = reference(tips, leaves[0], topo, leaves[1], leaves[2])
    grads_p = torch.autograd.grad(site_graph, leaves, g, retain_graph=True)
    # d rootw -> d freqs, d props through rootw = props (x) freqs
    dr = drootw_k.view(-1, S)
    grads_k = (dP_k, (props[:, None] * dr).sum(0), (freqs[None, :] * dr).sum(1))
    site_p = site_graph.detach()
    tol = TOL[tips.dtype]
    check(bool(torch.all((site_k - site_p).abs()
                         <= tol["site"] * (site_p.abs() + 0.2)))
          and all(max_err(a, b)[1] <= tol["grad"]
                  for a, b in zip(grads_k, grads_p)),
          f"{mod.__name__} kernels against plain at a main path's shapes")
    rec = {
        "forward_err": float((site_k - site_p).abs().max()),
        "backward_err": max(max_err(a, b)[0]
                            for a, b in zip(grads_k, grads_p)),
        "forward_ms": median_ms(fwd, reps=100),
        "backward_ms": median_ms(lambda: bwd(partials, scale), reps=100),
    }
    with torch.no_grad():
        rec["forward_plain_ms"] = median_ms(lambda: reference(
            tips, pmats, topo, freqs, props), reps=100)
    rec["backward_plain_ms"] = median_ms(lambda: torch.autograd.grad(
        site_graph, leaves, g, retain_graph=True), reps=100)
    dims = (T, topo.I, pmats.shape[1], S, children.shape[1], P,
            tips.element_size())
    for kind, is_bwd in (("forward", False), ("backward", True)):
        ms, by = bound(*pruning_work(is_bwd, *dims))
        rec[f"{kind}_bound_ms"], rec[f"{kind}_bound_by"] = ms, by
    return rec


def loop_work(backward, T, I, C, S, maxc, P, L, itemsize):
    """(bytes, FLOPs) of one K5' or K6' launch over L chains: the function of
    the TPU loop kernel, which writes no partials (forward: tips once, and
    per chain pmats, freqs, props in, site logs out; backward: the same
    inputs and the cotangent in, d pmats, d freqs, d props out), and per
    chain the operations of :func:`pruning_work`."""
    N = T + I
    per_chain = N * C * S * S + S + C
    n = T * S * P + L * (per_chain + (P if backward else 0)
                         + (per_chain if backward else P))
    one = pruning_work(backward, T, I, C, S, maxc, P, itemsize)[1]
    return n * itemsize + 4 * I * maxc, L * one


# K5'/K6' against plain: logL relative to |logL| and gradients relative to
# their largest entry (float64: rounding only; float32: 24-bit products
# over 137 nodes and 238 weighted sites)
LOOP_TOL = {torch.float64: dict(logl=1e-12, grad=1e-12),
            torch.float32: dict(logl=1e-5, grad=1e-4)}


def loop_alone(name, topo, tips, pmats, freqs, props, g, rescale=True,
               timed=False, tol=None, phase="loop_kernel_vs_plain"):
    """K5'/K6' against the plain version on one batch of chains; logL is
    ``sum(g * site_log)`` per chain, held to ``tol`` (LOOP_TOL; with a
    "site" entry, the site logs too, as :func:`compare` holds them). With
    ``timed``, the median times (CUDA events) of each kernel (100 runs) and
    of the plain version (20), and the bounds."""
    children = topo_constant(topo, "children", lambda: topo.children, tips,
                             torch.int32)

    def fwd():
        return loop.loop_forward(tips, pmats, children, freqs, props,
                                 rescale)
    site_k, partials, scale = fwd()

    def bwd():
        return loop.loop_backward(tips, pmats, children, freqs, props,
                                  partials, scale, g)
    grads_k = bwd()
    leaves = [x.clone().requires_grad_(True) for x in (pmats, freqs, props)]
    site_graph = loop.loop_site_log_reference(tips, leaves[0], topo,
                                              leaves[1], leaves[2],
                                              rescale=rescale)
    grads_p = torch.autograd.grad(site_graph, leaves, g, retain_graph=True)
    site_p = site_graph.detach()
    torch.cuda.synchronize()
    tol = tol or LOOP_TOL[tips.dtype]
    logl_k, logl_p = (g * site_k).sum(-1), (g * site_p).sum(-1)
    rec = {"shape": name, "dtype": str(tips.dtype).replace("torch.", ""),
           "chains": pmats.shape[0], "categories": pmats.shape[2],
           "max_children": int(children.shape[1]), "rescale": rescale,
           "logl_rel_err": float(((logl_k - logl_p).abs()
                                  / logl_p.abs()).max()),
           "forward_err": float((site_k - site_p).abs().max()),
           "backward_err": max(max_err(a, b)[0]
                               for a, b in zip(grads_k, grads_p)),
           "grad_rel_err": max(max_err(a, b)[1]
                               for a, b in zip(grads_k, grads_p)),
           "tolerance": tol}
    rec["ok"] = bool(rec["logl_rel_err"] <= tol["logl"]
                     and rec["grad_rel_err"] <= tol["grad"]
                     and all(bool(torch.isfinite(a).all()) for a in grads_k))
    if "site" in tol:
        rec["ok"] = rec["ok"] and bool(torch.all(
            (site_k - site_p).abs() <= tol["site"] * (site_p.abs() + 0.2)))
    if timed:
        rec["forward_ms"] = median_ms(fwd, reps=100)
        rec["backward_ms"] = median_ms(bwd, reps=100)
        with torch.no_grad():
            rec["forward_plain_ms"] = median_ms(
                lambda: loop.loop_site_log_reference(
                    tips, pmats, topo, freqs, props, rescale=rescale),
                reps=20)
        rec["backward_plain_ms"] = median_ms(lambda: torch.autograd.grad(
            site_graph, leaves, g, retain_graph=True), reps=20)
        dims = (tips.shape[0], topo.I, pmats.shape[2], tips.shape[1],
                children.shape[1], tips.shape[2], pmats.shape[0],
                tips.element_size())
        for kind, is_bwd in (("forward", False), ("backward", True)):
            ms, by = bound(*loop_work(is_bwd, *dims))
            rec[f"{kind}_bound_ms"], rec[f"{kind}_bound_by"] = ms, by
    emit(phase, **rec)
    check(rec["ok"], f"K5'/K6' against plain on {name} {rec['dtype']} "
                     f"rescale={rescale}")
    return rec


# (S, C) of the small K6' and K8' cases: with the main paths' shapes (S = 20
# and 61), one for each tile shape of their shared node step
# (csrc/wide_backward.cuh; A rows a thread: 2 to 16 at S <= 32, 5 to 8
# above)
WIDE_BUCKET_S = [(2, 1), (8, 2), (12, 8), (16, 1), (24, 2), (28, 1),
                 (32, 1), (33, 2), (48, 1), (56, 2), (64, 1)]
# (S, C) of the small K5' and K7' cases beside those: their forward node
# step (csrc/wide_forward.cuh) has the same instantiations, and launches the
# C category blocks as one thread-block cluster; these take the cluster
# sizes the cases above do not (3, 5, 6, 7) on both step shapes
FORWARD_CLUSTER_S = [(12, 3), (20, 5), (24, 6), (28, 7), (40, 3), (61, 7)]


def wide_dp_scratch_bytes(topo, tips, pmats):
    """Bytes of K6''s per-(chain, block) dP scratch at S != 4: L x
    ceil(P / WIDE_BACKWARD_BLOCK) x N x C x S^2 scalars."""
    L, N, C, S = pmats.shape[:4]
    nb = -(-tips.shape[2] // loop.WIDE_BACKWARD_BLOCK)
    return L * nb * N * C * S * S * tips.element_size()


def k8_dp_scratch_bytes(tips, pmats):
    """Bytes of K8''s per-block dP scratch: ceil(P / its pattern block) x N
    x C x S^2 scalars."""
    N, C, S = pmats.shape[:3]
    nb = -(-tips.shape[2] // wide.BWD_PATTERNS)
    return nb * N * C * S * S * tips.element_size()


def bit_identical(run) -> bool:
    """``run()`` twice: bit-identical tensors."""
    runs = [run() for _ in range(2)]
    torch.cuda.synchronize()
    return all(torch.equal(a, b) for a, b in zip(*runs))


def k6_deterministic(topo, tips, pmats, freqs, props, g) -> bool:
    """K6' twice on the same inputs: bit-identical d pmats, d freqs and
    d props."""
    children = topo_constant(topo, "children", lambda: topo.children, tips,
                             torch.int32)
    _, partials, scale = loop.loop_forward(tips, pmats, children, freqs,
                                           props)
    g = g.contiguous()
    return bit_identical(lambda: loop.loop_backward(
        tips, pmats, children, freqs, props, partials, scale, g))


def k8_deterministic(topo, tips, pmats, freqs, props, g) -> bool:
    """K8' twice on the same inputs: bit-identical d pmats and d rootw."""
    children = topo_constant(topo, "children", lambda: topo.children, tips,
                             torch.int32)
    rootw = (props[:, None] * freqs[None, :]).reshape(-1).contiguous()
    schedule = cuda_build.level_schedule(topo, tips)
    _, partials, scale = wide.wide_forward(tips, pmats, children, rootw,
                                           schedule)
    g = g.contiguous()
    return bit_identical(lambda: wide.wide_backward(
        tips, pmats, children, rootw, schedule, partials, scale, g))


def forward_checks(topo, tips, pmats, freqs, props) -> dict:
    """K5' at S != 4 (``pmats [L, N, C, S, S]``) and K7' (on chain 0), each
    twice on the same inputs: bit-identical site logs, partials and
    scalers, and rescaled partials that peak at exactly 1 over (C, S) at
    every node and pattern (x / max x: the cluster's blocks met)."""
    children = topo_constant(topo, "children", lambda: topo.children, tips,
                             torch.int32)
    rootw = (props[0][:, None] * freqs[0][None, :]).reshape(-1).contiguous()
    schedule = cuda_build.level_schedule(topo, tips)
    out = {}
    for name, run, dims in (
            ("k5", lambda: loop.loop_forward(tips, pmats, children, freqs,
                                             props), (2, 3)),
            ("k7", lambda: wide.wide_forward(tips, pmats[0].contiguous(),
                                             children, rootw, schedule),
             (1, 2))):
        runs = [run() for _ in range(2)]
        torch.cuda.synchronize()
        out[f"{name}_bit_identical"] = all(
            torch.equal(a, b) for a, b in zip(*runs))
        out[f"{name}_partials_peak_1"] = bool(
            torch.all(runs[0][1].amax(dims) == 1))
    return out


def cluster_occupancy() -> dict:
    """The most clusters of K5' and K7' resident at once, float32, at the
    main paths' S and C = 4 and 8."""
    return {f"{name}_S{S}_C{C}": fn(torch.float32, S, C)
            for name, fn in (("k5", loop.wide_forward_clusters),
                             ("k7", wide.forward_clusters))
            for S in (20, 61) for C in (4, 8)}


def adam_step_ms(tlk, params, n_steps=20, lr=0.01):
    """Mean host time of one Adam step (after 3 warm-up steps)."""
    space = tlk.param_space()
    optimize_adam(tlk.log_likelihood, space, params, learning_rate=lr,
                  max_iter=3, patience=1000)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    optimize_adam(tlk.log_likelihood, space, params, learning_rate=lr,
                  max_iter=n_steps, patience=1000)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n_steps


def timed_build(mod):
    t0 = time.perf_counter()
    mod.build()
    return time.perf_counter() - t0


def ptxas_lines(log: str) -> list:
    return [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln]


def ptxas_by_kernel(log: str, part: str) -> dict:
    """nvcc -Xptxas -v's register and spill lines of each kernel whose
    (mangled) name contains ``part``."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)'?", ln)
        if m:
            name = m.group(1)
        elif name and part in name and ("registers" in ln or "spill" in ln):
            out.setdefault(name, []).append(ln.strip())
    return out


# kernel-against-plain shapes: (name, n_tips, patterns, categories); n_tips
# None is the fluA tree (69 taxa), else a balanced tree
SHAPES = [("fluA-69x256-C1", None, 256, 1),
          ("fluA-69x256-C4", None, 256, 4),
          ("balanced-128x16384-C4", 128, 16384, 4)]
# the wide kernels' shapes: (name, topology, patterns, categories, datatype,
# seed); GY94 M0 and WAG+G4 at the JAX package's benchmark sizes
# (bench.py), and a caterpillar, the deepest tree
WIDE_SHAPES = [
    ("codon-GY94-32x4096-C1", lambda: balanced_topology(32), 4096, 1,
     "codon", 5),
    ("wag-64x8192-C4", lambda: balanced_topology(64), 8192, 4, "aminoacid",
     9),
    ("codon-caterpillar-32x1024-C1", lambda: caterpillar_topology(32), 1024,
     1, "codon", 5),
]


# K3'/K4' against plain: (name, topology, patterns, categories): the JAX
# package's large shape, a caterpillar (one node per level, the prototype
# K9's many-step case) and a ragged pattern count
STAGED_SHAPES = [
    ("balanced-128x16384-C4", lambda: balanced_topology(128), 16384, 4),
    ("caterpillar-64x8192-C4", lambda: caterpillar_topology(64), 8192, 4),
    ("balanced-128x8229-C4", lambda: balanced_topology(128), 8192 + 37, 4),
]


def cuda_device():
    """The card, or exit 1 (no fallback to the CPU)."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        raise SystemExit(1)
    return torch.device("cuda", 0)


def checkpoint_a(dev, engine="auto", phase="checkpoint_a"):
    """Checkpoint A on the card: JC69 strict-clock fluA logP and
    d logP / d rate in float64 (and the float32 drift)."""
    tlk64 = load_fluA_time(torch.float64, dev)
    tlk64.engine = engine
    params = {k: v.requires_grad_(True) for k, v in
              tlk64.param_space().init_params(dtype=torch.float64,
                                              device=dev).items()}
    logp64 = tlk64.log_likelihood_only(params)
    (g_rate,) = torch.autograd.grad(logp64, [params["rate"]])
    tlk32 = load_fluA_time(torch.float32, dev)
    tlk32.engine = engine
    logp32 = float(tlk32.log_likelihood_only(
        tlk32.param_space().init_params(dtype=torch.float32, device=dev)))
    torch.cuda.synchronize()
    logp64 = logp64.detach()
    rec = dict(engine=tlk64.engine_name(), logp_f64=float(logp64),
               rate_grad_f64=float(g_rate),
               logp_f64_err=float(logp64) - GOLDEN_LOGP,
               rate_grad_f64_rel_err=float(g_rate) / GOLDEN_RATE_GRAD - 1,
               logp_f32=logp32, logp_f32_drift=logp32 - GOLDEN_LOGP,
               tolerance=dict(logp_f64_atol=1e-8, rate_grad_f64_rtol=1e-8,
                              logp_f32_atol=F32_LOGP_ATOL))
    ok = (abs(rec["logp_f64_err"]) <= 1e-8
          and abs(rec["rate_grad_f64_rel_err"]) <= 1e-8
          and abs(rec["logp_f32_drift"]) <= F32_LOGP_ATOL
          and (engine == "auto" or rec["engine"] == engine))
    emit(phase, ok=ok, **rec)
    check(ok, f"checkpoint A on the card ({rec['engine']})")


def gtrg4_golden(dev, engine="auto", phase="gtrg4_fluA"):
    """The GTR+G4 fluA golden in float64: logP and the branch gradients
    against the reference's finite differences."""
    gtr64 = load_gtrg4_fluA(torch.float64, dev)
    gtr64.engine = engine
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
              and len(nonroot) == len(fd_ref) and max(fd_err) <= 0
              and (engine == "auto" or gtr64.engine_name() == engine))
    emit(phase, ok=ok, engine=gtr64.engine_name(), logp=float(lp),
         logp_ref=logp_ref, logp_err=float(lp) - logp_ref, n_fd=len(fd_ref),
         worst_fd_margin=float(max(fd_err)),
         tolerance=dict(logp_rtol=5e-9, logp_atol=2e-8, fd_rtol=5e-4,
                        fd_atol=5e-2))
    check(ok, f"GTR+G4 fluA golden on the card ({gtr64.engine_name()})")


def random_dated_tree(n_tips: int, seed: int):
    """A random binary tree over ``n_tips`` tips sampled across 20 years:
    random pairs of lineages merge, each parent 0.1-5 years (uniform) above
    its older child. Returns (newick with branch lengths in years,
    {taxon: date})."""
    rng = np.random.default_rng(seed)
    tip_h = rng.uniform(0.0, 20.0, n_tips)
    active = [(f"t{i}", h) for i, h in enumerate(tip_h)]
    while len(active) > 1:
        i, j = sorted(rng.choice(len(active), 2, replace=False))
        (a, ha), (b, hb) = active[i], active[j]
        h = max(ha, hb) + rng.uniform(0.1, 5.0)
        del active[j], active[i]
        active.append((f"({a}:{h - ha:.9f},{b}:{h - hb:.9f})", h))
    return active[0][0] + ";", {f"t{i}": 2020.0 - h
                                 for i, h in enumerate(tip_h)}


# the simulation's truth: GTR exchangeabilities (AC, AG, AT, CG, CT, GT),
# frequencies, Gamma shape and clock rate (substitutions per site per year)
LARGE_TRUTH = dict(rates=[1.0, 3.0, 0.8, 1.2, 3.5, 1.0],
                   freqs=[0.3, 0.2, 0.22, 0.28], shape=0.8, rate=4e-3)


def large_config(workdir: Path, n_tips: int, n_sites: int, dev,
                 seed: int = 13):
    """Simulate a GTR+G4 alignment down a random dated tree on ``dev`` and
    write it as FASTA with a config that mirrors tests/data/fluA-elbo.json:
    GTR+G4, a strict clock on a time tree, a constant coalescent, oneonx
    and ctmcscale priors, mean-field blocks; action: 200 steps of ADVI.
    Returns (config path, pattern count)."""
    from physher_tpu_torch.io.seqio import write_fasta

    newick, dates = random_dated_tree(n_tips, seed)
    topo, dist = read_newick(newick)
    kw = dict(dtype=torch.float64, device=dev)
    t = LARGE_TRUTH
    subst = GTR(rates_init=np.asarray(t["rates"]) / sum(t["rates"]),
                freqs_init=t["freqs"], **kw)
    site = GammaSiteModel(4, shape_init=t["shape"], **kw)
    params = {**subst.param_space().init_params(**kw),
              **site.param_space().init_params(**kw)}
    bl = np.nan_to_num(dist, nan=0.0) * t["rate"]
    gen = torch.Generator(device=dev).manual_seed(seed)
    seqs = simulate_alignment(gen, topo, subst, site, params, bl, n_sites)
    n_patterns = SitePattern.from_alignment(seqs).pattern_count
    write_fasta(seqs, str(workdir / "large.fa"))

    def param(pid, value, lower=None):
        out = {"id": pid, "type": "parameter", "value": value}
        if lower is not None:
            out["lower"] = lower
        return out

    cfg = {
        "rates": {"id": "rates", "type": "simplex",
                  "values": [1.0] * 6},
        "model": {"id": "posterior", "type": "compound", "distributions": [
            {"id": "treelikelihood", "type": "treelikelihood",
             "include_jacobian": True, "tipstates": False,
             "sitepattern": {"id": "patterns", "type": "sitepattern",
                             "datatype": "nucleotide",
                             "alignment": {"id": "seqs", "type": "alignment",
                                           "file": "large.fa"}},
             "sitemodel": {
                 "id": "sitemodel", "type": "sitemodel",
                 "distribution": {"distribution": "gamma", "categories": 4,
                                  "parameters": {"alpha": param(
                                      "alpha", 0.5, 0)}},
                 "substitutionmodel": {
                     "id": "sm", "type": "substitutionmodel",
                     "model": "gtr", "datatype": "nucleotide",
                     "rates": "$rates",
                     "frequencies": {"id": "freqs", "type": "Simplex",
                                     "values": [0.25] * 4}}},
             "tree": {"id": "tree", "type": "tree", "time": True,
                      "newick": newick, "dates": dates,
                      "reparam": "tree.scalers"},
             "branchmodel": {"id": "bm", "type": "branchmodel",
                             "model": "strict", "tree": "&tree",
                             "rate": param("rate", 1e-3, 0)}},
            {"id": "prior", "type": "compound", "distributions": [
                {"id": "coalescent", "type": "coalescent",
                 "model": "constant",
                 "parameters": {"n0": param("n0", 10.0, 0)},
                 "tree": "&tree"},
                {"id": "priortheta", "type": "distribution",
                 "distribution": "oneonx", "x": "&n0"},
                {"id": "priorrate", "type": "distribution",
                 "distribution": "ctmcscale", "x": "&rate",
                 "tree": "&tree"}]}]},
        "varmodel": {"id": "varnormal", "type": "variational",
                     "posterior": "&posterior", "elbosamples": 100,
                     "gradsamples": 1, "distributions": [
                         {"id": "block1", "type": "block",
                          "distribution": "normal", "x": "%tree.scalers",
                          "initialize": True},
                         {"id": "block2", "type": "block",
                          "distribution": "normal", "x": "&n0",
                          "parameters": {"sigma": param("sigma.theta", 0.13,
                                                        0)}},
                         {"id": "block3", "type": "block",
                          "distribution": "normal", "x": "&rate",
                          "initialize": True,
                          "parameters": {"sigma": param("sigma.rate", 0.07,
                                                        0)}}]},
        "physher": [
            {"id": "vb", "type": "optimizer", "algorithm": "sg",
             "model": "&varnormal", "eta": 0.1, "tol": 1e-5, "max": 200},
        ],
    }
    path = workdir / "large.json"
    path.write_text(json.dumps(cfg, indent=1))
    return path, n_patterns


def run_cli(argv):
    """The port's CLI in-process: (runner, printed lines)."""
    import io

    out = io.StringIO()
    runner = cli.run([str(a) for a in argv], out=out)
    torch.cuda.synchronize()
    return runner, out.getvalue().splitlines()


def cli_checkpoint_b(dev):
    """The reference's fluA ADVI config as it stands, through the CLI on the
    card in float32 (K1'/K2'): the final ELBO within 1.5 nats of
    checkpoint B."""
    golden = json.loads((DATA / "goldens" / "fluA_elbo.json").read_text())
    fused.FORWARD_LAUNCHES = fused.BACKWARD_LAUNCHES = 0
    staged.STAGED_FORWARD_LAUNCHES = staged.STAGED_BACKWARD_LAUNCHES = 0
    t0 = time.perf_counter()
    runner, lines = run_cli([DATA / "fluA-elbo.json"])
    wall = time.perf_counter() - t0
    launches = {"fused_forward": fused.FORWARD_LAUNCHES,
                "fused_backward": fused.BACKWARD_LAUNCHES,
                "staged_forward": staged.STAGED_FORWARD_LAUNCHES,
                "staged_backward": staged.STAGED_BACKWARD_LAUNCHES}
    res = runner.results["sg"]
    tlk = runner.ctx.objects["treelikelihood"]
    vh = runner.ctx.objects["varnormal"]
    elbo_line = next(ln for ln in lines if ln.startswith("ELBO: "))
    elbo = float(elbo_line.split()[1])
    # a low-noise evaluation of the converged distribution (1000 draws)
    gen = torch.Generator(device=dev).manual_seed(123)
    with torch.no_grad():
        elbo_1000 = float(vh.family.elbo(res.vparams, gen, 1000))
    err = elbo - golden["reference_elbo"]
    ok = bool(abs(err) <= golden["tolerance_nats"]
              and tlk.engine_name() == "cuda-fused"
              and runner.ctx.dtype == torch.float32
              and launches["fused_forward"] >= res.iterations
              and launches["fused_backward"] >= res.iterations
              and launches["staged_forward"] == 0
              and launches["staged_backward"] == 0)
    emit("cli_checkpoint_B", ok=ok, lines=lines, elbo=elbo,
         reference_elbo=golden["reference_elbo"], elbo_err=err,
         tolerance_nats=golden["tolerance_nats"], elbo_1000_draws=elbo_1000,
         iterations=res.iterations, checks=len(res.history),
         wall_seconds=wall, fit_seconds=res.seconds,
         check_seconds=res.check_seconds,
         check_share=res.check_seconds / res.seconds,
         mean_step_ms=(res.seconds - res.check_seconds) * 1e3
         / res.iterations,
         engine=tlk.engine_name(), dtype=str(runner.ctx.dtype),
         launches=launches)
    check(ok, "checkpoint B through the CLI on the card")
    return runner, {"forward": launches["fused_forward"],
                    "backward": launches["fused_backward"]}


def cli_staged_large(dev, n_tips=128, n_sites=20480):
    """ADVI of a GTR+G4 config on an alignment simulated on the card (128
    taxa, 20 480 sites: about 16 000 patterns, the JAX package's large
    shape; P >= 8192 asserted) through the CLI, and 50 Adam steps of ML on
    its posterior through ``optimize_adam`` (the config's ML node would run
    Adam to convergence, as the JAX package does whatever "max" says): the
    staged kernels K3'/K4' carry both."""
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        path, n_patterns = large_config(Path(tmp), n_tips, n_sites, dev)
        sim_s = time.perf_counter() - t0
        fused.FORWARD_LAUNCHES = fused.BACKWARD_LAUNCHES = 0
        staged.STAGED_FORWARD_LAUNCHES = staged.STAGED_BACKWARD_LAUNCHES = 0
        t0 = time.perf_counter()
        runner, lines = run_cli([path])
        post = runner.ctx.objects["posterior"]
        ml_res = optimize_adam(post.log_prob, post.param_space(),
                               runner.params_for(post.param_space()),
                               learning_rate=0.01, max_iter=50,
                               patience=1000)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"forward": staged.STAGED_FORWARD_LAUNCHES,
                    "backward": staged.STAGED_BACKWARD_LAUNCHES,
                    "fused_forward": fused.FORWARD_LAUNCHES,
                    "fused_backward": fused.BACKWARD_LAUNCHES}
    tlk = runner.ctx.objects["treelikelihood"]
    vb_res = runner.results["vb"]
    fam = runner.ctx.objects["varnormal"].family
    eps = fam.draw(fam.init, torch.Generator(device=dev).manual_seed(7), 100)
    with torch.no_grad():
        elbo_first = float(fam.elbo(fam.init, eps=eps))
        elbo_last = float(fam.elbo(vb_res.vparams, eps=eps))
    hist = ml_res.history
    ok = bool(n_patterns >= 8192 and tlk.engine_name() == "cuda-staged"
              and launches["forward"] >= ml_res.iterations
              + vb_res.iterations
              and launches["backward"] >= ml_res.iterations
              + vb_res.iterations
              and launches["fused_forward"] == 0
              and launches["fused_backward"] == 0
              and len(hist) == 50 and all(np.isfinite(hist))
              and hist[-1] > hist[0] and elbo_last > elbo_first)
    rec = dict(ok=ok, lines=lines, taxa=n_tips, sites=n_sites,
               patterns=n_patterns, engine=tlk.engine_name(),
               levels=len(tlk.topo.levels), simulate_seconds=sim_s,
               wall_seconds=wall, ml_steps=ml_res.iterations,
               ml_logp_first=hist[0], ml_logp_last=hist[-1],
               ml_step_ms=ml_res.seconds * 1e3 / ml_res.iterations,
               vb_steps=vb_res.iterations, elbo_first=elbo_first,
               elbo_last=elbo_last, vb_history=vb_res.history,
               vb_step_ms=(vb_res.seconds - vb_res.check_seconds) * 1e3
               / vb_res.iterations,
               vb_check_share=vb_res.check_seconds / vb_res.seconds,
               launches=launches)
    emit("cli_staged_large", **rec)
    check(ok, "ML and ADVI of the large GTR+G4 config through K3'/K4'")
    return runner, launches


def flua_config(workdir: Path, physher: list, gtr_g4: bool = False) -> Path:
    """tests/data/fluA-elbo.json's model (the checkpoint B model), or with
    GTR+G4 in place of JC69, and the action list ``physher``, written to
    ``workdir`` beside links to its data files."""
    cfg = json.loads((DATA / "fluA-elbo.json").read_text())
    if gtr_g4:
        sm = cfg["model"]["distributions"][0]["sitemodel"]
        sm["distribution"] = {"distribution": "gamma", "categories": 4,
                              "parameters": {"alpha": {
                                  "id": "alpha", "type": "parameter",
                                  "value": 0.5, "lower": 0}}}
        sm["substitutionmodel"].update(model="gtr", rates={
            "id": "rates", "type": "simplex", "values": [1.0] * 6})
    cfg.pop("varmodel")
    cfg["physher"] = physher
    for name in ("fluA.fa", "fluA-rooted.nxs"):
        link = workdir / name
        if not link.exists():
            link.symlink_to(DATA / name)
    path = workdir / ("fluA-gtrg4.json" if gtr_g4 else "fluA-jc69.json")
    path.write_text(json.dumps(cfg))
    return path


def loop_launches():
    return {"forward": loop.LOOP_FORWARD_LAUNCHES,
            "backward": loop.LOOP_BACKWARD_LAUNCHES,
            "fused_forward": fused.FORWARD_LAUNCHES,
            "staged_forward": staged.STAGED_FORWARD_LAUNCHES}


def zero_launches():
    fused.FORWARD_LAUNCHES = fused.BACKWARD_LAUNCHES = 0
    staged.STAGED_FORWARD_LAUNCHES = staged.STAGED_BACKWARD_LAUNCHES = 0
    loop.LOOP_FORWARD_LAUNCHES = loop.LOOP_BACKWARD_LAUNCHES = 0


# recomputing logged values one chain at a time through the one-dict
# engines (K1'/K2', K3'/K4') against the batched K5' values, float32: 1e-5
# relative (0.05 nats at 4700)
MCMC_LOG_RTOL = 1e-5


def cli_mmcmc(elbo_b, length=3000, n_temps=16):
    """mmcmc (16 temperatures as one batch of chains, float32) then
    marginallikelihood through the CLI on the checkpoint B model: every
    step through K5' at L = 16, none through K1'/K3'. The rungs' last
    recorded log-likelihoods are recomputed as one batch through the plain
    engine and one chain at a time through K1'/K2', and the mean
    log-likelihood must rise from the prior's rung to the posterior's
    (d E_T[ll] / dT = Var_T[ll] >= 0). The estimates are
    printed beside checkpoint B's ELBO, not held to it: the config's prior
    is improper (oneonx on the population size), so its log Z is not the
    ELBO's target."""
    burnin = length // 10
    actions = [{"id": "mmcmc", "type": "mmcmc", "model": "&posterior",
                "length": length, "temperatures": n_temps, "every": 10,
                "burnin": burnin},
               {"id": "ml", "type": "marginallikelihood", "mmcmc": "&mmcmc"}]
    with tempfile.TemporaryDirectory() as tmp:
        path = flua_config(Path(tmp), actions)
        zero_launches()
        t0 = time.perf_counter()
        runner, lines = run_cli([path])
        wall = time.perf_counter() - t0
        launches = loop_launches()
    temps, lls, res = runner.results["mmcmc"]
    est = runner.results["ml"]
    ss, ps = est["stepping"], est["path"]
    tlk = runner.ctx.objects["treelikelihood"]
    like, _ = runner._split_like_prior(runner.ctx.objects["posterior"])
    logged = np.asarray([x[-1] for x in lls])
    with torch.no_grad():
        # the rungs' last states again as one batch through the plain
        # engine (the same arithmetic up to the kernel), and one at a time
        # through K1'/K2'
        last = res.constrain(res.samples_u[-1])
        tlk.engine = "torch"
        plain = like(last).cpu().numpy()
        tlk.engine = "auto"
        one = np.asarray([float(like(res.params_at(-1, chain=k)))
                          for k in range(n_temps)])
    rel_plain = np.abs(plain - logged) / np.abs(plain)
    rel_one = np.abs(one - logged) / np.abs(one)
    # the hot rungs sample the (improper) prior far from the data: there
    # float32 heights cancel (a branch is a difference of two large
    # heights) differently in the batched and the one-dict transforms, and
    # sites underflow, which the kernels clamp at tiny and the plain engine
    # does not (log 0), as in the JAX package: held from T = 0.1 up
    warm = temps >= 0.1
    means = [float(np.mean(x)) for x in lls]
    ok = bool(launches["forward"] == length + burnin + 1
              and launches["fused_forward"] == launches["staged_forward"]
              == 0 and tlk.engine_name(n_temps) == "cuda-loop"
              and np.isfinite([ss, ps]).all()
              and all(np.isfinite(x).all() for x in lls)
              and rel_plain[warm].max() <= MCMC_LOG_RTOL
              and rel_one[warm].max() <= MCMC_LOG_RTOL
              and means[-1] > means[0])
    emit("cli_mmcmc", ok=ok, lines=lines, temperatures=list(temps),
         iterations=length, burnin=burnin,
         samples_per_temperature=len(lls[0]), stepping_stone=ss,
         path_sampling=ps, estimates=est, checkpoint_b_elbo=elbo_b,
         mean_loglik_per_temperature=means,
         last_loglik_rel_err_plain_batch=list(rel_plain),
         last_loglik_rel_err_one_chain=list(rel_one), rtol=MCMC_LOG_RTOL,
         acceptance=list(res.acceptance), wall_seconds=wall,
         step_ms=wall * 1e3 / (length + burnin), launches=launches,
         engine=tlk.engine_name(n_temps))
    check(ok, "mmcmc and marginallikelihood through K5' on the card")
    return launches


def cli_mcmc_gtr(length=1000, n_chains=8):
    """mcmc with 8 chains through the CLI on a GTR+G4 strict-clock fluA
    time-tree config (float32), with tabular, tree and sitewise loggers;
    the logged log-posteriors recomputed one chain at a time."""
    actions = [{"id": "mc", "type": "mcmc", "model": "&posterior",
                "length": length, "chains": n_chains,
                "log": [{"id": "lg", "type": "logger", "every": 100,
                         "file": "mc.log", "models": ["&posterior"],
                         "x": ["&rate", "&n0", "&alpha"]},
                        {"id": "lt", "type": "logger", "every": 100,
                         "file": "mc.trees", "models": ["&tree"]},
                        {"id": "ls", "type": "logger", "every": 200,
                         "file": "mc.site", "models": ["&treelikelihood"],
                         "sitewise": True}]}]
    with tempfile.TemporaryDirectory() as tmp:
        path = flua_config(Path(tmp), actions, gtr_g4=True)
        zero_launches()
        t0 = time.perf_counter()
        runner, lines = run_cli([path])
        wall = time.perf_counter() - t0
        launches = loop_launches()
        texts = {n: (Path(tmp) / n).read_text()
                 for n in ("mc.log", "mc.trees", "mc.site")}
    res = runner.results["mc"]
    post = runner.ctx.objects["posterior"]
    tlk = runner.ctx.objects["treelikelihood"]
    rows = texts["mc.log"].splitlines()
    logged = np.asarray([float(r.split("\t")[1]) for r in rows[1:]])
    with torch.no_grad():
        again = np.asarray([float(post.log_prob(res.params_at(i)))
                            for i in range(len(logged))])
    rel = np.abs(again - logged) / np.abs(again)
    n_samples = length // 100
    ok = bool(launches["forward"] >= length
              and tlk.engine_name(n_chains) == "cuda-loop"
              and tlk.engine_name() == "cuda-staged"
              and rows[0] == "state\tposterior\tbm.rate\tcoalescent.theta"
                             "\tsitemodel.shape"
              and len(logged) == n_samples
              and texts["mc.trees"].count("tree STATE_") == n_samples
              and len(texts["mc.site"].splitlines()) == 2 + n_samples // 2
              and np.isfinite(logged).all()
              and float(rel.max()) <= MCMC_LOG_RTOL)
    emit("cli_mcmc_gtrg4", ok=ok, lines=lines, chains=n_chains,
         iterations=length, log_header=rows[0],
         logged_posterior=list(logged), recomputed_l1=list(again),
         max_rel_err=float(rel.max()), rtol=MCMC_LOG_RTOL,
         acceptance=list(res.acceptance), wall_seconds=wall,
         step_ms=wall * 1e3 / length, launches=launches,
         engine_batch=tlk.engine_name(n_chains),
         engine_one=tlk.engine_name())
    check(ok, "mcmc with 8 chains through K5' and its logs")


def hmc_checkpoint_b(dev, n_chains=4, n_iter=60, every=5, burnin=60):
    """HMC through the Python API on the checkpoint B model (float32): 4
    chains, 10 leapfrog steps, value and gradient through K5'/K6'."""
    from physher_tpu_torch.config.builder import build_config, load_json
    from physher_tpu_torch.inference.mcmc import HMC

    ctx, _ = build_config(load_json(str(DATA / "fluA-elbo.json")),
                          base_dir=str(DATA), dtype=torch.float32,
                          device=dev)
    post = ctx.objects["posterior"]
    space = post.param_space()
    zero_launches()
    t0 = time.perf_counter()
    res = HMC(space, post.log_prob, n_leapfrog=10).run(
        torch.Generator(device=dev).manual_seed(5),
        space.init_params(dtype=torch.float32, device=dev), n_iter=n_iter,
        every=every, n_chains=n_chains, step_size=0.03, burnin=burnin)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = loop_launches()
    acc = float(np.mean(res.acceptance[burnin // every:]))
    n_evals = (n_iter + burnin) * 10 + 1
    ok = bool(0.2 < acc < 0.99 and np.isfinite(res.samples_u).all()
              and np.isfinite(res.log_posterior).all()
              and launches["backward"] >= n_evals
              and launches["forward"] >= n_evals
              and ctx.objects["treelikelihood"].engine_name(n_chains)
              == "cuda-loop")
    emit("hmc_checkpoint_B", ok=ok, chains=n_chains, leapfrog=10,
         iterations=n_iter, burnin=burnin, acceptance_after_adaptation=acc,
         acceptance_per_chunk=list(res.acceptance),
         step_size=float(res.step_sizes[0]),
         log_posterior_last=list(res.log_posterior[-1]), wall_seconds=wall,
         ms_per_leapfrog=wall * 1e3 / n_evals, launches=launches)
    check(ok, "HMC on the checkpoint B model through K5'/K6'")
    return launches


def gy94_mcmc_config(workdir: Path, dev, length, n_chains, seed=11,
                     n_codons=4096):
    """GY94 M0 data simulated on the card as :func:`gy94_m0_fit_model`
    simulates it (kappa 2, omega 0.2, branch lengths 0.3, a balanced
    32-taxon tree, 4096 codons), written as FASTA beside a config: GY94
    (free frequencies) over it on the tree with the simulation's branch
    lengths, and mcmc with ``n_chains`` chains, the omega and kappa moves
    weighted up (the builder starts them at 1, as the JAX builder does), a
    tabular logger every 100 steps. Returns the config's path."""
    from physher_tpu_torch.io.seqio import write_fasta
    from physher_tpu_torch.io.treeio import write_newick

    kw = dict(dtype=torch.float64, device=dev)
    topo = balanced_topology(32)
    subst = GY94(fixed_freqs=True, **kw)
    params = subst.param_space().init_params(**kw)
    params.update({k: torch.tensor(v, **kw) for k, v in M0_TRUTH.items()})
    bl = np.full(topo.N, 0.3)
    bl[topo.root] = 0.0
    gen = torch.Generator(device=dev).manual_seed(seed)
    seqs = simulate_alignment(gen, topo, subst, ConstantSiteModel(**kw),
                              params, bl, n_codons, datatype="codon")
    write_fasta(seqs, str(workdir / "m0.fa"))
    bl[topo.root] = np.nan
    ops = [{"id": f"op{k}", "type": "operator", "algorithm": "scaler",
            "x": f"%sm.{k}", "weight": 30.0} for k in ("omega", "kappa")]
    cfg = {
        "model": {
            "id": "treelikelihood", "type": "treelikelihood",
            "sitepattern": {"id": "patterns", "type": "sitepattern",
                            "datatype": "codon",
                            "alignment": {"id": "seqs", "type": "alignment",
                                          "file": "m0.fa"}},
            "sitemodel": {"id": "sitemodel", "type": "sitemodel",
                          "substitutionmodel": {
                              "id": "sm", "type": "substitutionmodel",
                              "model": "gy94", "datatype": "codon"}},
            "tree": {"id": "tree", "type": "tree",
                     "newick": write_newick(topo, bl)}},
        "physher": [
            {"id": "mc", "type": "mcmc", "model": "&treelikelihood",
             "length": length, "chains": n_chains, "operators": ops,
             "log": [{"id": "lg", "type": "logger", "every": 100,
                      "file": "mc.log", "models": ["&treelikelihood"],
                      "x": ["%sm.kappa", "%sm.omega"]}]}]}
    path = workdir / "m0-mcmc.json"
    path.write_text(json.dumps(cfg))
    return path


def kernel_rows(prof, n_steps: int):
    """(device ms per step, kernel launches per step, top rows) from a
    profiler's kernel rows (device-side events only)."""
    from torch.autograd import DeviceType

    rows = [r for r in prof.key_averages()
            if getattr(r, "device_type", None) == DeviceType.CUDA]

    def dev_us(r):
        return getattr(r, "self_device_time_total",
                       getattr(r, "self_cuda_time_total", 0.0))
    rows.sort(key=dev_us, reverse=True)
    top = [{"name": r.key[:80], "ms_per_step": dev_us(r) / 1e3 / n_steps,
            "calls_per_step": r.count / n_steps} for r in rows[:10]]
    return (sum(dev_us(r) for r in rows) / 1e3 / n_steps,
            sum(r.count for r in rows) / n_steps, top)


def cli_mcmc_codon(dev, length=2000, n_chains=8, n_profiled=20,
                   n_codons=4096):
    """mcmc with 8 chains through the CLI on a GY94 config over data
    simulated on the card (float32; K5' at S = 61, L = 8): the logged
    log-likelihoods of chain 0 recomputed one chain at a time through K7',
    omega's posterior mean (the second half of every chain) against the
    simulation's 0.2; then the MH step of the built model alone (host
    clock, a profiler window for its device time and launches) and the
    eigendecomposition of [8, 61, 61] that each step's P(t) needs (CUDA
    events)."""
    from physher_tpu_torch.inference.mcmc import MCMC
    from torch.profiler import ProfilerActivity, profile

    with tempfile.TemporaryDirectory() as tmp:
        path = gy94_mcmc_config(Path(tmp), dev, length, n_chains,
                                n_codons=n_codons)
        zero_launches()
        wide.WIDE_FORWARD_LAUNCHES = wide.WIDE_BACKWARD_LAUNCHES = 0
        t0 = time.perf_counter()
        runner, lines = run_cli([path])
        wall = time.perf_counter() - t0
        launches = {**loop_launches(),
                    "wide_forward": wide.WIDE_FORWARD_LAUNCHES}
        rows = (Path(tmp) / "mc.log").read_text().splitlines()
    res = runner.results["mc"]
    tlk = runner.ctx.objects["treelikelihood"]
    logged = np.asarray([float(r.split("\t")[1]) for r in rows[1:]])
    wide.WIDE_FORWARD_LAUNCHES = 0
    with torch.no_grad():
        again = np.asarray([float(tlk.log_likelihood(res.params_at(i)))
                            for i in range(len(logged))])
    one_chain_launches = wide.WIDE_FORWARD_LAUNCHES
    rel = np.abs(again - logged) / np.abs(again)
    omega = res.to_dict_of_arrays()["sm.omega"]           # [samples, L]
    half = omega[len(omega) // 2:]
    omega_mean = float(half.mean())
    # the MH step alone on the built model, from the last state
    space = tlk.param_space()
    start = res.params_at(-1)
    sampler = MCMC(space, tlk.log_likelihood)
    gen = torch.Generator(device=dev).manual_seed(3)

    def run(n):
        return sampler.run(gen, start, n_iter=n, every=n, n_chains=n_chains)
    run(10)
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    run(100)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / 100
    k5_per_step = loop.LOOP_FORWARD_LAUNCHES / 100
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(n_profiled)
        torch.cuda.synchronize()
    device_ms, kernels_per_step, top = kernel_rows(prof, n_profiled)
    sym = torch.randn((n_chains, 61, 61), generator=gen, device=dev)
    sym = sym + sym.transpose(-1, -2)
    eigh_ms = median_ms(lambda: torch.linalg.eigh(sym), reps=20)
    ok = bool(launches["forward"] >= length
              and tlk.engine_name(n_chains) == "cuda-loop"
              and tlk.engine_name() == "cuda-wide"
              and one_chain_launches >= len(logged)
              and rows[0] == "state\ttreelikelihood\tsm.kappa\tsm.omega"
              and len(logged) == length // 100
              and np.isfinite(logged).all()
              and float(rel.max()) <= MCMC_LOG_RTOL
              and abs(omega_mean - M0_TRUTH["omega"]) <= M0_ATOL["omega"])
    emit("cli_mcmc_codon", ok=ok, lines=lines, chains=n_chains,
         iterations=length, patterns=tlk.sp.pattern_count,
         log_header=rows[0], logged_loglik=list(logged),
         recomputed_one_chain=list(again), max_rel_err=float(rel.max()),
         rtol=MCMC_LOG_RTOL, omega_posterior_mean=omega_mean,
         omega_truth=M0_TRUTH["omega"], omega_atol=M0_ATOL["omega"],
         kappa_posterior_mean=float(res.to_dict_of_arrays()["sm.kappa"][
             len(omega) // 2:].mean()),
         acceptance=list(res.acceptance), wall_seconds=wall,
         mh_step_ms=step_ms, k5_launches_per_step=k5_per_step,
         device_ms_per_step=device_ms, busy_share=device_ms / step_ms,
         kernel_launches_per_step=kernels_per_step, top_kernels=top,
         eigh_8x61x61_f32_ms=eigh_ms, launches=launches,
         engine_batch=tlk.engine_name(n_chains),
         engine_one=tlk.engine_name())
    check(ok, "mcmc with 8 chains on GY94 through K5' at S = 61")
    return launches


def hmc_wag(dev, n_chains=4, n_iter=20, every=5, burnin=20):
    """HMC through the Python API on WAG+G4 at 64 taxa x 8192 patterns
    (float32): 4 chains, 10 leapfrog steps, value and gradient through
    K5'/K6' at S = 20, from 200 Adam steps."""
    from physher_tpu_torch.inference.mcmc import HMC

    kw = dict(dtype=torch.float32, device=dev)
    tlk = wag_g4_large(torch.float32, dev)
    space = tlk.param_space()
    fit = optimize_adam(tlk.log_likelihood, space, space.init_params(**kw),
                        learning_rate=0.05, max_iter=200, patience=1000)
    start = {k: v.detach() for k, v in fit.params.items()}
    zero_launches()
    t0 = time.perf_counter()
    res = HMC(space, tlk.log_likelihood, n_leapfrog=10).run(
        torch.Generator(device=dev).manual_seed(5), start, n_iter=n_iter,
        every=every, n_chains=n_chains, step_size=0.005, burnin=burnin)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = loop_launches()
    acc = float(np.mean(res.acceptance[burnin // every:]))
    n_evals = (n_iter + burnin) * 10 + 1
    ok = bool(acc > 0 and np.isfinite(res.samples_u).all()
              and np.isfinite(res.log_posterior).all()
              and launches["backward"] >= n_evals
              and launches["forward"] >= n_evals
              and tlk.engine_name(n_chains) == "cuda-loop")
    emit("hmc_wag", ok=ok, chains=n_chains, leapfrog=10, iterations=n_iter,
         burnin=burnin, adam_steps=fit.iterations, adam_logp=fit.logp,
         acceptance_after_adaptation=acc,
         acceptance_per_chunk=list(res.acceptance),
         step_size=float(res.step_sizes[0]),
         log_posterior_last=list(res.log_posterior[-1]), wall_seconds=wall,
         ms_per_leapfrog=wall * 1e3 / n_evals, launches=launches)
    check(ok, "HMC on WAG+G4 through K5'/K6' at S = 20")
    return launches


def engine_names(dev):
    """The JAX package's engine names in a config on the card (float64):
    tiny_aa under WAG (tests/data/goldens/wag.json's model) with
    ``pallas-fused`` runs K7'/K8' and with ``pallas-loop`` K5' for a batch of
    2 chains and for one dict, each at the ``auto`` build's logP."""
    from physher_tpu_torch.config.builder import build_config, load_json

    kw = dict(dtype=torch.float64, device=dev)
    cfg = load_json(str(DATA / "goldens" / "wag.json"))
    cfg["model"]["sitepattern"]["alignment"]["file"] = "tiny_aa.fa"
    models = {}
    for engine in ("auto", "pallas-fused", "pallas-loop"):
        cfg["model"]["engine"] = engine
        ctx, _ = build_config(cfg, base_dir=str(DATA), **kw)
        models[engine] = ctx.objects["treelikelihood"]
    auto = models["auto"]
    batch = chain_params(auto, 2, 4)
    with torch.no_grad():
        ref_one = float(auto.log_likelihood(auto.param_space().init_params(
            **kw)))
        ref_batch = [float(auto.log_likelihood({k: v[i] for k, v in
                                                batch.items()}))
                     for i in range(2)]
        zero_launches()
        wide.WIDE_FORWARD_LAUNCHES = 0
        fused_one = float(models["pallas-fused"].log_likelihood(
            auto.param_space().init_params(**kw)))
        wide_launches = wide.WIDE_FORWARD_LAUNCHES
        loop_one = float(models["pallas-loop"].log_likelihood(
            auto.param_space().init_params(**kw)))
        loop_batch = models["pallas-loop"].log_likelihood(batch).tolist()
        loop_launches_ = loop.LOOP_FORWARD_LAUNCHES
    errs = {"pallas-fused": abs(fused_one / ref_one - 1),
            "pallas-loop": abs(loop_one / ref_one - 1),
            "pallas-loop-L2": max(abs(a / b - 1) for a, b in
                                  zip(loop_batch, ref_batch))}
    names = {e: (m.engine_name(), m.engine_name(2))
             for e, m in models.items()}
    ok = bool(names["pallas-fused"] == ("cuda-wide", "cuda-loop")
              and names["pallas-loop"] == ("cuda-loop", "cuda-loop")
              and names["auto"] == ("cuda-wide", "cuda-loop")
              and wide_launches == 1 and loop_launches_ == 2
              and max(errs.values()) <= 1e-12)
    emit("engine_names", ok=ok, engines=names, logp_auto=ref_one,
         rel_err=errs, rtol=1e-12, wide_launches=wide_launches,
         loop_launches=loop_launches_)
    check(ok, "the pallas-* engine names on the card")


def kernel_row(name, src, replaces, launches, alone, kind):
    return {"name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches,
            "max_abs_err": alone[f"{kind}_err"], "ms": alone[f"{kind}_ms"],
            "plain_ms": alone[f"{kind}_plain_ms"],
            "bound_ms": alone[f"{kind}_bound_ms"],
            "bound_by": alone[f"{kind}_bound_by"],
            # no single PyTorch call computes a pruning sweep
            "library_ms": None}


def main() -> int:
    t_start = time.perf_counter()
    # ---- 1. device
    dev = cuda_device()
    smi = nvidia_smi()
    emit("device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0])

    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32, "TF32 off")

    # ---- 2. build the four sources, one nvcc each, started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(4) as pool:
        build_s, build_wide_s, build_staged_s, build_loop_s = pool.map(
            timed_build, (fused, wide, staged, loop))
    both_s = time.perf_counter() - t0
    emit("build", seconds=build_s, ptxas=ptxas_lines(fused.build_log))
    emit("build_wide", seconds=build_wide_s, all_seconds=both_s,
         ptxas=ptxas_lines(wide.build_log))
    emit("build_staged", seconds=build_staged_s, all_seconds=both_s,
         ptxas=ptxas_lines(staged.build_log))
    emit("build_loop", seconds=build_loop_s, all_seconds=both_s,
         ptxas=ptxas_lines(loop.build_log))

    # ---- 3. K1'/K2' against plain, on the card
    flu_topo = load_fluA_time(torch.float64, "cpu").topo
    shapes = [(name, flu_topo if n is None else balanced_topology(n), P, C)
              for name, n, P, C in SHAPES]
    for dtype in (torch.float32, torch.float64):
        for name, topo, P, C in shapes:
            compare(name, topo, random_inputs(topo, P, C, 7, dtype,
                                                     dev), dtype)
            torch.cuda.synchronize()

    # ---- 4. checkpoint A on the card
    checkpoint_a(dev)

    # ---- 5. GTR+G4 fluA golden on the card (float64) through K1'/K2' (auto
    # picks K3'/K4' for this model; phase 13 holds them to it)
    gtrg4_golden(dev, engine="cuda-fused")

    # ---- 6. the nucleotide main path: 20 Adam steps, GTR+G4 fluA, float32,
    # through the pair that select_engine picks (K3'/K4' since the gate was
    # measured: C = 4 on 68 internal nodes in 21 levels)
    gtr32 = load_gtrg4_fluA(torch.float32, dev)
    space = gtr32.param_space()
    start = space.init_params(dtype=torch.float32, device=dev)
    fused.FORWARD_LAUNCHES = fused.BACKWARD_LAUNCHES = 0
    staged.STAGED_FORWARD_LAUNCHES = staged.STAGED_BACKWARD_LAUNCHES = 0
    t0 = time.perf_counter()
    res = optimize_adam(gtr32.log_likelihood, space, start,
                        learning_rate=0.01, max_iter=20, patience=1000)
    torch.cuda.synchronize()
    adam_s = time.perf_counter() - t0
    launches = {"fused_forward": fused.FORWARD_LAUNCHES,
                "fused_backward": fused.BACKWARD_LAUNCHES,
                "staged_forward": staged.STAGED_FORWARD_LAUNCHES,
                "staged_backward": staged.STAGED_BACKWARD_LAUNCHES}
    pair = gtr32.engine_name().removeprefix("cuda-")
    hist = res.history
    ok = bool(len(hist) == 20 and all(np.isfinite(hist))
              and hist[-1] > hist[0] and pair in ("fused", "staged")
              and min(launches[f"{pair}_forward"],
                      launches[f"{pair}_backward"]) >= 20)
    emit("adam", ok=ok, steps=len(hist), logp_first=hist[0],
         logp_last=hist[-1], best_logp=res.logp, engine=gtr32.engine_name(),
         launches=launches, seconds=adam_s)
    check(ok, "20 Adam steps through the kernels with rising logP")

    # ---- 7. times of K1'/K2'
    times = {"card": smi}
    for name, topo, P, C in shapes[1:]:
        inputs = random_inputs(topo, P, C, 7, torch.float32, dev)
        times[name] = {
            "value_and_grad_kernel_ms": median_ms(lambda: value_and_grad(
                fused.fused_site_log, topo, *inputs)),
            "value_and_grad_plain_ms": median_ms(lambda: value_and_grad(
                fused.fused_site_log_reference, topo, *inputs)),
        }
    # each kernel alone at GTR+G4 fluA (float32), as in earlier runs
    times["adam_step_ms_gtrg4_fluA_f32"] = adam_step_ms(gtr32, start,
                                                        n_steps=50)
    times["kernel_alone_gtrg4_fluA_f32"] = kernels_alone(
        fused, gtr32.topo, *engine_inputs(gtr32, start))
    times["build_seconds"] = build_s
    emit("times", **times)

    # ---- 8. K7'/K8' against plain at both full shapes and the caterpillar,
    # then one small case for each tile shape of K8' (WIDE_BUCKET_S; 1000
    # patterns, ragged), the cluster sizes those leave out
    # (FORWARD_CLUSTER_S) and a WAG tree with polytomies
    wide_shapes = [(name, make(), P, C, datatype, seed)
                   for name, make, P, C, datatype, seed in WIDE_SHAPES]
    wag_poly = collapsed_topology(balanced_topology(64))
    bucket_topo = balanced_topology(16)
    for dtype in (torch.float32, torch.float64):
        for name, topo, P, C, datatype, seed in wide_shapes:
            compare(name, topo, random_inputs(topo, P, C, seed, dtype, dev,
                                              datatype), dtype, mod=wide,
                    phase="wide_kernel_vs_plain")
            torch.cuda.synchronize()
        cases = [(f"bucket-S{S}-C{C}", bucket_topo, 1000, C, S)
                 for S, C in WIDE_BUCKET_S + FORWARD_CLUSTER_S]
        cases.append(("wag-polytomy-2048-C4", wag_poly, 2048, 4, 20))
        for name, topo, P, C, S in cases:
            tips, pm, fr, pr, w = random_chains(topo, P, C, 1, S, dtype,
                                                dev, S=S)
            compare(name, topo, (tips, pm[0], fr[0], pr[0], w[0]), dtype,
                    mod=wide, phase="wide_kernel_vs_plain")
        torch.cuda.synchronize()

    # ---- 9. codon and protein goldens through K7'/K8' (float64)
    kw64 = dict(dtype=torch.float64, device=dev)
    wide.WIDE_FORWARD_LAUNCHES = wide.WIDE_BACKWARD_LAUNCHES = 0
    rec, ok = {}, True
    cases = [(m, *codon_small(m, torch.float64, dev)) for m in ("gy94",
                                                                "mg94")]
    wag64 = wag_tiny_aa(torch.float64, dev)
    cases.append(("wag", wag64, wag64.param_space().init_params(**kw64),
                  WAG_GOLDEN_LOGP))
    for name, tlk, params, golden in cases:
        leaves = {k: v.clone().requires_grad_(True)
                  for k, v in params.items()}
        logp = tlk.log_likelihood(leaves)
        (g_dist,) = torch.autograd.grad(logp, [leaves["tree.distances"]])
        # the same gradient from the plain engine on the card
        plain = {k: v.clone().requires_grad_(True)
                 for k, v in params.items()}
        tlk.engine = "torch"
        (g_plain,) = torch.autograd.grad(tlk.log_likelihood(plain),
                                         [plain["tree.distances"]])
        tlk.engine = "auto"
        err = float(logp.detach()) - golden
        atol = 1e-8 if name == "wag" else 1e-7 + 5e-9 * abs(golden)
        g_rel = max_err(g_dist, g_plain)[1]
        rec[name] = dict(logp=float(logp.detach()), golden=golden,
                         logp_err=err, logp_tol=atol,
                         engine=tlk.engine_name(),
                         distance_grad_rel_err_vs_plain=g_rel)
        ok = ok and abs(err) <= atol and tlk.engine_name() == "cuda-wide" \
            and g_rel <= 1e-10
    launches = {"forward": wide.WIDE_FORWARD_LAUNCHES,
                "backward": wide.WIDE_BACKWARD_LAUNCHES}
    ok = ok and min(launches.values()) >= len(cases)
    emit("codon_protein_goldens", ok=ok, launches=launches, **rec)
    check(ok, "codon and protein goldens through the wide kernels")

    # ---- 10. the codon and protein main path: a GY94 M0 fit to data
    # simulated on the card, then 20 Adam steps of WAG+G4 64 x 8192 (f32)
    kw32 = dict(dtype=torch.float32, device=dev)
    wide.WIDE_FORWARD_LAUNCHES = wide.WIDE_BACKWARD_LAUNCHES = 0
    t0 = time.perf_counter()
    m0 = gy94_m0_fit_model(torch.float32, dev)
    m0_space = m0.param_space()
    m0_start = m0_space.init_params(**kw32)
    fit = optimize_adam(m0.log_likelihood, m0_space, m0_start,
                        learning_rate=0.05, max_iter=600)
    m0_s = time.perf_counter() - t0
    got = {k: float(fit.params[k]) for k in M0_TRUTH}
    m0_ok = all(abs(got[k] - M0_TRUTH[k]) < M0_ATOL[k] for k in M0_TRUTH)
    wag32 = wag_g4_large(torch.float32, dev)
    wag_space = wag32.param_space()
    wag_start = wag_space.init_params(**kw32)
    wres = optimize_adam(wag32.log_likelihood, wag_space, wag_start,
                         learning_rate=0.01, max_iter=20, patience=1000)
    torch.cuda.synchronize()
    wide_launches = {"forward": wide.WIDE_FORWARD_LAUNCHES,
                     "backward": wide.WIDE_BACKWARD_LAUNCHES}
    hist = wres.history
    wag_ok = bool(len(hist) == 20 and all(np.isfinite(hist))
                  and hist[-1] > hist[0])
    ok = bool(m0_ok and wag_ok and m0.engine_name() == "cuda-wide"
              and wag32.engine_name() == "cuda-wide"
              and min(wide_launches.values()) >= fit.iterations + 20)
    emit("adam_codon", ok=ok, patterns=m0.sp.pattern_count,
         m0_steps=fit.iterations, m0_estimates=got, m0_truth=M0_TRUTH,
         m0_tolerance=M0_ATOL, m0_logp=fit.logp, m0_seconds=m0_s,
         wag_steps=len(hist), wag_logp_first=hist[0], wag_logp_last=hist[-1],
         launches=wide_launches)
    check(ok, "GY94 M0 recovery and WAG+G4 Adam steps through the wide "
              "kernels")

    # ---- 11. times of K7'/K8' (float32), K8''s dP scratch, registers and
    # spills, and K8' twice on the same inputs (bit-identical: no atomics)
    times = {"card": smi, "k8_ptxas": ptxas_by_kernel(wide.build_log,
                                                      "backward_level"),
             "k7_ptxas": ptxas_by_kernel(wide.build_log, "forward_level")}
    m0_params = {k: v.detach() for k, v in fit.params.items()}
    for name, tlk, params in (("gy94-32x4096", m0, m0_params),
                              ("wag-g4-64x8192", wag32, wag_start)):
        inputs = engine_inputs(tlk, params)
        times[name] = {
            "patterns": tlk.sp.pattern_count,
            "value_and_grad_kernel_ms": median_ms(lambda: value_and_grad(
                wide.wide_site_log, tlk.topo, *inputs)),
            "value_and_grad_plain_ms": median_ms(lambda: value_and_grad(
                wide.wide_site_log_reference, tlk.topo, *inputs)),
            "kernel_alone": kernels_alone(wide, tlk.topo, *inputs),
            "adam_step_ms": adam_step_ms(tlk, params),
            "dP_scratch_bytes": k8_dp_scratch_bytes(inputs[0], inputs[1]),
            "k8_bit_identical": k8_deterministic(tlk.topo, *inputs),
        }
        check(times[name]["k8_bit_identical"],
              f"K8' twice on the same inputs, bit for bit, at {name}")
    times["build_seconds"] = build_wide_s
    emit("wide_times", **times)
    wide_alone = times["gy94-32x4096"]["kernel_alone"]

    # ---- 12. K3'/K4' against plain: the large balanced tree, a caterpillar
    # and a ragged pattern count, float32 and float64
    for dtype in (torch.float32, torch.float64):
        for name, make, P, C in STAGED_SHAPES:
            topo = make()
            compare(name, topo, random_inputs(topo, P, C, 7, dtype, dev),
                    dtype, mod=staged, phase="staged_kernel_vs_plain")
            torch.cuda.synchronize()

    # ---- 13. checkpoint A and the GTR+G4 golden through K3'/K4' (float64)
    checkpoint_a(dev, engine="cuda-staged", phase="staged_checkpoint_a")
    gtrg4_golden(dev, engine="cuda-staged", phase="staged_gtrg4_fluA")

    # ---- 14. checkpoint B: the fluA ADVI config through the CLI (K1'/K2'),
    # and K1'/K2' alone at its model's inputs
    runner, launches_fused = cli_checkpoint_b(dev)
    runner_b_elbo = runner.results["sg"].elbo
    tlk = runner.ctx.objects["treelikelihood"]
    fused_alone = kernels_alone(fused, tlk.topo, *engine_inputs(
        tlk, runner.params_for(tlk.param_space())))
    emit("fused_times", card=smi, model="fluA-elbo JC69 float32",
         patterns=tlk.sp.pattern_count, kernel_alone=fused_alone)

    # ---- 15. the third slice's main path: ML then ADVI of a GTR+G4 config
    # at 128 taxa x about 16 000 patterns through the CLI (K3'/K4')
    runner, staged_launches = cli_staged_large(dev)

    # ---- 16. times of K3'/K4', K1'/K2' and plain at that model's inputs
    tlk = runner.ctx.objects["treelikelihood"]
    params = runner.params_for(tlk.param_space())
    inputs = engine_inputs(tlk, params)
    staged_alone = kernels_alone(staged, tlk.topo, *inputs)
    times = {"card": smi, "patterns": tlk.sp.pattern_count,
             "kernel_alone": staged_alone}
    for label, fn in (("staged", staged.staged_site_log),
                      ("fused", fused.fused_site_log),
                      ("plain", staged.staged_site_log_reference)):
        times[f"value_and_grad_{label}_ms"] = median_ms(
            lambda: value_and_grad(fn, tlk.topo, *inputs))
    inputs64 = random_inputs(balanced_topology(128), 16384, 4, 7,
                             torch.float64, dev)
    topo128 = balanced_topology(128)
    for label, fn in (("staged", staged.staged_site_log),
                      ("fused", fused.fused_site_log)):
        times[f"value_and_grad_{label}_f64_balanced_128x16384_ms"] = \
            median_ms(lambda: value_and_grad(fn, topo128, *inputs64))
    times["build_seconds"] = build_staged_s
    emit("staged_times", **times)

    # ---- 17. K5'/K6' against plain at the fourth slice's shapes: chains of
    # the checkpoint B model (L = 16, the mmcmc ladder; L = 4, the HMC
    # chains) and of GTR+G4 fluA (L = 8), and a fluA tree with polytomies
    # at L = 1 and 4; float32, and float64 with rescale on and off
    loop_times = {"card": smi, "build_seconds": build_loop_s}
    poly = collapsed_topology(flu_topo)
    for dtype in (torch.float32, torch.float64):
        jc, gtr = load_fluA_time(dtype, dev), load_gtrg4_fluA(dtype, dev)
        cases = [("fluA-jc69-L16", jc.topo,
                  engine_inputs(jc, chain_params(jc, 16, 1))),
                 ("fluA-jc69-L4", jc.topo,
                  engine_inputs(jc, chain_params(jc, 4, 2))),
                 ("fluA-gtrg4-L8", gtr.topo,
                  engine_inputs(gtr, chain_params(gtr, 8, 3)))]
        for rescale in (True,) if dtype == torch.float32 else (True, False):
            timed = dtype == torch.float32
            for name, topo, (tips, pm, fr, pr, w) in cases:
                g = w.expand(pm.shape[0], -1).contiguous()
                rec = loop_alone(name, topo, tips, pm, fr, pr, g, rescale,
                                 timed=timed)
                if timed:
                    loop_times[name] = rec
            for L in (1, 4):
                loop_alone(f"fluA-polytomy-L{L}", poly,
                           *random_chains(poly, 238, 4, L, 11 + L, dtype,
                                          dev), rescale=rescale)
        torch.cuda.synchronize()
    emit("loop_times", **loop_times)

    # ---- 18. the fourth slice's main path: mmcmc (16 temperatures as one
    # batch) and marginallikelihood through the CLI on the checkpoint B
    # model (K5')
    elbo_b = float(runner_b_elbo)
    ladder_launches = cli_mmcmc(elbo_b)

    # ---- 19. mcmc with 8 chains through the CLI, GTR+G4 fluA, loggers
    cli_mcmc_gtr()

    # ---- 20. HMC through the Python API on the checkpoint B model (K5'/K6')
    hmc_launches = hmc_checkpoint_b(dev)

    # ---- 21. K5'/K6' at S != 4 against plain at the sixth slice's shapes:
    # chains of GY94 M0 (32 x 4096, L = 8, the codon mcmc's batch) and of
    # WAG+G4 (64 x 8192, L = 4, the HMC chains), and a WAG tree with
    # polytomies at L = 1 and 4; float32, and float64 with rescale on and
    # off, at the kernel tolerances of TOL; then one small case for each
    # instantiation of K6' and K5' (WIDE_BUCKET_S) and for each cluster size
    # of K5' those leave out (FORWARD_CLUSTER_S); K6' twice on the same
    # inputs (bit-identical: no atomics), K5' and K7' twice (bit-identical,
    # the partials peaking at 1), their registers and spills and the most
    # clusters resident at once
    wide_loop_times = {"card": smi, "k6_ptxas": ptxas_by_kernel(
        loop.build_log, "loop_wide_backward"), "k5_ptxas": ptxas_by_kernel(
        loop.build_log, "loop_wide_forward"),
        "max_active_clusters": cluster_occupancy()}
    for dtype in (torch.float32, torch.float64):
        gy, wg = gy94_m0_fit_model(dtype, dev), wag_g4_large(dtype, dev)
        cases = [("gy94-32x4096-L8", gy.topo,
                  engine_inputs(gy, chain_params(gy, 8, 5))),
                 ("wag-g4-64x8192-L4", wg.topo,
                  engine_inputs(wg, chain_params(wg, 4, 6)))]
        for rescale in (True,) if dtype == torch.float32 else (True, False):
            timed = dtype == torch.float32
            for name, topo, (tips, pm, fr, pr, w) in cases:
                g = w.expand(pm.shape[0], -1).contiguous()
                rec = loop_alone(name, topo, tips, pm, fr, pr, g, rescale,
                                 timed=timed, tol=TOL[dtype],
                                 phase="loop_wide_kernel_vs_plain")
                if timed:
                    rec["dP_scratch_bytes"] = wide_dp_scratch_bytes(
                        topo, tips, pm)
                    wide_loop_times[name] = rec
            for L in (1, 4):
                loop_alone(f"wag-polytomy-L{L}", wag_poly,
                           *random_chains(wag_poly, 2048, 4, L, 21 + L,
                                          dtype, dev, S=20),
                           rescale=rescale, tol=TOL[dtype],
                           phase="loop_wide_kernel_vs_plain")
            for S, C in WIDE_BUCKET_S + FORWARD_CLUSTER_S:
                loop_alone(f"bucket-S{S}-C{C}", bucket_topo,
                           *random_chains(bucket_topo, 1000, C, 2, S, dtype,
                                          dev, S=S),
                           rescale=rescale, tol=TOL[dtype],
                           phase="loop_wide_kernel_vs_plain")
        if dtype == torch.float32:
            name, topo, (tips, pm, fr, pr, w) = cases[1]
            wide_loop_times["k6_bit_identical"] = k6_deterministic(
                topo, tips, pm, fr, pr, w.expand(pm.shape[0], -1))
            check(wide_loop_times["k6_bit_identical"],
                  "K6' twice on the same inputs, bit for bit")
            # K5' and K7' twice on the same inputs at both main shapes
            for name, topo, (tips, pm, fr, pr, w) in cases:
                rec = forward_checks(topo, tips, pm, fr, pr)
                wide_loop_times[f"forward_checks_{name}"] = rec
                check(all(rec.values()), f"K5' and K7' bit for bit, their "
                                         f"partials peaking at 1, at {name}")
        del gy, wg, cases
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    emit("loop_wide_times", **wide_loop_times)

    # ---- 22. the sixth slice's main path: mcmc with 8 chains through the
    # CLI on a GY94 config over data simulated on the card (K5' at S = 61)
    codon_launches = cli_mcmc_codon(dev)

    # ---- 23. HMC with 4 chains on WAG+G4 through the API (K5'/K6', S = 20)
    hmc_wag_launches = hmc_wag(dev)

    # ---- 24. the config engine names pallas-fused and pallas-loop, card
    engine_names(dev)

    emit("total", seconds=time.perf_counter() - t_start)
    fused_src = "physher_tpu_torch/csrc/pruning.cu"
    wide_src = "physher_tpu_torch/csrc/wide.cu"
    staged_src = "physher_tpu_torch/csrc/staged.cu"
    loop_src = "physher_tpu_torch/csrc/loop.cu"
    print(json.dumps({"kernels": [
        kernel_row("pruning_forward", fused_src,
                   "physher_tpu/ops/pallas_fused.py:245",
                   launches_fused["forward"], fused_alone, "forward"),
        kernel_row("pruning_backward", fused_src,
                   "physher_tpu/ops/pallas_fused.py:390",
                   launches_fused["backward"], fused_alone, "backward"),
        kernel_row("wide_forward", wide_src,
                   "physher_tpu/ops/pallas_wide.py:217",
                   wide_launches["forward"], wide_alone, "forward"),
        kernel_row("wide_backward", wide_src,
                   "physher_tpu/ops/pallas_wide.py:396",
                   wide_launches["backward"], wide_alone, "backward"),
        kernel_row("staged_forward", staged_src,
                   "physher_tpu/ops/pallas_staged.py:234",
                   staged_launches["forward"], staged_alone, "forward"),
        kernel_row("staged_backward", staged_src,
                   "physher_tpu/ops/pallas_staged.py:375",
                   staged_launches["backward"], staged_alone, "backward"),
        kernel_row("loop_forward", loop_src,
                   "physher_tpu/ops/pallas_pruning_loop.py:119",
                   ladder_launches["forward"], loop_times["fluA-jc69-L16"],
                   "forward"),
        kernel_row("loop_backward", loop_src,
                   "physher_tpu/ops/pallas_pruning_loop.py:314",
                   hmc_launches["backward"], loop_times["fluA-jc69-L4"],
                   "backward"),
        dict(kernel_row("loop_forward_wide", loop_src,
                        "physher_tpu/ops/pallas_pruning_loop.py:119",
                        codon_launches["forward"],
                        wide_loop_times["gy94-32x4096-L8"], "forward"),
             # the HMC chains' shape beside the codon mcmc's
             wag_g4_64x8192_L4_ms=wide_loop_times["wag-g4-64x8192-L4"][
                 "forward_ms"],
             wag_g4_64x8192_L4_bound_ms=wide_loop_times["wag-g4-64x8192-L4"][
                 "forward_bound_ms"],
             wag_g4_64x8192_L4_launches=hmc_wag_launches["forward"]),
        kernel_row("loop_backward_wide", loop_src,
                   "physher_tpu/ops/pallas_pruning_loop.py:314",
                   hmc_wag_launches["backward"],
                   wide_loop_times["wag-g4-64x8192-L4"], "backward"),
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
