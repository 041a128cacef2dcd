"""On-card check of physher_tpu_torch: builds the CUDA pruning kernels from
this checkout, holds them against their plain PyTorch version, runs the
slices' main paths through them and times kernel against plain:

- nucleotide (K1'/K2', ``csrc/pruning.cu``): fluA likelihoods, gradients
  and the GTR+G4 golden, and Adam steps of GTR+G4 fluA through the pair
  that ``select_engine`` picks;
- codon and protein (K7'/K8', ``csrc/wide.cu``): the libphyc and WAG
  goldens, GY94 and MG94 on codon_small in float32 at the goldens' and
  the degenerate point (through K7'/K8' and, as two chains, K5'/K6')
  against float64, a GY94 M0 fit to data simulated on the card at 32 taxa
  x 4096 codons, and Adam steps of WAG+G4 at 64 taxa x 8192 patterns; K7'
  and K8' (redesigned around K5''s and K6''s node steps,
  ``csrc/wide_forward.cuh`` and ``csrc/wide_backward.cuh``) also on one
  small case per tile shape and cluster size and a WAG tree with
  polytomies, K8' twice on the same inputs (bit for bit), with its
  registers, spills and dP scratch;
- large nucleotide alignments (K3'/K4', ``csrc/staged.cu``) and the
  JSON-config CLI: checkpoint A and the GTR+G4 golden through K3'/K4',
  the reference's fluA ADVI config to checkpoint B (through K1'/K2'), and
  ADVI and ML of a GTR+G4 config on 128 taxa x about 16 000 patterns
  simulated on the card (through K3'/K4'); K3'/K4' against plain also at
  C = 1 and 8, on a tree with polytomies, on the GTR+G4 fluA tree and the
  config's tree, their launches' device times and K3''s launches a sweep
  (the levels below its switch and one walk: 7 at the config's model, 1
  at GTR+G4 fluA) and both twice on the same inputs (bit for bit);
- MCMC and marginal likelihood over a batch of chains (K5'/K6',
  ``csrc/loop.cu``): the kernels against plain on chains of the fluA
  models and on a fluA tree with polytomies, mmcmc (16 temperatures as one
  batch) and marginallikelihood through the CLI on the checkpoint B model,
  mcmc with 8 chains and its loggers on GTR+G4 fluA, and HMC on the
  checkpoint B model; K6' at S = 4 and K2' (their shared reverse step,
  ``csrc/s4_backward.cuh``) also at a 128-taxon caterpillar with 16 384
  patterns and K2' on a fluA tree with polytomies, both twice on the same
  inputs (bit for bit), with their launches' device times; K5' at S = 4
  and K1' (their shared forward step by postorder level,
  ``csrc/s4_forward.cuh``) twice on the same inputs at the checkpoint B
  model and its ladder and HMC chains (bit for bit, their rescaled
  partials peaking at 1), with their launches' device times and
  registers;
- codon and protein MCMC over a batch of chains (K5'/K6' at S != 4, the
  same ``csrc/loop.cu``): the kernels against plain on chains of GY94 M0 at
  32 taxa x 4096 codons, WAG+G4 at 64 taxa x 8192 patterns and a WAG tree
  with polytomies, mcmc with 8 chains through the CLI on a GY94 config over
  data simulated on the card, HMC with 4 chains on WAG+G4 through the API,
  and the config engine names pallas-fused and pallas-loop on the card;
  K5' and K6' at S != 4 also on one small case per instantiation and
  cluster size; K6', K5' and K7' twice on the same inputs (bit for bit; the
  forward's rescaled partials peaking at exactly 1), with their registers,
  spills and the most clusters of K5' and K7' resident at once;
- the ML estimator through the CLI: meta (Adam, L-BFGS, Brent) on
  tests/data/jc69-time.json in float32 and float64 (K1'/K2'), meta with six
  starts on GTR+G4 fluA (the starts as one batch through K5'/K6', then the
  pair that ``select_engine`` picks), both against the JAX package's
  optima; the hessian and laplace actions in float64 (K5'/K6' at L = 2n +
  1) against the port's on the CPU, at the jc69-time optimum and on HKY
  tiny.fa, with the float32 Hessian's error; and an optimizer's CSV
  checkpoint restored through the CLI's ``-c``;
- the other substitution, site and clock models: K1'/K2', K3'/K4' and
  K5'/K6' at S = 4 against plain at C = 3 and 5 (Gamma4+I), each also with
  category 0's P the identity (an invariable category), and the device
  times of K3'/K4' and K5'/K6' at C = 5 beside C = 4 (and K5'/K6' at 8),
  in a CUDA graph over interleaved rounds;
  then through the CLI: GTR+Gamma4+I meta on the fluA time tree against
  the JAX package's optimum (K3'/K4'), ADVI and 8-chain mcmc of the
  fluA-elbo model with Gamma4+I and a lognormal relaxed clock (K3'/K4',
  K5'), UNREST (P(t) by expm) against the JAX package's logP and gradient
  and its meta fit, the jc69w4 (Weibull) golden, and the 128-taxon
  Gamma4+I config against plain with 20 ADVI steps;
- Bayesian model comparison: the skyline, skygrid and piecewise-linear
  coalescents on the fluA time tree against the port on the CPU (float64)
  and an 8-chain skygrid mcmc through the CLI (K5'); one ELBO check of 100
  draws as one batch (K5', ``ml.hessian_chunk`` chunks) against the
  parent's loop of one-chain targets at the checkpoint B model and the
  128-taxon config, with both times, and 20 ADVI steps at gradsamples 4
  (K5'/K6'); on tests/data/fluA-calibrated.json in float64 at its own
  settings, stepping stone, bridge sampling and IS within the JAX
  package's windows at the same settings
  (fluA-calibrated.reference.json), mc, cpo and a short nest, and bridge
  sampling on the card against the CPU on the same draws; MixedMCMC over
  an SSVS local clock with bits [4, N] (K5' at L = 4);
- tree search and ancestral analyses on the fluA NJ tree in float64:
  meta, then asr, ppsite, cat and simultron through the CLI on JC69 and
  GTR+G4 (K1'/K2', K3'/K4'), against the port on the CPU at the same
  parameters, with float32's posterior error, and the parsimony model card
  against CPU; the topology optimizer with NNI and SPR (the neighbourhood
  scored by the dynamic engine, each candidate re-optimized through
  K1'/K2'), its cut held against the CPU's run; and the nni tree MCMC with
  one chain (K1' a proposal) and 8 chains, with and without incremental
  updates (the dynamic engine), each chain's carried log posterior against
  a from-scratch evaluation of its final state;
- the Interface API, the tools and pattern sharding: checkpoint A and its
  rate gradient through ``api.TreeLikelihoodInterface`` on the card in
  float64 (one K1' launch a LogLikelihood, K1' and K2' a Gradient),
  Gradient against TreeLikelihood's autograd, GTR+G4 fluA card against
  CPU (K3'/K4'), and the host time a call; the legacy CLI's fluA run
  against the same run on the CPU (started beside the build), the dumper
  after it, a one-chain nni tree MCMC and the sbn action on its log; every
  kernel pair on pattern shards (the card listed 2 and 4 times, or every
  card when there are two or more) against unsharded in float64 and
  float32, an 8-chain mcmc with --mesh 2x2 through the CLI against the
  unsharded run, and the value-and-gradient time at 1, 2 and 4 shards;
- K1'/K2' at S != 4 (``csrc/pruning.cu`` fused_wide_*_kernel: one launch a
  sweep, K5'/K6''s node steps spread over the card) in the TPU wrapper's
  category-split mode at WAG+G4 64 x 8192 and GY94 M0 32 x 4096 and its
  packed mode at WAG 64 x 8192 and on a 128-taxon caterpillar at 8192,
  float32 and float64: a value and gradient through
  TreeLikelihood(engine="cuda-fused") (one launch of each, nothing else)
  against the plain engine, the kernels against the plain version of the
  mode and against K7'/K8' on the same inputs, each alone timed beside
  K7'/K8', and one sweep replayed three times from a CUDA graph bit for bit
  as the eager call; the staged sweep at S = 20
  (``csrc/wide.cu``'s level kernels) through engine="cuda-staged" and
  against plain; and the ``"pallas-fused"`` WAG+G4 config through the CLI
  (an L-BFGS fit, float64) against ``"pallas-wide"`` at its optimum.

    python3 chip_smoke.py

Needs one NVIDIA GPU (sm_90a) and nvcc; exits non-zero without them or on
any failed phase. Each phase prints one JSON line; the line before the last
is the card's name and power limit from nvidia-smi, and the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import atexit
import io
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
# the codon goldens' parameters, and the points where the generator has
# repeated eigenvalues
CODON_GOLDEN_VALUES = {"gy94": {"kappa": 2.5, "omega": 0.3},
                       "mg94": {"alpha": 1.0, "beta": 0.4, "kappa": 2.0}}
CODON_DEGENERATE_VALUES = {"gy94": {"kappa": 1.0, "omega": 1.0},
                           "mg94": {"alpha": 1.0, "beta": 1.0, "kappa": 1.0}}
# codon models in float32 on codon_small against float64 (P(t) from a
# float64 decomposition of Q): logP within 1e-5 relative, each gradient in
# the model's parameters within 1e-3 of the largest float64 entry, as
# tests/test_torch_codon_protein.py holds them on the CPU
F32_CODON_LOGP_RTOL = 1e-5
F32_CODON_GRAD_ATOL = 1e-3
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


def random_inputs(topo, P, C, seed, dtype, device, datatype="nucleotide",
                  identity=False):
    """Tips [T,S,P] of random states, row-stochastic pmats [N,C,S,S],
    freqs, props, pattern weights (numpy seed). With ``identity``, category
    0's P is the identity on every branch, as an invariable category's."""

    sp = random_sitepattern(topo.T, P, seed=seed, datatype=datatype)
    S = sp.datatype.state_count
    rng = np.random.default_rng(seed)
    Q = rng.random((topo.N, C, S, S)) + 0.1
    pm = Q / Q.sum(-1, keepdims=True)
    if identity:
        pm[:, 0] = np.eye(S)
    freqs = (np.asarray([0.3, 0.2, 0.25, 0.25]) if S == 4
             else rng.dirichlet(np.full(S, 5.0)))
    arrays = (sp.tip_partials(), pm, freqs,
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


def compare(name, topo, inputs, dtype, mod=fused, phase="kernel_vs_plain",
            fns=None):
    """Kernel against plain on one shape (``mod`` is ops.fused, ops.staged
    or ops.wide; ``fns`` a (kernel, reference) pair of site-log functions
    in its place); returns the error record."""
    tol = TOL[dtype]
    kernel, plain = fns or SITE_LOG[mod]
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


def load_fluA_time(dtype, device, pattern_pad_multiple=1):

    with open(DATA / "jc69-time.json") as fh:
        tree_cfg = json.load(fh)["model"]["tree"]
    topo, dist = read_newick(tree_cfg["newick"])
    td = TimeTreeData.from_dated_tree(topo, dist, tree_cfg["dates"])
    sp = SitePattern.from_alignment(read_alignment(str(DATA / "fluA.fa")))
    kw = dict(dtype=dtype, device=device)
    return TreeLikelihood(sp, topo, JC69(**kw),
                          clock=StrictClock(topo.N, rate_init=1e-3, **kw),
                          time_data=td, tipstates=True,
                          pattern_pad_multiple=pattern_pad_multiple, **kw)


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


def golden_lines(case="gtrg4_fluA"):
    """(logP, node ids, the reference's central-difference branch gradients)
    of tests/data/goldens/<case>.txt."""
    logp, node_ids, fd = None, [], []
    with open(DATA / "goldens" / f"{case}.txt") as fh:
        for line in fh:
            if line.startswith("logP "):
                logp = float(line.split()[1])
            elif line.startswith("node "):
                node_ids.append(int(line.split()[3]))
            elif line.startswith("dlogP_fd "):
                fd.append(float(line.split()[2]))
    return logp, node_ids, fd


def codon_small(model, dtype, device, pattern_pad_multiple=1):
    """GY94 or MG94 on codon_small at the golden's parameters; returns
    (model, params, golden logP)."""
    seqs = read_alignment(str(DATA / "codon_small.fa"))
    topo, dist = read_newick((DATA / "codon_small.nwk").read_text().strip())
    sp = SitePattern.from_alignment(seqs, "codon")
    golden = (DATA / "goldens" / "codon_small.txt").read_text()
    maker = {"gy94": GY94, "mg94": MG94}[model]
    values = CODON_GOLDEN_VALUES[model]
    logp = next(float(ln.split()[-1]) for ln in golden.splitlines()
                if ln.startswith(model + " "))
    kw = dict(dtype=dtype, device=device)
    tlk = TreeLikelihood(sp, topo, maker(fixed_freqs=True, **kw),
                         distances_init=dist,
                         pattern_pad_multiple=pattern_pad_multiple, **kw)
    params = tlk.param_space().init_params(**kw)
    params.update({k: torch.tensor(v, **kw) for k, v in values.items()})
    return tlk, params, logp


def codon_value_and_grad(tlk, values):
    """logP of a codon_small model at the model parameters ``values``
    (floats, or lists: one chain each) and its gradient in them, as float64
    numpy."""
    kw = dict(dtype=tlk.dtype, device=tlk.tip_partials.device)
    p = tlk.param_space().init_params(**kw)
    lead = np.shape(next(iter(values.values())))
    p = {k: v.expand(lead + v.shape) for k, v in p.items()}
    p.update({k: torch.tensor(v, **kw).requires_grad_(True)
              for k, v in values.items()})
    logp = tlk.log_likelihood(p)
    grads = torch.autograd.grad(logp.sum(), [p[k] for k in values])
    return (logp.detach().double().cpu().numpy(),
            {k: g.double().cpu().numpy() for k, g in zip(values, grads)})


def codon_float32(dev):
    """(9, float32) GY94 and MG94 on codon_small in float32 at the golden's
    and the degenerate point, through K7'/K8' a point a call and through
    K5'/K6' with the two points as two chains, against the golden logP
    (the degenerate point: float64 on the card, K7'/K8') and the float64
    gradients, at F32_CODON_LOGP_RTOL and F32_CODON_GRAD_ATOL."""
    rec, ok = {}, True
    zero_all_launches()
    for model in ("gy94", "mg94"):
        tlk64, _, golden = codon_small(model, torch.float64, dev)
        tlk32 = codon_small(model, torch.float32, dev)[0]
        points = (CODON_GOLDEN_VALUES[model], CODON_DEGENERATE_VALUES[model])
        refs = [codon_value_and_grad(tlk64, v) for v in points]
        refs[0] = (np.float64(golden), refs[0][1])
        two = {k: [v[k] for v in points] for k in points[0]}
        got = [codon_value_and_grad(tlk32, v) for v in points]
        chains = codon_value_and_grad(tlk32, two)
        got += [(chains[0][i], {k: g[i] for k, g in chains[1].items()})
                for i in range(2)]
        for (val, grad), (ref_val, ref_grad), case in zip(
                got, refs + refs, ("golden_cuda_wide", "degenerate_cuda_wide",
                                   "golden_cuda_loop",
                                   "degenerate_cuda_loop")):
            big = float(max(np.abs(g).max() for g in ref_grad.values()))
            rel = abs(float(val) - float(ref_val)) / abs(float(ref_val))
            g_err = max(float(np.abs(grad[k] - ref_grad[k]).max())
                        for k in ref_grad) / big
            finite = bool(np.isfinite(val).all() and all(
                np.isfinite(g).all() for g in grad.values()))
            good = (finite and rel <= F32_CODON_LOGP_RTOL
                    and g_err <= F32_CODON_GRAD_ATOL)
            rec[f"{model}_{case}"] = dict(
                ok=good, logp=float(val), reference=float(ref_val),
                logp_rel_err=rel,
                grad={k: g.tolist() for k, g in grad.items()},
                grad_f64={k: g.tolist() for k, g in ref_grad.items()},
                grad_err_of_largest=g_err)
            ok = ok and good
        ok = (ok and tlk32.engine_name() == "cuda-wide"
              and tlk32.engine_name(2) == "cuda-loop")
    launches = {"wide_forward": wide.WIDE_FORWARD_LAUNCHES,
                "wide_backward": wide.WIDE_BACKWARD_LAUNCHES,
                "loop_forward": loop.LOOP_FORWARD_LAUNCHES,
                "loop_backward": loop.LOOP_BACKWARD_LAUNCHES}
    ok = ok and min(launches.values()) >= 2
    emit("codon_float32", ok=ok, launches=launches,
         logp_rtol=F32_CODON_LOGP_RTOL, grad_atol=F32_CODON_GRAD_ATOL, **rec)
    check(ok, "codon models in float32 against float64 through K7'/K8' "
          "and K5'/K6'")


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


def gy94_m0_fit_model(dtype, device, seed=11, pattern_pad_multiple=1):
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
                          distances_init=np.full(topo.N - 1, 0.3),
                          pattern_pad_multiple=pattern_pad_multiple, **kw)


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


def random_chains(topo, P, C, L, seed, dtype, device, S=4, identity=False):
    """Random one-hot tips [T,S,P] and L chains' row-stochastic pmats
    [L,N,C,S,S], freqs [L,S], props [L,C], and a cotangent [L,P] (numpy
    seed). With ``identity``, category 0's P is the identity on every
    branch of every chain."""
    rng = np.random.default_rng(seed)
    tips = np.eye(S)[rng.integers(0, S, (topo.T, P))].transpose(0, 2, 1)
    Q = rng.random((L, topo.N, C, S, S)) + 0.1
    pm = Q / Q.sum(-1, keepdims=True)
    if identity:
        pm[:, :, 0] = np.eye(S)
    arrays = (tips, pm,
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
# wide ones take the level schedule after rootw, the fused ones the
# postorder (forward) and preorder (backward) schedules on the device
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
    if mod is fused:
        extra = (cuda_build.postorder_schedule(topo, tips),)
        bwd_extra = (cuda_build.preorder_schedule(topo, tips),)
    else:
        extra = bwd_extra = (cuda_build.level_schedule(topo, tips),)

    def fwd():
        return forward(tips, pmats, children, rootw, *extra)

    def bwd(partials, scale):
        return backward(tips, pmats, children, rootw, *bwd_extra, partials,
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

    postorder = cuda_build.postorder_schedule(topo, tips)

    def fwd():
        return loop.loop_forward(tips, pmats, children, freqs, props,
                                 postorder, rescale)
    site_k, partials, scale = fwd()

    schedule = cuda_build.preorder_schedule(topo, tips)

    def bwd():
        return loop.loop_backward(tips, pmats, children, freqs, props,
                                  schedule, partials, scale, g)
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
    _, partials, scale = loop.loop_forward(
        tips, pmats, children, freqs, props,
        cuda_build.postorder_schedule(topo, tips))
    g = g.contiguous()
    schedule = cuda_build.preorder_schedule(topo, tips)
    return bit_identical(lambda: loop.loop_backward(
        tips, pmats, children, freqs, props, schedule, partials, scale, g))


def k2_deterministic(topo, tips, pmats, freqs, props, g) -> bool:
    """K2' twice on the same inputs: bit-identical d pmats and d rootw."""
    children = topo_constant(topo, "children", lambda: topo.children, tips,
                             torch.int32)
    rootw = (props[:, None] * freqs[None, :]).reshape(-1).contiguous()
    _, partials, scale = fused.pruning_forward(
        tips, pmats, children, rootw, cuda_build.postorder_schedule(topo, tips))
    g = g.contiguous()
    schedule = cuda_build.preorder_schedule(topo, tips)
    return bit_identical(lambda: fused.pruning_backward(
        tips, pmats, children, rootw, schedule, partials, scale, g))


def s4_launch_us(run_backward) -> list:
    """Device time (us, torch.profiler) of each launch of one K2' or K6'
    call at S = 4: the walk, then the dP pass."""
    # chip_profile imports this module, so it is imported here
    from chip_profile import launch_device_us

    return launch_device_us(run_backward, ("s4_walk", "s4_dp"))


def s4_forward_checks(run, dims) -> dict:
    """K1' or K5' at S = 4 (``run()``: one wrapper call) twice on the same
    inputs: bit-identical site logs, partials and scalers, and rescaled
    partials that peak at exactly 1 over (C, 4) (``dims``) at every node and
    pattern (x / max x: the lane group's max met); and its launch's device
    time (us, one of 20 calls in a CUDA graph: torch.profiler stops seeing
    kernels after a few sessions in one process)."""
    # chip_profile imports this module, so it is imported here
    from chip_profile import graph_launch_us

    runs = [run() for _ in range(2)]
    torch.cuda.synchronize()
    return {"bit_identical": all(torch.equal(a, b) for a, b in zip(*runs)),
            "partials_peak_1": bool(torch.all(runs[0][1].amax(dims) == 1)),
            "graph_us": graph_launch_us(run)}


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


def staged_checks(topo, tips, pmats, freqs, props, g) -> dict:
    """K3' and K4' on one model's inputs: each launch's device time (us,
    torch.profiler, None where it saw no kernel; K3''s levels below the
    switch leaves first, then its walk of the rest, ``s4_forward_kernel``
    or ``forward_chain``; K4''s root seed, levels root first and last
    sum), K3''s kernel launches a sweep as its C code counts them
    (``staged.STAGED_FORWARD_KERNELS``) and as ``staged.forward_launches``
    plans them, and both twice on the same inputs (bit-identical site
    logs, partials, scalers, d pmats and d rootw)."""
    # chip_profile imports this module, so it is imported here
    from chip_profile import launch_device_us

    children = topo_constant(topo, "children", lambda: topo.children, tips,
                             torch.int32)
    rootw = (props[:, None] * freqs[None, :]).reshape(-1).contiguous()
    schedule = cuda_build.level_schedule(topo, tips)
    g = g.contiguous()
    top, walk = staged.walk_level(
        schedule[1], pmats.shape[1], tips.shape[2],
        torch.cuda.get_device_properties(tips.device).multi_processor_count)

    def fwd():
        return staged.staged_forward(tips, pmats, children, rootw, schedule)
    k0 = staged.STAGED_FORWARD_KERNELS
    _, partials, logscale = fwd()
    kernels = staged.STAGED_FORWARD_KERNELS - k0

    def bwd():
        return staged.staged_backward(tips, pmats, children, rootw, schedule,
                                      partials, logscale, g)
    fwd_us = launch_device_us(fwd, ("forward_level", "s4_forward_kernel",
                                    "forward_chain"))
    return {"switch_level": top, "walk": walk,
            "forward_kernels_a_sweep": kernels,
            "forward_launches_planned": staged.forward_launches(
                schedule[1], top),
            "forward_launches_profiled": len(fwd_us) if fwd_us else None,
            "forward_launch_us": fwd_us,
            "backward_launch_us": launch_device_us(
                bwd, ("backward_root", "backward_level", "backward_sum")),
            "forward_bit_identical": bit_identical(fwd),
            "backward_bit_identical": bit_identical(bwd)}


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
            ("k5", lambda: loop.loop_forward(
                tips, pmats, children, freqs, props,
                cuda_build.postorder_schedule(topo, tips)), (2, 3)),
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
# K2''s further shapes, for its reverse step (csrc/s4_backward.cuh, shared
# with K6' at S = 4): (name, topology, patterns, categories); the 128-taxon
# caterpillar has 127 preorder levels of one node and takes eight dP chunks
# (C x internal nodes / levels is 1-2 there, under the staged gate, so the
# main path reaches K2' at such P), and a fluA tree with polytomies
S4_SHAPES = [
    ("caterpillar-128x16384-C1", lambda: caterpillar_topology(128), 16384, 1),
    ("caterpillar-128x16384-C2", lambda: caterpillar_topology(128), 16384, 2),
    ("fluA-polytomy-238-C4",
     lambda: collapsed_topology(load_fluA_time(torch.float64, "cpu").topo),
     238, 4),
]
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


def gtrg4_flua_topology():
    """The GTR+G4 fluA golden's tree (69 taxa, 21 levels)."""
    with open(DATA / "goldens" / "gtrg4_fluA.json") as fh:
        return read_newick(json.load(fh)["model"]["tree"]["newick"])[0]


def config_128_topology():
    """The tree of the 128-taxon GTR+G4 config (cli_staged_large)."""
    return read_newick(random_dated_tree(128, 13)[0])[0]


# K3'/K4' against plain: (name, topology, patterns, categories): the JAX
# package's large shape, a caterpillar (one node per level, the prototype
# K9's many-step case), a ragged pattern count, C = 1 and 8 (one and eight
# warps a pattern row in K4'), a tree with polytomies (K4''s general path),
# the GTR+G4 fluA tree (K3' walks it whole) and the 128-taxon config's
# tree (K3''s switch at level 3)
STAGED_SHAPES = [
    ("balanced-128x16384-C4", lambda: balanced_topology(128), 16384, 4),
    ("caterpillar-64x8192-C4", lambda: caterpillar_topology(64), 8192, 4),
    ("balanced-128x8229-C4", lambda: balanced_topology(128), 8192 + 37, 4),
    ("balanced-64x2000-C1", lambda: balanced_topology(64), 2000, 1),
    ("caterpillar-32x700-C8", lambda: caterpillar_topology(32), 700, 8),
    ("polytomy-64x1500-C4",
     lambda: collapsed_topology(balanced_topology(64)), 1500, 4),
    ("fluA-gtrg4-238-C4", gtrg4_flua_topology, 238, 4),
    ("config-128x16291-C4", config_128_topology, 16291, 4),
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
                 seed: int = 13, invariant: bool = False,
                 advi_steps: int = 200):
    """Simulate a GTR+G4 alignment down a random dated tree on ``dev`` and
    write it as FASTA with a config that mirrors tests/data/fluA-elbo.json:
    GTR+G4 (with ``invariant``, Gamma4+I), a strict clock on a time tree, a
    constant coalescent, oneonx and ctmcscale priors, mean-field blocks;
    action: ``advi_steps`` steps of ADVI. Returns (config path, pattern
    count)."""
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
             "model": "&varnormal", "eta": 0.1, "tol": 1e-5,
             "max": advi_steps},
        ],
    }
    if invariant:
        cfg["model"]["distributions"][0]["sitemodel"]["distribution"][
            "proportions"] = {"id": "pinv", "type": "Simplex",
                              "values": [0.1, 0.9]}
    path = workdir / "large.json"
    path.write_text(json.dumps(cfg, indent=1))
    return path, n_patterns


def run_cli(argv):
    """The port's CLI in-process: (runner, printed lines)."""
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
    # the hot rungs sample the (improper) prior far from the data, where
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
    events), in float32 and in float64, the dtype P(t) decomposes Q in."""
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
    # float32 models decompose Q in float64 (models/substitution.py)
    sym64 = sym.double()
    eigh64_ms = median_ms(lambda: torch.linalg.eigh(sym64), reps=20)
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
         eigh_8x61x61_f32_ms=eigh_ms, eigh_8x61x61_f64_ms=eigh64_ms,
         launches=launches,
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
    ``pallas-fused`` runs K1' (packed at S = 20, C = 1) and with
    ``pallas-loop`` K5' for a batch of 2 chains and for one dict, each at
    the ``auto`` build's logP (K7')."""
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
        zero_all_launches()
        fused_one = float(models["pallas-fused"].log_likelihood(
            auto.param_space().init_params(**kw)))
        fused_launches = fused.FORWARD_LAUNCHES
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
    ok = bool(names["pallas-fused"] == ("cuda-fused", "cuda-loop")
              and names["pallas-loop"] == ("cuda-loop", "cuda-loop")
              and names["auto"] == ("cuda-wide", "cuda-loop")
              and fused_launches == 1 and wide_launches == 0
              and loop_launches_ == 2 and max(errs.values()) <= 1e-12)
    emit("engine_names", ok=ok, engines=names, logp_auto=ref_one,
         rel_err=errs, rtol=1e-12, fused_launches=fused_launches,
         wide_launches=wide_launches, loop_launches=loop_launches_)
    check(ok, "the pallas-* engine names on the card")


# The JAX package's ML optima on the CPU in float64, for the ML phases:
# `python -m physher_tpu.cli tests/data/jc69-time.json` prints "Maximum log
# likelihood: -4341.059554" (meta + serial: the ratios and root height,
# the clock rate fixed), and the same CLI on gtrg4_meta_config's file
# "-4089.521845" (an unrestricted meta with six starts; about 60 s)
JAX_JC69_TIME_ML = -4341.059554
JAX_GTRG4_META_ML = -4089.521845
# the card's Hessian and Laplace estimate in float64 against the port's on
# the CPU (the same differences, other summation orders), and the float32
# Hessian's relative Frobenius error against float64
HESSIAN_RTOL, LAPLACE_RTOL, HESSIAN_F32_FROB = 1e-6, 1e-6, 5e-2


def all_launches() -> dict:
    return {"fused_forward": fused.FORWARD_LAUNCHES,
            "fused_backward": fused.BACKWARD_LAUNCHES,
            "staged_forward": staged.STAGED_FORWARD_LAUNCHES,
            "staged_backward": staged.STAGED_BACKWARD_LAUNCHES,
            "loop_forward": loop.LOOP_FORWARD_LAUNCHES,
            "loop_backward": loop.LOOP_BACKWARD_LAUNCHES,
            "wide_forward": wide.WIDE_FORWARD_LAUNCHES,
            "wide_backward": wide.WIDE_BACKWARD_LAUNCHES}


def zero_all_launches():
    zero_launches()
    wide.WIDE_FORWARD_LAUNCHES = wide.WIDE_BACKWARD_LAUNCHES = 0


def maximum_line(lines) -> float:
    line = next(ln for ln in lines if ln.startswith("Maximum log likelihood"))
    return float(line.split()[3])


def ml_meta_time(dev):
    """The reference's time-tree ML config (tests/data/jc69-time.json: meta
    with a serial sub-optimizer, so Adam, L-BFGS and Brent over the ratios
    and root height) through the CLI on the card, float32 and float64
    (K1'/K2'): the maximum past -4400 (the start is -4786.87), float64
    within 0.05 of the JAX package's. Returns the float64 run's Runner and
    launches."""
    rec, ok, runner64 = {"card": nvidia_smi()}, True, None
    for label, extra in (("f32", []), ("f64", ["--f64"])):
        zero_all_launches()
        t0 = time.perf_counter()
        runner, lines = run_cli([DATA / "jc69-time.json", *extra])
        wall = time.perf_counter() - t0
        res = runner.results["metaopt"]
        tlk = runner.ctx.objects["treelikelihood"]
        launches = all_launches()
        logp = maximum_line(lines)
        rec[label] = dict(logp=logp, iterations=res.iterations,
                          wall_seconds=wall, meta_seconds=res.seconds,
                          engine=tlk.engine_name(), scope=sorted(res.params),
                          launches=launches)
        ok = bool(ok and logp > -4400 and tlk.engine_name() == "cuda-fused"
                  and sorted(res.params) == ["tree.ratios",
                                             "tree.root_height"]
                  and launches["fused_forward"] >= res.iterations
                  and launches["fused_backward"] >= res.iterations)
        runner64 = runner
    err = rec["f64"]["logp"] - JAX_JC69_TIME_ML
    ok = ok and abs(err) <= 0.05
    emit("ml_meta_time", ok=ok, jax_cpu_f64=JAX_JC69_TIME_ML, f64_err=err,
         tolerance=0.05, **rec)
    check(ok, "jc69-time.json's meta optimizer through the CLI on the card")
    return runner64, rec["f64"]["launches"]


def gtrg4_meta_config(workdir: Path, starts: int = 6) -> Path:
    """tests/data/goldens/gtrg4_fluA.json's model (GTR+G4 on the fluA
    tree) under an unrestricted meta optimizer with ``starts`` starts."""
    cfg = json.loads((DATA / "goldens" / "gtrg4_fluA.json").read_text())
    cfg["model"]["sitepattern"]["alignment"]["file"] = str(DATA / "fluA.fa")
    cfg["physher"] = [{"id": "ml", "type": "optimizer", "algorithm": "meta",
                       "precision": 0.001, "max": 10000,
                       "model": "&treelikelihood", "starts": starts}]
    path = workdir / "gtrg4-meta.json"
    path.write_text(json.dumps(cfg))
    return path


def ml_meta_gtrg4():
    """GTR+G4 fluA under meta with six starts through the CLI on the card:
    the starts' warmup as one batch (K5'/K6' at L = 6, one launch pair a
    step), then the one-dict kernels that select_engine picks; float64
    reaches the JAX package's maximum less 0.1, float32 is printed.
    Returns the float64 run's launches."""
    rec, ok = {"card": nvidia_smi()}, True
    with tempfile.TemporaryDirectory() as tmp:
        path = gtrg4_meta_config(Path(tmp))
        for label, extra in (("f64", ["--f64"]), ("f32", [])):
            zero_all_launches()
            t0 = time.perf_counter()
            runner, lines = run_cli([path, *extra])
            wall = time.perf_counter() - t0
            res = runner.results["ml"]
            tlk = runner.ctx.objects["treelikelihood"]
            launches = all_launches()
            rec[label] = dict(logp=maximum_line(lines),
                              iterations=res.iterations, wall_seconds=wall,
                              meta_seconds=res.seconds,
                              engine=tlk.engine_name(),
                              batch_engine=tlk.engine_name(6),
                              launches=launches)
            pair = tlk.engine_name().removeprefix("cuda-")
            # the warmup: 300 steps and the final values at L = 6; nothing
            # else is batched
            ok = bool(ok and launches["loop_forward"] == 301
                      and launches["loop_backward"] == 300
                      and tlk.engine_name(6) == "cuda-loop"
                      and pair in ("fused", "staged")
                      and launches[f"{pair}_forward"] >= res.iterations
                      and launches[f"{pair}_backward"] >= res.iterations
                      and np.isfinite(rec[label]["logp"]))
    err = rec["f64"]["logp"] - JAX_GTRG4_META_ML
    ok = ok and err >= -0.1
    emit("ml_meta_gtrg4", ok=ok, jax_cpu_f64=JAX_GTRG4_META_ML,
         f64_err=err, tolerance=-0.1, **rec)
    check(ok, "GTR+G4 fluA meta with six starts through the CLI on the card")
    return rec["f64"]["launches"]


def hky2_config(workdir: Path, physher: list, name: str) -> Path:
    """tests/data/goldens/hky2.json's model (HKY on tiny.fa) with the action
    list ``physher``."""
    cfg = json.loads((DATA / "goldens" / "hky2.json").read_text())
    cfg["model"]["sitepattern"]["alignment"]["file"] = str(DATA / "tiny.fa")
    cfg["physher"] = physher
    path = workdir / name
    path.write_text(json.dumps(cfg))
    return path


def hessian_laplace(dev, time_runner):
    """The hessian and laplace actions in float64 at the jc69-time optimum
    (the float64 ml_meta_time run's) and on hky2 (kappa and the
    frequencies carry the d2/dQ2 terms): the card's (K5'/K6' at L = 2n + 1,
    one launch pair a call) against the port's on the CPU, and the float32
    Hessian against float64. Returns the float64 Hessian's launches at the
    jc69-time optimum."""
    from physher_tpu_torch.config.actions import Runner
    from physher_tpu_torch.config.builder import build_config, load_json

    rec, ok = {"card": nvidia_smi()}, True
    with tempfile.TemporaryDirectory() as tmp:
        hky = hky2_config(Path(tmp), [], "hky2.json")
        tlk = time_runner.ctx.objects["treelikelihood"]
        point = {k: v.detach().cpu() for k, v in
                 time_runner.params_for(tlk.param_space()).items()}
        for name, path, at in (("jc69_time_optimum", DATA / "jc69-time.json",
                                point), ("hky2", hky, None)):
            out = {}
            for where, dtype, device in (("card", torch.float64, dev),
                                         ("cpu", torch.float64, "cpu"),
                                         ("card_f32", torch.float32, dev)):
                ctx, _ = build_config(load_json(str(path)),
                                      base_dir=str(DATA), dtype=dtype,
                                      device=device)
                runner = Runner(ctx, out=io.StringIO())
                model = ctx.objects["treelikelihood"]
                if at is not None:
                    runner.pool = {k: v.to(dtype=dtype, device=device)
                                   for k, v in at.items()}
                node = {"model": "&treelikelihood", "id": "x"}
                zero_all_launches()
                t0 = time.perf_counter()
                H = runner.action_hessian(node)
                hessian_s = time.perf_counter() - t0
                hess_launches = all_launches()
                lap = (runner.action_laplace(node) if where != "card_f32"
                       else None)
                out[where] = dict(H=H, laplace=lap, seconds=hessian_s,
                                  launches=hess_launches,
                                  n=model.param_space().unconstrained_size,
                                  engine=model.engine_name(
                                      2 * model.param_space()
                                      .unconstrained_size + 1))
            card, cpu, f32 = out["card"], out["cpu"], out["card_f32"]
            h_err = float(np.abs(card["H"] - cpu["H"]).max()
                          / np.abs(cpu["H"]).max())
            lap_err = abs(card["laplace"] / cpu["laplace"] - 1.0)
            frob = float(np.linalg.norm(f32["H"] - card["H"])
                         / np.linalg.norm(card["H"]))
            calls = card["launches"]
            rec[name] = dict(
                n=card["n"], rows=2 * card["n"] + 1, engine=card["engine"],
                hessian_rel_err_vs_cpu=h_err, laplace_card=card["laplace"],
                laplace_cpu=cpu["laplace"], laplace_rel_err=lap_err,
                f32_frobenius_rel_err=frob, hessian_seconds=card["seconds"],
                hessian_seconds_f32=f32["seconds"],
                hessian_seconds_cpu=cpu["seconds"], launches=calls,
                launches_f32=f32["launches"], max_abs_h=float(
                    np.abs(cpu["H"]).max()))
            ok = bool(ok and h_err <= HESSIAN_RTOL and lap_err <= LAPLACE_RTOL
                      and frob <= HESSIAN_F32_FROB
                      and card["engine"] == "cuda-loop"
                      and calls["loop_forward"] == 1
                      and calls["loop_backward"] == 1
                      and f32["launches"]["loop_forward"] == 1)
    emit("hessian_laplace", ok=ok, hessian_rtol=HESSIAN_RTOL,
         laplace_rtol=LAPLACE_RTOL, f32_frobenius_bound=HESSIAN_F32_FROB,
         **rec)
    check(ok, "the hessian and laplace actions on the card against the CPU")
    return rec["jc69_time_optimum"]["launches"]


def ml_checkpoint():
    """An sg optimizer with a "checkpoint" writes the CSV on the card
    (float32); the CLI's -c seeds the next run's pool with the same
    values, which its logger reads."""
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        ckpt = tmp / "ml.csv"
        fit = hky2_config(tmp, [
            {"id": "ml", "type": "optimizer", "algorithm": "sg",
             "model": "&treelikelihood", "precision": 1e-3,
             "checkpoint": str(ckpt)}], "fit.json")
        log = hky2_config(tmp, [{"id": "log", "type": "logger",
                                 "models": ["&treelikelihood"]}], "log.json")
        zero_all_launches()
        runner, _ = run_cli([fit])
        launches = all_launches()
        res = runner.results["ml"]
        rows = ckpt.read_text().splitlines()
        restored, lines = run_cli([log, "-c", ckpt])
        tlk = runner.ctx.objects["treelikelihood"]
        with torch.no_grad():
            at = float(tlk.log_likelihood(runner.params_for(
                tlk.param_space())))
    same = all(torch.equal(restored.pool[k], v.detach())
               for k, v in res.params.items())
    logged = float(lines[0].split()[1])
    ok = bool(same and len(rows) == sum(v.numel() for v in
                                        res.params.values())
              and abs(logged - at) <= 1e-6
              and launches["fused_forward"] >= res.iterations)
    emit("checkpoint", ok=ok, rows=len(rows), restored_equal=same,
         logged=logged, logp_at_checkpoint=at, iterations=res.iterations,
         dtype=str(restored.ctx.dtype), launches=launches)
    check(ok, "an optimizer's checkpoint restored through the CLI's -c")


# -- the fourteenth slice: the other substitution, site and clock models --

# GTR as tests/data/goldens/gtrg4_fluA.json gives it (GT at 1)
GTR_NODE = {"id": "sm", "type": "substitutionmodel", "model": "gtr",
            "datatype": "nucleotide",
            "frequencies": {"id": "freqs", "type": "Simplex",
                            "values": [0.34, 0.18, 0.21, 0.27]},
            "rates": {k: {"id": k, "type": "parameter", "value": v,
                          "lower": 0}
                      for k, v in zip(["ac", "ag", "at", "cg", "ct"],
                                      [1.7, 5.2, 0.9, 0.6, 6.1])}}
# Gamma4+I: four median Gamma categories beside the invariable one (C = 5)
G4I_NODE = {"distribution": "gamma", "categories": 4,
            "parameters": {"id": "alpha", "type": "parameter",
                           "value": 0.5, "lower": 0},
            "proportions": {"id": "pinv", "type": "Simplex",
                            "values": [0.1, 0.9]}}
META_ACTION = {"id": "ml", "type": "optimizer", "algorithm": "meta",
               "precision": 0.001, "max": 10000, "model": "&treelikelihood"}


def flua_time_config(workdir: Path, name: str, subst: dict,
                     distribution: dict | None = None,
                     physher: list | None = None) -> Path:
    """tests/data/jc69-time.json's fluA time tree and strict clock with the
    substitution model ``subst`` and the site model's ``distribution``,
    under an unrestricted meta optimizer (or ``physher``). The height
    transform's Jacobian is left out: with the clock rate free it grows
    without bound as the root height does, at a likelihood that stays
    put."""
    cfg = json.loads((DATA / "jc69-time.json").read_text())
    m = cfg["model"]
    m["reparameterized"] = False
    m["sitepattern"]["alignment"]["file"] = str(DATA / "fluA.fa")
    m["sitemodel"]["substitutionmodel"] = subst
    if distribution is not None:
        m["sitemodel"]["distribution"] = distribution
    cfg["physher"] = [META_ACTION] if physher is None else physher
    path = workdir / name
    path.write_text(json.dumps(cfg))
    return path


# kernel-against-plain shapes at the categories of Gamma4+I (C = 5) and a
# three-class model (C = 3): (name, topology, patterns, categories, module)
FAMILY_SHAPES = [
    ("fluA-238-C5", lambda: load_fluA_time(torch.float64, "cpu").topo, 238,
     5, fused),
    ("caterpillar-128x4096-C3", lambda: caterpillar_topology(128), 4096, 3,
     fused),
    ("balanced-128x16384-C5", lambda: balanced_topology(128), 16384, 5,
     staged),
    ("balanced-48x1537-C3", lambda: balanced_topology(48), 1537, 3, staged),
]


# K5'/K6' at S = 4 on the fluA tree: (chains, categories); C = 3 is padded
# onto the lanes of C' = 4, C = 5 onto those of C' = 8
FAMILY_LOOP = [(8, 5), (4, 3)]


def family_kernels(dev):
    """K1'/K2' and K3'/K4' at FAMILY_SHAPES and K5'/K6' at S = 4 on the
    fluA tree at FAMILY_LOOP against plain, float32 and float64, each also
    with category 0's P the identity on every branch (the invariable
    category's)."""
    shapes = [(name, make(), P, C, mod) for name, make, P, C, mod in
              FAMILY_SHAPES]
    flu = shapes[0][1]
    for dtype in (torch.float32, torch.float64):
        for identity in (False, True):
            tag = "-identity" if identity else ""
            for name, topo, P, C, mod in shapes:
                compare(name + tag, topo,
                        random_inputs(topo, P, C, 17, dtype, dev,
                                      identity=identity),
                        dtype, mod=mod, phase="family_kernel_vs_plain")
            for L, C in FAMILY_LOOP:
                loop_alone(f"fluA-238-C{C}-L{L}{tag}", flu,
                           *random_chains(flu, 238, C, L, 19, dtype, dev,
                                          identity=identity),
                           phase="family_loop_vs_plain")
            torch.cuda.synchronize()


def staged_calls(topo, tips, pmats, freqs, props, g):
    """K3' and K4' as two closures on one model's inputs (K4' on the
    partials of one K3' call), for timing."""
    children = topo_constant(topo, "children", lambda: topo.children, tips,
                             torch.int32)
    rootw = (props[:, None] * freqs[None, :]).reshape(-1).contiguous()
    schedule = cuda_build.level_schedule(topo, tips)
    _, partials, scale = staged.staged_forward(tips, pmats, children, rootw,
                                               schedule)
    return {"forward": lambda: staged.staged_forward(
                tips, pmats, children, rootw, schedule),
            "backward": lambda: staged.staged_backward(
                tips, pmats, children, rootw, schedule, partials, scale, g)}


def loop_calls(topo, tips, pmats, freqs, props, g):
    """K5' and K6' as two closures on one batch of chains, as
    :func:`staged_calls`."""
    children = topo_constant(topo, "children", lambda: topo.children, tips,
                             torch.int32)
    post = cuda_build.postorder_schedule(topo, tips)
    pre = cuda_build.preorder_schedule(topo, tips)
    _, partials, scale = loop.loop_forward(tips, pmats, children, freqs,
                                           props, post)
    return {"forward": lambda: loop.loop_forward(
                tips, pmats, children, freqs, props, post),
            "backward": lambda: loop.loop_backward(
                tips, pmats, children, freqs, props, pre, partials, scale,
                g)}


def family_times(smi, rounds=7):
    """Device times of K3'/K4' at balanced 128 x 16384 and of K5'/K6' at
    S = 4 on 8 chains of the fluA tree at C = 4 and 5 (and 8: the S = 4
    walks put C = 5 on the lanes of C' = 8), float32. Each time is one
    wrapper call's device time in a CUDA graph (chip_profile's
    graph_launch_us: the host's time, which the S = 4 walks' wrappers
    exceed, drops out); the C values are timed in ``rounds`` interleaved
    rounds, their order reversed every other round, and each round gives
    a C = 5 over C = 4 ratio. K5'/K6' at C = 4 and 8 are first held
    against plain (:func:`loop_alone`)."""
    # chip_profile imports this module, so it is imported here
    from chip_profile import graph_launch_us

    rec = {"card": smi, "rounds": rounds, "timer": "graph_launch_us"}
    topo = balanced_topology(128)
    flu = load_fluA_time(torch.float64, "cpu").topo
    dev = torch.device("cuda", 0)
    calls = {}
    for C in (4, 5):
        calls[f"staged-balanced-128x16384-C{C}"] = (C, staged_calls(
            topo, *random_inputs(topo, 16384, C, 7, torch.float32, dev)))
    for C in (4, 5, 8):
        chains = random_chains(flu, 238, C, 8, 23, torch.float32, dev)
        if C != 5:
            loop_alone(f"fluA-238-C{C}-L8", flu, *chains,
                       phase="family_loop_vs_plain")
        calls[f"loop-fluA-238-C{C}-L8"] = (C, loop_calls(flu, *chains))
    times = {name: {"forward": [], "backward": []} for name in calls}
    names = list(calls)
    for r in range(rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            for kind, run in calls[name][1].items():
                times[name][kind].append(graph_launch_us(run) / 1e3)
    for name, by_kind in times.items():
        rec[name] = {f"{kind}_ms": statistics.median(ms)
                     for kind, ms in by_kind.items()}
        rec[name]["rounds_ms"] = by_kind
    for shape in ("staged-balanced-128x16384", "loop-fluA-238"):
        suffix = "-L8" if shape.startswith("loop") else ""
        for kind in ("forward", "backward"):
            ratios = [b / a for a, b in zip(
                times[f"{shape}-C4{suffix}"][kind],
                times[f"{shape}-C5{suffix}"][kind])]
            rec[f"{shape}{suffix}-{kind}-C5_over_C4"] = {
                "median": statistics.median(ratios),
                "min": min(ratios), "max": max(ratios)}
    emit("family_times", **rec)
    return rec


# The JAX package's optimum on the CPU in float64, for the fourteenth
# slice's path (a): `python -m physher_tpu.cli gtrg4i-time.json --f64` on
# the file that flua_time_config(workdir, "gtrg4i-time.json", GTR_NODE,
# G4I_NODE) writes (GTR+Gamma4+I on the fluA time tree, strict clock,
# unrestricted meta) prints "Maximum log likelihood: -4144.687316 (503
# iterations)" (about 65 s); the port on the CPU -4144.686883 (511). The
# same CLI on unrest-time.json (UNREST_NODE) prints "-inf": its gradient in
# the rates is NaN at the start (see JAX_UNREST_START), so no optimum of
# the JAX package is held there.
JAX_GTRG4I_TIME_ML = -4144.687316


UNREST_NODE = {"id": "sm", "type": "substitutionmodel", "model": "unrest",
               "datatype": "nucleotide"}
# UNREST's rates at the second point of the start comparison: at the
# config's start (all rates 1, Q is JC69's) the JAX package's gradient in
# the rates is NaN (its lstsq's derivative at repeated singular values), so
# "start" holds the rest of its gradient and "moved" all of it at these
# rates, the rest of the parameters at their start. Made with the JAX
# package (float64, CPU): build_config of flua_time_config(workdir,
# "unrest-time.json", UNREST_NODE)'s file, engine "xla", then
# jax.jit(jax.value_and_grad(tlk.log_likelihood)) at
# tlk.param_space().init_params() and with "sm.rates" set to these.
UNREST_MOVED_RATES = 0.5 + np.arange(12) / 8.0
JAX_UNREST_START = (
    {'moved': {'grad': {'bm.rate': 322132.0902305796,
                        'sm.rates': [-11.39544235473413, 69.51320212383862,
                                     -9.559696272039428, 12.911037644428317,
                                     -16.991074239389995, 28.983451084193945,
                                     49.70735917781424, -32.09170847255798,
                                     -10.80444508140454, -19.866248790135806,
                                     8.865084936808444, -22.67914702455647],
                        'tree.ratios': [-0.6311177969889731, 6.404151137456436,
                                        8.827990524411097, 5.132271071773341,
                                        -5.2847063312751335, 2.718152697588011,
                                        1.9875118785841908, 3.9045792088356284,
                                        5.451923472587736, 9.461629128341661,
                                        15.128366625892086, 34.757610913388284,
                                        72.14074319357682, 95.35970054473215,
                                        14.852660319980913, 14.91855423175683,
                                        -1.362657155517958, 10.8706152351495,
                                        19.53816011900858, 21.166728652918138,
                                        38.97017334419405, 3.582085571077318,
                                        11.093044161658987, 12.1575752293598,
                                        70.3389637540082, -3.94837552818883,
                                        86.8849910607432, 3.5030652705467844,
                                        18.27433051813125, 6.0066112302443955,
                                        19.630967202238253, 23.01225330774605,
                                        22.459168666442757, 1.7695643800710261,
                                        9.266155897154643, 53.149260796661,
                                        41.59688310306893, 10.692954462084309,
                                        4.1399384809463875, 3.300052516976889,
                                        -4.668364155061688, 27.038240872020964,
                                        53.89779565371934, 150.18618542092855,
                                        23.50317862464312, 14.158564704847223,
                                        1.3241888862370708, 16.73659790341985,
                                        26.05030303853376, 3.448358604698746,
                                        4.060261182719826, 10.147148320648567,
                                        15.400878660659895, 69.7839565057381,
                                        4.165264227118758, 5.823403813043434,
                                        37.71654382661896, 3.4322585443818143,
                                        65.47863995020116, 7.583681906773629,
                                        5.7629922602418, 3.9285764309793123,
                                        5.399841425119437, 39.74137662839564,
                                        30.074491803636022, 3.193054001682466,
                                        6.8490734803192055],
                        'tree.root_height': 17.220164190912662},
               'logp': -4783.756357468143},
     'start': {'grad': {'bm.rate': 328017.67328134074,
                        'tree.ratios': [-0.593653664221372, 6.441289658869023,
                                        8.92145177998426, 5.17392443903548,
                                        -5.118948603352916, 2.73140189672864,
                                        2.0078824725492397, 3.956031262798641,
                                        5.542287760476407, 9.566238093866211,
                                        15.276905670004258, 35.18003581182308,
                                        73.0043687778072, 96.69564894572781,
                                        14.991147746063277, 15.285818508376543,
                                        -1.3363345353514546, 10.9410898481444,
                                        19.643146962059106, 21.46013340961518,
                                        39.139452337512466, 3.6372759221191977,
                                        11.269174317983506, 12.443235860074665,
                                        71.12758013218425, -3.8069961277877074,
                                        88.12588290657769, 3.599600183030489,
                                        18.47948570610025, 6.036534490721635,
                                        19.84110328156244, 23.24734623488598,
                                        22.733164231934566, 1.8172474126370375,
                                        9.368306385819672, 54.08739297310047,
                                        42.35386071758681, 10.67977767411859,
                                        4.140801615931922, 3.3305556707251966,
                                        -4.622247216605132, 27.320694183101118,
                                        54.314129320904975, 152.27137882559458,
                                        23.54087488762284, 14.306570584262353,
                                        1.22256815610141, 16.980030076371335,
                                        26.380172461496038, 3.4861149347894544,
                                        4.098873332099792, 10.26781221671924,
                                        15.592298788222056, 70.94321518451105,
                                        4.240029132899423, 6.016353791291138,
                                        38.34349768432318, 3.488515635005263,
                                        66.51533636215461, 7.694985489228406,
                                        5.883423757662067, 3.9810161028136086,
                                        5.470071627031155, 40.519127249010204,
                                        30.451660702188576, 2.8408309399005915,
                                        6.80252182038415],
                        'tree.root_height': 17.49248495783966},
               'logp': -4777.6163497139805}})


def family_meta_gtrg4i():
    """(a) GTR+Gamma4+I (C = 5) on the fluA time tree with a strict clock
    under an unrestricted meta optimizer through the CLI in float64: the
    maximum within 0.05 of the JAX package's, through K3'/K4' (the staged
    gate takes C = 5 at fluA), their launches counted."""
    with tempfile.TemporaryDirectory() as tmp:
        path = flua_time_config(Path(tmp), "gtrg4i-time.json", GTR_NODE,
                                G4I_NODE)
        zero_all_launches()
        t0 = time.perf_counter()
        runner, lines = run_cli([path, "--f64"])
        wall = time.perf_counter() - t0
    launches = all_launches()
    res = runner.results["ml"]
    tlk = runner.ctx.objects["treelikelihood"]
    logp = maximum_line(lines)
    err = logp - JAX_GTRG4I_TIME_ML
    ok = bool(abs(err) <= 0.05 and tlk.engine_name() == "cuda-staged"
              and tlk.site_model.cat_count == 5
              and launches["staged_forward"] >= res.iterations
              and launches["staged_backward"] >= res.iterations)
    emit("family_meta_gtrg4i", ok=ok, logp=logp,
         jax_cpu_f64=JAX_GTRG4I_TIME_ML, err=err, tolerance=0.05,
         iterations=res.iterations, wall_seconds=wall,
         meta_seconds=res.seconds, engine=tlk.engine_name(),
         launches=launches, estimates={k: v.tolist() for k, v in (
             (k, runner.params_for(tlk.param_space())[k].cpu().numpy())
             for k in ("sitemodel.shape", "sitemodel.proportions",
                       "bm.rate"))})
    check(ok, "GTR+G4+I fluA meta through the CLI on the card")
    return launches


def family_flua_config(workdir: Path, physher: list,
                       varmodel: bool) -> Path:
    """tests/data/fluA-elbo.json's model with Gamma4+I and a lognormal
    relaxed clock of 8 bins (DistributionRelaxedClock) in place of the
    strict clock, exponential priors on the Gamma shape and the log sigma
    and a normal one on the log mean (in place of the clock rate's
    ctmcscale), the variational blocks of the new parameters (with
    ``varmodel``), and the action list ``physher``."""
    cfg = json.loads((DATA / "fluA-elbo.json").read_text())
    tlk, prior = cfg["model"]["distributions"]
    tlk["sitemodel"]["distribution"] = G4I_NODE
    tlk["branchmodel"] = {
        "id": "bm", "type": "branchmodel", "model": "relaxed",
        "distribution": "lognormal", "categories": 8, "tree": "&tree",
        "parameters": {
            "logmean": {"id": "lm", "type": "parameter", "value": -6.9},
            "logsigma": {"id": "ls", "type": "parameter", "value": 0.3,
                         "lower": 0}}}
    prior["distributions"] = [
        d for d in prior["distributions"] if d["id"] != "priorrate"] + [
        {"id": "prioralpha", "type": "distribution",
         "distribution": "exponential", "x": "&alpha",
         "parameters": {"lambda": 1.0}},
        {"id": "priorlm", "type": "distribution", "distribution": "normal",
         "x": "&lm", "parameters": {"mu": -7.0, "sigma": 2.0}},
        {"id": "priorls", "type": "distribution",
         "distribution": "exponential", "x": "&ls",
         "parameters": {"lambda": 3.0}}]
    if varmodel:
        blocks = cfg["varmodel"]["distributions"]
        blocks[:] = blocks[:2] + [
            {"id": f"block.{x}", "type": "block", "distribution": "normal",
             "x": f"&{x}", "initialize": True,
             "parameters": {"sigma": {"id": f"sigma.{x}",
                                      "type": "parameter", "value": 0.05,
                                      "lower": 0}}}
            for x in ("lm", "ls", "alpha")]
    else:
        cfg.pop("varmodel")
    cfg["physher"] = physher
    for name in ("fluA.fa", "fluA-rooted.nxs"):
        link = workdir / name
        if not link.exists():
            link.symlink_to(DATA / name)
    path = workdir / "fluA-g4i-relaxed.json"
    path.write_text(json.dumps(cfg))
    return path


def family_advi_mcmc(dev, advi_steps=200, length=500, n_chains=8):
    """(b) The fluA-elbo model with Gamma4+I and a lognormal relaxed clock
    through the CLI in float32: 200 ADVI steps (K3'/K4'), the ELBO finite
    and rising (the same 100 draws at the start and the end), then mcmc
    with 8 chains for 500 steps through K5' at C = 5, finite throughout."""
    rec, ok = {}, True
    with tempfile.TemporaryDirectory() as tmp:
        path = family_flua_config(Path(tmp), [
            {"id": "vb", "type": "optimizer", "algorithm": "sg",
             "model": "&varnormal", "eta": 0.1, "tol": 1e-5,
             "max": advi_steps}], varmodel=True)
        zero_all_launches()
        t0 = time.perf_counter()
        runner, lines = run_cli([path])
        wall = time.perf_counter() - t0
        launches = all_launches()
        vb_res = runner.results["vb"]
        tlk = runner.ctx.objects["treelikelihood"]
        fam = runner.ctx.objects["varnormal"].family
        eps = fam.draw(fam.init, torch.Generator(device=dev).manual_seed(7),
                       100)
        with torch.no_grad():
            elbo_first = float(fam.elbo(fam.init, eps=eps))
            elbo_last = float(fam.elbo(vb_res.vparams, eps=eps))
        ok = bool(np.isfinite([elbo_first, elbo_last]).all()
                  and elbo_last > elbo_first
                  and vb_res.iterations == advi_steps
                  and tlk.site_model.cat_count == 5
                  and tlk.engine_name() == "cuda-staged"
                  and launches["staged_forward"] >= advi_steps
                  and launches["staged_backward"] >= advi_steps)
        rec["advi"] = dict(lines=lines, steps=vb_res.iterations,
                           elbo_first=elbo_first, elbo_last=elbo_last,
                           wall_seconds=wall,
                           step_ms=(vb_res.seconds - vb_res.check_seconds)
                           * 1e3 / vb_res.iterations,
                           engine=tlk.engine_name(), launches=launches)
        path = family_flua_config(Path(tmp), [
            {"id": "mc", "type": "mcmc", "model": "&posterior",
             "length": length, "chains": n_chains,
             "log": [{"id": "lg", "type": "logger", "every": 50,
                      "file": "mc.log", "models": ["&posterior"],
                      "x": ["&alpha", "&lm", "&ls"]}]}], varmodel=False)
        zero_all_launches()
        t0 = time.perf_counter()
        runner, lines = run_cli([path])
        wall = time.perf_counter() - t0
        launches = all_launches()
    res = runner.results["mc"]
    tlk = runner.ctx.objects["treelikelihood"]
    post = runner.ctx.objects["posterior"]
    with torch.no_grad():
        last = np.asarray([float(post.log_prob(res.params_at(-1, chain=k)))
                           for k in range(n_chains)])
    ok = bool(ok and launches["loop_forward"] >= length
              and tlk.engine_name(n_chains) == "cuda-loop"
              and np.isfinite(res.log_posterior).all()
              and np.isfinite(last).all())
    rec["mcmc"] = dict(lines=lines, chains=n_chains, iterations=length,
                       last_log_posterior=list(last),
                       acceptance=list(res.acceptance), wall_seconds=wall,
                       step_ms=wall * 1e3 / length, launches=launches,
                       engine=tlk.engine_name(n_chains))
    emit("family_advi_mcmc", ok=ok, **rec)
    check(ok, "ADVI and mcmc of the Gamma4+I lognormal-clock fluA model")
    return rec["advi"]["launches"], launches


def family_unrest(dev):
    """(c) UNREST on the fluA time tree (strict clock) in float64 on the
    card, its P(t) by expm_pade: logP and the gradient at the config's
    start and at UNREST_MOVED_RATES against the JAX package's at 1e-8
    (K1'/K2'), then the unrestricted meta optimizer through the CLI."""
    from physher_tpu_torch.config.builder import build_config

    rec, ok = {}, True
    kw = dict(dtype=torch.float64, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        path = flua_time_config(Path(tmp), "unrest-time.json", UNREST_NODE)
        ctx, _ = build_config(json.loads(path.read_text()),
                              base_dir=str(DATA), **kw)
        tlk = ctx.objects["treelikelihood"]
        start = tlk.param_space().init_params(**kw)
        moved = dict(start, **{"sm.rates": torch.as_tensor(
            UNREST_MOVED_RATES, **kw)})
        fused.FORWARD_LAUNCHES = fused.BACKWARD_LAUNCHES = 0
        for label, params in (("start", start), ("moved", moved)):
            ref = JAX_UNREST_START[label]
            leaves = {k: v.clone().requires_grad_(True)
                      for k, v in params.items()}
            logp = tlk.log_likelihood(leaves)
            grads = dict(zip(leaves, torch.autograd.grad(
                logp, list(leaves.values()))))
            errs = {k: float(np.max(np.abs(grads[k].cpu().numpy()
                                           - np.asarray(g))
                                    / (1e-8 * np.abs(np.asarray(g)) + 1e-8)))
                    for k, g in ref["grad"].items()}
            lerr = float(logp.detach()) - ref["logp"]
            rec[label] = dict(logp=float(logp.detach()), logp_err=lerr,
                              grad_err_over_tol=errs,
                              rates_grad=grads["sm.rates"].tolist())
            ok = ok and abs(lerr) <= 1e-8 and max(errs.values()) <= 1.0 \
                and bool(torch.isfinite(grads["sm.rates"]).all())
        start_launches = {"forward": fused.FORWARD_LAUNCHES,
                          "backward": fused.BACKWARD_LAUNCHES}
        ok = ok and tlk.engine_name() == "cuda-fused" \
            and min(start_launches.values()) >= 2
        zero_all_launches()
        t0 = time.perf_counter()
        runner, lines = run_cli([path, "--f64"])
        wall = time.perf_counter() - t0
    launches = all_launches()
    res = runner.results["ml"]
    logp = maximum_line(lines)
    ok = bool(ok and np.isfinite(logp)
              and logp > JAX_UNREST_START["start"]["logp"]
              and launches["fused_forward"] >= res.iterations)
    emit("family_unrest", ok=ok, tolerance=dict(logp_atol=1e-8,
                                                grad_rtol=1e-8,
                                                grad_atol=1e-8),
         start_launches=start_launches, meta_logp=logp,
         meta_iterations=res.iterations, meta_wall_seconds=wall,
         meta_launches=launches, **rec)
    check(ok, "UNREST on the card against the JAX package, and its meta fit")


def family_jc69w4(dev):
    """(d) The jc69w4 golden (JC69 + four median Weibull categories on
    tiny.fa) in float64 on the card, at tests/test_oracle_goldens.py's
    tolerances: logP, and the branch gradients against the reference's
    central differences."""
    from physher_tpu_torch.config.builder import build_config

    kw = dict(dtype=torch.float64, device=dev)
    cfg = json.loads((DATA / "goldens" / "jc69w4.json").read_text())
    cfg["model"]["sitepattern"]["alignment"]["file"] = str(DATA / "tiny.fa")
    ctx, _ = build_config(cfg, base_dir=str(DATA), **kw)
    tlk = ctx.objects["treelikelihood"]
    params = {k: v.requires_grad_(True) for k, v in
              tlk.param_space().init_params(**kw).items()}
    logp = tlk.log_likelihood(params)
    (g,) = torch.autograd.grad(logp, [params["tree.distances"]])
    g = g.cpu().numpy()
    logp_ref, node_ids, fd_ref = golden_lines("jc69w4")
    nonroot = [i for i in node_ids if i != tlk.topo.root]
    margins = [abs(g[i] - fd) - (5e-2 + 5e-4 * abs(fd))
               for i, fd in zip(nonroot, fd_ref)]
    err = float(logp.detach()) - logp_ref
    ok = bool(abs(err) <= 2e-8 + 5e-9 * abs(logp_ref)
              and len(nonroot) == len(fd_ref) and max(margins) <= 0)
    emit("family_jc69w4", ok=ok, logp=float(logp.detach()),
         logp_ref=logp_ref, logp_err=err, engine=tlk.engine_name(),
         worst_fd_margin=float(max(margins)),
         tolerance=dict(logp_rtol=5e-9, logp_atol=2e-8, fd_rtol=5e-4,
                        fd_atol=5e-2))
    check(ok, "the jc69w4 golden on the card")


def family_staged_large(dev, n_tips=128, n_sites=20480, advi_steps=20):
    """(e) cli_staged_large's config with Gamma4+I (C = 5, 128 taxa x
    about 16 000 patterns): the posterior's value and gradient through
    K3'/K4' against the plain engine on the card (float32, TOL), then 20
    ADVI steps through the CLI: the ELBO it prints finite, the variational
    parameters finite and moved from the start, and the ELBO on the same
    100 draws finite at the start and the end. (Its periodic checks come
    every 100 steps, so the 20 steps keep no history.)"""
    with tempfile.TemporaryDirectory() as tmp:
        path, n_patterns = large_config(Path(tmp), n_tips, n_sites, dev,
                                        invariant=True,
                                        advi_steps=advi_steps)
        zero_all_launches()
        t0 = time.perf_counter()
        runner, lines = run_cli([path])
        wall = time.perf_counter() - t0
        launches = all_launches()
    tlk = runner.ctx.objects["treelikelihood"]
    post = runner.ctx.objects["posterior"]
    vb_res = runner.results["vb"]
    fam = runner.ctx.objects["varnormal"].family
    eps = fam.draw(fam.init, torch.Generator(device=dev).manual_seed(7), 100)
    with torch.no_grad():
        elbo_first = float(fam.elbo(fam.init, eps=eps))
        elbo_last = float(fam.elbo(vb_res.vparams, eps=eps))
    vparams_finite = all(bool(torch.isfinite(v).all())
                         for v in vb_res.vparams.values())
    moved = any(not torch.equal(vb_res.vparams[k], v)
                for k, v in fam.init.items())
    params = runner.params_for(post.param_space())
    out = {}
    for engine in ("auto", "torch"):
        tlk.engine = engine
        leaves = {k: v.detach().clone().requires_grad_(True)
                  for k, v in params.items()}
        val = post.log_prob(leaves)
        out[engine] = (float(val.detach()), dict(zip(leaves, (
            gg.detach() for gg in torch.autograd.grad(
                val, list(leaves.values()))))))
    tlk.engine = "auto"
    tol = TOL[torch.float32]
    rel = abs(out["auto"][0] - out["torch"][0]) / abs(out["torch"][0])
    grad_rel = {k: max_err(out["auto"][1][k], out["torch"][1][k])[1]
                for k in out["auto"][1]}
    ok = bool(n_patterns >= 8192 and tlk.site_model.cat_count == 5
              and tlk.engine_name() == "cuda-staged"
              and rel <= tol["logl"] and max(grad_rel.values()) <= tol["grad"]
              and vb_res.iterations == advi_steps
              and np.isfinite([vb_res.elbo, elbo_first, elbo_last]).all()
              and vparams_finite and moved
              and launches["staged_forward"] >= advi_steps
              and launches["staged_backward"] >= advi_steps)
    emit("family_staged_large", ok=ok, patterns=n_patterns,
         logp_kernels=out["auto"][0], logp_plain=out["torch"][0],
         logp_rel_err=rel, grad_rel_err=grad_rel, tolerance=tol,
         advi_steps=vb_res.iterations, elbo=vb_res.elbo,
         elbo_first=elbo_first, elbo_last=elbo_last,
         vparams_finite=vparams_finite, vparams_moved=moved,
         wall_seconds=wall, engine=tlk.engine_name(), launches=launches)
    check(ok, "the Gamma4+I large config through K3'/K4' against plain")


# -- the fifteenth slice: coalescents over chain batches, the batched ELBO
# checks, and the Bayesian model-comparison estimators


def wall_ms(fn, reps: int, warmup: int = 1) -> list:
    """Host wall times of ``fn()`` in ms, each ended by a synchronize."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


# the population-size models of phase (a) on the fluA time tree (68
# coalescences; the root is about 21 years above the latest tip)
COAL_GRID, COAL_CUTOFF = 8, 18.0


def coal_config(workdir: Path, model: str, physher: list) -> Path:
    """tests/data/fluA-elbo.json's model with its constant coalescent
    replaced by ``model`` (skyline with 3 groups, skygrid or
    piecewise-linear on 8 grid points to 18 years; sizes from a seed), the
    oneonx prior on those sizes, and the action list ``physher``."""
    cfg = json.loads((DATA / "fluA-elbo.json").read_text())
    prior = cfg["model"]["distributions"][1]
    n = 3 if model == "skyline" else COAL_GRID
    values = np.random.default_rng(3).uniform(4.0, 12.0, n)
    node = {"id": "coalescent", "type": "coalescent", "model": model,
            "tree": "&tree",
            "parameters": {"thetas": {
                "id": "thetas", "type": "parameter", "lower": 0,
                "values": [float(v) for v in values]}}}
    if model == "skyline":
        node["groups"] = [30, 20, 18]
    else:
        node.update(grid=COAL_GRID, cutoff=COAL_CUTOFF)
    prior["distributions"][0] = node
    prior["distributions"][1]["x"] = "&thetas"
    cfg.pop("varmodel")
    cfg["physher"] = physher
    for name in ("fluA.fa", "fluA-rooted.nxs"):
        link = workdir / name
        if not link.exists():
            link.symlink_to(DATA / name)
    path = workdir / f"fluA-{model}.json"
    path.write_text(json.dumps(cfg))
    return path


def coalescent_card(dev, length=1000, n_chains=8):
    """(a) The fluA time tree with skyline, skygrid and piecewise-linear
    priors in float64: the joint logP and its gradient on the card (K1'/K2')
    against the port on the CPU in this process; then an 8-chain mcmc of the
    skygrid config through the CLI (float32, K5' at L = 8)."""
    from physher_tpu_torch.config.builder import build_config, load_json

    rec, ok = {}, True
    with tempfile.TemporaryDirectory() as tmp:
        for model in ("skyline", "skygrid", "piecewise-linear"):
            path = coal_config(Path(tmp), model, [])
            out = {}
            for device in (dev, "cpu"):
                ctx, _ = build_config(load_json(str(path)), base_dir=tmp,
                                      dtype=torch.float64, device=device)
                post = ctx.objects["posterior"]
                leaves = {k: v.requires_grad_(True) for k, v in
                          post.param_space().init_params(
                              dtype=torch.float64, device=device).items()}
                val = post.log_prob(leaves)
                grads = torch.autograd.grad(val, list(leaves.values()))
                out[str(device)] = (float(val.detach()), {
                    k: g.cpu() for k, g in zip(leaves, grads)},
                    ctx.objects["treelikelihood"].engine_name())
            card, cpu = out[str(dev)], out["cpu"]
            rel = abs(card[0] - cpu[0]) / abs(cpu[0])
            g_rel = max(max_err(card[1][k], cpu[1][k])[1] for k in cpu[1])
            rec[model] = dict(logp_card=card[0], logp_cpu=cpu[0],
                              logp_rel_err=rel, grad_rel_err=g_rel,
                              engine=card[2])
            ok = ok and rel <= 1e-10 and g_rel <= 1e-9 \
                and card[2] == "cuda-fused"
        actions = [{"id": "mc", "type": "mcmc", "model": "&posterior",
                    "length": length, "chains": n_chains,
                    "log": [{"id": "lg", "type": "logger", "every": 100,
                             "file": "mc.log", "models": ["&posterior"],
                             "x": ["&thetas", "&rate"]}]}]
        path = coal_config(Path(tmp), "skygrid", actions)
        zero_all_launches()
        t0 = time.perf_counter()
        runner, lines = run_cli([path])
        wall = time.perf_counter() - t0
        launches = all_launches()
    res = runner.results["mc"]
    tlk = runner.ctx.objects["treelikelihood"]
    acc = np.asarray(res.acceptance, np.float64)
    mcmc_ok = bool(np.isfinite(res.samples_u).all()
                   and np.isfinite(res.log_posterior).all()
                   and res.samples_u.shape[:2] == (length // 100, n_chains)
                   and 0.0 < np.nanmean(acc) < 1.0
                   and tlk.engine_name(n_chains) == "cuda-loop"
                   and launches["loop_forward"] >= length)
    ok = bool(ok and mcmc_ok)
    emit("coalescent_card", ok=ok, models=rec, tolerance={"logp": 1e-10,
         "grad": 1e-9}, mcmc_lines=lines, mcmc_chains=n_chains,
         mcmc_iterations=length, mcmc_acceptance=list(acc),
         mcmc_log_posterior_last=list(res.log_posterior[-1]),
         mcmc_wall_seconds=wall, mcmc_step_ms=wall * 1e3 / length,
         launches=launches)
    check(ok, "skyline, skygrid and piecewise-linear on the card against "
              "the CPU, and an 8-chain skygrid mcmc through K5'")
    return launches


def elbo_checks(dev, smi, sized_runners, reps=(7, 3)):
    """(b) One ELBO convergence check (100 fixed draws) of each fitted
    family, as one batch of chains (K5' in ``hessian_chunk`` chunks) and as
    the parent's loop of one-chain targets (K1' or K3'), on the same draws:
    the K5' calls a check and both wall times, at the checkpoint B model
    and the 128 x 16 291 config; then 20 ADVI steps of fluA-elbo.json at
    gradsamples 4 through the CLI (one K5'/K6' pair a step)."""
    rec = {"card": smi}
    ok = True
    for (label, runner, key), n_reps in zip(sized_runners, reps):
        fam = runner.ctx.objects["varnormal"].family
        vparams = runner.results[key].vparams
        eps = fam.draw(vparams, torch.Generator(device=dev).manual_seed(5),
                       100)

        def batched():
            with torch.no_grad():
                return float(fam.elbo(vparams, eps=eps))

        def loop_check():
            with torch.no_grad():
                z = fam.sample_unconstrained(vparams, eps)
                return float(sum(fam._target(zi) for zi in z) / len(z)
                             + fam.entropy(vparams))

        zero_all_launches()
        e_batch = batched()
        launches = all_launches()
        e_loop = loop_check()
        t_batch = wall_ms(batched, n_reps)
        t_loop = wall_ms(loop_check, n_reps)
        n_chunks = -(-100 // fam.max_chains)
        rel = abs(e_batch - e_loop) / abs(e_loop)
        rec[label] = dict(
            elbo_batched=e_batch, elbo_loop=e_loop, rel_err=rel,
            chunk_rows=fam.max_chains, chunks=n_chunks,
            k5_calls_a_check=launches["loop_forward"], launches=launches,
            batched_ms=statistics.median(t_batch), batched_ms_all=t_batch,
            loop_ms=statistics.median(t_loop), loop_ms_all=t_loop,
            loop_over_batched=statistics.median(t_loop)
            / statistics.median(t_batch))
        ok = ok and launches["loop_forward"] == n_chunks and rel <= 1e-5 \
            and launches["fused_forward"] == launches["staged_forward"] == 0
    cfg = json.loads((DATA / "fluA-elbo.json").read_text())
    cfg["varmodel"]["gradsamples"] = 4
    cfg["physher"][0]["max"] = 20
    with tempfile.TemporaryDirectory() as tmp:
        for name in ("fluA.fa", "fluA-rooted.nxs"):
            (Path(tmp) / name).symlink_to(DATA / name)
        path = Path(tmp) / "fluA-elbo-g4.json"
        path.write_text(json.dumps(cfg))
        zero_all_launches()
        t0 = time.perf_counter()
        runner, lines = run_cli([path])
        wall = time.perf_counter() - t0
        launches = all_launches()
    res = runner.results["sg"]
    steps_ok = bool(res.iterations == 20 and np.isfinite(res.elbo)
                    and launches["loop_backward"] == 20
                    and launches["loop_forward"] == 21
                    and launches["fused_forward"] == 0
                    and launches["fused_backward"] == 0)
    rec["advi_gradsamples4"] = dict(lines=lines, iterations=res.iterations,
                                    elbo=res.elbo, wall_seconds=wall,
                                    launches=launches)
    ok = bool(ok and steps_ok)
    emit("elbo_checks", ok=ok, **rec)
    check(ok, "the ELBO checks as one batch through K5' and ADVI steps at "
              "gradsamples 4 through K5'/K6'")
    return rec


def calibrated_actions():
    """The card's action list on tests/data/fluA-calibrated.json: the
    config's own actions at its own settings, those of the JAX package's
    reference (mmcmc and marginallikelihood, and bridgesampling over the
    node's chains, from the config's values; the L-BFGS fit, the ADVI fit
    from its optimum, and is), then an 8-chain mcmc with cpo, mc, and a
    short nest (20 points, 200 iterations)."""
    cfg = json.loads((DATA / "fluA-calibrated.json").read_text())
    return cfg, cfg["physher"] + [
        {"id": "mcmc", "type": "mcmc", "model": "&posterior",
         "length": 1000, "chains": 8,
         "log": [{"every": 10, "models": ["&posterior"]}]},
        {"id": "cpo", "type": "cpo", "mcmc": "&mcmc"},
        {"id": "mc", "type": "mc", "model": "&posterior", "length": 1000,
         "chains": 8},
        {"id": "nest", "type": "nest", "model": "&posterior", "points": 20,
         "max": 200}]


def estimators_card(dev, smi):
    """(c) The calibrated config in float64 on the card through the CLI's
    Runner, action by action: stepping stone, bridge sampling and IS within
    the windows of tests/data/fluA-calibrated.reference.json (the JAX
    package's values over three seeds at the config's settings, which the
    reference records), mc, cpo and a short nest finite; then bridge
    sampling on the card against the port on the CPU on the same posterior
    samples and proposal draws (1e-8 relative)."""
    from physher_tpu_torch.config.actions import Runner
    from physher_tpu_torch.config.builder import build_config
    from physher_tpu_torch.inference import marginal

    ref = json.loads((DATA / "fluA-calibrated.reference.json").read_text())
    win = ref["estimates"]
    cfg, actions = calibrated_actions()
    # the reference was made at the settings the card runs
    nodes = {a["id"]: a for a in cfg["physher"]}
    same_settings = all(nodes.get(i, {}).get(k) == v
                        for i, kv in ref["settings"].items()
                        for k, v in kv.items())
    ctx, _ = build_config(cfg, base_dir=str(DATA), dtype=torch.float64,
                          device=dev)
    out = io.StringIO()
    runner = Runner(ctx, seed=0, out=out)
    seconds, launches = {}, {}
    for node in actions:
        zero_all_launches()
        t0 = time.perf_counter()
        runner.run([node])
        torch.cuda.synchronize()
        seconds[node["id"]] = time.perf_counter() - t0
        launches[node["id"]] = all_launches()
    res = runner.results
    got = {"stepping_stone": res["marginal"]["stepping"],
           "path_sampling": res["marginal"]["path"],
           "bridge": res["bridge"], "is": res["is"]}
    inside = {k: abs(got[k] - win[k]["mean"]) <= win[k]["tolerance"]
              for k in ("stepping_stone", "bridge", "is")}
    finite = bool(np.isfinite([res["mc"], res["nest"], res["cpo"][1],
                               res["vb"].elbo]).all())
    # bridge sampling on the same samples and proposal draws, card and CPU
    post = ctx.objects["posterior"]
    space = post.param_space()
    mres = res["mcmc"]
    z = torch.as_tensor(mres.samples_u.reshape(-1, mres.samples_u.shape[-1]),
                        dtype=torch.float64, device=dev)
    eps = torch.randn(z.shape, generator=torch.Generator(
        device=dev).manual_seed(9), dtype=torch.float64, device=dev)
    cpu_ctx, _ = build_config(cfg, base_dir=str(DATA), dtype=torch.float64,
                              device="cpu")
    cpu_post = cpu_ctx.objects["posterior"]
    vals = {}
    for label, p, zz, ee in (("card", post, z, eps),
                             ("cpu", cpu_post, z.cpu(), eps.cpu())):
        vals[label] = marginal.bridge_sampling_marginal(
            zz, lambda x, p=p: marginal.batched_values(
                p.log_prob, space, x, jacobian=True), space, eps=ee)
    bridge_rel = abs(vals["card"] - vals["cpu"]) / abs(vals["cpu"])
    loop_calls = {k: v["loop_forward"] for k, v in launches.items()}
    ok = bool(same_settings and all(inside.values()) and finite
              and bridge_rel <= 1e-8
              and loop_calls["bridge"] >= 1 and loop_calls["is"] >= 1
              and loop_calls["mc"] >= 1 and loop_calls["cpo"] >= 1)
    emit("estimators_card", ok=ok, card=smi, same_settings=same_settings,
         settings=ref["settings"], lines=out.getvalue().splitlines(),
         estimates=got,
         windows={k: win[k] for k in ("stepping_stone", "bridge", "is")},
         inside=inside, mc=res["mc"], nest=res["nest"], lpml=res["cpo"][1],
         elbo=res["vb"].elbo, vb_iterations=res["vb"].iterations,
         bridge_card_vs_cpu={**vals, "rel_err": bridge_rel,
                             "samples": int(z.shape[0])},
         seconds=seconds, launches=launches)
    check(ok, "the estimators on the calibrated config within the JAX "
              "package's windows, and bridge sampling card against CPU")
    return {"seconds": seconds, "launches": launches, "estimates": got}


def mixed_mcmc_ssvs(dev, n_chains=4, n_iter=400, every=10):
    """(d) MixedMCMC over an SSVSLocalClock on the fluA JC69 time tree
    (float32): bits [4, N], lognormal priors on the rates and a Bernoulli
    prior of 0.05 on each bit; every step one K5' launch at L = 4. The step
    sizes stay fixed, so that the acceptance covers the whole run."""
    from physher_tpu_torch.inference.mcmc import MixedMCMC
    from physher_tpu_torch.models.clock import SSVSLocalClock
    from physher_tpu_torch.models.distributions import lognormal_logpdf
    from physher_tpu_torch.models.parameters import ParamBatch

    with open(DATA / "jc69-time.json") as fh:
        tree_cfg = json.load(fh)["model"]["tree"]
    topo, dist = read_newick(tree_cfg["newick"])
    td = TimeTreeData.from_dated_tree(topo, dist, tree_cfg["dates"])
    sp = SitePattern.from_alignment(read_alignment(str(DATA / "fluA.fa")))
    kw = dict(dtype=torch.float32, device=dev)
    clock = SSVSLocalClock(topo, rate_init=3e-3, **kw)
    tlk = TreeLikelihood(sp, topo, JC69(**kw), clock=clock, time_data=td,
                         tipstates=True, **kw)
    space = tlk.param_space()
    ind = clock.key("indicators")

    def log_prob(params, bits):
        p = ParamBatch({**params, ind: bits}, params.batch_shape)
        rates = torch.cat([params[clock.key("rate")][..., None],
                           params[clock.key("local_rates")]], -1)
        n_on = bits.sum(-1).to(rates.dtype)
        return (tlk.log_likelihood(p)
                + lognormal_logpdf(rates, -5.8, 1.0).sum(-1)
                + n_on * np.log(0.05) + (bits.shape[-1] - n_on)
                * np.log(0.95))

    zero_all_launches()
    t0 = time.perf_counter()
    out = MixedMCMC(space, log_prob, n_bits=topo.N, p_flip=0.3).run(
        torch.Generator(device=dev).manual_seed(3),
        space.init_params(**kw), np.zeros(topo.N), n_iter=n_iter,
        every=every, n_chains=n_chains, adapt=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = all_launches()
    freq = float(out["bits"].mean())
    ok = bool(np.isfinite(out["log_posterior"]).all()
              and out["bits"].shape == (n_iter // every, n_chains, topo.N)
              and 0.0 < freq < 1.0
              and tlk.engine_name(n_chains) == "cuda-loop"
              and launches["loop_forward"] >= n_iter)
    emit("mixed_mcmc_ssvs", ok=ok, chains=n_chains, iterations=n_iter,
         bits=topo.N, bit_frequency=freq,
         bits_on_last=out["bits"][-1].sum(-1).tolist(),
         acceptance=[float(a) for a in out["acceptance"]],
         log_posterior_last=[float(v) for v in out["log_posterior"][-1]],
         wall_seconds=wall, step_ms=wall * 1e3 / n_iter, launches=launches)
    check(ok, "MixedMCMC over the SSVS local clock through K5' at L = 4")
    return launches


# -- the sixteenth slice: tree search and ancestral analyses ---------------

def flua_nj_config(workdir: Path, physher: list, gtr_g4: bool = False,
                   name: str | None = None) -> Path:
    """tests/data/fluA.fa (69 taxa, 238 patterns) on its NJ tree with free
    branch lengths (unrooted), JC69 or GTR+G4 (rates and frequencies free,
    alpha 0.5), and the action list ``physher``."""
    sm = {"id": "sm", "type": "substitutionmodel", "model": "jc69",
          "datatype": "nucleotide"}
    site = {"id": "sitemodel", "type": "sitemodel", "substitutionmodel": sm}
    if gtr_g4:
        sm.update(model="gtr",
                  rates={"id": "rates", "type": "simplex",
                         "values": [1.0] * 6},
                  frequencies={"id": "freqs", "type": "simplex",
                               "values": [0.25] * 4})
        site["distribution"] = {
            "distribution": "gamma", "categories": 4,
            "parameters": {"alpha": {"id": "alpha", "type": "parameter",
                                     "value": 0.5, "lower": 0}}}
    cfg = {"model": {
        "id": "treelikelihood", "type": "treelikelihood",
        "sitepattern": {"id": "patterns", "type": "sitepattern",
                        "datatype": "nucleotide",
                        "alignment": {"id": "seqs", "type": "alignment",
                                      "file": str(DATA / "fluA.fa")}},
        "sitemodel": site,
        "tree": {"id": "tree", "type": "tree", "parameters": "tree.distances",
                 "init": {"algorithm": "nj", "sitepattern": "&patterns"}}},
        "physher": physher}
    path = workdir / (name or ("fluA-nj-gtrg4.json" if gtr_g4
                               else "fluA-nj-jc69.json"))
    path.write_text(json.dumps(cfg))
    return path


def aten_ops(fn) -> int:
    """The aten operations of ``fn()`` with a result on the card, views
    excepted: each is one kernel launch or more. Counted on the host by a
    dispatch mode, so it needs no profiler."""
    from torch.utils._pytree import tree_leaves
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if not func.is_view and any(
                    isinstance(t, torch.Tensor) and t.is_cuda
                    for t in tree_leaves(out)):
                Count.n += 1
            return out

    with Count():
        fn()
    torch.cuda.synchronize()
    return Count.n


def profiled_kernels(fn) -> int:
    """Kernel launches that torch.profiler sees on the card in ``fn()`` (0
    where it sees no device events)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(r.count for r in prof.key_averages()
               if getattr(r, "device_type", None) == DeviceType.CUDA)


ANALYSIS_SITES = 10000


def analyses_card(dev, smi):
    """(40) meta, then asr, ppsite, cat and simultron through the CLI on
    JC69 and GTR+G4 fluA (NJ tree) in float64 on the card (the meta fit
    through K1'/K2' and K3'/K4'); the analyses against the port on the CPU
    at the same parameters (node posteriors and ppsite within 1e-10, MAP
    states, sequences and categories identical), float32's largest
    posterior error beside float64's, the simulated alignment's shape,
    alphabet and base frequencies (within 0.02 of the model's over
    ANALYSIS_SITES sites), and the parsimony model's score on the NJ tree,
    card against CPU exactly."""
    from physher_tpu_torch.config.builder import build_config, load_json
    from physher_tpu_torch.likelihood import analysis

    rec, ok = {}, True
    with tempfile.TemporaryDirectory() as tmp:
        for name, gtr in (("jc69", False), ("gtrg4", True)):
            acts = [dict(META_ACTION),
                    {"id": "asr", "type": "asr", "model": "&treelikelihood",
                     "file": "asr.fa"},
                    {"id": "ppsite", "type": "ppsite",
                     "model": "&treelikelihood", "file": "ppsite.txt"},
                    {"id": "cat", "type": "cat", "model": "&treelikelihood"},
                    {"id": "sim", "type": "simultron",
                     "model": "&treelikelihood", "length": ANALYSIS_SITES,
                     "output": "sim.fa"}]
            path = flua_nj_config(Path(tmp), acts, gtr)
            zero_all_launches()
            t0 = time.perf_counter()
            runner, lines = run_cli([path, "--f64"])
            wall = time.perf_counter() - t0
            launches = all_launches()
            tlk = runner.ctx.objects["treelikelihood"]
            params = runner.params_for(tlk.param_space())
            cfg = load_json(str(path))
            cpu = build_config(cfg, base_dir=tmp, dtype=torch.float64,
                               device="cpu")[0].objects["treelikelihood"]
            p_cpu = {k: v.cpu() for k, v in params.items()}
            t0 = time.perf_counter()
            post, maps = analysis.ancestral_states(tlk, params)
            torch.cuda.synchronize()
            asr_ms = (time.perf_counter() - t0) * 1e3
            post_cpu, maps_cpu = analysis.ancestral_states(cpu, p_cpu)
            pp_cpu = analysis.site_rate_posteriors(cpu, p_cpu)
            f32 = build_config(cfg, base_dir=tmp, dtype=torch.float32,
                               device=dev)[0].objects["treelikelihood"]
            post32 = analysis.ancestral_states(
                f32, {k: v.float() for k, v in params.items()})[0]
            res = runner.results
            sim = res["sim"]
            text = "".join(sim.values())
            counts = np.array([text.count(c) for c in "ACGT"], np.float64)
            with torch.no_grad():
                freqs = tlk.subst.frequencies(params).cpu().numpy()
            sim_err = float(np.abs(counts / counts.sum() - freqs).max())
            r = dict(
                meta_logp=maximum_line(lines), engine=tlk.engine_name(),
                seconds=wall, asr_ms=asr_ms, launches=launches,
                posterior_max_abs_err_f64=float(np.abs(post - post_cpu).max()),
                posterior_max_abs_err_f32=float(np.abs(post32
                                                       - post_cpu).max()),
                map_identical=bool((maps == maps_cpu).all()),
                asr_identical=res["asr"] == analysis.ancestral_sequences(
                    cpu, p_cpu),
                ppsite_max_abs_err=float(np.abs(res["ppsite"]
                                                - pp_cpu).max()),
                cat_identical=bool((res["cat"] == analysis.cat_assignment(
                    cpu, p_cpu)).all()),
                sim_taxa=len(sim), sim_sites=sorted({len(v)
                                                     for v in sim.values()}),
                sim_alphabet="".join(sorted(set(text))),
                sim_freqs=list(counts / counts.sum()),
                model_freqs=[float(f) for f in freqs],
                sim_freq_max_err=sim_err)
            rec[name] = r
            ok = ok and bool(
                r["posterior_max_abs_err_f64"] <= 1e-10
                and r["map_identical"] and r["asr_identical"]
                and r["ppsite_max_abs_err"] <= 1e-10 and r["cat_identical"]
                and r["sim_taxa"] == 69
                and r["sim_sites"] == [ANALYSIS_SITES]
                and set(r["sim_alphabet"]) <= set("ACGT")
                and sim_err <= 0.02 and np.isfinite(r["meta_logp"]))
        pars = {"id": "pars", "type": "parsimony",
                "sitepattern": {"id": "p", "type": "sitepattern",
                                "datatype": "nucleotide",
                                "alignment": {"id": "a", "type": "alignment",
                                              "file": str(DATA / "fluA.fa")}},
                "tree": {"id": "t", "type": "tree",
                         "init": {"algorithm": "nj", "sitepattern": "&p"}}}
        scores = [build_config({"pars": pars, "physher": []}, base_dir=tmp,
                               dtype=torch.float64, device=d)[0].objects[
                                   "pars"].score() for d in (dev, "cpu")]
    ok = ok and scores[0] == scores[1]
    emit("analyses_card", ok=ok, card=smi, models=rec,
         parsimony_card=scores[0], parsimony_cpu=scores[1],
         tolerance={"posterior": 1e-10, "ppsite": 1e-10, "sim_freq": 0.02})
    check(ok, "asr, ppsite, cat, simultron and parsimony on the card "
              "against the CPU (fluA, float64)")
    return rec


# rounds of the card's searches (each NNI round re-optimizes up to 16
# candidates by 200 Adam steps), and of the CPU's cut that the card is
# held against
NNI_ROUNDS, SPR_ROUNDS, CPU_ROUNDS = 8, 1, 1


def topology_node(move: str, rounds: int) -> dict:
    return {"id": "topo", "type": "optimizer", "algorithm": "topology",
            "move": move, "model": "&treelikelihood", "rounds": rounds}


def topology_card(dev, smi, nj_ml_logp):
    """(41) The topology optimizer through the CLI from the fluA NJ tree
    (JC69, float64): NNI for NNI_ROUNDS rounds and SPR for SPR_ROUNDS on
    the card, and NNI for CPU_ROUNDS on the CPU (and on the card, unless
    its NNI run ended within as many rounds: a search capped at R rounds is
    one that ends by itself within R). The history never decreases, the
    searches end no lower than the NJ tree's own ML logP (phase 40's
    meta), and the card's cut ends where the CPU's does (RF 0, logP within
    1e-6). Candidate scoring runs the dynamic engine, the
    re-optimizations K1'/K2': the launches of one scoring call are
    counted, and the kernels' calls per round. Returns the records and the
    card runs' launches."""
    from physher_tpu_torch.inference.topology_search import (
        TopologySearch, nni_neighbors, to_nested)
    from physher_tpu_torch.trees.stats import robinson_foulds
    from physher_tpu_torch.trees.topology import Topology

    rec, ok = {}, True
    card_launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        def search_run(name, move, rounds, device=dev):
            nonlocal ok
            path = flua_nj_config(Path(tmp), [topology_node(move, rounds)],
                                  name=f"{name}.json")
            zero_all_launches()
            t0 = time.perf_counter()
            runner, lines = run_cli([path, "--f64"] + (
                [] if device == dev else ["--device", "cpu"]))
            wall = time.perf_counter() - t0
            launches = all_launches()
            if device == dev:
                for k, v in launches.items():
                    card_launches[k] = card_launches.get(k, 0) + v
            res = runner.results["topo"]
            hist = [float(h) for h in res.history]
            rec[name] = dict(
                rounds=res.rounds, moves=res.moves_accepted, logp=res.logp,
                history=hist, seconds=wall, launches=launches,
                kernel_calls_per_round={k: v / max(res.rounds, 1)
                                        for k, v in launches.items() if v},
                engine=runner.ctx.objects["treelikelihood"].engine_name(),
                line=lines[-1])
            ok = ok and bool(all(b >= a for a, b in zip(hist, hist[1:]))
                             and np.isfinite(res.logp)
                             and res.logp >= nj_ml_logp
                             - 1e-6 * abs(nj_ml_logp))
            return runner, res

        runner, res = search_run("nni", "nni", NNI_ROUNDS)
        search_run("spr", "spr", SPR_ROUNDS)
        card = res if res.rounds <= CPU_ROUNDS else search_run(
            "nni_cut", "nni", CPU_ROUNDS)[1]
        cpu = search_run("nni_cut_cpu", "nni", CPU_ROUNDS, "cpu")[1]
        rf = robinson_foulds(card.topology, cpu.topology)
        dlogp = abs(card.logp - cpu.logp)
        ok = ok and rf == 0 and dlogp <= 1e-6
        # one scoring call: the final NNI tree's neighbourhood, one batch
        tlk = runner.ctx.objects["treelikelihood"]
        search = TopologySearch(None)
        search._base = (tlk, runner.params_for(tlk.param_space()))
        cands = [Topology.from_nested(c)
                 for c in nni_neighbors(to_nested(res.topology,
                                                  res.distances))]
        search._score_candidates(cands)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        search._score_candidates(cands)
        torch.cuda.synchronize()
        score_ms = (time.perf_counter() - t0) * 1e3
        ops = aten_ops(lambda: search._score_candidates(cands))
        kernels = profiled_kernels(lambda: search._score_candidates(cands))
    rec["scoring_call"] = dict(candidates=len(cands), ms=score_ms,
                               aten_ops=ops, profiled_kernels=kernels,
                               internal_nodes=tlk.topo.I)
    emit("topology_card", ok=ok, card=smi, runs=rec, nj_ml_logp=nj_ml_logp,
         card_vs_cpu={"rf": rf, "logp_abs_err": dlogp},
         rounds_cap={"nni": NNI_ROUNDS, "spr": SPR_ROUNDS,
                     "cpu_cut": CPU_ROUNDS})
    check(ok, "the topology search on fluA: a history that never falls, no "
              "lower than the NJ tree's ML, card against CPU")
    return rec, card_launches


def children_topology(taxa, children, bl):
    """A ``Topology`` and its distances [N] for a sampler's children array
    (any id order) and branch lengths, numbered anew by
    ``Topology.from_nested`` with the lengths carried exactly."""
    from physher_tpu_torch.trees.topology import Topology

    T, I = len(taxa), len(children)
    root = T + I - 1

    def build(nid):
        kids = [] if nid < T else [build(int(c)) for c in children[nid - T]]
        return {"name": taxa[nid] if nid < T else None,
                "length": None if nid == root else float(bl[nid]),
                "children": kids}

    topo, dist = Topology.from_nested(build(root))
    return topo, np.nan_to_num(dist, nan=0.0)


TREE_MCMC_LENGTH = {"one_chain": 1000, "chains8": 1000,
                    "chains8_incremental": 1000}


def tree_mcmc_card(dev, smi):
    """(42) The nni operator through the CLI on JC69 fluA (NJ tree, float64)
    one-chain (TreeMCMC: K1' a proposal) and with 8 chains, with and
    without incremental updates (the dynamic engine): finite logPs, every
    move family's acceptance strictly inside (0, 1), the tree log parsing
    back to 69 taxa, and each chain's carried log posterior equal to a
    from-scratch evaluation of its final state within 1e-9 (the
    one-chain sampler's through the dynamic engine, the batched samplers'
    through the fixed topology's kernels); ms and launches per
    iteration."""
    from physher_tpu_torch.inference.treemcmc import BatchedTreeMCMC
    from physher_tpu_torch.ops import dynamic_pruning as dyn

    modes = {"one_chain": {}, "chains8": {"chains": 8},
             "chains8_incremental": {"chains": 8, "incremental": True}}
    rec, ok = {}, True
    with tempfile.TemporaryDirectory() as tmp:
        for name, extra in modes.items():
            length = TREE_MCMC_LENGTH[name]
            node = {"id": "mcmc", "type": "mcmc", "model": "&treelikelihood",
                    "length": length, **extra,
                    "operators": [
                        {"id": "o1", "type": "operator", "algorithm": "nni",
                         "x": "&tree", "weight": 1},
                        {"id": "o2", "type": "operator",
                         "algorithm": "scaler", "x": "%tree.distances",
                         "weight": 4}],
                    "log": [{"id": "l1", "type": "logger", "every": 100,
                             "file": f"{name}.log"},
                            {"id": "l2", "type": "logger", "every": 100,
                             "file": f"{name}.trees", "models": "&tree"}]}
            path = flua_nj_config(Path(tmp), [node], name=f"{name}.json")
            zero_all_launches()
            t0 = time.perf_counter()
            runner, lines = run_cli([path, "--f64"])
            wall = time.perf_counter() - t0
            launches = all_launches()
            tlk = runner.ctx.objects["treelikelihood"]
            res = runner.results["mcmc"]
            trees = (Path(tmp) / f"{name}.trees").read_text().split()
            taxa_ok = all(read_newick(t)[0].T == 69 for t in trees)
            rate = 10.0
            with torch.no_grad():
                if name == "one_chain":
                    acc = {k: v for k, v in res.acceptance.items()
                           if not np.isnan(v)}
                    carried = res.log_posterior[-1:]
                    topo, bl = res.final_topology, res.final_distances
                    blt = torch.as_tensor(bl, dtype=tlk.dtype,
                                          device=tlk.tip_partials.device)
                    ll = dyn.tree_loglik_dynamic(
                        tlk.tips_for(topo),
                        tlk.subst.p_t({}, torch.clamp(blt, min=0.0)[:, None]),
                        torch.as_tensor(topo.children[:, :2],
                                        device=blt.device).long(),
                        tlk.subst.frequencies({}),
                        blt.new_ones(1), tlk.weights,
                        rescale=tlk.rescale)[0]
                    scratch = [float(ll) + (topo.N - 1) * np.log(rate)
                               - rate * float(blt[:-1].sum())]
                    logps = res.log_posterior
                else:
                    # a model without free parameters proposes no walk
                    acc = {k: v for k, v in res["acceptance"].items()
                           if k != "params" or BatchedTreeMCMC(tlk).dim}
                    carried = res["logp"][-1]
                    scratch = []
                    for b in range(8):
                        topo, bl = children_topology(
                            tlk.topo.taxa, res["children"][-1, b],
                            res["bl"][-1, b])
                        blt = torch.as_tensor(bl, dtype=tlk.dtype,
                                              device=tlk.tip_partials.device)
                        ll = tlk.topology_log_likelihood(
                            {}, topo, tlk.tips_for(topo), blt)
                        scratch.append(float(ll) + (topo.N - 1)
                                       * np.log(rate)
                                       - rate * float(blt[:-1].sum()))
                    logps = res["logp"]
            rel = float(np.max(np.abs(np.asarray(carried) - scratch)
                               / np.abs(scratch)))
            r = dict(iterations=length, seconds=wall,
                     ms_per_iteration=wall * 1e3 / length,
                     acceptance=acc, carried_last=list(map(float, carried)),
                     from_scratch=scratch, rel_err=rel, trees=len(trees),
                     launches=launches,
                     k1_per_iteration=launches["fused_forward"] / length,
                     line=lines[-1])
            if name != "one_chain":
                sampler = BatchedTreeMCMC(tlk)
                inc = bool(extra.get("incremental"))

                def few(n=10):
                    return sampler.run(
                        torch.Generator(device=dev).manual_seed(5),
                        n_iter=n, every=n, n_chains=8, incremental=inc)

                few()
                r["aten_ops_per_iteration"] = aten_ops(few) / 10
                r["profiled_kernels_per_iteration"] = \
                    profiled_kernels(few) / 10
            rec[name] = r
            ok = ok and bool(np.isfinite(logps).all()
                             and all(0.0 < a < 1.0 for a in acc.values())
                             and taxa_ok and len(trees) == length // 100
                             and rel <= 1e-9)
    emit("tree_mcmc_card", ok=ok, card=smi, modes=rec, tolerance=1e-9)
    check(ok, "the nni tree MCMC on fluA: one chain and 8, with and without "
              "incremental updates")
    return rec


# ---- the seventeenth slice: the Interface API, the tools, pattern sharding

# the legacy CLI's fluA run (NJ start tree, JC69 meta) that phase 44 runs
# on the card in float64 and holds against the same run on the CPU, which
# main() starts in a process of its own while the kernels build
LEGACY_ARGV = ["-i", str(DATA / "fluA.fa"), "-m", "JC69", "-D", "nj"]
LEGACY_CPU_CODE = (
    "import json, os, sys, time\n"
    "from physher_tpu_torch import legacy_cli\n"
    "t0 = time.perf_counter()\n"
    "with open(os.devnull, 'w') as out:\n"
    "    r = legacy_cli.run(sys.argv[1:], out=out)\n"
    "res = r.results['metaopt']\n"
    "tlk = r.ctx.objects['treelikelihood']\n"
    "print(json.dumps({'logp': res.logp, 'iterations': res.iterations,\n"
    "                  'seconds': time.perf_counter() - t0,\n"
    "                  'logp_at_params': float(tlk.log_likelihood(\n"
    "                      res.params)),\n"
    "                  'params': {k: v.tolist()\n"
    "                             for k, v in res.params.items()}}))\n")
# the CPU run's threads, beside the four nvcc of the build
LEGACY_CPU_THREADS = 3
# the legacy meta maximum, card (float64) against CPU: the runs stop where
# a round gains less than the config's precision (1e-3), and their paths
# part by rounding (run 1: 1691 iterations on the card, 1679 on the CPU,
# maxima 1.2e-4 apart), so the maxima agree to that precision; the card's
# logP at the CPU run's optimum agrees with the CPU's to float64 rounding
LEGACY_ML_ATOL = 1e-3
LEGACY_AT_CPU_OPTIMUM_RTOL = 1e-12
# sharded against unsharded in float64: rounding only (the shards' sums in
# another order), relative to the largest entry of logP, of the site logs
# and of the model's gradient (one vector over all its parameters)
SHARD_F64_RTOL = 1e-12


def start_legacy_cpu() -> subprocess.Popen:
    """The legacy CLI's fluA run on the CPU, in a process of its own (no
    CUDA device, ``LEGACY_CPU_THREADS`` threads); ``legacy_cpu_result``
    reads it."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS=str(LEGACY_CPU_THREADS),
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")]
                                  if p]))
    return subprocess.Popen(
        [sys.executable, "-c", LEGACY_CPU_CODE, *LEGACY_ARGV, "--device",
         "cpu"], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env, cwd=str(ROOT))


def stop_process(proc: subprocess.Popen) -> None:
    if proc.poll() is None:
        proc.kill()
        proc.wait(timeout=60)


def legacy_cpu_result(proc: subprocess.Popen) -> dict:
    """The CPU run's {logp, iterations, seconds}, waiting for it."""
    t0 = time.perf_counter()
    out, err = proc.communicate(timeout=600)
    check(proc.returncode == 0, f"the legacy CLI's CPU run: {err[-2000:]}")
    rec = json.loads(out.strip().splitlines()[-1])
    rec["waited_seconds"] = time.perf_counter() - t0
    return rec


def host_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """Median host time of ``fn()`` in ms; ``fn`` returns host values, so
    each call ends in a synchronize."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def rel_err(a, b) -> float:
    """max |a - b| over max |b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def api_flua(api, **kw):
    """The reference's fluA JC69 strict-clock time tree (checkpoint A)
    through the Interface API."""
    cfg = json.loads((DATA / "jc69-time.json").read_text())["model"]["tree"]
    tm = api.ReparameterizedTimeTreeModelInterface(
        cfg["newick"], dates=cfg["dates"], **kw)
    clock = api.StrictClockModelInterface(0.001, tm)
    return api.TreeLikelihoodInterface(
        read_alignment(str(DATA / "fluA.fa")), tm, api.JC69Interface(),
        api.ConstantSiteModelInterface(), clock, use_tip_states=True, **kw)


def api_gtrg4(api, **kw):
    """GTR+G4 on fluA's tree at the golden's values (tests/data/goldens/
    gtrg4_fluA.json) through the Interface API."""
    m = json.loads((DATA / "goldens" / "gtrg4_fluA.json").read_text())[
        "model"]
    sm = m["sitemodel"]["substitutionmodel"]
    rates = [sm["rates"][k]["value"] if k in sm["rates"] else 1.0
             for k in ("ac", "ag", "at", "cg", "ct", "gt")]
    dist = m["sitemodel"]["distribution"]
    tm = api.UnRootedTreeModelInterface(m["tree"]["newick"], **kw)
    return api.TreeLikelihoodInterface(
        read_alignment(str(DATA / "fluA.fa")), tm,
        api.GTRInterface(rates, sm["frequencies"]["values"]),
        api.GammaSiteModelInterface(dist["parameters"]["value"],
                                    dist["categories"]),
        use_tip_states=True, **kw)


def api_card(dev, smi):
    """(43) The Interface API on the card in float64: checkpoint A's logP
    and d logP / d rate through LogLikelihood and Gradient, Gradient
    against TreeLikelihood's autograd gradient on the card (1e-12
    relative), GTR+G4 fluA card against CPU (1e-10), the kernel launches a
    call and the median host ms a call over 30 (what a torchtree user pays
    an evaluation)."""
    from physher_tpu_torch import api

    f64 = dict(dtype=torch.float64, device=dev)
    flua = api_flua(api)
    check(flua.device == dev and flua.dtype == torch.float64,
          "the API's default device and dtype")
    zero_all_launches()
    logp = flua.LogLikelihood()
    per_logl = all_launches()
    zero_all_launches()
    grad = flua.Gradient()
    per_grad = all_launches()
    # TreeLikelihood's autograd gradient on the card, in the API's order
    tlk = load_fluA_time(torch.float64, dev)
    params = {k: v.requires_grad_() for k, v in
              tlk.param_space().init_params(**f64).items()}
    grads = dict(zip(params, torch.autograd.grad(tlk.log_likelihood(params),
                                                 list(params.values()))))
    ref = np.concatenate([np.atleast_1d(grads[k].cpu().numpy())
                          for k in sorted(grads)])
    rec = {"card": smi, "engine_flua": flua.tlk.engine_name(),
           "logp": logp, "logp_err": logp - GOLDEN_LOGP,
           "rate_grad_rel_err": grad[0] / GOLDEN_RATE_GRAD - 1,
           "gradient_vs_autograd_rel_err": rel_err(grad, ref),
           "launches_flua": {"log_likelihood": per_logl,
                             "gradient": per_grad}}
    ok = (abs(rec["logp_err"]) <= 1e-8
          and abs(rec["rate_grad_rel_err"]) <= 1e-8
          and rec["gradient_vs_autograd_rel_err"] <= 1e-12
          and per_logl["fused_forward"] == 1 and sum(per_logl.values()) == 1
          and per_grad["fused_forward"] == 1
          and per_grad["fused_backward"] == 1
          and sum(per_grad.values()) == 2)
    # GTR+G4 fluA, card against CPU, and its launches
    gtr, gtr_cpu = api_gtrg4(api), api_gtrg4(api, device="cpu")
    zero_all_launches()
    l_card = gtr.LogLikelihood()
    gtr_logl = all_launches()
    zero_all_launches()
    g_card = gtr.Gradient()
    gtr_grad = all_launches()
    rec.update(engine_gtrg4=gtr.tlk.engine_name(),
               gtrg4_logp=l_card,
               gtrg4_logp_rel_err=rel_err(l_card, gtr_cpu.LogLikelihood()),
               gtrg4_gradient_rel_err=rel_err(g_card, gtr_cpu.Gradient()),
               launches_gtrg4={"log_likelihood": gtr_logl,
                               "gradient": gtr_grad})
    kind = "staged" if gtr.tlk.engine_name() == "cuda-staged" else "fused"
    ok = (ok and rec["gtrg4_logp_rel_err"] <= 1e-10
          and rec["gtrg4_gradient_rel_err"] <= 1e-10
          and gtr_logl[f"{kind}_forward"] == 1
          and sum(gtr_logl.values()) == 1
          and gtr_grad[f"{kind}_forward"] == 1
          and gtr_grad[f"{kind}_backward"] == 1)
    # the host time a call, SetParameters included (the user's loop)
    tm, clock = flua.tree_model, flua.branch_model
    r0 = tm.GetParameters()
    rates = iter(np.linspace(0.9e-3, 1.1e-3, 10 ** 4))
    flua_set = lambda: clock.SetParameters([next(rates)])  # noqa: E731
    rec["host_ms"] = {
        "flua_log_likelihood": host_ms(flua.LogLikelihood),
        "flua_gradient": host_ms(flua.Gradient),
        "flua_set_and_log_likelihood": host_ms(
            lambda: (flua_set(), flua.LogLikelihood())),
        "gtrg4_log_likelihood": host_ms(gtr.LogLikelihood),
        "gtrg4_gradient": host_ms(gtr.Gradient),
        "tree_likelihood_f64_value_and_grad": host_ms(
            lambda: [g.item() for g in torch.autograd.grad(
                tlk.log_likelihood(params), [params["rate"]])]),
    }
    tm.SetParameters(r0)
    clock.SetParameters([1e-3])
    check(flua.LogLikelihood() == logp, "SetParameters back to the start")
    rec["tolerance"] = dict(logp_atol=1e-8, rate_grad_rtol=1e-8,
                            gradient_vs_autograd=1e-12, gtrg4_card_cpu=1e-10)
    rec["ok"] = ok
    emit("api_card", **rec)
    check(ok, "the Interface API on the card")
    return rec


def tools_card(dev, smi, legacy_cpu):
    """(44) The legacy CLI's fluA run on the card in float64 (its meta
    maximum within LEGACY_ML_ATOL of the same run on the CPU, started at
    the beginning of main, and its logP at the CPU run's optimum within
    LEGACY_AT_CPU_OPTIMUM_RTOL of the CPU's) and the dumper after it (read
    back equal to the pool, the meta optimum), then a 200-iteration
    one-chain nni tree MCMC with a tree logger through the CLI (float64)
    and the sbn action on its log (rootsplit probabilities summing to
    1)."""
    from physher_tpu_torch import legacy_cli

    rec = {"card": smi}
    zero_all_launches()
    t0 = time.perf_counter()
    out = io.StringIO()
    runner = legacy_cli.run(LEGACY_ARGV + ["--f64"], out=out)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    res = runner.results["metaopt"]
    launches = all_launches()
    cpu = legacy_cpu_result(legacy_cpu)
    tlk = runner.ctx.objects["treelikelihood"]
    with torch.no_grad():
        at_cpu = float(tlk.log_likelihood({
            k: torch.tensor(v, dtype=torch.float64, device=dev)
            for k, v in cpu.pop("params").items()}))
    rec["legacy"] = dict(
        logp=res.logp, iterations=res.iterations, wall_seconds=wall,
        engine=tlk.engine_name(), launches=launches, cpu=cpu,
        err=res.logp - cpu["logp"], tolerance=LEGACY_ML_ATOL,
        card_logp_at_cpu_optimum=at_cpu,
        at_cpu_optimum_rel_err=rel_err(at_cpu, cpu["logp_at_params"]),
        at_cpu_optimum_tolerance=LEGACY_AT_CPU_OPTIMUM_RTOL)
    ok = (abs(rec["legacy"]["err"]) <= LEGACY_ML_ATOL
          and rec["legacy"]["at_cpu_optimum_rel_err"]
          <= LEGACY_AT_CPU_OPTIMUM_RTOL
          and "Maximum log likelihood" in out.getvalue()
          and launches["fused_forward"] >= res.iterations)
    with tempfile.TemporaryDirectory() as tmp:
        dumped = runner.action_dumper({"type": "dumper",
                                       "file": str(Path(tmp) / "pool.json")})
        back = json.loads((Path(tmp) / "pool.json").read_text())
        pool_ok = (back == dumped and sorted(back) == sorted(runner.pool)
                   and len(back) > 0 and all(
                       np.array_equal(np.asarray(back[k]), v.cpu().numpy())
                       for k, v in runner.pool.items()))
        rec["dumper"] = dict(names=sorted(back), equal=pool_ok)
    ok = ok and pool_ok
    with tempfile.TemporaryDirectory() as tmp:
        node = {"id": "mcmc", "type": "mcmc", "model": "&treelikelihood",
                "length": 200,
                "operators": [
                    {"id": "o1", "type": "operator", "algorithm": "nni",
                     "x": "&tree", "weight": 1},
                    {"id": "o2", "type": "operator", "algorithm": "scaler",
                     "x": "%tree.distances", "weight": 4}],
                "log": [{"id": "l1", "type": "logger", "every": 10,
                         "file": "chain.trees", "models": "&tree"}]}
        path = flua_nj_config(Path(tmp), [
            node, {"id": "sbn", "type": "sbn", "file": "chain.trees",
                   "burnin": 0.1}], name="tools.json")
        zero_all_launches()
        t0 = time.perf_counter()
        runner, lines = run_cli([path, "--f64"])
        wall = time.perf_counter() - t0
        sbn = runner.results["sbn"]
        roots, conds = sbn.probabilities()
        rec["tree_mcmc_sbn"] = dict(
            wall_seconds=wall, launches=all_launches(),
            trees=len((Path(tmp) / "chain.trees").read_text().split()),
            sbn_trees=sbn.n_trees, rootsplits=len(roots),
            parent_clades=len(conds),
            rootsplit_sum_err=abs(sum(roots.values()) - 1.0))
    ok = (ok and rec["tree_mcmc_sbn"]["rootsplit_sum_err"] <= 1e-12
          and sbn.n_trees == 18)
    rec["ok"] = ok
    emit("tools_card", **rec)
    check(ok, "the legacy CLI, sbn and dumper on the card")
    return rec


def shard_layouts(dev) -> dict:
    """The device lists to shard over: every visible card when there are
    two or more (and the first two), else the card listed 2 and 4 times;
    and the four places of a 2 x 2 chains x patterns mesh."""
    n = torch.cuda.device_count()
    cards = [torch.device("cuda", i) for i in range(n)]
    if n >= 2:
        layouts = {f"cards{k}": cards[:k] for k in sorted({2, n})}
    else:
        layouts = {"x2": [dev] * 2, "x4": [dev] * 4}
    return layouts, [cards[i % n] for i in range(4)]


def shard_case(name, build, params, devices, dtype, chains=False):
    """A model sharded over ``devices`` (a 2 x (n/2) chains x patterns mesh
    with ``chains``) against the unsharded one at ``params``: the errors of
    logP, the site logs and every gradient, the engine and the launches of
    the sharded value-and-gradient."""
    from physher_tpu_torch.models.parameters import ParamBatch
    from physher_tpu_torch.parallel.mesh import (
        chain_pattern_mesh, pattern_mesh, shard_tree_likelihood)

    base = build(1)
    mesh = (chain_pattern_mesh(2, devices=devices) if chains
            else pattern_mesh(devices=devices))
    shd = shard_tree_likelihood(build(4), mesh)
    batch = params.batch_shape if isinstance(params, ParamBatch) else None
    out, launches = [], None
    for tlk in (base, shd):
        leaves = {k: v.detach().clone().requires_grad_()
                  for k, v in params.items()}
        p = ParamBatch(leaves, batch) if batch else leaves
        zero_all_launches()
        logp = tlk.log_likelihood(p)
        grads = torch.autograd.grad(logp.sum(), list(leaves.values()))
        torch.cuda.synchronize()
        launches = all_launches()
        with torch.no_grad():
            site = tlk.site_log_likelihoods(p)
        # the model's gradient: one vector over all its parameters
        out.append([logp.detach(), site,
                    torch.cat([g.reshape(-1) for g in grads])])
    tol = TOL[dtype]
    errs = {k: rel_err(b.cpu(), a.cpu())
            for k, a, b in zip(("logp", "site", "grad"), *out)}
    limits = ({"logp": SHARD_F64_RTOL, "site": SHARD_F64_RTOL,
               "grad": SHARD_F64_RTOL} if dtype == torch.float64 else
              {"logp": tol["logl"], "site": tol["site"],
               "grad": tol["grad"]})
    L = batch[0] if batch else None
    rec = dict(errs=errs, limits=limits, engine=shd.engine_name(L),
               unsharded_engine=base.engine_name(L), mesh=repr(shd.mesh),
               P=base.tip_partials.shape[-1],
               P_shard=shd._shard_rows[0][0][1].shape[-1], launches=launches)
    ok = (all(errs[k] <= limits[k] for k in errs)
          and rec["engine"] == rec["unsharded_engine"])
    return ok, rec


def sharding_card(dev, smi, reps=20):
    """(45) Pattern sharding on the card: every kernel pair sharded against
    unsharded in float64 (SHARD_F64_RTOL) and float32 (TOL) on K1'/K2' at
    checkpoint A, K3'/K4' on the balanced 128 x 16384 GTR+G4, K7'/K8' on
    GY94 on codon_small at the golden's values and K5'/K6' with 8 chains on
    a 2 x 2 chains x patterns mesh; an 8-chain fluA mcmc of 200 iterations
    with --mesh 2x2 through the CLI in float64 against the unsharded run
    (rtol 1e-9); the value-and-gradient host time at 1, 2 and 4 shards."""
    from physher_tpu_torch.parallel.mesh import (
        pattern_mesh, shard_tree_likelihood)

    layouts, mesh4 = shard_layouts(dev)
    one_card = torch.cuda.device_count() < 2
    rec = {"card": smi, "layouts": {k: [str(d) for d in v]
                                    for k, v in layouts.items()},
           "chains_mesh": [str(d) for d in mesh4],
           "note": ("one card listed several times: the times show only "
                    "the overhead of splitting") if one_card else None}
    emit("sharding_layouts", **rec)
    balanced = balanced_topology(128)
    sp128 = random_sitepattern(128, 16384, seed=7)

    def flua_time(dtype):
        return lambda pad: load_fluA_time(dtype, dev, pad)

    def gtr128(dtype):
        kw = dict(dtype=dtype, device=dev)
        return lambda pad: TreeLikelihood(
            sp128, balanced, GTR(**kw), GammaSiteModel(4, **kw),
            pattern_pad_multiple=pad, **kw)

    def gy94(dtype):
        return lambda pad: codon_small("gy94", dtype, dev, pad)[0]

    def gy94_params(dtype, build):
        kw = dict(dtype=dtype, device=dev)
        p = build(1).param_space().init_params(**kw)
        p.update({k: torch.tensor(v, **kw)
                  for k, v in CODON_GOLDEN_VALUES["gy94"].items()})
        return p

    cases, ok = {}, True
    for dtype in (torch.float64, torch.float32):
        label = str(dtype).replace("torch.", "")
        kw = dict(dtype=dtype, device=dev)
        specs = {
            "k1k2_checkpoint_a": (flua_time(dtype), lambda b: b(1)
                                  .param_space().init_params(**kw),
                                  "cuda-fused", False),
            "k3k4_balanced_128x16384": (gtr128(dtype), lambda b: b(1)
                                        .param_space().init_params(**kw),
                                        "cuda-staged", False),
            "k7k8_gy94": (gy94(dtype), lambda b: gy94_params(dtype, b),
                          "cuda-wide", False),
            "k5k6_flua_L8_2x2": (flua_time(dtype), lambda b: chain_params(
                b(1), 8, seed=3), "cuda-loop", True)}
        for name, (build, make_params, engine, chains) in specs.items():
            params = make_params(build)
            runs = ({"2x2": mesh4} if chains else layouts)
            for lay, devs in runs.items():
                good, r = shard_case(name, build, params, devs, dtype, chains)
                good = good and r["engine"] == engine
                cases[f"{name}_{label}_{lay}"] = r
                ok = ok and good
                emit("sharding_case", case=name, dtype=label, layout=lay,
                     ok=good, **r)
        torch.cuda.empty_cache()
    # an 8-chain fluA mcmc through the CLI, --mesh 2x2 against unsharded
    mc = {"type": "mcmc", "id": "mc", "model": "&treelikelihood",
          "length": 200, "chains": 8, "log": [{"every": 20}]}
    samples = {}
    with tempfile.TemporaryDirectory() as tmp:
        cfg = json.loads((DATA / "jc69-time.json").read_text())
        cfg["physher"] = [mc]
        path = Path(tmp) / "mcmc.json"
        path.write_text(json.dumps(cfg).replace(
            '"fluA.fa"', json.dumps(str(DATA / "fluA.fa"))))
        for lay, extra in (("unsharded", {}),
                           ("mesh2x2", {"mesh_devices": mesh4})):
            zero_all_launches()
            t0 = time.perf_counter()
            argv = [str(path), "--f64"] + (["--mesh", "2x2"] if extra
                                           else [])
            runner = cli.run(argv, out=io.StringIO(), **extra)
            torch.cuda.synchronize()
            res = runner.results["mc"]
            samples[lay] = (res.samples_u, res.log_posterior)
            rec[f"mcmc_{lay}"] = dict(
                wall_seconds=time.perf_counter() - t0,
                launches=all_launches(), shape=list(res.samples_u.shape),
                mesh=repr(runner.ctx.mesh))
    a, b = samples["unsharded"], samples["mesh2x2"]
    mcmc_err = max(rel_err(b[0], a[0]), rel_err(b[1], a[1]))
    mcmc_ok = bool(np.allclose(b[0], a[0], rtol=1e-9, atol=1e-12)
                   and np.allclose(b[1], a[1], rtol=1e-9)
                   and a[0].shape == (10, 8, 69))
    rec["mcmc_max_rel_err"] = mcmc_err
    ok = ok and mcmc_ok
    # the value-and-gradient host time at 1, 2 and 4 shards (float32)
    times = {}
    for name, build in (("flua_k1k2", flua_time(torch.float32)),
                        ("balanced_128x16384_k3k4",
                         gtr128(torch.float32))):
        params = build(1).param_space().init_params(dtype=torch.float32,
                                                    device=dev)
        leaves = {k: v.requires_grad_() for k, v in params.items()}
        for n in (1, 2, 4):
            tlk = build(4)
            if n > 1:
                devs = (layouts.get(f"x{n}") or layouts.get(f"cards{n}")
                        or [dev] * n)
                tlk = shard_tree_likelihood(tlk, pattern_mesh(devices=devs))

            def vg(tlk=tlk):
                logp = tlk.log_likelihood(leaves)
                torch.autograd.grad(logp, list(leaves.values()))
                return logp.item()

            times[f"{name}_shards{n}_ms"] = host_ms(vg, reps=reps)
    rec["value_and_grad_host_ms"] = times
    rec["ok"] = ok
    emit("sharding_card", **{k: v for k, v in rec.items()
                             if not k.startswith("layouts")})
    check(mcmc_ok, "the --mesh 2x2 mcmc's samples against unsharded")
    check(ok, "pattern sharding on the card")
    return rec, cases


# ---- phase 46: K1'/K2' at S != 4 (packed and category-split) and the
# level-staged sweep at S = 20


def wag_large(dtype, device):
    """WAG without Gamma at the JAX package's benchmark size: the patterns
    of :func:`wag_g4_large` (S = 20, C = 1: K1'/K2''s packed mode)."""
    sp = random_sitepattern(64, 8192, seed=9, datatype="aminoacid")
    kw = dict(dtype=dtype, device=device)
    return TreeLikelihood(sp, balanced_topology(64), WAG(**kw), **kw)


def wag_caterpillar(dtype, device):
    """WAG (C = 1: packed) on a 128-taxon caterpillar at 8192 patterns: 127
    internal nodes in a row, the worst case for K1'/K2''s hand-offs between
    blocks."""
    sp = random_sitepattern(128, 8192, seed=19, datatype="aminoacid")
    kw = dict(dtype=dtype, device=device)
    return TreeLikelihood(sp, caterpillar_topology(128), WAG(**kw), **kw)


def graph_replays_identical(run, replays=3) -> bool:
    """``run()`` captured in a CUDA graph and replayed ``replays`` times,
    its outputs set to NaN before each: every replay bit for bit the eager
    call's (a kernel's counter or flag left set would show here)."""
    eager = run()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = run()
    same = True
    for _ in range(replays):
        for x in captured:
            x.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        same = same and all(torch.equal(a, b)
                            for a, b in zip(captured, eager))
    del graph
    return bool(same)


def fused_wide_alone(topo, tips, pmats, freqs, props, w, split):
    """K1' and K2' at S != 4 alone, in the TPU wrapper's mode ``split``,
    against the plain version of the mode on one model's inputs: max abs
    errors (site logs; d pmats, d freqs, d props), median times (CUDA
    events; one launch each a call), the plain version's, the bounds
    (:func:`pruning_work`) and, with ``split``, K2''s per-block dP scratch
    in bytes."""
    T, S, P = tips.shape
    C = pmats.shape[1]
    children = topo_constant(topo, "children", lambda: topo.children, tips,
                             torch.int32)
    rootw = (props[:, None] * freqs[None, :]).reshape(-1).contiguous()

    def fwd():
        return fused.fused_wide_forward(tips, pmats, children, rootw, split)
    n0 = (fused.FORWARD_LAUNCHES, fused.BACKWARD_LAUNCHES)
    out, partials, scale = fwd()
    # the cotangent of the kernel's output: per category the logsumexp's
    # gradient g exp(site_c - site_log) in split mode
    site_k = torch.logsumexp(out, 0) if split else out
    g = (w * torch.exp(out - site_k)).contiguous() if split else w

    def bwd():
        return fused.fused_wide_backward(tips, pmats, children, rootw, split,
                                         partials, scale, g)
    dP, drootw = bwd()
    launches = (fused.FORWARD_LAUNCHES - n0[0],
                fused.BACKWARD_LAUNCHES - n0[1])
    dr = drootw.view(C, S)
    grads_k = (dP, (props[:, None] * dr).sum(0), (freqs[None, :] * dr).sum(1))
    plain = (fused.fused_split_site_log_reference if split
             else fused.fused_site_log_reference)
    leaves = [x.clone().requires_grad_(True) for x in (pmats, freqs, props)]
    site_graph = plain(tips, leaves[0], topo, leaves[1], leaves[2])
    grads_p = torch.autograd.grad(site_graph, leaves, w, retain_graph=True)
    site_p = site_graph.detach()
    rec = {"split": split, "launches_per_call": launches,
           "forward_err": float((site_k - site_p).abs().max()),
           "forward_rel_err": max_err(site_k, site_p)[1],
           "backward_err": max(max_err(a, b)[0]
                               for a, b in zip(grads_k, grads_p)),
           "backward_rel_err": max(max_err(a, b)[1]
                                   for a, b in zip(grads_k, grads_p))}
    rec["forward_ms"] = median_ms(fwd, reps=50)
    rec["backward_ms"] = median_ms(bwd, reps=50)

    def sweep():
        out_, part_, scale_ = fwd()
        return (out_, part_, scale_) + fused.fused_wide_backward(
            tips, pmats, children, rootw, split, part_, scale_, g)
    rec["graph_replays_identical"] = graph_replays_identical(sweep)
    with torch.no_grad():
        rec["forward_plain_ms"] = median_ms(lambda: plain(
            tips, pmats, topo, freqs, props), reps=10)
    rec["backward_plain_ms"] = median_ms(lambda: torch.autograd.grad(
        site_graph, leaves, w, retain_graph=True), reps=10)
    dims = (T, topo.I, C, S, children.shape[1], P, tips.element_size())
    for kind, is_bwd in (("forward", False), ("backward", True)):
        ms, by = bound(*pruning_work(is_bwd, *dims))
        rec[f"{kind}_bound_ms"], rec[f"{kind}_bound_by"] = ms, by
    nb = -(-P // fused.WIDE_BACKWARD_BLOCK)
    rec["dP_scratch_bytes"] = nb * (T + topo.I) * C * S * S * \
        tips.element_size()
    return rec


def tlk_value_and_grad(tlk, params):
    """(logP, its gradient in every parameter, in ``params``' order)."""
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    logp = tlk.log_likelihood(leaves)
    grads = torch.autograd.grad(logp, list(leaves.values()),
                                allow_unused=True)
    return logp.detach(), [torch.zeros_like(v) if g is None else g
                           for v, g in zip(leaves.values(), grads)]


def engine_path(tlk, params, engine):
    """One value and gradient of ``tlk`` through ``engine`` with every
    launch count set to 0 just before: (logP, gradients, the counts)."""
    tlk.engine = engine
    zero_all_launches()
    logp, grads = tlk_value_and_grad(tlk, params)
    torch.cuda.synchronize()
    return logp, grads, all_launches()


def wag_g4_config(workdir: Path, dev, engine, n_tips=64, n_sites=8192,
                  seed=17) -> Path:
    """WAG+G4 data simulated on the card down a balanced ``n_tips`` tree
    (branch lengths 0.1, shape 0.5), written as FASTA beside a config:
    WAG+G4 on that tree with ``"engine": engine`` and an L-BFGS fit of the
    branch lengths and the shape. Returns the config's path."""
    from physher_tpu_torch.io.seqio import write_fasta
    from physher_tpu_torch.io.treeio import write_newick

    kw = dict(dtype=torch.float64, device=dev)
    topo = balanced_topology(n_tips)
    subst, site = WAG(**kw), GammaSiteModel(4, **kw)
    params = {**subst.param_space().init_params(**kw),
              **site.param_space().init_params(**kw)}
    bl = np.full(topo.N, 0.1)
    bl[topo.root] = 0.0
    fasta = workdir / "wag.fa"
    if not fasta.exists():
        gen = torch.Generator(device=dev).manual_seed(seed)
        seqs = simulate_alignment(gen, topo, subst, site, params, bl,
                                  n_sites, datatype="aa")
        write_fasta(seqs, str(fasta))
    bl[topo.root] = np.nan
    cfg = {
        "model": {
            "id": "treelikelihood", "type": "treelikelihood",
            "engine": engine,
            "sitepattern": {"id": "patterns", "type": "sitepattern",
                            "datatype": "aa",
                            "alignment": {"id": "seqs", "type": "alignment",
                                          "file": fasta.name}},
            "sitemodel": {
                "id": "sitemodel", "type": "sitemodel",
                "distribution": {"distribution": "gamma", "categories": 4,
                                 "parameters": {"alpha": {
                                     "id": "alpha", "type": "parameter",
                                     "value": 0.5, "lower": 0}}},
                "substitutionmodel": {"id": "sm", "type": "substitutionmodel",
                                      "model": "wag", "datatype": "aa"}},
            "tree": {"id": "tree", "type": "tree",
                     "newick": write_newick(topo, bl)}},
        "physher": [{"id": "ml", "type": "optimizer", "algorithm": "lbfgs",
                     "model": "&treelikelihood"}]}
    path = workdir / f"wag-g4-{engine}.json"
    path.write_text(json.dumps(cfg))
    return path


# the pallas-fused CLI run against pallas-wide at the fused run's optimum
# (float64): the same function through other kernels, rounding only
CLI_FUSED_RTOL = 1e-10


def cli_fused_wag_g4(dev):
    """The ``"engine": "pallas-fused"`` CLI run on a WAG+G4 config (64 taxa
    x 8192 sites simulated on the card, float64, an L-BFGS fit): through
    K1'/K2' in category-split mode by their launch counts, and its logP
    within CLI_FUSED_RTOL of the same config under ``pallas-wide`` at the
    fused run's optimum."""
    from physher_tpu_torch.config.builder import build_config, load_json

    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        fused_cfg = wag_g4_config(work, dev, "pallas-fused")
        wide_cfg = wag_g4_config(work, dev, "pallas-wide")
        zero_all_launches()
        t0 = time.perf_counter()
        runner, lines = run_cli([fused_cfg, "--f64"])
        wall = time.perf_counter() - t0
        launches = all_launches()
        ctx, _ = build_config(load_json(str(wide_cfg)), base_dir=tmp,
                              dtype=torch.float64, device=dev)
    tlk = runner.ctx.objects["treelikelihood"]
    wide_tlk = ctx.objects["treelikelihood"]
    res = runner.results["ml"]
    params = runner.params_for(tlk.param_space())
    with torch.no_grad():
        logp = float(tlk.log_likelihood(params))
        wide.WIDE_FORWARD_LAUNCHES = 0
        logp_wide = float(wide_tlk.log_likelihood(params))
        wide_n = wide.WIDE_FORWARD_LAUNCHES
    rel = abs(logp / logp_wide - 1)
    names = (tlk.engine_name(), wide_tlk.engine_name())
    ok = bool(names == ("cuda-fused", "cuda-wide") and wide_n == 1
              and launches["fused_forward"] >= res.iterations >= 1
              and launches["fused_backward"] >= res.iterations
              and launches["wide_forward"] == 0
              and launches["wide_backward"] == 0
              and np.isfinite(res.logp) and rel <= CLI_FUSED_RTOL
              and fused.needs_csplit(4, 20))
    rec = dict(ok=ok, lines=lines, patterns=tlk.sp.pattern_count,
               engines=names, ml_iterations=res.iterations, ml_logp=res.logp,
               logp_at_optimum=logp, logp_wide_at_optimum=logp_wide,
               rel_err=rel, rtol=CLI_FUSED_RTOL, launches=launches,
               wall_seconds=wall)
    return rec


def fused_wide_card(dev, smi):
    """Phase 46. At the three full-width shapes (WAG+G4 64 x 8192 and GY94
    M0 32 x 4096: category-split; WAG 64 x 8192: packed) and a 128-taxon
    caterpillar (WAG at 8192, packed), float32 and float64:
    TreeLikelihood(engine="cuda-fused") value and gradient (one K1' and one
    K2' launch, no other kernel) against the plain engine; K1'/K2' against
    the plain version of the mode and against K7'/K8' on the same inputs;
    ``cuda-staged`` at S = 20 (csrc/wide.cu's level kernels) against the
    plain version; then the ``pallas-fused`` CLI run. Float32: each kernel
    alone by CUDA events beside K7'/K8' and plain, and a sweep replayed from
    a CUDA graph three times bit for bit."""
    shapes = (("wag-g4-64x8192", wag_g4_large, True),
              ("gy94-32x4096", gy94_m0_fit_model, True),
              ("wag-64x8192", wag_large, False),
              ("wag-caterpillar-128x8192", wag_caterpillar, False))
    rec = {"card": smi}
    ok = True
    for dtype in (torch.float32, torch.float64):
        dt = str(dtype).replace("torch.", "")
        kw = dict(dtype=dtype, device=dev)
        for name, make, split in shapes:
            tlk = make(dtype, dev)
            params = tlk.param_space().init_params(**kw)
            tips, pm, fr, pr, w = inputs = engine_inputs(tlk, params)
            C, S = pm.shape[1], tips.shape[1]
            out = {"categories": C, "states": S, "split": split}
            ok = ok and fused.needs_csplit(C, S) == split
            # the main path: one value and gradient through each named pair
            logp_k, g_k, n_fused = engine_path(tlk, params, "cuda-fused")
            logp_p, g_p, _ = engine_path(tlk, params, "torch")
            out["launches_fused"] = n_fused
            out["logp_rel_err"] = abs(float(logp_k) / float(logp_p) - 1)
            out["grad_rel_err"] = max(max_err(a, b)[1]
                                      for a, b in zip(g_k, g_p))
            tol = TOL[dtype]
            path_ok = (n_fused["fused_forward"] == 1
                       and n_fused["fused_backward"] == 1
                       and sum(n_fused.values()) == 2
                       and out["logp_rel_err"] <= tol["logl"]
                       and out["grad_rel_err"] <= tol["grad"])
            if S == 20 and split:
                logp_s, g_s, n_staged = engine_path(tlk, params,
                                                    "cuda-staged")
                out["launches_staged"] = n_staged
                out["staged_logp_rel_err"] = abs(float(logp_s)
                                                 / float(logp_p) - 1)
                out["staged_grad_rel_err"] = max(
                    max_err(a, b)[1] for a, b in zip(g_s, g_p))
                path_ok = path_ok and (
                    n_staged["wide_forward"] == 1
                    and n_staged["wide_backward"] == 1
                    and sum(n_staged.values()) == 2
                    and out["staged_logp_rel_err"] <= tol["logl"]
                    and out["staged_grad_rel_err"] <= tol["grad"])
            tlk.engine = "auto"
            out["path_ok"] = path_ok
            ok = ok and path_ok
            # the kernels alone: against the plain version of the mode and
            # against K7'/K8' on the same inputs, at compare()'s tolerances
            plain = (fused.fused_split_site_log_reference if split
                     else fused.fused_site_log_reference)
            out["vs_plain"] = compare(
                f"{name}-{'split' if split else 'packed'}", tlk.topo, inputs,
                dtype, phase="fused_wide_vs_plain",
                fns=(fused.fused_site_log, plain))
            out["vs_k7k8"] = compare(
                f"{name}-vs-k7k8", tlk.topo, inputs, dtype,
                phase="fused_wide_vs_k7k8",
                fns=(fused.fused_site_log, wide.wide_site_log))
            if S == 20 and split:
                out["staged_vs_plain"] = compare(
                    f"{name}-staged", tlk.topo, inputs, dtype, mod=staged,
                    phase="staged_wide_vs_plain")
            if dtype == torch.float32:
                out["kernel_alone"] = fused_wide_alone(tlk.topo, *inputs,
                                                       split)
                out["k7k8_alone"] = kernels_alone(wide, tlk.topo, tips, pm,
                                                  fr, pr, w)
                ok = ok and out["kernel_alone"]["graph_replays_identical"]
            rec[f"{name}-{dt}"] = out
            del tlk, params, inputs, tips, pm, fr, pr, w
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rec["cli"] = cli_fused_wag_g4(dev)
    rec["cli_seconds"] = time.perf_counter() - t0
    ok = ok and rec["cli"]["ok"]
    rec["ok"] = ok
    emit("fused_wide_card", **rec)
    check(ok, "K1'/K2' at S != 4 and the staged sweep at S = 20 on the card")
    return rec


def fused_wide_rows(fw, fused_src, wide_src) -> list:
    """The ``kernels`` line's rows of phase 46: K1'/K2' at S != 4 split (at
    WAG+G4, launches from the pallas-fused CLI run; GY94's times beside)
    and packed (WAG; launches from its cuda-fused value and gradient; the
    caterpillar's times beside), and
    the staged sweep at S = 20 on csrc/wide.cu (launches from the
    cuda-staged value and gradient, times those of K7'/K8' at WAG+G4)."""
    split, gy, packed, cat = (fw[f"{n}-float32"] for n in (
        "wag-g4-64x8192", "gy94-32x4096", "wag-64x8192",
        "wag-caterpillar-128x8192"))
    cli = fw["cli"]["launches"]
    rows = []
    for kind, line in (("forward", 245), ("backward", 390)):
        rows.append(dict(
            kernel_row(f"fused_wide_{kind}_split", fused_src,
                       f"physher_tpu/ops/pallas_fused.py:{line}",
                       cli[f"fused_{kind}"], split["kernel_alone"], kind),
            k7k8_ms=split["k7k8_alone"][f"{kind}_ms"],
            gy94_32x4096_ms=gy["kernel_alone"][f"{kind}_ms"],
            gy94_32x4096_bound_ms=gy["kernel_alone"][f"{kind}_bound_ms"],
            gy94_32x4096_k7k8_ms=gy["k7k8_alone"][f"{kind}_ms"],
            path_launches=split["launches_fused"][f"fused_{kind}"],
            **({"dP_scratch_bytes": split["kernel_alone"][
                "dP_scratch_bytes"]} if kind == "backward" else {})))
        rows.append(dict(
            kernel_row(f"fused_wide_{kind}_packed", fused_src,
                       f"physher_tpu/ops/pallas_fused.py:{line}",
                       packed["launches_fused"][f"fused_{kind}"],
                       packed["kernel_alone"], kind),
            k7k8_ms=packed["k7k8_alone"][f"{kind}_ms"],
            caterpillar_128x8192_ms=cat["kernel_alone"][f"{kind}_ms"],
            caterpillar_128x8192_bound_ms=cat["kernel_alone"][
                f"{kind}_bound_ms"],
            caterpillar_128x8192_k7k8_ms=cat["k7k8_alone"][f"{kind}_ms"]))
    for kind, line in (("forward", 234), ("backward", 375)):
        rows.append(kernel_row(
            f"staged_{kind}_wide", wide_src,
            f"physher_tpu/ops/pallas_staged.py:{line}",
            split["launches_staged"][f"wide_{kind}"], split["k7k8_alone"],
            kind))
    return rows


def c5_times(rec, shape, kind, suffix=""):
    """A kernel's device time at C = 4 and 5 (and 8 where measured) on one
    shape, and the ratio of C = 5 to C = 4 (median and range over the
    rounds), from :func:`family_times`."""
    out = {f"C{C}_device_ms": rec[f"{shape}-C{C}{suffix}"][f"{kind}_ms"]
           for C in (4, 5, 8) if f"{shape}-C{C}{suffix}" in rec}
    out["C5_over_C4"] = rec[f"{shape}{suffix}-{kind}-C5_over_C4"]
    return out


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
    # phase 44's CPU run of the legacy CLI, beside the build
    legacy_cpu = start_legacy_cpu()
    atexit.register(stop_process, legacy_cpu)
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

    # ---- 3. K1'/K2' against plain, on the card (K2' also at S4_SHAPES)
    flu_topo = load_fluA_time(torch.float64, "cpu").topo
    shapes = [(name, flu_topo if n is None else balanced_topology(n), P, C)
              for name, n, P, C in SHAPES]
    s4_shapes = [(name, make(), P, C) for name, make, P, C in S4_SHAPES]
    for dtype in (torch.float32, torch.float64):
        for name, topo, P, C in shapes + s4_shapes:
            compare(name, topo, random_inputs(topo, P, C, 7, dtype,
                                                     dev), dtype)
            torch.cuda.synchronize()
    # K2' twice on the same inputs at the caterpillar (bit-identical: fixed
    # sum orders, no atomics)
    name, topo, P, C = s4_shapes[1]
    check(k2_deterministic(topo, *random_inputs(topo, P, C, 7,
                                                torch.float32, dev)),
          f"K2' twice on the same inputs, bit for bit, at {name}")

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

    # ---- 9. codon and protein goldens through K7'/K8' (float64), then the
    # codon models in float32 through K7'/K8' and K5'/K6'
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
    codon_float32(dev)

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
    # and K1'/K2' alone at its model's inputs, their launches' device times
    # and registers, and both twice on the same inputs (bit for bit; K1''s
    # rescaled partials peaking at 1)
    runner, launches_fused = cli_checkpoint_b(dev)
    runner_b = runner
    runner_b_elbo = runner.results["sg"].elbo
    tlk = runner.ctx.objects["treelikelihood"]
    b_inputs = engine_inputs(tlk, runner.params_for(tlk.param_space()))
    fused_alone = kernels_alone(fused, tlk.topo, *b_inputs)
    tips, pm, fr, pr, w = b_inputs
    children = topo_constant(tlk.topo, "children", lambda: tlk.topo.children,
                             tips, torch.int32)
    rootw = (pr[:, None] * fr[None, :]).reshape(-1).contiguous()
    postorder = cuda_build.postorder_schedule(tlk.topo, tips)
    _, part, sc = fused.pruning_forward(tips, pm, children, rootw, postorder)
    schedule = cuda_build.preorder_schedule(tlk.topo, tips)
    k2_launch_us = s4_launch_us(lambda: fused.pruning_backward(
        tips, pm, children, rootw, schedule, part, sc, w))
    k2_same = k2_deterministic(tlk.topo, *b_inputs)
    k1 = s4_forward_checks(lambda: fused.pruning_forward(
        tips, pm, children, rootw, postorder), (1, 2))
    emit("fused_times", card=smi, model="fluA-elbo JC69 float32",
         patterns=tlk.sp.pattern_count, kernel_alone=fused_alone,
         k1_checks=k1, k1_ptxas=ptxas_by_kernel(fused.build_log,
                                                "s4_forward"),
         k2_launch_us=k2_launch_us, k2_bit_identical=k2_same)
    check(k2_same, "K2' twice on the same inputs, bit for bit, at the "
                   "checkpoint B model")
    check(k1["bit_identical"] and k1["partials_peak_1"],
          "K1' twice on the same inputs, bit for bit, its partials peaking "
          "at 1, at the checkpoint B model")

    # ---- 15. the third slice's main path: ML then ADVI of a GTR+G4 config
    # at 128 taxa x about 16 000 patterns through the CLI (K3'/K4')
    runner, staged_launches = cli_staged_large(dev)
    runner_large = runner

    # ---- 16. times of K3'/K4', K1'/K2' and plain at that model's inputs,
    # each K3'/K4' launch's device time, and both twice on the same inputs
    # (bit-identical: fixed sum orders, no atomics)
    tlk = runner.ctx.objects["treelikelihood"]
    params = runner.params_for(tlk.param_space())
    inputs = engine_inputs(tlk, params)
    staged_alone = kernels_alone(staged, tlk.topo, *inputs)
    times = {"card": smi, "patterns": tlk.sp.pattern_count,
             "level_nodes": [len(lv) for lv in tlk.topo.levels],
             "kernel_alone": staged_alone,
             **staged_checks(tlk.topo, *inputs)}
    check(times["forward_bit_identical"] and times["backward_bit_identical"],
          "K3' and K4' twice on the same inputs, bit for bit")
    check(times["forward_kernels_a_sweep"]
          == times["forward_launches_planned"]
          <= times["switch_level"] + 1
          and times["forward_launches_profiled"] in (
              None, times["forward_kernels_a_sweep"]),
          "K3' at the 128-taxon config: a launch a wide level and one walk")
    # K3' at GTR+G4 fluA: the whole tree in one walk
    gtr = load_gtrg4_fluA(torch.float32, dev)
    flua = staged_checks(gtr.topo, *engine_inputs(
        gtr, gtr.param_space().init_params(dtype=torch.float32, device=dev)))
    times["fluA_gtrg4"] = flua
    check(flua["forward_kernels_a_sweep"] == 1 and flua["switch_level"] == 0
          and flua["forward_launches_profiled"] in (None, 1)
          and flua["forward_bit_identical"]
          and flua["backward_bit_identical"],
          "K3' walks the GTR+G4 fluA tree in one launch, bit for bit")
    del gtr
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
    staged_walk = {
        "kernels": {"s4": "s4_forward_kernel<scalar_t, RootWeights, "
                          "TopOfStage> (physher_tpu_torch/csrc/"
                          "s4_forward.cuh)",
                    "chain": "forward_chain (physher_tpu_torch/csrc/"
                             "staged.cu)"},
        "launched_from": "physher_tpu_torch/csrc/staged.cu",
        "walk": {"config_128x16291": times["walk"],
                 "fluA_gtrg4": times["fluA_gtrg4"]["walk"]},
        "launches_a_sweep": {
            "config_128x16291": times["forward_kernels_a_sweep"],
            "fluA_gtrg4": times["fluA_gtrg4"]["forward_kernels_a_sweep"]},
        "switch_level": {
            "config_128x16291": times["switch_level"],
            "fluA_gtrg4": times["fluA_gtrg4"]["switch_level"]}}

    # ---- 17. K5'/K6' against plain at the fourth slice's shapes: chains of
    # the checkpoint B model (L = 16, the mmcmc ladder; L = 4, the HMC
    # chains) and of GTR+G4 fluA (L = 8), a fluA tree with polytomies at
    # L = 1 and 4, and (K6''s reverse step at large P) a 128-taxon
    # caterpillar at 16 384 patterns; float32, and float64 with rescale on
    # and off; K5' and K6' at S = 4 twice on the same inputs, with their
    # launches' device times and registers
    loop_times = {"card": smi, "build_seconds": build_loop_s,
                  "k5_ptxas": ptxas_by_kernel(loop.build_log, "s4_forward"),
                  "k6_ptxas": {**ptxas_by_kernel(loop.build_log, "s4_walk"),
                               **ptxas_by_kernel(loop.build_log, "s4_dp")}}
    poly = collapsed_topology(flu_topo)
    cat128 = caterpillar_topology(128)
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
            # K6''s reverse step at large P: 127 preorder levels of one
            # node, eight dP chunks; 16 384 patterns a sum, so at the
            # kernel tolerances of TOL, as K2' at this shape
            loop_alone("caterpillar-128x16384-C2-L2", cat128,
                       *random_chains(cat128, 16384, 2, 2, 31, dtype, dev),
                       rescale=rescale, tol=TOL[dtype])
        if dtype == torch.float32:
            # K6' at S = 4 at the HMC chains: its launches and twice on the
            # same inputs (bit-identical: fixed sum orders, no atomics)
            name, topo, (tips, pm, fr, pr, w) = cases[1]
            g = w.expand(pm.shape[0], -1).contiguous()
            children = topo_constant(topo, "children", lambda: topo.children,
                                     tips, torch.int32)
            postorder = cuda_build.postorder_schedule(topo, tips)
            _, part, sc = loop.loop_forward(tips, pm, children, fr, pr,
                                            postorder)
            schedule = cuda_build.preorder_schedule(topo, tips)
            loop_times["k6_launch_us"] = s4_launch_us(
                lambda: loop.loop_backward(tips, pm, children, fr, pr,
                                           schedule, part, sc, g))
            loop_times["k6_bit_identical"] = k6_deterministic(
                topo, tips, pm, fr, pr, g)
            check(loop_times["k6_bit_identical"],
                  "K6' at S = 4 twice on the same inputs, bit for bit")
            # K5' at S = 4 at the ladder's and the HMC chains: its launch's
            # device time, twice on the same inputs, partials peaking at 1
            for name, topo, (tips, pm, fr, pr, w) in cases[:2]:
                postorder = cuda_build.postorder_schedule(topo, tips)
                children = topo_constant(topo, "children",
                                         lambda: topo.children, tips,
                                         torch.int32)
                rec = s4_forward_checks(
                    lambda: loop.loop_forward(tips, pm, children, fr, pr,
                                              postorder), (2, 3))
                loop_times[f"k5_checks_{name}"] = rec
                check(rec["bit_identical"] and rec["partials_peak_1"],
                      f"K5' at S = 4 twice on the same inputs, bit for bit, "
                      f"its partials peaking at 1, at {name}")
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

    # ---- 25-28. the ML estimator: meta on jc69-time.json (Adam, L-BFGS,
    # Brent through K1'/K2'), meta with six starts on GTR+G4 fluA (the
    # warmup through K5'/K6' at L = 6), the hessian and laplace actions
    # (K5'/K6' at L = 2n + 1) and an optimizer's CSV checkpoint with -c
    t0 = time.perf_counter()
    time_runner, ml_time = ml_meta_time(dev)
    ml_gtr = ml_meta_gtrg4()
    ml_hessian = hessian_laplace(dev, time_runner)
    ml_checkpoint()
    emit("ml_phases", seconds=time.perf_counter() - t0)

    # ---- 29-30. the fourteenth slice's shapes: K1'/K2', K3'/K4' and
    # K5'/K6' at S = 4 against plain at C = 3 and 5, with and without an
    # identity category, then their times at C = 5 beside C = 4
    walls = {}
    t0 = time.perf_counter()
    family_kernels(dev)
    walls["family_kernels"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    c5 = family_times(smi)
    walls["family_times"] = time.perf_counter() - t0

    # ---- 31-35. the fourteenth slice's paths through the CLI: (a)
    # GTR+G4+I meta (K3'/K4'), (b) ADVI and 8-chain mcmc of the fluA-elbo
    # model with G4+I and a lognormal relaxed clock (K3'/K4', K5'), (c)
    # UNREST against the JAX package and its meta fit (K1'/K2'), (d) the
    # jc69w4 golden, (e) the large G4+I config against plain and ADVI
    results = {}
    for name, run in (("a_meta_gtrg4i", family_meta_gtrg4i),
                      ("b_advi_mcmc", lambda: family_advi_mcmc(dev)),
                      ("c_unrest", lambda: family_unrest(dev)),
                      ("d_jc69w4", lambda: family_jc69w4(dev)),
                      ("e_staged_large", lambda: family_staged_large(dev))):
        t0 = time.perf_counter()
        results[name] = run()
        walls[name] = time.perf_counter() - t0
    g4i_meta = results["a_meta_gtrg4i"]
    g4i_advi, g4i_mcmc = results["b_advi_mcmc"]
    emit("family_phases", card=smi, seconds=walls)

    # ---- 36-39. the fifteenth slice: (a) skyline, skygrid and
    # piecewise-linear on the card against the CPU and an 8-chain skygrid
    # mcmc (K5'), (b) the ELBO checks as one batch (K5') against the
    # parent's loop, and ADVI at gradsamples 4 (K5'/K6'), (c) the
    # estimators on the calibrated config against the JAX package's
    # windows, (d) MixedMCMC over the SSVS local clock (K5' at L = 4)
    walls = {}
    t0 = time.perf_counter()
    coal_launches = coalescent_card(dev)
    walls["a_coalescent"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    checks = elbo_checks(dev, smi, (("fluA", runner_b, "sg"),
                                    ("128x16291", runner_large, "vb")))
    walls["b_elbo_checks"] = time.perf_counter() - t0
    del runner_large
    t0 = time.perf_counter()
    est = estimators_card(dev, smi)
    walls["c_estimators"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    mixed_launches = mixed_mcmc_ssvs(dev)
    walls["d_mixed_mcmc"] = time.perf_counter() - t0
    emit("comparison_phases", card=smi, seconds=walls)

    # ---- 40-42. the sixteenth slice: (40) asr, ppsite, cat, simultron and
    # parsimony after a meta fit (K1'/K2' at JC69, K3'/K4' at GTR+G4), (41)
    # the topology search (candidates scored by the dynamic engine,
    # re-optimized through K1'/K2'), (42) the nni tree MCMC, one chain (K1'
    # a proposal) and 8 chains (the dynamic engine), with and without
    # incremental updates
    walls = {}
    t0 = time.perf_counter()
    analyses = analyses_card(dev, smi)
    walls["40_analyses"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, search_launches = topology_card(dev, smi,
                                       analyses["jc69"]["meta_logp"])
    walls["41_topology_search"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tree_mc = tree_mcmc_card(dev, smi)
    walls["42_tree_mcmc"] = time.perf_counter() - t0
    emit("topology_phases", card=smi, seconds=walls)

    # ---- 43-45. the seventeenth slice: (43) the Interface API on the card
    # (K1'/K2' at checkpoint A, the staged gate's pair at GTR+G4), (44) the
    # legacy CLI against its CPU run, a tree MCMC, sbn and dumper, (45)
    # every kernel pair on pattern shards and a --mesh 2x2 mcmc
    walls = {}
    t0 = time.perf_counter()
    api_rec = api_card(dev, smi)
    walls["43_api"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tools = tools_card(dev, smi, legacy_cpu)
    walls["44_tools"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    shard_rec, shard_cases = sharding_card(dev, smi)
    walls["45_sharding"] = time.perf_counter() - t0
    emit("interface_phases", card=smi, seconds=walls)

    # ---- 46. the eighteenth slice: K1'/K2' at S != 4 in the TPU wrapper's
    # packed and category-split modes, and the staged sweep at S = 20
    # (csrc/wide.cu's level kernels), at the full-width protein and codon
    # shapes, and the pallas-fused CLI run on a WAG+G4 config
    t0 = time.perf_counter()
    fw = fused_wide_card(dev, smi)
    emit("fused_wide_phase", card=smi, seconds=time.perf_counter() - t0)

    def sharded(prefix, key):
        return {k[len(prefix) + 1:]: v["launches"][key]
                for k, v in shard_cases.items() if k.startswith(prefix)}

    api_flua_n = api_rec["launches_flua"]
    api_gtr_n = api_rec["launches_gtrg4"]
    mesh_mcmc_n = shard_rec["mcmc_mesh2x2"]["launches"]

    emit("total", seconds=time.perf_counter() - t_start)
    fused_src = "physher_tpu_torch/csrc/pruning.cu"
    wide_src = "physher_tpu_torch/csrc/wide.cu"
    staged_src = "physher_tpu_torch/csrc/staged.cu"
    loop_src = "physher_tpu_torch/csrc/loop.cu"
    print(json.dumps({"kernels": [
        dict(kernel_row("pruning_forward", fused_src,
                        "physher_tpu/ops/pallas_fused.py:245",
                        launches_fused["forward"], fused_alone, "forward"),
             ml_meta_time_f64_launches=ml_time["fused_forward"],
             nest_f64_launches=est["launches"]["nest"]["fused_forward"],
             analyses_meta_jc69_f64_launches=analyses["jc69"]["launches"][
                 "fused_forward"],
             topology_search_launches=search_launches["fused_forward"],
             tree_mcmc_launches=tree_mc["one_chain"]["launches"][
                 "fused_forward"],
             api_log_likelihood_launches=api_flua_n["log_likelihood"][
                 "fused_forward"],
             api_gradient_launches=api_flua_n["gradient"]["fused_forward"],
             legacy_meta_f64_launches=tools["legacy"]["launches"][
                 "fused_forward"],
             sharded_launches=sharded("k1k2_checkpoint_a", "fused_forward")),
        dict(kernel_row("pruning_backward", fused_src,
                        "physher_tpu/ops/pallas_fused.py:390",
                        launches_fused["backward"], fused_alone,
                        "backward"),
             ml_meta_time_f64_launches=ml_time["fused_backward"],
             analyses_meta_jc69_f64_launches=analyses["jc69"]["launches"][
                 "fused_backward"],
             topology_search_launches=search_launches["fused_backward"],
             api_gradient_launches=api_flua_n["gradient"]["fused_backward"],
             legacy_meta_f64_launches=tools["legacy"]["launches"][
                 "fused_backward"],
             sharded_launches=sharded("k1k2_checkpoint_a",
                                      "fused_backward")),
        dict(kernel_row("wide_forward", wide_src,
                        "physher_tpu/ops/pallas_wide.py:217",
                        wide_launches["forward"], wide_alone, "forward"),
             sharded_launches=sharded("k7k8_gy94", "wide_forward")),
        dict(kernel_row("wide_backward", wide_src,
                        "physher_tpu/ops/pallas_wide.py:396",
                        wide_launches["backward"], wide_alone, "backward"),
             sharded_launches=sharded("k7k8_gy94", "wide_backward")),
        dict(kernel_row("staged_forward", staged_src,
                        "physher_tpu/ops/pallas_staged.py:234",
                        staged_launches["forward"], staged_alone, "forward"),
             ml_meta_gtrg4_f64_launches=ml_gtr["staged_forward"],
             meta_gtrg4i_f64_launches=g4i_meta["staged_forward"],
             advi_g4i_relaxed_launches=g4i_advi["staged_forward"],
             analyses_meta_gtrg4_f64_launches=analyses["gtrg4"][
                 "launches"]["staged_forward"],
             api_gtrg4_log_likelihood_launches=api_gtr_n["log_likelihood"][
                 "staged_forward"],
             api_gtrg4_gradient_launches=api_gtr_n["gradient"][
                 "staged_forward"],
             sharded_launches=sharded("k3k4_balanced_128x16384",
                                      "staged_forward"),
             walk=staged_walk,
             **c5_times(c5, "staged-balanced-128x16384", "forward")),
        dict(kernel_row("staged_backward", staged_src,
                        "physher_tpu/ops/pallas_staged.py:375",
                        staged_launches["backward"], staged_alone,
                        "backward"),
             ml_meta_gtrg4_f64_launches=ml_gtr["staged_backward"],
             meta_gtrg4i_f64_launches=g4i_meta["staged_backward"],
             advi_g4i_relaxed_launches=g4i_advi["staged_backward"],
             analyses_meta_gtrg4_f64_launches=analyses["gtrg4"][
                 "launches"]["staged_backward"],
             api_gtrg4_gradient_launches=api_gtr_n["gradient"][
                 "staged_backward"],
             sharded_launches=sharded("k3k4_balanced_128x16384",
                                      "staged_backward"),
             **c5_times(c5, "staged-balanced-128x16384", "backward")),
        dict(kernel_row("loop_forward", loop_src,
                        "physher_tpu/ops/pallas_pruning_loop.py:119",
                        ladder_launches["forward"],
                        loop_times["fluA-jc69-L16"], "forward"),
             ml_warmup_launches=ml_gtr["loop_forward"],
             hessian_launches=ml_hessian["loop_forward"],
             mcmc_g4i_relaxed_launches=g4i_mcmc["loop_forward"],
             elbo_check_launches_fluA=checks["fluA"]["k5_calls_a_check"],
             elbo_check_launches_128x16291=checks["128x16291"][
                 "k5_calls_a_check"],
             advi_gradsamples4_launches=checks["advi_gradsamples4"][
                 "launches"]["loop_forward"],
             skygrid_mcmc_launches=coal_launches["loop_forward"],
             estimator_f64_launches={
                 k: v["loop_forward"] for k, v in est["launches"].items()},
             mixed_mcmc_launches=mixed_launches["loop_forward"],
             sharded_launches=sharded("k5k6_flua_L8_2x2", "loop_forward"),
             mesh2x2_mcmc_f64_launches=mesh_mcmc_n["loop_forward"],
             **c5_times(c5, "loop-fluA-238", "forward", "-L8")),
        dict(kernel_row("loop_backward", loop_src,
                        "physher_tpu/ops/pallas_pruning_loop.py:314",
                        hmc_launches["backward"], loop_times["fluA-jc69-L4"],
                        "backward"),
             ml_warmup_launches=ml_gtr["loop_backward"],
             hessian_launches=ml_hessian["loop_backward"],
             advi_gradsamples4_launches=checks["advi_gradsamples4"][
                 "launches"]["loop_backward"],
             sharded_launches=sharded("k5k6_flua_L8_2x2", "loop_backward"),
             **c5_times(c5, "loop-fluA-238", "backward", "-L8")),
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
        *fused_wide_rows(fw, fused_src, wide_src),
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
