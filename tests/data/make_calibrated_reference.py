"""Reference marginal likelihoods of ``fluA-calibrated.json`` from the JAX
package on the CPU in float64, written to ``fluA-calibrated.reference.json``.

The config is the fluA JC69 strict-clock time tree of ``jc69-time.json``
with proper priors: a lognormal prior on the clock rate, a constant
coalescent on the node heights and a lognormal prior on its size. The node
heights are parameterized by their shifts above their children (``"transform":
"shift"``), whose Jacobian is 1, so no Jacobian rides in the tempered term.

For each seed the script runs the config's own action list, at the config's
own settings, through the JAX package's Runner: ``mmcmc`` and
``marginallikelihood`` (stepping stone, path sampling) and
``bridgesampling``, their chains started at the config's values; then an
L-BFGS fit of the posterior, from whose optimum the ADVI fit of the
mean-field normal starts, and ``is``. (Chains started at the L-BFGS
optimum depend on where the optimizer stopped: shifts that the likelihood
pushes toward 0 drift toward -inf in log space, and at these lengths the
chains' way back out sets the bridge estimate, by 14 nats between the two
packages' optima.) The JAX package's ``bridgesampling`` action runs one
chain whatever its node says; the port runs the node's ``"chains"`` as one
batch. So the script runs that node itself, as the action does but over
the node's chains: the JAX package's ``MCMC.run(n_chains=...)`` from the
pool's values, then its ``bridge_sampling_marginal`` on every chain's
samples. A run of the port is held to this reference at the same
settings, which ``"settings"`` records.

With a fixed topology the constant coalescent is not a normalized density
of the heights: its integral is the prior probability of the topology, Z0.
Bridge sampling and importance sampling estimate log Z (the unnormalized
evidence), stepping stone and path sampling log Z - log Z0. The script
estimates log Z0 by bridge sampling of the prior alone (MCMC on the prior,
then ``bridge_sampling_marginal``), so that the two families can be held
to each other.

Each estimate's window is its mean over the seeds plus or minus the larger
of three times its spread (max - min over the seeds) and 0.5 nats.

    python tests/data/make_calibrated_reference.py            # seeds 1 2 3
    python tests/data/make_calibrated_reference.py --seeds 1  # one seed

Run from the repository root; the seeds run in parallel processes
(``--jobs``). The JAX package evaluates bridge sampling's samples in one
``vmap``, about 1 MB of memory a sample.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import io
import multiprocessing
import json
import os
import re
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

from physher_tpu.config.actions import Runner  # noqa: E402
from physher_tpu.config.builder import build_config  # noqa: E402
from physher_tpu.inference import marginal, mcmc  # noqa: E402

CONFIG = os.path.join(HERE, "fluA-calibrated.json")
OUT = os.path.join(HERE, "fluA-calibrated.reference.json")
PRIOR_LENGTH, PRIOR_BURNIN = 100000, 10000


SETTINGS = {"mmcmc": ("temperatures", "length", "burnin"),
            "bridgesampling": ("chains", "length", "burnin"),
            "optimizer": ("algorithm", "max"), "is": ("samples",)}


def settings(cfg) -> dict:
    """The chain settings of the config's actions, by action id."""
    return {a["id"]: {k: a.get(k) for k in SETTINGS[a["type"]]}
            for a in cfg["physher"] if a["type"] in SETTINGS}


def bridge_over_chains(runner: Runner, node) -> float:
    """``bridgesampling`` over the node's ``"chains"``: the JAX package's
    action with ``n_chains`` given to its MCMC."""
    model = runner.ctx.resolve(node.get("model"))
    space = model.param_space()
    log_prob = runner.model_logprob(model)
    res = mcmc.MCMC(space, log_prob).run(
        runner.next_key(), runner.params_for(space),
        n_iter=int(node["length"]), every=10, burnin=int(node["burnin"]),
        n_chains=int(node.get("chains", 1)))
    su = jnp.asarray(res.samples_u.reshape(-1, res.samples_u.shape[-1]))

    def log_unnorm(z):
        up = space.unflatten_unconstrained(z)
        return log_prob(space.constrain(up)) + space.log_jacobian(up)

    val = marginal.bridge_sampling_marginal(su, log_unnorm, space,
                                            runner.next_key())
    print(f"Bridge-sampling log marginal likelihood: {val:.6f}",
          file=runner.out)
    runner.results[node.get("id", "bridge")] = val
    return val


def run_seed(seed: int) -> dict:
    cfg = json.load(open(CONFIG))
    ctx, actions = build_config(cfg, base_dir=HERE)
    out = io.StringIO()
    t0 = time.perf_counter()
    runner = Runner(ctx, seed=seed, out=out)
    for node in actions:
        if node.get("type") == "bridgesampling":
            bridge_over_chains(runner, node)
        else:
            runner.run([node])
    res = runner.results
    rec = {"seed": seed,
           "stepping_stone": float(res["marginal"]["stepping"]),
           "path_sampling": float(res["marginal"]["path"]),
           "bridge": float(res["bridge"]), "is": float(res["is"]),
           "elbo": float(res["vb"].elbo),
           "lines": out.getvalue().splitlines()}
    # log Z0: bridge sampling of the prior alone over the same space
    post = ctx.objects["posterior"]
    tlk = ctx.objects["treelikelihood"]
    space = post.param_space()

    def log_prior(p):
        return post.log_prob(p) - tlk.log_likelihood(p)

    samples = mcmc.MCMC(space, log_prior).run(
        jax.random.PRNGKey(1000 + seed), space.init_params(),
        n_iter=PRIOR_LENGTH, every=10, burnin=PRIOR_BURNIN).samples_u
    su = jnp.asarray(samples.reshape(-1, samples.shape[-1]))

    def log_unnorm(z):
        up = space.unflatten_unconstrained(z)
        return log_prior(space.constrain(up)) + space.log_jacobian(up)

    rec["log_z0"] = float(marginal.bridge_sampling_marginal(
        su, log_unnorm, space, jax.random.PRNGKey(2000 + seed)))
    rec["seconds"] = time.perf_counter() - t0
    return rec


def window(values) -> dict:
    v = np.asarray(values, np.float64)
    spread = float(v.max() - v.min())
    return {"mean": float(v.mean()), "spread": spread,
            "tolerance": max(3.0 * spread, 0.5), "values": v.tolist()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3])
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--jobs", type=int, default=3)
    args = ap.parse_args(argv)
    runs = []
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(args.jobs,
                                                mp_context=ctx) as pool:
        for rec in pool.map(run_seed, args.seeds):
            print(json.dumps({k: v for k, v in rec.items()
                              if k != "lines"}), flush=True)
            runs.append(rec)
    keys = ("bridge", "is", "stepping_stone", "path_sampling", "log_z0")
    summary = {k: window([r[k] for r in runs]) for k in keys}
    summary["stepping_stone_plus_log_z0"] = window(
        [r["stepping_stone"] + r["log_z0"] for r in runs])
    doc = {
        "config": os.path.basename(CONFIG),
        "made_by": "python tests/data/make_calibrated_reference.py --seeds "
                   + " ".join(str(s) for s in args.seeds),
        "seconds_per_seed": [r["seconds"] for r in runs],
        "package": "physher_tpu (JAX) on the CPU, float64",
        "jax": jax.__version__,
        "settings": settings(json.load(open(CONFIG))),
        "prior_normalizer": {"length": PRIOR_LENGTH, "burnin": PRIOR_BURNIN,
                             "method": "bridge sampling of the prior"},
        "window_rule": "mean +- max(3 x (max - min over the seeds), 0.5)",
        "estimates": summary,
        "runs": runs,
    }
    with open(args.out, "w") as fh:
        json.dump(doc, fh, indent=1)
        fh.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
