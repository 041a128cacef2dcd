"""The check's control and faults, each put in the program's place, read
at a cell's own size; the benchmark's runs do not run this.

    python3 portbench/control.py --workload <name> --seeds 1,2,3 \
        --mode control|half|alter [--seconds 5]

- ``control``: the plain reference computed in the precision below the
  cell's: TF32 products for float32 (TF32 is off in the program), float32
  for float64;
- ``half``: the reference with half the patterns left out and the rest
  counted twice (the mean over what is left);
- ``alter``: the reference's log target a thousandth off where it is
  produced.

Each seed prints one JSON line with the check's numbers. ``gy94-mcmc``
and ``gtrg4-mcmc`` take their states from a short window of the program,
whose log targets the control then computes in its place.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def lower_precision(dtype):
    import torch

    return "tf32" if dtype == torch.float32 else torch.float32


def planted(model, mode, precision):
    """(the log target and the API likelihood) put in the program's place
    under ``mode``, in ``precision``."""
    import torch

    def halve(case):
        pats, w = case.patterns()
        keep = torch.zeros_like(w)
        keep[: w.shape[0] // 2] = 2
        return dataclasses.replace(case, _patterns=(pats, w * keep))

    def wrap(fn):
        def f(case, x, dtype, device, want_grad=False):
            if mode == "half":
                case = halve(case)
            v, g = fn(case, x, precision if mode == "control" else dtype,
                      device, want_grad)
            if mode == "alter":
                v = v * (1.0 + 1e-3)
                g = None if g is None else (
                    {k: a * (1.0 + 1e-3) for k, a in g.items()}
                    if isinstance(g, dict) else g * (1.0 + 1e-3))
            return v, g
        return f
    return wrap(model.log_target), wrap(getattr(model, "api_loglik", None)
                                        or model.log_target)


def one(bench, workload, seed, mode, seconds, device):
    import numpy as np
    import torch

    from portbench import harness, manifest
    from portbench.drivers import advi, api, mcmc

    cell = manifest.cell(bench, workload)
    cfg, traffic = cell.config, cell.traffic
    model = manifest.module("models", cfg["model"])
    dtype = harness.DTYPES[traffic.get("dtype", cfg["dtype"])]
    target, api_target = planted(model, mode, lower_precision(dtype))
    driver = traffic["driver"]
    with tempfile.TemporaryDirectory() as tmp:
        case = model.make(cfg, seed, device, Path(tmp))
        if driver == "mcmc":
            # the program's states, from a short window at the cell's load
            if device.type == "cuda":
                harness.build_kernels(traffic.get("kernels", []))
            s = mcmc.setup(case, traffic, seed, device, dtype)
            mcmc.window(s, seconds)
            ans = mcmc.answers(s)
            del s
            ans["logps"] = [np.asarray([target(case, u, torch.float64,
                                               device)[0] for u in end])
                            for end in ans["ends"]]
            return mcmc.check(ans, case, cell.limits, seed, device)
    if driver == "advi":
        dim = sum(n - 1 if t == "simplex" else n
                  for _, t, n, _ in case.layout)
        gen = torch.Generator(device=device).manual_seed(seed)
        draws = [torch.randn((traffic["grad_samples"], dim), generator=gen,
                             dtype=dtype, device=device).to(
                                 "cpu", torch.float64).numpy()
                 for _ in range(traffic["first_steps"])]
        losses, first, after, start = advi.reference_steps(
            case, draws, traffic["eta"], torch.float64, device, target)
        ans = {"draws": draws, "losses": losses, "before": start,
               "first_grad": first, "after": after, "eta": traffic["eta"],
               "steps": traffic["first_steps"]}
        return advi.check(ans, case, cell.limits, seed, device)
    pool = api.Walk(case.api_start(), traffic["answers"],
                    traffic["walk_scale"], traffic["walk_pull"], seed,
                    float(case.low[case.tree.root]))
    order = sorted(api.NAMES)
    done = []
    for v in (pool.values(i) for i in range(len(pool))):
        logl, g = api_target(case, v, torch.float64, device, True)
        done.append((v, logl, np.concatenate(
            [np.atleast_1d(g[api.NAMES[k]]) for k in order])))
    blocks = [(k, int(np.size(np.atleast_1d(
        done[0][0][api.NAMES[k]])))) for k in order]
    return api.check({"done": done, "blocks": blocks, "n": len(done)},
                     case, cell.limits, seed, device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--mode", choices=("control", "half", "alter"),
                    default="control")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("portbench control: no CUDA device", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        checks = one(bench, args.workload, seed, args.mode, args.seconds,
                     device)
        print(json.dumps({"workload": args.workload, "mode": args.mode,
                          "seed": seed, "seconds": time.perf_counter() - t0,
                          "checks": checks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
