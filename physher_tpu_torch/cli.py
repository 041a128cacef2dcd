"""physher_tpu_torch CLI: run reference-format JSON configs on the GPU.

Port of ``physher_tpu/cli.py`` (the reference's main program,
src/physher.c:62-326): parse the config, build the model graph, run the
``physher`` action list.

    python -m physher_tpu_torch.cli config.json [--seed N] [--dry] [--f64]
                                                [--device {cuda,cpu}]
                                                [-c checkpoint.csv]

It runs on the CUDA device unless ``--device cpu`` is given, and exits
non-zero with a message when there is none: it never falls back to the CPU.
Models are float32 on the card and float64 on the CPU; ``--f64`` asks for
float64 on the card too (the reference's goldens need it). ``-c`` seeds
the parameter pool of every model from a checkpoint CSV (the ``name,value``
lines that an optimizer's ``"checkpoint"`` writes) before the actions run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch


class NoDeviceError(RuntimeError):
    """No CUDA device, and ``--device cpu`` was not given."""


def run(argv=None, out=None):
    """Parse ``argv`` and run the config; returns the action Runner (with
    its context and results), or None for ``--dry``."""
    ap = argparse.ArgumentParser(
        prog="python -m physher_tpu_torch.cli",
        description="phylogenetic inference on an NVIDIA GPU "
                    "(physher-compatible JSON configs)")
    ap.add_argument("config", help="JSON config file")
    ap.add_argument("--seed", type=int, default=None,
                    help="random seed (overrides the config's init.seed)")
    ap.add_argument("--dry", action="store_true",
                    help="print the resolved config and exit")
    ap.add_argument("-c", "--checkpoint", default=None,
                    help="restore parameter values from a checkpoint CSV")
    ap.add_argument("--f64", action="store_true",
                    help="float64 on the card (the CPU always runs float64)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the models run (default: cuda)")
    args = ap.parse_args(argv)
    out = out or sys.stdout

    from .config.builder import build_config, load_json, _prune

    cfg = load_json(args.config)
    if args.dry:
        json.dump(_prune(cfg), out, indent=2)
        print(file=out)
        return None
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise NoDeviceError("physher_tpu_torch: no CUDA device; pass "
                                "--device cpu to run on the CPU")
        device = torch.device("cuda", torch.cuda.current_device())
        dtype = torch.float64 if args.f64 else torch.float32
    else:
        device, dtype = torch.device("cpu"), torch.float64

    t0 = time.time()
    base_dir = os.path.dirname(os.path.abspath(args.config))
    ctx, actions = build_config(cfg, base_dir=base_dir, dtype=dtype,
                                device=device)
    seed = args.seed if args.seed is not None else ctx.seed

    from .config.actions import Runner

    runner = Runner(ctx, seed=seed, out=out)
    if args.checkpoint and os.path.exists(args.checkpoint):
        from .inference.ml import load_checkpoint

        # seed the pool from the checkpoint over every model's parameters
        pool = {}
        for obj in ctx.objects.values():
            if hasattr(obj, "param_space"):
                pool.update(obj.param_space().init_params(**ctx.kw))
        runner.pool = load_checkpoint(args.checkpoint, pool)
    runner.run(actions)
    print(f"Total runtime: {time.time() - t0:.3f}s", file=out)
    return runner


def main(argv=None, out=None) -> int:
    try:
        run(argv, out)
    except NoDeviceError as e:
        print(e, file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
