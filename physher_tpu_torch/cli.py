"""physher_tpu_torch CLI: run reference-format JSON configs on the GPU.

Port of ``physher_tpu/cli.py`` (the reference's main program,
src/physher.c:62-326): parse the config, build the model graph, run the
``physher`` action list.

    python -m physher_tpu_torch.cli config.json [--seed N] [--dry] [--f64]
                                                [--device {cuda,cpu}]
                                                [-c checkpoint.csv]
                                                [--devices N | --mesh CxP]
                                                [--trace DIR]

It runs on the CUDA device unless ``--device cpu`` is given, and exits
non-zero with a message when there is none: it never falls back to the CPU.
Models are float32 on the card and float64 on the CPU; ``--f64`` asks for
float64 on the card too (the reference's goldens need it). ``-c`` seeds
the parameter pool of every model from a checkpoint CSV (the ``name,value``
lines that an optimizer's ``"checkpoint"`` writes) before the actions run.
``--devices N`` shards the site patterns over N devices and ``--mesh CxP``
over a chains x patterns mesh (overriding the config's ``init.devices`` /
``init.mesh``): the first visible CUDA devices on the card, the CPU listed
N (C x P) times with ``--device cpu``; in-process callers may give the
mesh's devices themselves (``run(..., mesh_devices=[...])``, a list that
may repeat a device). ``--trace DIR`` runs the actions under
``torch.profiler`` and writes ``DIR/trace.json`` (Chrome trace format, read
by Perfetto): the program's ``physher.*`` spans (README.md lists them)
beside the card's kernels, copies and runtime calls.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import torch


class NoDeviceError(RuntimeError):
    """No CUDA device, and ``--device cpu`` was not given."""


def run(argv=None, out=None, mesh_devices=None):
    """Parse ``argv`` and run the config; returns the action Runner (with
    its context and results), or None for ``--dry``. ``mesh_devices``: the
    devices of the ``--devices`` / ``--mesh`` mesh, in row-major order."""
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
    ap.add_argument("--devices", type=int, default=None,
                    help="shard site patterns over N devices "
                         "(overrides config init.devices)")
    ap.add_argument("--mesh", default=None, metavar="CxP",
                    help="2-D device mesh 'chains x patterns', e.g. 2x4 "
                         "(overrides config init.mesh)")
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="profile the actions; write DIR/trace.json")
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
                                device=device,
                                devices=_mesh_request(args, mesh_devices))
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
    from .utils.profiling import trace

    with trace(args.trace) if args.trace else contextlib.nullcontext():
        runner.run(actions)
    print(f"Total runtime: {time.time() - t0:.3f}s", file=out)
    return runner


def _mesh_request(args, mesh_devices):
    """``build_config``'s ``devices`` for ``--mesh`` / ``--devices``: the
    shape, or a Mesh over ``mesh_devices`` when given."""
    if args.mesh:
        c, p = args.mesh.lower().replace("x", " ").split()
        shape = {"chains": int(c), "patterns": int(p)}
    elif args.devices:
        shape = {"chains": 1, "patterns": args.devices}
    else:
        return None
    if mesh_devices is None:
        return shape
    from .parallel.mesh import mesh_from_shape

    return mesh_from_shape(shape, mesh_devices)


def main(argv=None, out=None) -> int:
    try:
        run(argv, out)
    except NoDeviceError as e:
        print(e, file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
