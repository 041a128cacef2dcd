"""Legacy command-line front-end: argv -> physher JSON config -> run.

Rebuild of the reference's classic CLI (reference: src/phyc/physhercmd.c —
an argv parser whose options table at physhercmd.c:820-893 builds the same
JSON object model the config file path uses, then executes it). Options
mirror the reference's table: -i/--sequences, -t/--tree, -m/--model,
-c/--cat, -a/--alpha, -I/--invariant, -f/--frequencies, -r/--rates,
-D/--distance (NJ/UPGMA start tree), -O/--treeopt, -R/--seed, --dry.

Port of ``physher_tpu/legacy_cli.py``: :func:`build_json` is a copy, and
the generated config runs through the port's ``cli.run`` on the CUDA
device unless ``--device cpu`` is given (``--f64``: float64 on the card).
``--dry`` prints the JAX package's JSON for the same arguments.
"""

from __future__ import annotations

import argparse
import json
import sys


def build_json(args) -> dict:
    """Assemble a reference-format config dict from parsed argv."""
    datatype = args.datatype or "nucleotide"

    subst = {
        "id": "sm", "type": "substitutionmodel",
        "model": args.model.lower(), "datatype": datatype,
    }
    if datatype == "codon":
        subst["code"] = args.genetic_code
    if args.frequencies:
        if args.frequencies == "e":
            n = {"nucleotide": 4, "aa": 20}.get(datatype, 4)
            vals = [1.0 / n] * n
        else:
            vals = [float(x) for x in args.frequencies.split(",")]
        subst["frequencies"] = {
            "id": "freqs", "type": "Simplex", "values": vals}
    if args.rates:
        vals = [float(x) for x in args.rates.split(",")]
        subst["rates"] = {"id": "rates", "type": "Simplex", "values": vals} \
            if len(vals) == 6 else {
                "id": "rates", "type": "parameter", "value": vals}

    sitemodel = {"id": "sitemodel", "type": "sitemodel",
                 "substitutionmodel": subst}
    if args.cat > 1 or args.invariant > 0:
        dist = {
            "distribution": args.dist, "categories": args.cat,
            "quadrature": args.quad,
            "parameters": {
                "alpha": {"id": "alpha", "type": "parameter",
                          "value": args.alpha, "lower": 0.0}},
        }
        if args.invariant > 0:
            dist["invariant"] = True
            dist["proportions"] = {
                "id": "props", "type": "Simplex",
                "values": [args.invariant, 1.0 - args.invariant]}
        sitemodel["distribution"] = dist

    tree = {"id": "tree", "type": "tree"}
    if args.tree:
        tree["file"] = args.tree
    else:
        init = {"id": "init", "type": "distancematrix",
                "algorithm": (args.distance or "nj").lower(),
                "sitepattern": "&patterns", "model": "JC69"}
        tree["init"] = init
    tree["parameters"] = "tree.distances"

    model = {
        "id": "treelikelihood", "type": "treelikelihood",
        "sitepattern": {
            "id": "patterns", "type": "sitepattern", "datatype": datatype,
            "alignment": {"id": "seqs", "type": "alignment",
                          "file": args.sequences},
        },
        "sitemodel": sitemodel,
        "tree": tree,
    }

    opt = {
        "id": "metaopt", "type": "optimizer", "algorithm": "meta",
        "precision": 0.001, "max": 10000, "model": "&treelikelihood",
        "list": [{"id": "optbl", "type": "optimizer", "algorithm": "serial",
                  "model": "&treelikelihood",
                  "treelikelihood": "&treelikelihood"}],
    }
    if args.treeopt:
        opt["list"].append({
            "id": "topo", "type": "optimizer", "algorithm": "topology",
            "move": args.treeopt.lower(), "model": "&treelikelihood"})

    actions = [opt, {"id": "log", "type": "logger",
                     "models": "&treelikelihood", "tree": "&tree"}]

    cfg = {"model": model, "physher": actions}
    if args.seed is not None and args.seed >= 0:
        cfg["init"] = {"seed": args.seed}
    if args.stem:
        cfg["_stem"] = args.stem
    return cfg


def run(argv=None, out=None):
    """Parse ``argv``, build the config and run it through ``cli.run``;
    returns its action Runner, or None for ``--dry``."""
    ap = argparse.ArgumentParser(
        prog="physher-tpu-torch-legacy",
        description="classic physher CLI: builds and runs a JSON config "
                    "(reference: physhercmd.c)")
    ap.add_argument("-i", "--sequences", required=True,
                    help="input alignment file")
    ap.add_argument("-t", "--tree", help="input tree file")
    ap.add_argument("-o", "--stem", help="output stem")
    ap.add_argument("-g", "--genetic-code", type=int, default=0,
                    dest="genetic_code")
    ap.add_argument("-d", "--datatype",
                    choices=["nucleotide", "aa", "codon"])
    ap.add_argument("-m", "--model", default="JC69",
                    help="substitution model (JC69/HKY/GTR/WAG/LG/...)")
    ap.add_argument("-f", "--frequencies",
                    help="comma list or 'e' for equal")
    ap.add_argument("-r", "--rates", help="relative rates, comma list")
    ap.add_argument("-c", "--cat", type=int, default=1,
                    help="number of rate categories")
    ap.add_argument("--dist", default="gamma",
                    choices=["gamma", "lognormal", "weibull", "discrete"])
    ap.add_argument("--quad", default="median",
                    choices=["median", "mean", "discrete", "beta",
                             "laguerre"])
    ap.add_argument("-a", "--alpha", type=float, default=0.5)
    ap.add_argument("-I", "--invariant", type=float, default=0.0)
    ap.add_argument("-D", "--distance", choices=["nj", "upgma", "NJ",
                                                 "UPGMA"],
                    help="starting tree from distances")
    ap.add_argument("-O", "--treeopt", choices=["nni", "spr"],
                    help="topology optimization")
    ap.add_argument("-R", "--seed", type=int, default=-1)
    ap.add_argument("--dry", action="store_true",
                    help="print the generated JSON and exit")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the models run (default: cuda)")
    ap.add_argument("--f64", action="store_true",
                    help="float64 on the card (the CPU always runs float64)")
    args = ap.parse_args(argv)
    out = out or sys.stdout

    cfg = build_json(args)
    if args.dry:
        json.dump(cfg, out, indent=2)
        print(file=out)
        return None

    import os
    import tempfile

    from .cli import run as run_config

    # paths in the generated config are absolute, so the temp file's
    # location doesn't matter
    cfg["model"]["sitepattern"]["alignment"]["file"] = os.path.abspath(
        args.sequences)
    if args.tree:
        cfg["model"]["tree"]["file"] = os.path.abspath(args.tree)
    with tempfile.NamedTemporaryFile(
            "w", suffix=".json", delete=False) as fh:
        json.dump(cfg, fh)
        path = fh.name
    try:
        return run_config([path, "--device", args.device]
                          + (["--f64"] if args.f64 else []), out=out)
    finally:
        os.unlink(path)


def main(argv=None, out=None) -> int:
    from .cli import NoDeviceError

    try:
        run(argv, out)
    except NoDeviceError as e:
        print(e, file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
