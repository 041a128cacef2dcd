"""Config generator: advi / mcmc / optimize subcommands -> physher JSON.

A copy of ``physher_tpu/configgen.py``. Rebuild of the reference's Python config generator (reference:
python/physhpy/cli/{cli,advi,mcmc,optimize,evolution}.py — the ``physhpy``
console script that assembles physher JSON for ML/ADVI/MCMC time-tree
analyses, setup.cfg:33-35). The generated configs use the same schema as the
reference's examples (examples/fluA/*.json) and run unmodified through
``physher-tpu-torch``.

Usage:
    physher-tpu-torch-configgen advi -i aln.fa -t tree.nwk --clock strict \
        --coalescent constant --dates '_' > advi.json
    physher-tpu-torch-configgen mcmc -i aln.fa -t tree.nwk -m HKY --length 100000
    physher-tpu-torch-configgen optimize -i aln.fa -t tree.nwk -m GTR -c 4
"""

from __future__ import annotations

import argparse
import json
import sys


def _parse_dates(tree_file: str, sep: str):
    """Taxon dates parsed from name suffixes (physhpy-style ``name_2001``)."""
    from .io.treeio import read_newick

    topo, _ = read_newick(tree_file)
    dates = {}
    for t in topo.taxa:
        try:
            dates[t] = float(t.split(sep)[-1])
        except ValueError:
            dates[t] = 0.0
    return dates


def _substmodel(arg) -> dict:
    sm = {"id": "substmodel", "type": "substitutionmodel",
          "model": arg.model.lower(), "datatype": "nucleotide"}
    if arg.model.upper() in ("HKY", "GTR", "F81"):
        sm["frequencies"] = {"id": "frequencies", "type": "Simplex",
                             "values": [0.25] * 4}
    if arg.model.upper() == "HKY":
        sm["kappa"] = {"id": "kappa", "type": "parameter", "value": 1.0,
                       "lower": 0.0}
    if arg.model.upper() == "GTR":
        sm["rates"] = {"id": "rates", "type": "Simplex",
                       "values": [1.0 / 6] * 6}
    return sm


def _sitemodel(arg) -> dict:
    node = {"id": "sitemodel", "type": "sitemodel",
            "substitutionmodel": _substmodel(arg)}
    if arg.categories > 1:
        node["distribution"] = {
            "distribution": "gamma", "categories": arg.categories,
            "parameters": {"alpha": {"id": "sitemodel.shape",
                                     "type": "parameter", "value": 0.5,
                                     "lower": 0.0}}}
    return node


def _treelikelihood(arg, time: bool) -> dict:
    tree = {"id": "tree", "type": "tree", "file": arg.tree}
    if time:
        tree.update({"time": True, "parameters": "tree.distances",
                     "heights": "tree.heights", "reparam": "tree.scalers",
                     "dates": _parse_dates(arg.tree, arg.dates)})
    else:
        tree["parameters"] = "tree.distances"
    tlk = {"id": "treelikelihood", "type": "treelikelihood",
           "sitepattern": {
               "id": "patterns", "type": "sitepattern",
               "datatype": "nucleotide",
               "alignment": {"id": "seqs", "type": "alignment",
                             "file": arg.input}},
           "sitemodel": _sitemodel(arg),
           "tree": tree}
    if time:
        tlk["include_jacobian"] = True
        tlk["branchmodel"] = {
            "id": "branchmodel", "type": "branchmodel", "model": "strict",
            "tree": "&tree",
            "rate": {"id": "rate", "type": "parameter",
                     "value": arg.rate or 0.001, "lower": 0.0}}
    return tlk


def _coalescent(arg) -> list:
    """Coalescent + hyperpriors (reference: physhpy advi.py coalescent
    handling)."""
    out = []
    model = arg.coalescent
    if model == "constant":
        out.append({"id": "coalescent", "type": "coalescent",
                    "model": "constant", "tree": "&tree",
                    "parameters": {"n0": {
                        "id": "theta", "type": "parameter", "value": 3.0,
                        "lower": 0.0}}})
        out.append({"id": "priortheta", "type": "distribution",
                    "distribution": "oneonx", "x": "&theta"})
    elif model in ("skyride", "skygrid"):
        node = {"id": "coalescent", "type": "coalescent", "model": model,
                "tree": "&tree",
                "parameters": {"thetas": {
                    "id": "thetas", "type": "parameter",
                    "dimension": arg.grid, "values": [3.0],
                    "lower": 0.0}},
                "parameterization": "logtheta"}
        if model == "skygrid":
            node["cutoff"] = arg.cutoff
        out.append(node)
        out.append({"id": "gmrf", "type": "distribution",
                    "distribution": "gmrf", "x": "%thetas",
                    "parameters": {"precision": {
                        "id": "gmrf.precision", "type": "parameter",
                        "value": 0.1, "lower": 0.0}}})
        out.append({"id": "priorprecision", "type": "distribution",
                    "distribution": "gamma", "x": "&gmrf.precision",
                    "parameters": {
                        "shape": {"id": "precshape", "type": "parameter",
                                  "value": 0.001},
                        "rate": {"id": "precrate", "type": "parameter",
                                 "value": 0.001}}})
    elif model == "exponential":
        out.append({"id": "coalescent", "type": "coalescent",
                    "model": "exponential", "tree": "&tree",
                    "parameters": {
                        "n0": {"id": "theta", "type": "parameter",
                               "value": 3.0, "lower": 0.0},
                        "growth": {"id": "growth", "type": "parameter",
                                   "value": 0.0}}})
        out.append({"id": "priortheta", "type": "distribution",
                    "distribution": "oneonx", "x": "&theta"})
    return out


def _joint(arg) -> dict:
    time = arg.clock is not None
    dists = [_treelikelihood(arg, time)]
    priors = []
    if time:
        priors += _coalescent(arg)
        priors.append({"id": "priorrate", "type": "distribution",
                       "distribution": "ctmcscale", "x": "&rate",
                       "tree": "&tree"})
    if priors:
        return {"id": "joint", "type": "compound",
                "distributions": dists + [{
                    "id": "prior", "type": "compound",
                    "distributions": priors}]}
    return dists[0]


def _var_params(arg) -> list:
    params = []
    if arg.clock is not None:
        params += ["%tree.scalers", "&rate"]
        if arg.coalescent == "constant":
            params.append("&theta")
        elif arg.coalescent in ("skyride", "skygrid"):
            params += ["%thetas", "&gmrf.precision"]
        elif arg.coalescent == "exponential":
            params += ["&theta", "&growth"]
    else:
        params.append("%tree.distances")
    if arg.model.upper() == "HKY":
        params += ["&kappa", "$frequencies"]
    elif arg.model.upper() == "GTR":
        params += ["$rates", "$frequencies"]
    if arg.categories > 1:
        params.append("&sitemodel.shape")
    return params


def build_optimize(arg) -> dict:
    model = _joint(arg)
    mid = "&" + model["id"]
    opt = {"id": "metaopt", "type": "optimizer", "algorithm": "meta",
           "precision": arg.tol, "max": arg.iter, "model": mid,
           "list": [{"id": "optbl", "type": "optimizer",
                     "algorithm": "serial", "model": mid,
                     "treelikelihood": "&treelikelihood"}]}
    cfg = {"model": model,
           "physher": [opt, {"id": "log", "type": "logger",
                             "models": mid, "tree": "&tree"}]}
    return cfg


def build_advi(arg) -> dict:
    model = _joint(arg)
    params = _var_params(arg)
    var = {"id": "varnormal", "type": "variational",
           "posterior": "&" + model["id"],
           "elbosamples": arg.elbo_samples, "gradsamples": arg.grad_samples,
           "distributions": [{
               "id": "block1", "type": "block", "distribution": "normal",
               "x": params,
               "initialize": "map" if arg.init_map else None,
               "parameters": {
                   "mu": {"id": "mu", "type": "parameter", "values": [0.1]},
                   "sigma": {"id": "sigma", "type": "parameter",
                             "values": [0.1], "lower": 0.0}}}]}
    if not arg.init_map:
        del var["distributions"][0]["initialize"]
    sg = {"id": "sg", "type": "optimizer", "algorithm": "sg",
          "update": "adam", "eta": arg.eta, "tol": arg.tol,
          "max": arg.iter, "model": "&varnormal",
          "parameters": ["%mu", "%sigma"],
          "checkpoint": arg.checkpoint or "checkpoint.csv"}
    cfg = {"model": model, "varmodel": var, "physher": [sg]}
    if arg.samples:
        cfg["physher"].append({
            "id": "sampler", "type": "logger", "file": arg.stem + ".log",
            "models": "&varnormal", "samples": arg.samples})
    return cfg


def build_mcmc(arg) -> dict:
    model = _joint(arg)
    mid = "&" + model["id"]
    ops = []

    def op(alg, x):
        ops.append({"id": f"{alg}.{len(ops)}", "type": "operator",
                    "algorithm": alg, "x": x, "weight": 1})

    if arg.clock is not None:
        op("beta", "%tree.scalers")
        op("scaler", "&tree.root_height")
        op("scaler", "&rate")
        if arg.coalescent == "constant":
            op("scaler", "&theta")
        elif arg.coalescent in ("skyride", "skygrid"):
            op("randomwalk", "%thetas")
            op("scaler", "&gmrf.precision")
    else:
        op("scaler", "%tree.distances")
    if arg.model.upper() == "HKY":
        op("scaler", "&kappa")
        op("dirichlet", "$frequencies")
    elif arg.model.upper() == "GTR":
        op("dirichlet", "$rates")
        op("dirichlet", "$frequencies")
    if arg.categories > 1:
        op("scaler", "&sitemodel.shape")

    logs = [{"id": "screenlogger", "type": "logger", "every": arg.every,
             "models": [mid, "&treelikelihood"]},
            {"id": "logger", "type": "logger", "file": arg.stem + ".log",
             "every": arg.every, "models": [mid, "&treelikelihood"]},
            {"id": "treelogger", "type": "logger",
             "file": arg.stem + ".trees", "every": arg.every,
             "models": "&tree"}]
    mcmc = {"id": "mcmc", "type": "mcmc", "model": mid,
            "length": arg.length, "log": logs, "operators": ops}
    return {"model": model, "physher": [mcmc]}


def _common(parser):
    parser.add_argument("-i", "--input", required=True,
                        help="alignment file")
    parser.add_argument("-t", "--tree", required=True, help="tree file")
    parser.add_argument("-m", "--model", default="JC69",
                        choices=["JC69", "HKY", "GTR"])
    parser.add_argument("-c", "--categories", type=int, default=1)
    parser.add_argument("--clock", choices=["strict"], default=None)
    parser.add_argument("--coalescent", default="constant",
                        choices=["constant", "exponential", "skyride",
                                 "skygrid"])
    parser.add_argument("--grid", type=int, default=25,
                        help="skyride/skygrid grid size")
    parser.add_argument("--cutoff", type=float, default=10.0)
    parser.add_argument("--dates", default="_",
                        help="separator for dates in taxon names")
    parser.add_argument("--rate", type=float, default=None,
                        help="initial clock rate")
    parser.add_argument("--iter", type=int, default=10000)
    parser.add_argument("--tol", type=float, default=0.001)
    parser.add_argument("-o", "--stem", default="out")


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="physher-tpu-torch-configgen",
        description="generate physher JSON configs (reference: physhpy)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("optimize", help="maximum-likelihood config")
    _common(p)
    p.set_defaults(func=build_optimize)

    p = sub.add_parser("advi", help="variational (ADVI) config")
    _common(p)
    p.add_argument("--eta", type=float, default=0.1)
    p.add_argument("--elbo-samples", type=int, default=100)
    p.add_argument("--grad-samples", type=int, default=1)
    p.add_argument("--samples", type=int, default=0,
                   help="posterior draws to log after fitting")
    p.add_argument("--init-map", action="store_true")
    p.add_argument("--checkpoint", default=None)
    p.set_defaults(func=build_advi)

    p = sub.add_parser("mcmc", help="MCMC config")
    _common(p)
    p.add_argument("--length", type=int, default=100000)
    p.add_argument("--every", type=int, default=100)
    p.set_defaults(func=build_mcmc)

    arg = ap.parse_args(argv)
    json.dump(arg.func(arg), sys.stdout, indent=2)
    print()
    return 0


if __name__ == "__main__":
    sys.exit(main())
