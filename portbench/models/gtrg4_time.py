"""GTR+Gamma4 on a dated tree with a strict clock, a constant coalescent,
and 1/x and CTMC-scale priors: the structure of physher's fluA ELBO example
(checkpoint B), here over an alignment simulated down a random dated tree
at the configuration's truth, its sites in an order drawn from the seed.

``make`` writes the alignment as FASTA and returns the physher config that
reads it; the rest is the plain reference of this model."""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .. import plain, sim

# the variational blocks of the fluA ELBO example: initial scales
SIGMA = {"bm.rate": 0.07, "coalescent.theta": 0.13}
INIT_SIGMA = 0.1


@dataclass
class Case:
    cfg: dict
    physher: dict
    base_dir: str
    tree: plain.Tree
    newick: str
    dates: dict
    fasta: str
    states: torch.Tensor          # tip states [T, L] on the device
    tip_heights: np.ndarray
    low: np.ndarray
    init: dict                    # the config's starting values
    layout: list
    truth: dict

    # the reference's own compression of the alignment, made on first use
    _patterns: tuple = None

    def patterns(self):
        if self._patterns is None:
            self._patterns = plain.compress(self.states)
        return self._patterns

    def shape(self) -> dict:
        pats, _ = self.patterns()
        return dict(T=self.tree.T, I=self.tree.I, C=self.cfg["categories"],
                    S=4, maxc=2, P=int(pats.shape[1]))

    def api_start(self) -> dict:
        """Where a torchtree client starts: the dated tree's heights and the
        simulation's substitution, site and clock values."""
        r, root = plain.ratios_from_heights(
            self.tree, plain.dated_heights(self.tree, self.tip_heights),
            self.low)
        t = self.truth
        return {"ratios": r, "root_height": root,
                "rates": np.asarray(t["rates"]) / sum(t["rates"]),
                "frequencies": np.asarray(t["freqs"]),
                "shape": t["shape"], "rate": t["rate"]}


def make(cfg: dict, seed: int, device, workdir) -> Case:
    T, L = cfg["taxa"], cfg["sites"]
    newick, dates = sim.random_dated_tree(T, cfg["tree_seed"])
    tree = plain.parse_newick(newick)
    tip_h = plain.tip_heights_from_dates(tree, dates)
    low = plain.lowers(tree, tip_h)
    t = cfg["truth"]
    f64 = torch.float64
    Q = plain.gtr_q(torch.tensor(t["rates"], dtype=f64) / sum(t["rates"]),
                    torch.tensor(t["freqs"], dtype=f64))
    rates = plain.gamma_median_rates(torch.tensor(t["shape"], dtype=f64),
                                     cfg["categories"])
    bl = np.nan_to_num(tree.lengths, nan=0.0) * t["rate"]
    pm = plain.transition_matrices(
        Q, torch.as_tensor(bl)[:, None] * rates[None, :])
    C = cfg["categories"]
    states = sim.simulate(
        tree, pm.to(device), torch.tensor(t["freqs"], dtype=f64,
                                          device=device),
        torch.full((C,), 1.0 / C, dtype=f64, device=device), L,
        torch.Generator(device=device).manual_seed(cfg["data_seed"]))
    states = sim.shuffle_sites(states, seed)
    fasta = str(workdir / "alignment.fa")
    sim.write_fasta(fasta, tree.taxa, states, list(plain.NUC))

    init = {k: np.asarray(v, dtype=np.float64)
            for k, v in cfg["start"].items()}
    init["sm.rates"] = init["sm.rates"] / init["sm.rates"].sum()
    r0, root0 = plain.ratios_from_heights(
        tree, plain.dated_heights(tree, tip_h), low)
    init.update({"tree.ratios": r0, "tree.root_height": root0})
    layout = [("tree.ratios", "logit", tree.I - 1, 0.0),
              ("tree.root_height", "shifted_log", 1, float(low[tree.root])),
              ("sm.rates", "simplex", 6, 0.0),
              ("sm.frequencies", "simplex", 4, 0.0),
              ("sitemodel.shape", "log", 1, 0.0),
              ("bm.rate", "log", 1, 0.0),
              ("coalescent.theta", "log", 1, 0.0)]
    return Case(cfg, physher_config(cfg, newick, dates, "alignment.fa"),
                str(workdir), tree, newick, dates, fasta, states, tip_h, low,
                init, layout, t)


def physher_config(cfg, newick, dates, fasta) -> dict:
    """The fluA ELBO example's model and variational nodes over this
    data."""
    s = cfg["start"]

    def param(pid, value, lower=None):
        out = {"id": pid, "type": "parameter", "value": value}
        if lower is not None:
            out["lower"] = lower
        return out

    C = cfg["categories"]
    return {
        "rates": {"id": "rates", "type": "simplex",
                  "values": list(s["sm.rates"])},
        "model": {"id": "posterior", "type": "compound", "distributions": [
            {"id": "treelikelihood", "type": "treelikelihood",
             "include_jacobian": True, "tipstates": False,
             "sitepattern": {"id": "patterns", "type": "sitepattern",
                             "datatype": "nucleotide",
                             "alignment": {"id": "seqs", "type": "alignment",
                                           "file": fasta}},
             "sitemodel": {
                 "id": "sitemodel", "type": "sitemodel",
                 "distribution": {"distribution": "gamma", "categories": C,
                                  "parameters": {"alpha": param(
                                      "alpha", s["sitemodel.shape"], 0)}},
                 "substitutionmodel": {
                     "id": "sm", "type": "substitutionmodel",
                     "model": "gtr", "datatype": "nucleotide",
                     "rates": "$rates",
                     "frequencies": {"id": "freqs", "type": "Simplex",
                                     "values": list(s["sm.frequencies"])}}},
             "tree": {"id": "tree", "type": "tree", "time": True,
                      "newick": newick, "dates": dates,
                      "reparam": "tree.scalers"},
             "branchmodel": {"id": "bm", "type": "branchmodel",
                             "model": "strict", "tree": "&tree",
                             "rate": param("rate", s["bm.rate"], 0)}},
            {"id": "prior", "type": "compound", "distributions": [
                {"id": "coalescent", "type": "coalescent",
                 "model": "constant",
                 "parameters": {"n0": param("n0", s["coalescent.theta"],
                                            0)},
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
                          "parameters": {"sigma": param(
                              "sigma.theta", SIGMA["coalescent.theta"], 0)}},
                         {"id": "block3", "type": "block",
                          "distribution": "normal", "x": "&rate",
                          "initialize": True,
                          "parameters": {"sigma": param(
                              "sigma.rate", SIGMA["bm.rate"], 0)}}]},
    }


# -- the plain reference --------------------------------------------------------


def _pmats(case: Case, rates6, freqs, shape, bl):
    """[N, C, 4, 4] float64 on the host; the root's row is unused."""
    C = case.cfg["categories"]
    Q = plain.gtr_q(rates6, freqs)
    rr = plain.gamma_median_rates(shape, C)
    t = torch.cat([bl, bl.new_zeros(1)])[:, None] * rr[None, :]
    return plain.transition_matrices(Q, t)


def _tree_terms(case: Case, v: dict, h):
    """The tree likelihood's inputs from constrained values ``v``."""
    dur = plain.durations(case.tree, h)
    pm = _pmats(case, v["rates"], v["frequencies"], v["shape"],
                dur * v["rate"])
    C = case.cfg["categories"]
    props = torch.full((C,), 1.0 / C, dtype=torch.float64)
    return dur, pm, props


def _loglik(case, pm, freqs, props, precision, device, want_grad):
    """(logL, surrogate) where the surrogate carries logL's gradient to
    the host graph of ``pm`` and ``freqs``; ``precision`` a dtype or
    "tf32"."""
    pats, w = case.patterns()
    dtype, matmul = plain.as_precision(precision)
    logL, g = plain.prune(case.tree, pats, w, pm.to(device, dtype),
                          freqs.to(device, dtype), props.to(device, dtype),
                          want_grad=want_grad, matmul=matmul)
    if not want_grad:
        return float(logL), None
    sur = (torch.sum(pm * g[0].to("cpu", torch.float64))
           + torch.sum(freqs * g[1].to("cpu", torch.float64)))
    return float(logL), sur


def log_target(case: Case, u: np.ndarray, dtype, device, want_grad=False):
    """The log posterior at the unconstrained point ``u`` plus the
    log-Jacobian of the transform to it: (value, d value / du or None)."""
    uu = torch.tensor(np.asarray(u, dtype=np.float64),
                      requires_grad=want_grad)
    v, logj = plain.constrain(case.layout, uu)
    tr = case.tree
    h = plain.heights_from_ratios(tr, v["tree.ratios"],
                                  v["tree.root_height"], case.tip_heights,
                                  case.low)
    vals = {"rates": v["sm.rates"], "frequencies": v["sm.frequencies"],
            "shape": v["sitemodel.shape"], "rate": v["bm.rate"]}
    dur, pm, props = _tree_terms(case, vals, h)
    logL, sur = _loglik(case, pm, vals["frequencies"], props, dtype, device,
                        want_grad)
    theta = v["coalescent.theta"]
    rest = (plain.ratio_log_jacobian(tr, h, case.low)
            + plain.constant_coalescent(h, tr.T, theta)
            + plain.one_on_x(theta)
            + plain.ctmc_scale(vals["rate"], torch.sum(dur)) + logj)
    value = logL + float(rest.detach())
    if not want_grad:
        return value, None
    (g,) = torch.autograd.grad(sur + rest, uu)
    return value, g.numpy()


def vb_init(case: Case) -> dict:
    """The mean-field normal's starting point: the config's values, and
    its blocks' scales."""
    loc = plain.unconstrain(case.layout, case.init)
    log_scale = np.full(loc.shape, math.log(INIT_SIGMA))
    i = 0
    for name, transform, size, _ in case.layout:
        n = size - 1 if transform == "simplex" else size
        if name in SIGMA:
            log_scale[i:i + n] = math.log(SIGMA[name])
        i += n
    return {"loc": loc, "log_scale": log_scale}


API_NAMES = ("ratios", "root_height", "rates", "frequencies", "shape",
             "rate")


def api_loglik(case: Case, values: dict, dtype, device, want_grad=True):
    """The tree likelihood with the ratio transform's log-Jacobian at
    ``values`` (:data:`API_NAMES`), and its gradient by name."""
    leaves = {k: torch.tensor(np.asarray(values[k], dtype=np.float64),
                              requires_grad=want_grad) for k in API_NAMES}
    tr = case.tree
    h = plain.heights_from_ratios(tr, leaves["ratios"],
                                  leaves["root_height"], case.tip_heights,
                                  case.low)
    _, pm, props = _tree_terms(case, leaves, h)
    logL, sur = _loglik(case, pm, leaves["frequencies"], props, dtype,
                        device, want_grad)
    jac = plain.ratio_log_jacobian(tr, h, case.low)
    value = logL + float(jac.detach())
    if not want_grad:
        return value, None
    grads = torch.autograd.grad(sur + jac, [leaves[k] for k in API_NAMES])
    return value, {k: np.atleast_1d(g.numpy())
                   for k, g in zip(API_NAMES, grads)}
