"""GY94 M0 (Goldman and Yang 1994; codeml model = 0, NSsites = 0) with
free codon frequencies on a balanced tree with free branch lengths, over
codons simulated from the seed at the configuration's kappa, omega and
branch length.

``make`` writes the alignment as FASTA and returns the physher config that
reads it; the rest is the plain reference of this model."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import plain, sim


@dataclass
class Case:
    cfg: dict
    physher: dict
    base_dir: str
    tree: plain.Tree
    newick: str
    fasta: str
    states: torch.Tensor          # tip states [T, L] (sense-codon index)
    init: dict
    layout: list

    _patterns: tuple = None

    def patterns(self):
        if self._patterns is None:
            self._patterns = plain.compress(self.states)
        return self._patterns

    def shape(self) -> dict:
        pats, _ = self.patterns()
        return dict(T=self.tree.T, I=self.tree.I, C=1, S=61, maxc=2,
                    P=int(pats.shape[1]))


def make(cfg: dict, seed: int, device, workdir) -> Case:
    T, L = cfg["taxa"], cfg["codons"]
    newick = sim.balanced_newick(T, cfg["branch_length"])
    tree = plain.parse_newick(newick)
    t = cfg["truth"]
    f64 = torch.float64
    S = len(plain.SENSE_CODONS)
    pi = torch.full((S,), 1.0 / S, dtype=f64)
    Q = plain.gy94_q(torch.tensor(t["kappa"], dtype=f64),
                     torch.tensor(t["omega"], dtype=f64), pi)
    bl = torch.as_tensor(np.nan_to_num(tree.lengths, nan=0.0))
    pm = plain.transition_matrices(Q, bl[:, None])           # [N, 1, S, S]
    states = sim.simulate(
        tree, pm.to(device), pi.to(device),
        torch.ones(1, dtype=f64, device=device), L,
        torch.Generator(device=device).manual_seed(cfg["data_seed"]))
    states = sim.shuffle_sites(states, seed)
    fasta = str(workdir / "alignment.fa")
    sim.write_fasta(fasta, tree.taxa, states, plain.SENSE_CODONS)
    # the chains start from the alignment's codon frequencies, as codeml's
    # F61 takes them (one pseudocount each, so that none is 0), kappa and
    # omega from the builder's 1
    counts = torch.bincount(states.flatten().long(), minlength=S) + 1
    freqs = (counts.double() / counts.sum()).cpu().numpy()
    init = {"tree.distances": np.nan_to_num(tree.lengths[:-1], nan=0.1),
            "sm.kappa": 1.0, "sm.omega": 1.0, "sm.frequencies": freqs}
    layout = [("tree.distances", "log", tree.N - 1, 0.0),
              ("sm.kappa", "log", 1, 0.0),
              ("sm.omega", "log", 1, 0.0),
              ("sm.frequencies", "simplex", S, 0.0)]
    physher = {"model": {
        "id": "treelikelihood", "type": "treelikelihood",
        "sitepattern": {"id": "patterns", "type": "sitepattern",
                        "datatype": "codon",
                        "alignment": {"id": "seqs", "type": "alignment",
                                      "file": "alignment.fa"}},
        "sitemodel": {"id": "sitemodel", "type": "sitemodel",
                      "substitutionmodel": {
                          "id": "sm", "type": "substitutionmodel",
                          "model": "gy94", "datatype": "codon",
                          "frequencies": {"id": "freqs", "type": "Simplex",
                                          "values": freqs.tolist()}}},
        "tree": {"id": "tree", "type": "tree", "newick": newick}}}
    return Case(cfg, physher, str(workdir), tree, newick, fasta, states,
                init, layout)


def log_target(case: Case, u: np.ndarray, dtype, device, want_grad=False):
    """The log-likelihood at the unconstrained point ``u`` plus the
    log-Jacobian of the transform to it: (value, None)."""
    if want_grad:
        raise ValueError("the GY94 reference gives values only")
    with torch.no_grad():
        uu = torch.tensor(np.asarray(u, dtype=np.float64))
        v, logj = plain.constrain(case.layout, uu)
        pi = v["sm.frequencies"]
        Q = plain.gy94_q(v["sm.kappa"], v["sm.omega"], pi)
        bl = torch.cat([v["tree.distances"], uu.new_zeros(1)])
        pm = plain.transition_matrices(Q, bl[:, None])
        pats, w = case.patterns()
        dtype, matmul = plain.as_precision(dtype)
        logL, _ = plain.prune(case.tree, pats, w, pm.to(device, dtype),
                              pi.to(device, dtype),
                              torch.ones(1, dtype=dtype, device=device),
                              matmul=matmul)
    return float(logL) + float(logj), None
