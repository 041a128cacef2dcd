"""Inputs made from the seed: trees, alignments simulated down them on the
device in plain PyTorch, and FASTA files of them."""

from __future__ import annotations

import numpy as np
import torch

from . import plain


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


def balanced_newick(n_tips: int, length: float) -> str:
    """A balanced binary tree over t0 .. t{n-1}, every branch ``length``."""
    def build(lo, hi):
        if hi - lo == 1:
            return f"t{lo}"
        mid = (lo + hi) // 2
        return f"({build(lo, mid)}:{length},{build(mid, hi)}:{length})"
    return build(0, n_tips) + ";"


def simulate(tree: plain.Tree, pmats: torch.Tensor, freqs: torch.Tensor,
             props: torch.Tensor, n_sites: int,
             generator: torch.Generator) -> torch.Tensor:
    """Tip states [T, n_sites] (uint8) simulated down ``tree`` with
    transition matrices ``pmats`` [N, C, S, S] (row: parent state): a rate
    category a site from ``props``, the root from ``freqs``, then each
    level of children at once from the root down."""
    dev = pmats.device
    S = pmats.shape[-1]
    cats = torch.multinomial(props, n_sites, replacement=True,
                             generator=generator)
    states = torch.zeros((tree.N, n_sites), dtype=torch.long, device=dev)
    states[tree.root] = torch.multinomial(freqs, n_sites, replacement=True,
                                          generator=generator)
    depth = np.zeros(tree.N, dtype=np.int64)
    for n in range(tree.N - 2, -1, -1):
        depth[n] = depth[tree.parent[n]] + 1
    for d in range(1, int(depth.max()) + 1):
        nodes = np.nonzero(depth == d)[0]
        idx = torch.as_tensor(nodes, device=dev)
        par = torch.as_tensor(tree.parent[nodes], device=dev)
        rows = pmats[idx[:, None], cats[None, :], states[par]]  # [n, L, S]
        u = torch.rand((len(nodes), n_sites, 1), dtype=pmats.dtype,
                       device=dev, generator=generator)
        states[idx] = torch.clamp((u > rows.cumsum(-1)).sum(-1), max=S - 1)
    return states[:tree.T].to(torch.uint8)


def shuffle_sites(states: torch.Tensor, seed: int) -> torch.Tensor:
    """The columns of ``states`` [T, L] in an order drawn from ``seed``.

    Every seed gets the same alignment, and so the same patterns and the
    same work, in another order: the seed changes the order of the
    program's patterns and, through the draws it seeds, the states the
    check compares; a seed that changed the data would change the work
    (rescaling, deflation) between runs."""
    gen = torch.Generator(device=states.device).manual_seed(seed)
    perm = torch.randperm(states.shape[1], generator=gen,
                          device=states.device)
    return states[:, perm].contiguous()


def write_fasta(path, taxa, states: torch.Tensor, symbols) -> None:
    """FASTA of tip states [T, L]; ``symbols`` the text of each state."""
    width = len(symbols[0])
    table = np.frombuffer("".join(symbols).encode(), dtype=np.uint8).reshape(
        len(symbols), width)
    rows = states.cpu().numpy()
    with open(path, "wb") as fh:
        for name, row in zip(taxa, rows):
            fh.write(b">" + name.encode() + b"\n")
            fh.write(table[row].tobytes() + b"\n")
