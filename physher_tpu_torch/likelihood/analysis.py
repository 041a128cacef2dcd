"""Sequence simulation down a tree.

Port of ``simulate_alignment`` of ``physher_tpu/likelihood/analysis.py``
(reference: the "simultron" simulator, src/phyc/physim.c:40). The JAX key
becomes a ``torch.Generator`` on the device of the model's tensors, so the
draws run where the P matrices are. The two packages' random streams
differ; what they share is the algorithm. Ancestral reconstruction and the
other analyses of that module are not ported yet.
"""

from __future__ import annotations

import torch

from ..data.datatype import get_datatype
from ..trees.topology import Topology


def simulate_alignment(generator: torch.Generator, topo: Topology, subst,
                       site_model, params, branch_lengths, n_sites: int,
                       datatype=None) -> dict:
    """Simulate sequences down the tree (reference: src/phyc/physim.c
    Sequence_simulate; JSON action "simultron" physher.c:289-292).

    ``branch_lengths`` [N] (root entry unused); returns ``{taxon: sequence}``.
    """
    rates, props = site_model.rates_props(params)
    freqs = subst.frequencies(params)
    S = subst.state_count
    dev = freqs.device
    with torch.no_grad():
        cats = torch.multinomial(props, n_sites, replacement=True,
                                 generator=generator)
        root_states = torch.multinomial(freqs, n_sites, replacement=True,
                                        generator=generator)
        bl = torch.as_tensor(branch_lengths, dtype=freqs.dtype, device=dev)
        pmats = subst.p_t(params, bl[:, None] * rates[None, :])  # [N,C,S,S]
        states = torch.zeros((topo.N, n_sites), dtype=torch.long, device=dev)
        states[topo.root] = root_states
        # preorder: parents before children
        for ranks in topo.preorder_levels:
            for k in ranks:
                node = topo.T + int(k)
                for j in range(int(topo.child_count[k])):
                    c = int(topo.children[k, j])
                    probs = pmats[c][cats, states[node], :]    # [L, S]
                    u = torch.rand(n_sites, dtype=freqs.dtype, device=dev,
                                   generator=generator)
                    cdf = probs.cumsum(-1)
                    # rounding can leave cdf[-1] a hair under u: clamp to
                    # the last state rather than index past it
                    states[c] = torch.clamp((u[:, None] > cdf).sum(-1),
                                            max=S - 1)
        tips = states[: topo.T].cpu().numpy()
    dt = datatype or getattr(subst, "datatype", None)
    if dt is None:
        dt = "nucleotide" if S == 4 else ("aa" if S == 20 else "codon")
    dt = get_datatype(dt)
    symbols = [dt.symbol(s) for s in range(S)]
    return {topo.taxa[t]: "".join(symbols[s] for s in tips[t])
            for t in range(topo.T)}
