"""Likelihood-based analyses: ancestral reconstruction, per-site category
posteriors, CAT assignment, sequence simulation.

Port of ``physher_tpu/likelihood/analysis.py`` (reference: marginal ASR
src/phyc/asr.c:104, action "asr"; per-site rate-category posteriors
src/phyc/ppsites.c, action "ppsite"; FastTree-style CAT assignment
src/phyc/cat.c:17, action "cat"; the "simultron" simulator
src/phyc/physim.c:40). The analyses run the postorder sweep without
rescaling, as the JAX package does: in float32 a tree much deeper than
fluA's can underflow there, the JAX package's own limit. In the simulator
the JAX key becomes a ``torch.Generator`` on the device of the model's
tensors, so the draws run where the P matrices are; the two packages'
random streams differ, what they share is the algorithm.
"""

from __future__ import annotations

import numpy as np
import torch

from ..data.datatype import get_datatype
from ..ops.pruning import pruning_partials
from ..ops.upper import (node_marginals, site_category_posteriors,
                         upper_partials)
from ..trees.topology import Topology


def _engine_state(tlk, params):
    """(pmats [N, C, S, S], freqs [S], props [C], lower partials
    [N, C, S, P]) of a TreeLikelihood at ``params``, without gradients."""
    with torch.no_grad():
        bl = tlk.branch_lengths(params)
        rates, props = tlk.site_model.rates_props(params)
        pmats = tlk.subst.p_t(params, bl[:, None] * rates[None, :]).to(
            tlk.dtype)
        freqs = tlk.subst.frequencies(params).to(tlk.dtype)
        lower, _ = pruning_partials(tlk.tip_partials, pmats, tlk.topo)
    return pmats, freqs, props.to(tlk.dtype), lower


def ancestral_states(tlk, params):
    """Marginal ancestral state posteriors and MAP states over the unique
    patterns: (posteriors [N, S, P], map_states [I, P]) as numpy arrays."""
    pmats, freqs, props, lower = _engine_state(tlk, params)
    with torch.no_grad():
        upper = upper_partials(lower, pmats, tlk.topo, freqs)
        post = node_marginals(lower, upper, props)[:, :, :tlk.sp.pattern_count]
        map_states = torch.argmax(post[tlk.topo.T:], dim=1)
    return post.cpu().numpy(), map_states.cpu().numpy()


def ancestral_sequences(tlk, params) -> dict:
    """MAP ancestral sequence strings per internal node (over sites)."""
    _, map_states = ancestral_states(tlk, params)
    dt = tlk.sp.datatype
    return {f"node{tlk.topo.T + k}": "".join(
        dt.symbol(int(s)) for s in map_states[k][tlk.sp.indexes])
        for k in range(tlk.topo.I)}


def site_rate_posteriors(tlk, params) -> np.ndarray:
    """P(category | pattern) over the unique patterns: [C, P]
    (reference: src/phyc/ppsites.c)."""
    _, freqs, props, lower = _engine_state(tlk, params)
    with torch.no_grad():
        post = site_category_posteriors(lower[tlk.topo.root], freqs, props)
    return post[:, : tlk.sp.pattern_count].cpu().numpy()


def cat_assignment(tlk, params) -> np.ndarray:
    """The MAP rate category of each site (reference: src/phyc/cat.c)."""
    return site_rate_posteriors(tlk, params).argmax(0)[tlk.sp.indexes]


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
