"""ops/fused.py at S != 4 on the CPU: the TPU wrapper's two modes of K1/K2
(packed, and category-split: one sweep per rate category with its own
scalers, combined by a logsumexp) against the JAX package, and an emulation
of the CUDA kernels' schedule against the plain version.

- The split mode's plain version against JAX's fused Pallas kernel in
  interpret mode at tests/test_fused_engine.py's split cases (balanced 12
  taxa, S = 20, C = 4; 8 taxa, S = 61, C = 1; 100 patterns padded to the
  kernel's tile), at that test's float32 tolerances; and in float64
  against JAX's XLA engine at 1e-10.
- The mode rule (``needs_csplit``) equal to JAX's ``_needs_csplit``.
- Packed mode at S = 20, C = 1 through ``fused_site_log`` on the CPU.
- The schedules of ``csrc/pruning.cu``'s S != 4 kernels (the tree
  kernels' plans and the walks), emulated in float64, against the plain
  version at 1e-12; the plans alone on larger trees; the walk rule.

All inputs come from numpy seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physher_tpu.ops.pallas_fused import TILE, _needs_csplit
from physher_tpu.ops.pallas_fused import (
    fused_tree_log_likelihood as j_fused_tree_log_likelihood)
from physher_tpu.ops.pruning import pad_patterns
from physher_tpu.ops.pruning import tree_log_likelihood as j_tree_log_likelihood
from physher_tpu.utils.synthetic import balanced_topology as j_balanced
from physher_tpu.utils.synthetic import (
    random_sitepattern as j_random_sitepattern)
from physher_tpu_torch.ops import fused
from physher_tpu_torch.ops.pruning import pruning_root_levels
from physher_tpu_torch.trees.topology import Topology
from physher_tpu_torch.utils.synthetic import (
    balanced_topology, caterpillar_topology)

F64 = dict(dtype=torch.float64)


def _split_case(S, C, n_tips, datatype, dtype=np.float32):
    """tests/test_fused_engine.py::test_csplit_parity's inputs: (port
    topology, JAX topology, tips [T, S, P], pmats [N, C, S, S], freqs,
    props, weights), numpy."""
    jtopo, topo = j_balanced(n_tips), balanced_topology(n_tips)
    assert list(topo.taxa) == list(jtopo.taxa)
    sp = j_random_sitepattern(n_tips, 100, seed=3, datatype=datatype)
    P = pad_patterns(sp.pattern_count, TILE)
    order = [sp.taxa.index(t) for t in jtopo.taxa]
    tips = sp.tip_partials(pad_to=P, dtype=dtype)[order]
    rng = np.random.default_rng(0)
    Q = rng.random((jtopo.N, C, S, S)).astype(dtype) + 0.1
    fr = rng.random(S).astype(dtype)
    pr = (np.arange(1, C + 1) / (C * (C + 1) / 2)).astype(dtype)
    w = np.asarray(sp.padded_weights(P), dtype)
    return (topo, jtopo, tips, Q / Q.sum(-1, keepdims=True), fr / fr.sum(),
            pr, w)


def _port(fn, topo, inputs, dtype):
    """(logL, site logs, [d pmats, d freqs, d props]) of the port's ``fn``
    on the CPU."""
    tips, pm, fr, pr, w = (torch.as_tensor(x, dtype=dtype) for x in inputs)
    leaves = [x.clone().requires_grad_(True) for x in (pm, fr, pr)]
    site = fn(tips, leaves[0], topo, leaves[1], leaves[2])
    ll = torch.sum(w * site)
    grads = torch.autograd.grad(ll, leaves)
    return (float(ll.detach()), site.detach().double().numpy(),
            [g.double().numpy() for g in grads])


def _jax(fn, jtopo, inputs, dtype):
    tips, pm, fr, pr, w = (jnp.asarray(x, dtype) for x in inputs)

    def f(pm_, fr_, pr_):
        return fn(tips, pm_, jtopo, fr_, pr_, w)

    (ll, sl), g = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        pm, fr, pr)
    return (float(ll), np.asarray(sl, np.float64),
            [np.asarray(x, np.float64) for x in g])


SPLIT_CASES = [(20, 4, 12, "aminoacid"), (61, 1, 8, "codon")]


@pytest.mark.parametrize("S,C,n_tips,datatype", SPLIT_CASES)
def test_split_plain_matches_pallas_kernel(S, C, n_tips, datatype):
    """float32: the split mode's plain version (what ``fused_site_log`` runs
    on the CPU at these shapes) against JAX's fused kernel in interpret
    mode, which splits them too: logL rtol 2e-6, site logs rtol 5e-5 /
    atol 1e-5, gradients rtol 5e-4 with a floor of 1e-4 of the largest
    entry."""
    topo, jtopo, *inputs = _split_case(S, C, n_tips, datatype)
    assert fused.needs_csplit(C, S)
    w = inputs[-1]
    ll, sl, g = _port(fused.fused_site_log, topo, inputs, torch.float32)

    def j_fused(*a):
        return j_fused_tree_log_likelihood(*a, interpret=True)

    jll, jsl, jg = _jax(j_fused, jtopo, inputs, jnp.float32)
    np.testing.assert_allclose(ll, jll, rtol=2e-6)
    np.testing.assert_allclose(sl[w > 0], jsl[w > 0], rtol=5e-5, atol=1e-5)
    for a, b in zip(g, jg):
        np.testing.assert_allclose(a, b, rtol=5e-4,
                                   atol=1e-4 * max(1.0, np.abs(b).max()))


@pytest.mark.parametrize("S,C,n_tips,datatype", SPLIT_CASES)
def test_split_plain_matches_xla_f64(S, C, n_tips, datatype):
    """float64: the split mode's plain version against JAX's XLA engine
    (rescaled) at 1e-10 relative: the categories' logsumexp is the site
    likelihood's sum in linear space."""
    topo, jtopo, *inputs = _split_case(S, C, n_tips, datatype, np.float64)
    ll, sl, g = _port(fused.fused_split_site_log_reference, topo, inputs,
                      torch.float64)

    def j_plain(*a):
        return j_tree_log_likelihood(*a, rescale=True)

    jll, jsl, jg = _jax(j_plain, jtopo, inputs, jnp.float64)
    np.testing.assert_allclose(ll, jll, rtol=1e-10)
    np.testing.assert_allclose(sl, jsl, rtol=1e-10, atol=1e-10)
    for a, b in zip(g, jg):
        np.testing.assert_allclose(a, b, rtol=1e-10,
                                   atol=1e-10 * np.abs(b).max())


@pytest.mark.parametrize("C", range(1, 9))
def test_needs_csplit_matches_jax(C):
    """The port chooses the mode by the TPU wrapper's rule, at every S from
    2 to 64."""
    for S in range(2, 65):
        assert fused.needs_csplit(C, S) == bool(_needs_csplit(C, S)), (C, S)


def test_packed_mode_on_cpu_matches_xla():
    """WAG without Gamma (S = 20, C = 1) is packed: ``fused_site_log`` on the
    CPU is the packed plain version, equal to JAX's XLA engine in float64
    to 1e-12; it launches nothing and builds nothing."""
    topo, jtopo, *inputs = _split_case(20, 1, 12, "aminoacid", np.float64)
    assert not fused.needs_csplit(1, 20)
    fused.FORWARD_LAUNCHES = fused.BACKWARD_LAUNCHES = 0
    ll, sl, g = _port(fused.fused_site_log, topo, inputs, torch.float64)
    assert fused.FORWARD_LAUNCHES == fused.BACKWARD_LAUNCHES == 0
    assert fused._lib is None
    tips, pm, fr, pr, _ = (torch.as_tensor(x, **F64) for x in inputs)
    assert torch.equal(fused.fused_site_log(tips, pm, topo, fr, pr),
                       fused.fused_site_log_reference(tips, pm, topo, fr, pr))

    def j_plain(*a):
        return j_tree_log_likelihood(*a, rescale=True)

    jll, jsl, jg = _jax(j_plain, jtopo, inputs, jnp.float64)
    np.testing.assert_allclose(ll, jll, rtol=1e-12)
    np.testing.assert_allclose(sl, jsl, rtol=1e-12, atol=1e-12)
    for a, b in zip(g, jg):
        np.testing.assert_allclose(a, b, rtol=1e-12,
                                   atol=1e-12 * np.abs(b).max())


def test_split_zero_category_is_log_tiny():
    """A category of props_c = 0 gives log tiny plus its scalers, not -inf,
    as the TPU kernel's ``log max(., tiny)`` does, and no gradient flows
    through its clamped root."""
    topo = balanced_topology(6)
    tips, pm, fr, pr, _ = _kernel_inputs(topo, 20, 3, 50, seed=4)
    pr = torch.tensor([0.5, 0.0, 0.5], **F64).requires_grad_(True)
    per = fused.category_site_logs_reference(tips, pm, topo, fr, pr)
    assert torch.isfinite(per).all()
    _, scal = pruning_root_levels(tips, pm[:, 1:2], topo, rescale=True)
    tiny = torch.finfo(torch.float64).tiny
    torch.testing.assert_close(per[1].detach(), np.log(tiny) + scal,
                               rtol=1e-14, atol=0)
    (d,) = torch.autograd.grad(torch.logsumexp(per, 0).sum(), [pr])
    assert torch.isfinite(d).all() and d[1] == 0


def test_wide_wrappers_refuse_cpu_tensors():
    topo = balanced_topology(6)
    tips, pm, fr, pr, _ = _kernel_inputs(topo, 20, 4, 50, seed=1)
    children = torch.as_tensor(topo.children, dtype=torch.int32)
    rootw = (pr[:, None] * fr[None, :]).reshape(-1)
    fused.FORWARD_LAUNCHES = 0
    with pytest.raises(ValueError, match="CUDA tensors"):
        fused.fused_wide_forward(tips, pm, children, rootw, True)
    assert fused.FORWARD_LAUNCHES == 0


# -- the CUDA kernels' schedule at S != 4, emulated on the CPU ---------------
#
# csrc/pruning.cu cannot run here. These functions follow the schedules of
# fused_wide_{forward,backward}_tree (and of the walks), so the CPU tests
# hold their algorithm against the plain version. The forward
# (ops/fused.forward_plan): a block per (start node, pattern block,
# category) runs a node step and goes up the tree, at a parent of several
# internal children only if it is the last to arrive; the emulation runs a
# few such blocks in a seeded random interleaving. Per node the step forms
# its category's product over children of P_j @ x_j (a missing child
# contributes 1) and its per-pattern max clamped at tiny; packed, the
# categories' maxima meet (a cluster), and the root's categories are
# summed in order c = 0 .. C - 1 (a thread's rows a = wi + WPC i, WPC warps
# a tile: 2 at S <= 32, 8 above, then the warps); category-split, each
# category keeps its own max and scalers. The root's block sums log m over
# every node in rank order and writes log(max(w . root, tiny)) + sum log m
# (split: per category, combined by a logsumexp outside the kernel, whose
# gradient g exp(site_c - site_log) seeds the reverse sweep). The backward
# (ops/fused.backward_plan): a few persistent blocks claim (item, pattern
# block, category) in the plan's order, wait for the item's node's flag
# (set by the item that wrote its cotangent rows to its number of waiting
# items, taken down by each), run the item and go on with its continuation.
# The root's seed item writes g / site (or g_c / site_c, 0 where site_c is
# below tiny), d rootw and the root's zero dP rows; a pair item (a node of
# at most two children) forms each child's y = P x once and the sibling's
# `other` from it, a polytomy item and a child item (a narrow level's
# node, one child) the siblings' products per child; dP is summed per step
# of 128 patterns at S <= 32, of 32 above, then over the block's steps.

_BLOCK = fused.WIDE_BACKWARD_BLOCK


def _kernel_inputs(topo, S, C, P, seed, zero_category=False):
    """float64 one-hot tips [T,S,P] (some ambiguous columns), pmats
    [N,C,S,S], freqs, props (one category 0 with ``zero_category``),
    weights."""
    rng = np.random.default_rng(seed)
    tips = np.eye(S)[rng.integers(0, S, (topo.T, P))].transpose(0, 2, 1)
    tips[:, :, rng.random(P) < 0.1] = 1.0
    Q = rng.random((topo.N, C, S, S)) + 0.1
    props = rng.dirichlet(np.full(C, 5.0))
    if zero_category:
        props[C // 2] = 0.0
        props /= props.sum()
    arrays = (tips, Q / Q.sum(-1, keepdims=True),
              rng.dirichlet(np.full(S, 5.0)), props, rng.uniform(0.5, 2.0, P))
    return [torch.as_tensor(np.ascontiguousarray(a), **F64) for a in arrays]


def _child(tips, partials, ch, c, T):
    return tips[ch] if ch < T else partials[ch - T, c]


def _block_sums(v, block):
    """[..., P] -> per-block sums [..., n_blocks] over ``block`` patterns."""
    P = v.shape[-1]
    nb = -(-P // block)
    v = torch.nn.functional.pad(v, (0, nb * block - P))
    return v.reshape(*v.shape[:-1], nb, block).sum(-1)


def _interleave(blocks, advance, rng):
    """Advance one of ``blocks`` (picked by ``rng``) at a time until none is
    left: ``advance(block)`` returns the block's next state, None when it
    leaves, or the same state when it must wait; fails when every block
    left waits."""
    blocks = list(blocks)
    while blocks:
        order = rng.permutation(len(blocks))
        for i in order:
            nxt = advance(blocks[i])
            if nxt is not blocks[i]:
                blocks[i] = nxt
                break
        else:
            raise AssertionError("every block waits: the schedule deadlocks")
        blocks = [b for b in blocks if b is not None]


def _emulate_forward(tips, pmats, children, rootw, split, seed=0,
                     walk=False):
    """(site_log [P], or with ``split`` the per-category rows [C, P];
    partials [I, C, S, P]; scale [I, P], or [C, I, P]), by ``forward_plan``
    (the tree kernel's), or as the walk kernel runs it (``walk``: one block
    per pattern block and category visits every node in rank order)."""
    T, S, P = tips.shape
    C = pmats.shape[1]
    I, maxc = children.shape
    tiny = torch.finfo(tips.dtype).tiny
    wpc = 2 if S <= 32 else 8
    if walk:
        nxt = np.append(np.arange(1, I), -1)
        need, starts = np.ones(I, int), [0]
    else:
        nxt, need, starts = fused.forward_plan(children.numpy(), T)
    partials = tips.new_full((I, C, S, P), float("nan"))
    scale = tips.new_full((C, I, P) if split else (I, P), float("nan"))
    written = np.zeros(I, int)
    arrivals = np.zeros(I, int)

    def node(k):
        # its internal children are done, and it is run once
        kids = [int(ch) for ch in children[k]]
        assert all(written[ch - T] == 1 for ch in kids if ch >= T)
        assert written[k] == 0
        written[k] += 1
        blocks = []                          # grid.y: one per category
        for c in range(C):
            acc = tips.new_ones((S, P))
            for ch in kids:
                if ch >= 0:
                    acc = acc * (pmats[ch, c] @ _child(tips, partials, ch, c,
                                                       T))
            blocks.append(acc)
        maxima = [torch.clamp(acc.amax(0), min=tiny) for acc in blocks]
        if split:                            # each category its own max
            for c in range(C):
                partials[k, c] = blocks[c] / maxima[c]
                scale[c, k] = maxima[c]
            return
        m = maxima[0]                        # the cluster's blocks meet
        for b in maxima[1:]:
            m = torch.maximum(m, b)
        for c in range(C):
            partials[k, c] = blocks[c] / m
        scale[k] = m

    def advance(k):
        node(k)
        up = int(nxt[k])
        if up < 0:
            return None
        if need[up] > 1:
            arrivals[up] += 1
            if arrivals[up] < need[up]:
                return None                  # not the last: the block leaves
            arrivals[up] = 0                 # the last resets the counter
        return up

    _interleave([int(k) for k in starts], advance,
                np.random.default_rng(seed))
    assert (written == 1).all() and (arrivals == 0).all()
    # the root's block: log m summed over every node in rank order
    log_sum = tips.new_zeros((C, P) if split else (P,))
    for k in range(I):
        log_sum = log_sum + torch.log(scale[:, k] if split else scale[k])
    w = rootw.view(C, S)
    sums = []
    for c in range(C):
        per_state = w[c, :, None] * partials[I - 1, c]
        v = per_state[0::wpc].sum(0)
        for wi in range(1, wpc):
            v = v + per_state[wi::wpc].sum(0)
        sums.append(v)
    if split:
        rows = [torch.log(torch.clamp(v, min=tiny)) + log_sum[c]
                for c, v in enumerate(sums)]
        return torch.stack(rows), partials, scale
    site = sums[0]
    for v in sums[1:]:                       # in category order
        site = site + v
    return torch.log(torch.clamp(site, min=tiny)) + log_sum, partials, scale


def _emulate_backward(tips, pmats, children, rootw, split, partials, scale,
                      g, width=8, walk=False, n_blocks=4, seed=0):
    """(d pmats [N, C, S, S], d rootw [C * S]) from the cotangent ``g``
    ([P], or [C, P] with ``split``), by ``backward_plan`` (levels of at most
    ``width`` steps split by child) on ``n_blocks`` persistent blocks, or as
    the walk kernel runs it (``walk``: the root's seed, then every node in
    reverse rank order, one block per pattern block and category)."""
    T, S, P = tips.shape
    N, C = pmats.shape[:2]
    I, maxc = children.shape
    tiny = torch.finfo(tips.dtype).tiny
    w = rootw.view(C, S)
    root = partials[I - 1]                              # [C, S, P]
    nb = -(-P // _BLOCK)
    step = _BLOCK if S <= 32 else 32
    if walk:                             # one chain of items a block
        items = np.stack([np.arange(I - 1, -1, -1), np.full(I, -1),
                          np.append(np.arange(1, I), -1),
                          np.zeros(I, int)], 1)
        items[0, 3] = 2
        claims, consumers = [0], np.zeros(I, int)
    else:
        items, claims, consumers = fused.backward_plan(
            children.numpy(), T, nb, C, width)
    total = len(claims) * nb * C

    gbuf = tips.new_full((I, C, S, P), float("nan"))
    dP_part = tips.new_full((nb, N, C, S, S), float("nan"))
    drootw_part = tips.new_full((nb, C, S), float("nan"))
    dP_writes = np.zeros((nb, N, C), int)
    g_writes = np.zeros((I, C, nb), int)
    flags = np.zeros((I, nb, C), int)
    claimed = [0]

    def seed_root(pb, c, sl):
        r = root[c][:, sl]
        if split:
            site = (w[c, :, None] * r).sum(0)
            inv = torch.where(site >= tiny, g[c, sl] / site,
                              torch.zeros_like(site))
        else:
            site = torch.clamp((w[:, :, None] * root[:, :, sl]).sum((0, 1)),
                               min=tiny)
            inv = g[sl] / site
        gbuf[I - 1, c, :, sl] = w[c, :, None] * inv
        g_writes[I - 1, c, pb] += 1
        drootw_part[pb, c] = (r * inv).sum(-1)
        dP_part[pb, N - 1, c] = 0.0
        dP_writes[pb, N - 1, c] += 1

    def run(it, pb, c):
        """One item at pattern block pb and category c; returns the nodes
        whose cotangent rows it wrote."""
        k, part, _, kind = (int(v) for v in items[it])
        kind, publishes = kind & 3, bool(kind & 4)
        sl = slice(pb * _BLOCK, min(P, (pb + 1) * _BLOCK))
        if kind == 2:
            seed_root(pb, c, sl)
        assert g_writes[k, c, pb] == 1, "a node's rows read before written"
        sc = scale[c] if split else scale
        g_raw = gbuf[k, c][:, sl] / sc[k][sl]
        kids = [int(ch) for ch in children[k]]
        ys = [pmats[ch, c] @ _child(tips, partials, ch, c, T)[:, sl]
              if ch >= 0 else None for ch in kids]
        if part < 0 and maxc <= 2:
            # each child's product once, reused for its sibling
            others = [g_raw * ys[1 - i] if maxc == 2
                      and ys[1 - i] is not None else g_raw
                      for i in range(maxc)]
            todo = range(maxc)
        else:
            # a polytomy or one child: the siblings' products per child
            todo = range(maxc) if part < 0 else [part]
            others = {}
            for i in todo:
                other = g_raw
                for j, y in enumerate(ys):
                    if j != i and y is not None:
                        other = other * y
                others[i] = other
        wrote = []
        for i in todo:
            ch = kids[i]
            if ch < 0:
                continue
            x = _child(tips, partials, ch, c, T)[:, sl]
            o = others[i]
            dP_part[pb, ch, c] = _block_sums(o[:, None] * x[None],
                                             step).sum(-1)
            dP_writes[pb, ch, c] += 1
            if ch >= T:
                gbuf[ch - T, c, :, sl] = pmats[ch, c].T @ o
                g_writes[ch - T, c, pb] += 1
                wrote.append(ch - T)
        # the item's flag bit: some child it wrote has waiting items
        assert publishes == any(consumers[n] for n in wrote)
        if kind == 2:
            wrote.insert(0, I - 1)           # the seed's rows
        return wrote

    def advance(state):
        """A block's next state: "claim" (it holds nothing), then (item,
        pattern block, category, whether it still waits), None when its
        claim fails."""
        if state == "claim":
            q = claimed[0]
            claimed[0] += 1
            if q >= total:
                return None
            e, r = divmod(q, nb * C)
            pb, c = divmod(r, C)
            it = int(claims[e])
            return (it, pb, c, (items[it, 3] & 3) == 1)
        it, pb, c, waits = state
        k = int(items[it, 0])
        if waits:
            if flags[k, pb, c] == 0:
                return state                 # its node's rows are not ready
            flags[k, pb, c] -= 1
            return (it, pb, c, False)
        for n in run(it, pb, c):
            if consumers[n]:
                assert flags[n, pb, c] == 0
                flags[n, pb, c] = consumers[n]
        nxt = int(items[it, 2])
        return "claim" if nxt < 0 else (nxt, pb, c, False)

    _interleave(["claim"] * min(n_blocks, total), advance,
                np.random.default_rng(seed))
    assert claimed[0] == total + min(n_blocks, total)
    assert (flags == 0).all(), "a flag is left set"
    # every row written exactly once (the root's dP rows by its seed)
    assert (dP_writes == 1).all() and (g_writes == 1).all()
    return dP_part.sum(0), drootw_part.sum(0).reshape(-1)


def _polytomy():
    def tip(i):
        return {"name": f"t{i}", "length": 0.1, "children": []}
    nested = {"name": None, "children": [
        {"name": None, "length": 0.2, "children": [tip(0), tip(1), tip(2),
                                                   tip(3)]},
        {"name": None, "length": 0.1, "children": [tip(4), tip(5)]},
        tip(6)]}
    return Topology.from_nested(nested)[0]


def _polytomy3():
    """Every internal node of up to three children (maxc 3), some of two."""
    def tip(i):
        return {"name": f"t{i}", "length": 0.1, "children": []}

    def node(*kids):
        return {"name": None, "length": 0.1, "children": list(kids)}
    nested = node(node(tip(0), tip(1), tip(2)),
                  node(node(tip(3), tip(4)), tip(5), node(tip(6), tip(7),
                                                          tip(8))),
                  tip(9))
    del nested["length"]
    return Topology.from_nested(nested)[0]


TOPOLOGIES = {"balanced": lambda: balanced_topology(8),
              "caterpillar": lambda: caterpillar_topology(6),
              "polytomy": _polytomy,
              "caterpillar16": lambda: caterpillar_topology(16),
              "polytomy3": _polytomy3}


# (shape, S, C, split, a category of props 0, the widest level of steps
# the backward splits by child; "walk" for both sweeps' walk kernels); a
# case is named by its first five, with "-walk" for the walks
SCHEDULE_CASES = [
    ("balanced", 20, 4, True, False, 24),
    ("balanced", 61, 1, True, False, 3),
    ("caterpillar", 20, 1, False, False, 3),
    ("polytomy", 20, 3, True, False, 9),
    ("polytomy", 33, 2, False, False, 6),
    ("caterpillar", 5, 4, True, True, 0),
    ("balanced", 4, 2, True, False, 6),
    ("balanced", 12, 3, False, False, 18),
    ("polytomy", 61, 2, True, True, 0),
    ("caterpillar16", 20, 1, False, False, 3),
    ("caterpillar16", 20, 4, True, False, 0),
    ("caterpillar16", 61, 1, True, False, 3),
    ("caterpillar16", 20, 2, False, False, "walk"),
    ("polytomy3", 20, 2, False, False, 12),
    ("polytomy3", 61, 1, True, False, 6),
    ("polytomy3", 20, 3, True, True, 0),
    ("balanced", 20, 4, True, False, "walk"),
    ("polytomy", 61, 2, True, True, "walk")]


@pytest.mark.parametrize(
    "shape,S,C,split,zero,width",
    [pytest.param(*case, id="-".join(map(str, case[:5]))
                  + ("-walk" if case[5] == "walk" else ""))
     for case in SCHEDULE_CASES])
def test_kernel_schedule_matches_plain(shape, S, C, split, zero, width):
    """float64: the emulated schedule of the S != 4 kernels (blocks going
    up the tree in the forward; claimed, waiting and continued items of
    the backward on four persistent blocks, in seeded random
    interleavings; or both walks), packed and category-split, against the
    plain version of the mode (site logs, d pmats, d freqs, d props) to
    1e-12: S from 4 to 61 (both step shapes), C up to 4, binary nodes, 16-
    and 6-taxon caterpillars, a 4-way polytomy and a tree of nodes of two
    and three children, narrow levels split by child (``width``) or not, a
    category of props 0 (split: its root clamped at tiny); 300 patterns,
    three ragged backward blocks."""
    walk = width == "walk"
    topo = TOPOLOGIES[shape]()
    tips, pm, fr, pr, w = _kernel_inputs(topo, S, C, 300, seed=S + C,
                                         zero_category=zero)
    children = torch.as_tensor(topo.children)
    rootw = (pr[:, None] * fr[None, :]).reshape(-1)
    out, partials, scale = _emulate_forward(tips, pm, children, rootw, split,
                                            seed=S, walk=walk)
    if split:
        site = torch.logsumexp(out, 0)
        seed = w * torch.exp(out - site)     # the logsumexp's gradient
    else:
        site, seed = out, w
    dP, drootw = _emulate_backward(tips, pm, children, rootw, split,
                                   partials, scale, seed,
                                   width=0 if walk else width, walk=walk,
                                   seed=C)
    dr = drootw.view(C, S)
    grads = (dP, (pr[:, None] * dr).sum(0), (fr[None, :] * dr).sum(1))

    leaves = [x.clone().requires_grad_(True) for x in (pm, fr, pr)]
    reference = (fused.fused_split_site_log_reference if split
                 else fused.fused_site_log_reference)
    ref = reference(tips, leaves[0], topo, leaves[1], leaves[2])
    ref_grads = torch.autograd.grad(torch.sum(w * ref), leaves)
    torch.testing.assert_close(site, ref.detach(), rtol=1e-12, atol=1e-12)
    for a, b in zip(grads, ref_grads):
        torch.testing.assert_close(a, b, rtol=1e-12,
                                   atol=1e-12 * float(b.abs().max()))


def _random_tree(n_tips, max_children, seed):
    """A random rooted tree of ``n_tips`` tips whose internal nodes have 2 to
    ``max_children`` children: subtrees merged at random."""
    rng = np.random.default_rng(seed)
    nodes = [{"name": f"t{i}", "length": 0.1, "children": []}
             for i in range(n_tips)]
    while len(nodes) > 1:
        m = int(min(len(nodes), rng.integers(2, max_children + 1)))
        picks = sorted(rng.choice(len(nodes), m, replace=False),
                       reverse=True)
        merged = {"name": None, "length": 0.1,
                  "children": [nodes.pop(i) for i in picks]}
        nodes.append(merged)
    del nodes[0]["length"]
    return Topology.from_nested(nodes[0])[0]


PLAN_TREES = {"balanced64": lambda: balanced_topology(64),
              "caterpillar128": lambda: caterpillar_topology(128),
              "random50-maxc2": lambda: _random_tree(50, 2, 1),
              "random60-maxc3": lambda: _random_tree(60, 3, 2),
              "random40-maxc5": lambda: _random_tree(40, 5, 3),
              "polytomy3": _polytomy3}


@pytest.mark.parametrize("tree", list(PLAN_TREES))
def test_schedule_plans(tree):
    """The tree kernels' plans alone, on larger trees, at several pattern
    blocks, categories and split widths.
    Forward: every node runs once, after its internal children, and each
    counter ends at 0. Backward: every item is claimed or continued exactly
    once; a waiting item's rows come from an item claimed before it, or
    from the chain of one (so no block waits on a later claim), and a
    continued item's from the item that continues with it; each non-root
    node's dP row and each internal node's cotangent rows are written by
    exactly one item, the root's by its seed; ``consumers`` counts the
    waiting items; claims go root first, level by level. The caterpillar
    is a chain (the walk rule's), the balanced tree is not."""
    topo = PLAN_TREES[tree]()
    T, I = topo.T, topo.I
    children = topo.children
    parent = {int(ch) - T: k for k in range(I) for ch in children[k]
              if ch >= T}
    nxt, need, starts = fused.forward_plan(children, T)
    done = np.zeros(I, int)
    arrivals = np.zeros(I, int)
    stack = [int(k) for k in starts]
    while stack:
        k = stack.pop()
        kids = [int(ch) - T for ch in children[k] if ch >= T]
        assert all(done[j] for j in kids) and not done[k]
        done[k] = 1
        up = int(nxt[k])
        if up < 0:
            continue
        arrivals[up] += 1
        if arrivals[up] == need[up]:
            arrivals[up] = 0
            stack.append(up)
    assert done.all() and not arrivals.any()
    if tree in ("balanced64", "caterpillar128"):
        assert fused.is_chain(children, T) == (tree == "caterpillar128")
    for blocks, C, width in ((1, 1, 132), (4, 2, 16), (3, 4, 132),
                             (2, 1, 10 ** 6), (8, 1, 0)):
        items, claims, consumers = fused.backward_plan(
            children, T, blocks, C, width)
        n = len(items)
        writer = {}                     # node rank -> item writing its rows
        dp_rows = np.zeros(topo.N, int)
        for i, (k, j, _, kind) in enumerate(items):
            kids = children[k] if j < 0 else children[k, j:j + 1]
            kind &= 3
            for ch in kids[kids >= 0]:
                dp_rows[ch] += 1
                if ch >= T:
                    assert ch - T not in writer
                    writer[ch - T] = i
            if kind == 2:
                assert k == I - 1 and I - 1 not in writer
                writer[I - 1] = i
        assert (dp_rows[:-1] == 1).all() and dp_rows[-1] == 0
        assert sorted(writer) == list(range(I))
        # each item's position: its claim, or its chain head's
        pos, seq = np.full(n, -1), np.full(n, -1)
        reached = np.zeros(n, int)
        for e, i in enumerate(claims):
            at = 0
            while i >= 0:
                reached[i] += 1
                pos[i], seq[i] = e, at
                at += 1
                i = int(items[i, 2])
        assert (reached == 1).all()
        for i, (k, j, cont, kind) in enumerate(items):
            w = writer[k]
            kind &= 3
            if kind == 1:                # waits: its writer came before
                assert pos[w] < pos[i]
            elif kind == 0:              # continued: earlier in its chain
                assert pos[w] == pos[i] and seq[w] < seq[i]
            if cont >= 0:                # continued: this item wrote it
                assert (items[cont, 3] & 3) == 0
                assert writer[items[cont, 0]] == i
        assert (np.bincount(items[(items[:, 3] & 3) == 1, 0], minlength=I)
                == consumers).all()
        # preorder level order of the claims
        depth = {I - 1: 0}
        for k in range(I - 2, -1, -1):
            depth[k] = depth[parent[k]] + 1
        claim_depths = [depth[int(items[i, 0])] for i in claims]
        assert claim_depths == sorted(claim_depths)


def test_walk_rule():
    """A sweep walks (the walk kernels) where its (pattern block, category)
    blocks fill at least WALK_FILL of the resident blocks (WAG+G4 64 x
    8192: 256 of 264 backward blocks) or the tree is a chain, and takes the
    tree's schedule where neither holds (GY94 32 x 4096: 32 of 396; the
    forward at WAG+G4, 256 of 528); SCHEDULE forces either."""
    assert fused.WALK_FILL == 0.5 and fused.SCHEDULE is None
    assert fused.walks(64, 4, 264, False) and fused.walks(66, 2, 264, False)
    assert not fused.walks(32, 1, 396, False)
    assert not fused.walks(64, 1, 264, False)
    assert not fused.walks(64, 4, 528, False)
    assert fused.walks(64, 4, 512, False) and fused.walks(1, 1, 264, True)
    try:
        fused.SCHEDULE = "tree"
        assert not fused.walks(64, 4, 264, True)
        fused.SCHEDULE = "walk"
        assert fused.walks(1, 1, 264, False)
    finally:
        fused.SCHEDULE = None
