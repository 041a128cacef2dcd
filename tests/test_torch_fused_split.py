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
- The schedule of ``csrc/pruning.cu``'s S != 4 kernels, emulated in
  float64, against the plain version at 1e-12.

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
# csrc/pruning.cu cannot run here. These functions follow the schedule of
# fused_wide_forward_kernel / fused_wide_backward_kernel, so the CPU tests
# hold their algorithm against the plain version. The forward: one block
# per (pattern block, category) walks the postorder; per node each block
# forms its category's product over children of P_j @ x_j (a missing child
# contributes 1) and its per-pattern max clamped at tiny. Packed, the
# categories' maxima meet (a cluster) and the root's categories are summed
# in order c = 0 .. C - 1 (a thread's rows a = wi + WPC i, WPC warps a
# tile: 2 at S <= 32, 8 above, then the warps); category-split, each
# category keeps its own max and scalers and writes log(max(w_c . root_c,
# tiny)) + sum_k log m_k^c, combined by a logsumexp outside the kernel,
# whose gradient g exp(site_c - site_log) seeds the reverse sweep. The
# backward: one block per (128 patterns, category) seeds its category at
# the root (g / site, or g_c / site_c, 0 where site_c is below tiny) and
# walks the reverse postorder in steps of 128 patterns at S <= 32, of 32
# above; at a node of at most two children each child's y = P x once, the
# sibling's `other` from it, at a polytomy the siblings' products per
# child; dP summed per step, then over the block's steps, per block.

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


def _emulate_forward(tips, pmats, children, rootw, split):
    """(site_log [P], or with ``split`` the per-category rows [C, P];
    partials [I, C, S, P]; scale [I, P], or [C, I, P])."""
    T, S, P = tips.shape
    C = pmats.shape[1]
    I, maxc = children.shape
    tiny = torch.finfo(tips.dtype).tiny
    wpc = 2 if S <= 32 else 8
    partials = tips.new_full((I, C, S, P), float("nan"))
    scale = tips.new_full((C, I, P) if split else (I, P), float("nan"))
    log_sum = tips.new_zeros((C, P) if split else (P,))
    for k in range(I):
        blocks = []                          # grid.y: one per category
        for c in range(C):
            acc = tips.new_ones((S, P))
            for j in range(maxc):
                ch = int(children[k, j])
                if ch >= 0:
                    acc = acc * (pmats[ch, c] @ _child(tips, partials, ch, c,
                                                       T))
            blocks.append(acc)
        maxima = [torch.clamp(acc.amax(0), min=tiny) for acc in blocks]
        if split:                            # each category its own max
            for c in range(C):
                partials[k, c] = blocks[c] / maxima[c]
                scale[c, k] = maxima[c]
                log_sum[c] = log_sum[c] + torch.log(maxima[c])
            continue
        m = maxima[0]                        # the cluster's blocks meet
        for b in maxima[1:]:
            m = torch.maximum(m, b)
        for c in range(C):
            partials[k, c] = blocks[c] / m
        scale[k] = m
        log_sum = log_sum + torch.log(m)
    # the root: per block over a thread's rows, then its warps
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
                      g):
    """(d pmats [N, C, S, S], d rootw [C * S]) from the cotangent ``g``
    ([P], or [C, P] with ``split``)."""
    T, S, P = tips.shape
    N, C = pmats.shape[:2]
    I, maxc = children.shape
    tiny = torch.finfo(tips.dtype).tiny
    w = rootw.view(C, S)
    root = partials[I - 1]                              # [C, S, P]
    if split:
        site = (w[:, :, None] * root).sum(1)            # [C, P]
        inv = torch.where(site >= tiny, g / site, torch.zeros_like(site))
    else:
        site = torch.clamp((w[:, :, None] * root).sum((0, 1)), min=tiny)
        inv = (g / site).expand(C, P)
    nb = -(-P // _BLOCK)
    step = _BLOCK if S <= 32 else 32

    def block_sums(v):
        """[..., P] -> [nb, ...]: sums per step, then over a block's
        steps."""
        return _block_sums(_block_sums(v, step), _BLOCK // step).movedim(
            -1, 0)

    gbuf = tips.new_full((I, C, S, P), float("nan"))
    dP_part = tips.new_full((nb, N, C, S, S), float("nan"))
    dP_part[:, N - 1] = 0.0
    drootw_part = tips.new_full((nb, C, S), float("nan"))
    for c in range(C):  # the grid's category axis
        sc = scale[c] if split else scale
        gbuf[I - 1, c] = w[c, :, None] * inv[c]
        drootw_part[:, c] = block_sums(root[c] * inv[c])
        for k in range(I - 1, -1, -1):
            g_raw = gbuf[k, c] / sc[k]
            kids = [int(ch) for ch in children[k]]
            if maxc <= 2:
                # each child's product once, reused for its sibling
                ys = [pmats[ch, c] @ _child(tips, partials, ch, c, T)
                      if ch >= 0 else None for ch in kids]
                others = [g_raw * ys[1 - i] if maxc == 2
                          and ys[1 - i] is not None else g_raw
                          for i in range(maxc)]
            else:
                # a polytomy: the siblings' products recomputed per child
                others = []
                for i in range(maxc):
                    other = g_raw
                    for j, cj in enumerate(kids):
                        if j != i and cj >= 0:
                            other = other * (pmats[cj, c] @ _child(
                                tips, partials, cj, c, T))
                    others.append(other)
            for ch, other in zip(kids, others):
                if ch < 0:
                    continue
                x = _child(tips, partials, ch, c, T)
                dP_part[:, ch, c] = block_sums(other[:, None] * x[None])
                if ch >= T:
                    gbuf[ch - T, c] = pmats[ch, c].T @ other
    assert torch.isfinite(dP_part).all(), "a dP row was never written"
    assert torch.isfinite(drootw_part).all()
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


TOPOLOGIES = {"balanced": lambda: balanced_topology(8),
              "caterpillar": lambda: caterpillar_topology(6),
              "polytomy": _polytomy}


@pytest.mark.parametrize("shape,S,C,split,zero", [
    ("balanced", 20, 4, True, False), ("balanced", 61, 1, True, False),
    ("caterpillar", 20, 1, False, False), ("polytomy", 20, 3, True, False),
    ("polytomy", 33, 2, False, False), ("caterpillar", 5, 4, True, True),
    ("balanced", 4, 2, True, False), ("balanced", 12, 3, False, False),
    ("polytomy", 61, 2, True, True)])
def test_kernel_schedule_matches_plain(shape, S, C, split, zero):
    """float64: the emulated schedule of the S != 4 kernels, packed and
    category-split, against the plain version of the mode (site logs,
    d pmats, d freqs, d props) to 1e-12: S from 4 to 61 (both step shapes),
    C up to 4, binary nodes and a 4-way polytomy, a category of props 0
    (split: its root clamped at tiny); 300 patterns, three ragged backward
    blocks."""
    topo = TOPOLOGIES[shape]()
    tips, pm, fr, pr, w = _kernel_inputs(topo, S, C, 300, seed=S + C,
                                         zero_category=zero)
    children = torch.as_tensor(topo.children)
    rootw = (pr[:, None] * fr[None, :]).reshape(-1)
    out, partials, scale = _emulate_forward(tips, pm, children, rootw, split)
    if split:
        site = torch.logsumexp(out, 0)
        seed = w * torch.exp(out - site)     # the logsumexp's gradient
    else:
        site, seed = out, w
    dP, drootw = _emulate_backward(tips, pm, children, rootw, split,
                                   partials, scale, seed)
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
