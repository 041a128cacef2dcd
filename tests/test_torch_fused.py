"""ops/fused.py on the CPU: the plain version of the CUDA kernels' function
against the JAX package's fused Pallas kernel (interpret mode) and its plain
pruning engine, and the CPU behaviour of the kernel wrappers.

The cases are those of tests/test_fused_engine.py: a balanced 12-taxon tree
and a 9-taxon caterpillar, C in {4, 3, 1} rate categories (the JAX kernel's
category-padding cases), patterns padded to 256 with all-ones tips and
weight 0. Tolerances are that test's: the float32 values agree to rtol 2e-5
(logL) and 5e-4/1e-4 (site logs); float32 gradients to rtol 5e-3 with an
absolute floor of 1e-3 of the largest entry, since summation orders differ.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physher_tpu.ops.pallas_fused import (
    fused_tree_log_likelihood as j_fused_tree_log_likelihood)
from physher_tpu.ops.pruning import tree_log_likelihood as j_tree_log_likelihood
from physher_tpu.trees.topology import Topology as JTopology
from physher_tpu.utils.synthetic import balanced_topology as j_balanced
from physher_tpu_torch.ops import cuda_build, fused
from physher_tpu_torch.ops.pruning import pad_patterns, pruning_root_levels
from physher_tpu_torch.trees.topology import Topology
from physher_tpu_torch.utils.synthetic import (
    balanced_topology, random_sitepattern)


def _caterpillar(cls, n_tips):
    nested = {"name": "t0", "length": 0.1, "children": []}
    for i in range(1, n_tips):
        nested = {"name": None, "length": 0.1, "children": [
            nested, {"name": f"t{i}", "length": 0.1, "children": []}]}
    topo, _ = cls.from_nested(nested)
    return topo


def _topologies(shape):
    if shape == "balanced":
        return balanced_topology(12), j_balanced(12)
    return _caterpillar(Topology, 9), _caterpillar(JTopology, 9)


def _setup(topo, C, n_sites=100, seed=0):
    """Numpy inputs: tips [T,4,P], pmats [N,C,4,4], freqs, props, weights."""
    sp = random_sitepattern(topo.T, n_sites, seed=seed)
    P = pad_patterns(sp.pattern_count, 256)
    order = [sp.taxa.index(t) for t in topo.taxa]
    tips = sp.tip_partials(pad_to=P)[order]
    rng = np.random.default_rng(seed)
    Q = rng.random((topo.N, C, 4, 4)) + 0.1
    pm = Q / Q.sum(-1, keepdims=True)
    freqs = np.asarray([0.3, 0.2, 0.25, 0.25])
    props = np.arange(1, C + 1) / (C * (C + 1) / 2)
    w = sp.padded_weights(P)
    return tips, pm, freqs, props, w


def _port_value_and_grad(topo, inputs, dtype):
    tips, pm, freqs, props, w = (torch.as_tensor(x, dtype=dtype)
                                 for x in inputs)
    leaves = [x.clone().requires_grad_(True) for x in (pm, freqs, props)]
    ll, sl = fused.fused_tree_log_likelihood(tips, *leaves[:1], topo,
                                             leaves[1], leaves[2], w)
    ll.backward()
    return (float(ll.detach()), sl.detach().double().numpy(),
            [x.grad.double().numpy() for x in leaves])


def _jax_value_and_grad(fn, jtopo, inputs, dtype):
    tips, pm, freqs, props, w = (jnp.asarray(x, dtype) for x in inputs)

    def f(pm_, fr_, pr_):
        return fn(tips, pm_, jtopo, fr_, pr_, w)

    (ll, sl), g = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        pm, freqs, props)
    return (float(ll), np.asarray(sl, np.float64),
            [np.asarray(x, np.float64) for x in g])


@pytest.mark.parametrize("shape,C", [
    ("balanced", 4), ("balanced", 1), ("caterpillar", 4),
    ("caterpillar", 3)])
def test_plain_matches_pallas_kernel(shape, C):
    topo, jtopo = _topologies(shape)
    inputs = _setup(topo, C)
    w = inputs[-1]
    ll, sl, g = _port_value_and_grad(topo, inputs, torch.float32)

    def j_fused(*a):
        return j_fused_tree_log_likelihood(*a, interpret=True)

    jll, jsl, jg = _jax_value_and_grad(j_fused, jtopo, inputs, jnp.float32)
    np.testing.assert_allclose(ll, jll, rtol=2e-5)
    np.testing.assert_allclose(sl[w > 0], jsl[w > 0], rtol=5e-4, atol=1e-4)
    for a, b in zip(g, jg):
        np.testing.assert_allclose(a, b, rtol=5e-3,
                                   atol=1e-3 * max(1.0, np.abs(b).max()))


@pytest.mark.parametrize("shape,C", [
    ("balanced", 4), ("balanced", 1), ("caterpillar", 4),
    ("caterpillar", 3)])
def test_plain_matches_pruning_f64(shape, C):
    """float64: the rescaled plain version against the JAX package's
    rescaled plain engine to 1e-12 (rounding only)."""
    topo, jtopo = _topologies(shape)
    inputs = _setup(topo, C)
    ll, sl, g = _port_value_and_grad(topo, inputs, torch.float64)

    def j_plain(*a):
        return j_tree_log_likelihood(*a, rescale=True)

    jll, jsl, jg = _jax_value_and_grad(j_plain, jtopo, inputs, jnp.float64)
    np.testing.assert_allclose(ll, jll, rtol=1e-12)
    np.testing.assert_allclose(sl, jsl, rtol=1e-12, atol=1e-12)
    for a, b in zip(g, jg):
        np.testing.assert_allclose(a, b, rtol=1e-12,
                                   atol=1e-12 * np.abs(b).max())


def test_cpu_runs_plain_version_without_launch():
    """Importing the module builds nothing; a CPU call launches nothing."""
    topo = balanced_topology(8)
    tips, pm, freqs, props, w = (torch.as_tensor(x)
                                 for x in _setup(topo, 4, n_sites=50))
    fused.FORWARD_LAUNCHES = fused.BACKWARD_LAUNCHES = 0
    pm.requires_grad_(True)
    ll, _ = fused.fused_tree_log_likelihood(tips, pm, topo, freqs, props, w)
    ll.backward()
    assert torch.isfinite(pm.grad).all()
    assert fused.FORWARD_LAUNCHES == 0 and fused.BACKWARD_LAUNCHES == 0
    assert fused._lib is None


def test_kernel_wrappers_refuse_cpu_tensors():
    topo = balanced_topology(8)
    tips, pm, freqs, props, _ = (torch.as_tensor(x)
                                 for x in _setup(topo, 4, n_sites=50))
    children = torch.as_tensor(topo.children)
    rootw = (props[:, None] * freqs[None, :]).reshape(-1)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fused.pruning_forward(tips, pm, children, rootw,
                              cuda_build.postorder_schedule(topo, tips))
    assert fused.FORWARD_LAUNCHES == 0


def test_cuda_engine_on_cpu_raises(data_dir):
    from physher_tpu_torch.models.substitution import JC69
    from physher_tpu_torch.models.treelikelihood import TreeLikelihood

    topo = balanced_topology(8)
    sp = random_sitepattern(8, 40, seed=1)
    tlk = TreeLikelihood(sp, topo, JC69(dtype=torch.float64, device="cpu"),
                         dtype=torch.float64, device="cpu", engine="cuda")
    params = tlk.param_space().init_params(dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tlk(params)


# -- the CUDA kernels' schedule, emulated on the CPU --------------------------
#
# csrc/pruning.cu cannot run here. These functions follow its schedules, so
# the CPU tests hold the kernels' algorithm against the plain version. The
# forward is the walk of csrc/s4_forward.cuh (shared with K5' at S = 4) at
# one chain, vectorized over patterns: by postorder level, leaves first
# (cuda_build.postorder_schedule), a pattern's values on 4 C' lanes (C' = C
# rounded up to 1, 2, 4 or 8; padded lanes load category C - 1 and hold 0),
# each child loaded (node 0 for a missing child, then counted as 1) and
# multiplied in slot order, rescaled by the max over the lane group clamped
# at tiny; the root's rootw . x by a butterfly over the lane group, and
# sum_k log m_k over R lanes a pattern (lane r every R-th rank in rank
# order), then a butterfly over them. The backward is the two launches of csrc/s4_backward.cuh (shared
# with K6' at S = 4) at one chain: the walk carries only the cotangents
# gbuf, by preorder level, root first (cuda_build.preorder_schedule): the
# root's seed rootw g / site, then at each node g_raw = gbuf / m and each
# internal child's P_i^T (g_raw * prod_{j != i} P_j x_j); the dP pass then
# takes every parent at once and sums other_i (x) x_i, and at the root
# x_root g / site, over chunks of cuda_build.S4_DP_CHUNK patterns, which
# the caller sums. The card holds the kernels themselves against the plain
# version (tests/test_torch_cuda.py, chip_smoke.py).


def _apply_p(pm, x):
    """out[..., a, p] = sum_b pm[..., a, b] * x[..., b, p]."""
    return sum(pm[..., b:b + 1] * x[..., b:b + 1, :] for b in range(4))


def _child(tips, partials, ch, c, T):
    return tips[ch] if ch < T else partials[ch - T, c]


def _butterfly(v):
    """What lane 0 holds after an xor butterfly sum over the first axis
    (offsets 1, 2, 4, ...): adjacent pairs summed, then pairs of pairs."""
    while v.shape[0] > 1:
        v = v[0::2] + v[1::2]
    return v[0]


def _emulate_forward(tips, pmats, children, rootw, schedule, lanes=32):
    """The forward walk at one chain; ``lanes`` is R of the log sum."""
    T, _, P = tips.shape
    C = pmats.shape[1]
    I, maxc = children.shape
    Cp = 1 << (C - 1).bit_length()
    cc = [min(c, C - 1) for c in range(Cp)]  # where a padded lane loads
    tiny = torch.finfo(tips.dtype).tiny
    order, offsets = (x.tolist() for x in schedule)
    partials = tips.new_full((I, C, 4, P), float("nan"))
    scale = tips.new_full((I, P), float("nan"))
    for d in range(len(offsets) - 1):
        for k in order[offsets[d]:offsets[d + 1]]:
            res = tips.new_ones((Cp, 4, P))
            for j in range(maxc):
                ch = int(children[k, j])
                a = max(ch, 0)
                x = tips[a].expand(Cp, -1, -1) if a < T else partials[a - T,
                                                                      cc]
                assert not torch.isnan(x).any(), "a child after its parent"
                y = _apply_p(pmats[a, cc], x)
                res = res * (y if ch >= 0 else 1.0)
            res[C:] = 0.0
            m = torch.clamp(res.amax((0, 1)), min=tiny)
            partials[k], scale[k] = (res / m)[:C], m
    v = rootw.view(C, 4, 1)[cc] * partials[I - 1, cc]
    v[C:] = 0.0
    site = _butterfly(v.reshape(4 * Cp, P))
    acc = tips.new_zeros((lanes, P))
    for k in range(I):
        acc[k % lanes] = acc[k % lanes] + torch.log(scale[k])
    return (torch.log(torch.clamp(site, min=tiny)) + _butterfly(acc),
            partials, scale)


def _chunk_sums(v):
    """[..., P] -> per-chunk sums [n_chunks, ...] over S4_DP_CHUNK
    patterns."""
    P, chunk = v.shape[-1], cuda_build.S4_DP_CHUNK
    nq = -(-P // chunk)
    v = torch.nn.functional.pad(v, (0, nq * chunk - P))
    return v.reshape(*v.shape[:-1], nq, chunk).sum(-1).movedim(-1, 0)


def _emulate_backward(tips, pmats, children, rootw, schedule, partials,
                      scale, g):
    T, _, P = tips.shape
    N, C = pmats.shape[:2]
    I = children.shape[0]
    tiny = torch.finfo(tips.dtype).tiny
    w = rootw.view(C, 4, 1)
    root = partials[I - 1]
    inv = g / torch.clamp((w * root).sum((0, 1)), min=tiny)
    order, offsets = schedule
    n_levels = len(offsets) - 1

    def node(k):
        """(child ids, x_j [C, 4, P], other_i = g_raw * prod_{j != i}
        P_j x_j) of node k, missing children left out."""
        kids = [int(ch) for ch in children[k] if ch >= 0]
        xs = [tips[ch].expand(C, -1, -1) if ch < T else partials[ch - T]
              for ch in kids]
        ys = [_apply_p(pmats[ch], x) for ch, x in zip(kids, xs)]
        g_raw = gbuf[k] / scale[k]
        others = []
        for i in range(len(kids)):
            other = g_raw
            for j, y in enumerate(ys):
                if j != i:
                    other = other * y
            others.append(other)
        return kids, xs, others

    # the walk: the cotangents by preorder level, root first
    gbuf = tips.new_full((I, C, 4, P), float("nan"))
    gbuf[I - 1] = w * inv
    for d in range(n_levels):
        for k in order[offsets[d]:offsets[d + 1]].tolist():
            kids, _, others = node(k)
            for ch, other in zip(kids, others):
                if ch >= T:
                    gbuf[ch - T] = _apply_p(pmats[ch].transpose(-1, -2),
                                            other)
    assert torch.isfinite(gbuf).all(), "a node's cotangent was never written"

    # the dP pass: every parent at once, summed over the chunks
    nq = -(-P // cuda_build.S4_DP_CHUNK)
    dP_part = tips.new_full((nq, N, C, 16), float("nan"))
    for k in range(I):
        for ch, x, other in zip(*node(k)):
            dP_part[:, ch] = _chunk_sums(
                (other[:, :, None] * x[:, None]).reshape(C, 16, P))
    dP_part[:, N - 1] = 0.0  # the root is no node's child
    drootw_part = _chunk_sums((root * inv).reshape(C * 4, P))
    assert torch.isfinite(dP_part).all(), "a dP row was never written"
    return dP_part.sum(0).view(N, C, 4, 4), drootw_part.sum(0)


def _polytomy():
    def tip(i):
        return {"name": f"t{i}", "length": 0.1, "children": []}
    nested = {"name": None, "children": [
        {"name": None, "length": 0.2, "children": [tip(0), tip(1), tip(2),
                                                   tip(3)]},
        {"name": None, "length": 0.1, "children": [tip(4), tip(5)]},
        tip(6)]}
    return Topology.from_nested(nested)[0]


def _five_children():
    """A root with a 5-way polytomy (three tips and two cherries) beside a
    tip."""
    def tip(i):
        return {"name": f"t{i}", "length": 0.1, "children": []}

    def cherry(i):
        return {"name": None, "length": 0.1, "children": [tip(i), tip(i + 1)]}
    return Topology.from_nested({"name": None, "children": [
        {"name": None, "length": 0.2, "children": [
            tip(0), cherry(1), tip(3), cherry(4), tip(6)]},
        tip(7)]})[0]


def _schedule_against_plain(topo, C, n_sites=300, lanes=32, identity=False):
    """float64: the kernels' emulated schedule against the plain version
    (value, d pmats, d rootw) to rounding; with ``identity``, category 0's
    P is the identity on every branch (an invariable-sites category)."""
    tips, pm, freqs, props, w = (torch.as_tensor(x) for x in
                                 _setup(topo, C, n_sites=n_sites, seed=2))
    if identity:
        pm[:, 0] = torch.eye(4, dtype=pm.dtype)
    rootw = (props[:, None] * freqs[None, :]).reshape(-1).requires_grad_(True)
    children = torch.as_tensor(topo.children)
    site, partials, scale = _emulate_forward(
        tips, pm, children, rootw.detach(),
        cuda_build.postorder_schedule(topo, tips), lanes)
    dP, drootw = _emulate_backward(tips, pm, children, rootw.detach(),
                                   cuda_build.preorder_schedule(topo, tips),
                                   partials, scale, w)

    pm_ = pm.clone().requires_grad_(True)
    root, scal = pruning_root_levels(tips, pm_, topo, rescale=True)
    ref = torch.log(torch.einsum("cs,csp->p", rootw.view(-1, 4), root)) + scal
    ref_dP, ref_drootw = torch.autograd.grad(torch.sum(w * ref), [pm_, rootw])
    torch.testing.assert_close(site, ref.detach(), rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(dP, ref_dP, rtol=1e-12,
                               atol=1e-12 * float(ref_dP.abs().max()))
    torch.testing.assert_close(drootw, ref_drootw, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("shape,C,lanes", [
    ("balanced", 4, 32), ("caterpillar", 3, 8), ("polytomy", 2, 32),
    ("balanced", 1, 4), ("polytomy", 4, 16), ("caterpillar", 1, 32),
    ("balanced", 5, 32), ("polytomy5", 3, 8), ("polytomy5", 6, 32)])
def test_kernel_schedule_matches_plain(shape, C, lanes):
    """float64: the kernels' emulated schedule against the plain version
    (value, d pmats, d rootw) to rounding: padded lane groups (C = 3, 5,
    6), polytomies of 4 and 5 children, the log sum over 4 to 32 lanes; 300
    patterns padded to 512, one dP chunk."""
    topo = {"polytomy": _polytomy, "polytomy5": _five_children}.get(
        shape, lambda: _topologies(shape)[0])()
    _schedule_against_plain(topo, C, lanes=lanes)


@pytest.mark.parametrize("shape,C", [
    ("balanced", 5), ("caterpillar", 3), ("polytomy5", 5), ("balanced", 3)])
def test_kernel_schedule_identity_category(shape, C):
    """The same at C = 5 (Gamma4+I) and C = 3 (a three-class discrete
    model, or +I beside two rates) with category 0's P the identity on
    every branch, as the invariable category has: its partials are exactly
    0 at every internal node of a variable pattern."""
    topo = {"polytomy5": _five_children}.get(
        shape, lambda: _topologies(shape)[0])()
    _schedule_against_plain(topo, C, identity=True)


@pytest.mark.parametrize("C", [1, 4])
def test_kernel_schedule_chunks_match_plain(C):
    """The same on a caterpillar at 5000 sites (patterns padded to a
    multiple of 256): three dP chunks and one node a preorder level."""
    _schedule_against_plain(_topologies("caterpillar")[0], C, n_sites=5000)
