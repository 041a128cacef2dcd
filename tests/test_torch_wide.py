"""ops/wide.py on the CPU: the plain version of the wide CUDA kernels' function
against the JAX package's wide Pallas kernel (interpret mode) and its plain
pruning engine, an emulation of the kernels' own schedule, and the engine
routing of TreeLikelihood.

The JAX cases are those of tests/test_wide_engine.py: codon (S = 61, C = 1)
on a balanced 12-taxon tree and a 9-taxon caterpillar, amino acids (S = 20,
C = 4) on the balanced tree, 80 sites padded to 256 with all-ones tips and
weight 0. Tolerances are that test's: float32 logL rtol 2e-5, site logs
rtol 2e-4, gradients atol 5e-4 of the largest entry (the JAX kernel's MXU
products and the port's einsums sum in other orders); float64 against the
JAX plain engine 1e-10 (rounding only).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physher_tpu.ops.pallas_wide import (
    wide_tree_log_likelihood as j_wide_tree_log_likelihood)
from physher_tpu.ops.pruning import tree_log_likelihood as j_tree_log_likelihood
from physher_tpu.utils import synthetic as j_synthetic
from physher_tpu.trees.topology import Topology as JTopology
from physher_tpu_torch.data.sitepattern import SitePattern
from physher_tpu_torch.models.treelikelihood import (
    TreeLikelihood, select_engine)
from physher_tpu_torch.ops import cuda_build, wide
from physher_tpu_torch.ops.pruning import pad_patterns
from physher_tpu_torch.trees.topology import Topology
from physher_tpu_torch.utils.synthetic import (
    balanced_topology, caterpillar_topology, random_sitepattern)

TILE = 256


def _j_caterpillar(n_tips):
    nested = {"name": "t0", "length": 0.1, "children": []}
    for i in range(1, n_tips):
        nested = {"name": None, "length": 0.1, "children": [
            nested, {"name": f"t{i}", "length": 0.1, "children": []}]}
    return JTopology.from_nested(nested)[0]


def _topologies(shape):
    if shape == "balanced":
        return balanced_topology(12), j_synthetic.balanced_topology(12)
    return caterpillar_topology(9), _j_caterpillar(9)


def _setup(topo, datatype, C, n_sites=80, seed=0):
    """Numpy inputs as tests/test_wide_engine.py makes them: tips [T,S,P],
    row-stochastic pmats [N,C,S,S], freqs, props, weights."""
    sp = random_sitepattern(topo.T, n_sites, seed=seed, datatype=datatype)
    P = pad_patterns(sp.pattern_count, TILE)
    order = [sp.taxa.index(t) for t in topo.taxa]
    tips = sp.tip_partials(pad_to=P)[order]
    S = tips.shape[1]
    rng = np.random.default_rng(seed)
    Q = rng.random((topo.N, C, S, S)) + 0.05
    f = rng.random(S) + 0.1
    return (tips, Q / Q.sum(-1, keepdims=True), f / f.sum(),
            np.ones(C) / C, sp.padded_weights(P))


def _port_value_and_grad(topo, inputs, dtype):
    tips, pm, freqs, props, w = (torch.as_tensor(x, dtype=dtype)
                                 for x in inputs)
    leaves = [x.clone().requires_grad_(True) for x in (pm, freqs, props)]
    ll, sl = wide.wide_tree_log_likelihood(tips, leaves[0], topo, leaves[1],
                                           leaves[2], w)
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


CASES = [("codon", 1, "balanced"), ("codon", 1, "caterpillar"),
         ("aminoacid", 4, "balanced")]


@pytest.mark.parametrize("datatype,C,shape", CASES)
def test_plain_matches_pallas_wide(datatype, C, shape):
    """float32: the plain version against the JAX wide kernel in interpret
    mode, value, site logs and d (pmats, freqs, props)."""
    topo, jtopo = _topologies(shape)
    inputs = _setup(topo, datatype, C)
    w = inputs[-1]
    ll, sl, g = _port_value_and_grad(topo, inputs, torch.float32)

    def j_wide(*a):
        return j_wide_tree_log_likelihood(*a, interpret=True)

    jll, jsl, jg = _jax_value_and_grad(j_wide, jtopo, inputs, jnp.float32)
    np.testing.assert_allclose(ll, jll, rtol=2e-5)
    np.testing.assert_allclose(sl[w > 0], jsl[w > 0], rtol=2e-4)
    for a, b in zip(g, jg):
        scale = np.abs(b).max()
        np.testing.assert_allclose(a / scale, b / scale, atol=5e-4)


@pytest.mark.parametrize("datatype,C,shape", CASES)
def test_plain_matches_pruning_f64(datatype, C, shape):
    """float64: the plain version against the JAX package's rescaled plain
    engine to 1e-10."""
    topo, jtopo = _topologies(shape)
    inputs = _setup(topo, datatype, C)
    ll, sl, g = _port_value_and_grad(topo, inputs, torch.float64)

    def j_plain(*a):
        return j_tree_log_likelihood(*a, rescale=True)

    jll, jsl, jg = _jax_value_and_grad(j_plain, jtopo, inputs, jnp.float64)
    np.testing.assert_allclose(ll, jll, rtol=1e-10)
    np.testing.assert_allclose(sl, jsl, rtol=1e-10, atol=1e-10)
    for a, b in zip(g, jg):
        np.testing.assert_allclose(a, b, rtol=1e-10,
                                   atol=1e-10 * np.abs(b).max())


# -- the CUDA kernels' schedule, emulated on the CPU --------------------------
#
# csrc/wide.cu cannot run here. These functions follow its launches: one
# forward launch per level of topo.levels (leaves first), one block per
# (pattern block, category, node), the C category blocks of a node forming
# one thread-block cluster: each block forms its category's product over
# children, reduces it to a per-pattern max, and the cluster's blocks meet
# for the max over (C, S) before the division; partials [I, C, S, P] and
# scalers [I, P] kept in device memory, a root launch summing log m over the
# ranks in order; then the root seed (d rootw
# summed per block of BWD_PATTERNS patterns) and one reverse launch
# per level, root first, whose blocks each take one (pattern block, category,
# node) and walk the block's patterns in steps (128 patterns at S <= 32, 32
# above): at a node of at most two children each y_j = P_j @ x_j once per
# step and other_i = gbuf / m * y_{1-i}, at a polytomy the siblings'
# products recomputed for each child; dP summed per block over its steps and
# gbuf[child] = P_i^T @ other_i. A level of at most one block an SM takes
# one (pattern block, category, child) a block instead, each computing its
# siblings' products. The card holds the kernels themselves against the
# plain version (tests/test_torch_cuda.py, chip_smoke.py).


def _x(tips, partials, ch, c, T):
    return tips[ch] if ch < T else partials[ch - T, c]


def _emulate_forward(tips, pmats, children, rootw, levels):
    T, S, P = tips.shape
    C = pmats.shape[1]
    I, maxc = children.shape
    tiny = torch.finfo(tips.dtype).tiny
    partials = torch.full((I, C, S, P), float("nan"), dtype=tips.dtype)
    scale = torch.full((I, P), float("nan"), dtype=tips.dtype)
    for level in levels:                       # one launch per level
        for k in level:                        # grid.z: the level's nodes
            blocks = []                        # grid.y: the categories
            for c in range(C):
                acc = tips.new_ones((S, P))
                for j in range(maxc):
                    ch = int(children[k, j])
                    if ch >= 0:
                        acc = acc * (pmats[ch, c]
                                     @ _x(tips, partials, ch, c, T))
                blocks.append(acc)
            # each block's per-pattern max; the cluster's blocks meet
            maxima = [torch.clamp(acc.amax(0), min=tiny) for acc in blocks]
            m = maxima[0]
            for b in maxima[1:]:
                m = torch.maximum(m, b)
            for c in range(C):
                partials[k, c] = blocks[c] / m
            scale[k] = m
    root = partials[I - 1]                     # the root launch
    site = torch.clamp((rootw.view(C, S, 1) * root).sum((0, 1)), min=tiny)
    log_sum = torch.zeros(P, dtype=tips.dtype)
    for k in range(I):
        log_sum = log_sum + torch.log(scale[k])
    return torch.log(site) + log_sum, partials, scale


def _block_sums(v):
    """[..., P] -> per-block sums [n_blocks, ...] over BWD_PATTERNS patterns."""
    B = wide.BWD_PATTERNS
    P = v.shape[-1]
    nb = -(-P // B)
    v = torch.nn.functional.pad(v, (0, nb * B - P))
    return v.reshape(*v.shape[:-1], nb, B).sum(-1).movedim(-1, 0)


def _emulate_backward(tips, pmats, children, rootw, levels, partials, scale,
                      g, sms):
    T, S, P = tips.shape
    N, C = pmats.shape[:2]
    I, maxc = children.shape
    B = wide.BWD_PATTERNS
    step = 128 if S <= 32 else 32            # patterns a step takes
    tiny = torch.finfo(tips.dtype).tiny
    gbuf = torch.full((I, C, S, P), float("nan"), dtype=tips.dtype)
    root = partials[I - 1].reshape(C * S, P)   # the root seed launch
    inv = g / torch.clamp((rootw[:, None] * root).sum(0), min=tiny)
    gbuf[I - 1] = (rootw[:, None] * inv).view(C, S, P)
    drootw_part = _block_sums(root * inv)
    nb = drootw_part.shape[0]
    dP_part = torch.full((nb, N, C, S, S), float("nan"), dtype=tips.dtype)
    dP_part[:, N - 1] = 0.0                    # the root is no node's child
    for level in reversed(levels):             # one launch per level
        # a level of at most one block an SM gives each child its own
        # blocks, which compute its siblings' products themselves
        split = nb * C * len(level) <= sms
        for k in level:                        # grid.z: the level's nodes
            kids = [int(ch) for ch in children[k] if ch >= 0]
            shared = maxc <= 2 and not split   # each y_j once per step
            for c in range(C):                 # grid.y: the categories
                for b in range(nb):            # grid.x: the pattern blocks
                    acc = {ch: torch.zeros(S, S, dtype=tips.dtype)
                           for ch in kids}
                    for p0 in range(b * B, min((b + 1) * B, P), step):
                        q = slice(p0, min(p0 + step, P))
                        x = {ch: _x(tips, partials, ch, c, T)[:, q]
                             for ch in kids}
                        g_raw = gbuf[k, c, :, q] / scale[k, q]
                        if shared:
                            y = {ch: pmats[ch, c] @ x[ch] for ch in kids}
                        for ch in kids:
                            other = g_raw
                            for cj in kids:
                                if cj != ch:
                                    other = other * (
                                        y[cj] if shared
                                        else pmats[cj, c] @ x[cj])
                            acc[ch] += other @ x[ch].T
                            if ch >= T:
                                gbuf[ch - T, c, :, q] = pmats[ch, c].T @ other
                    for ch in kids:
                        dP_part[b, ch, c] = acc[ch]
    assert torch.isfinite(dP_part).all(), "a dP row was never written"
    return dP_part.sum(0), drootw_part.sum(0)


def _polytomy():
    def tip(i):
        return {"name": f"t{i}", "length": 0.1, "children": []}
    nested = {"name": None, "children": [
        {"name": None, "length": 0.2, "children": [tip(0), tip(1), tip(2),
                                                   tip(3)]},
        {"name": None, "length": 0.1, "children": [tip(4), tip(5)]},
        tip(6)]}
    return Topology.from_nested(nested)[0]


def _star():
    """A root with 16 children, 15 tips and a cherry."""
    def tip(i):
        return {"name": f"t{i}", "length": 0.1, "children": []}
    return Topology.from_nested({"name": None, "children": [
        *(tip(i) for i in range(15)),
        {"name": None, "length": 0.1, "children": [tip(15), tip(16)]}]})[0]


def _random_inputs(topo, S, C, P, seed):
    """float64 tensors: one-hot tips of random states with a few all-ones
    columns, row-stochastic pmats, freqs, props, weights."""
    rng = np.random.default_rng(seed)
    tips = np.eye(S)[rng.integers(0, S, (topo.T, P))].transpose(0, 2, 1)
    tips[:, :, -5:] = 1.0
    Q = rng.random((topo.N, C, S, S)) + 0.05
    arrays = (tips, Q / Q.sum(-1, keepdims=True), rng.dirichlet(np.ones(S)),
              rng.dirichlet(np.ones(C)), rng.uniform(0.5, 2.0, P))
    return [torch.as_tensor(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("shape,S,C", [
    ("balanced", 61, 1), ("caterpillar", 20, 4), ("polytomy", 5, 3),
    ("balanced", 2, 1), ("caterpillar", 32, 8), ("balanced", 33, 2),
    ("balanced", 64, 1), ("polytomy", 40, 8),
    # with those, the forward's clusters: S = 2, 20, 32, 33, 61 and 64 at
    # C = 1, 3 and 8, polytomies of 4 and 16 children
    ("star", 20, 3), ("star", 61, 1), ("polytomy", 64, 8),
    ("caterpillar", 2, 3), ("balanced", 32, 1), ("polytomy", 33, 3)])
@pytest.mark.parametrize("sms", [0, 132])
def test_kernel_schedule_matches_plain(shape, S, C, sms):
    """float64: the kernels' emulated schedule against the plain version
    (value, d pmats, d rootw) to 1e-12, at S on each side of the step shapes
    (2 to 32: one step a block; 33 to 64: 32-pattern steps), C up to 8
    (clusters of 1 to 8 blocks) and polytomies of 4 and 16 children, with
    every level's nodes whole (no SMs to fill) and with the narrow levels
    split by child (the H100's 132 SMs); 300 patterns span three blocks of
    either step and three backward blocks, the last ones ragged."""
    topo = {"balanced": lambda: balanced_topology(12),
            "caterpillar": lambda: caterpillar_topology(9),
            "polytomy": _polytomy, "star": _star}[shape]()
    tips, pm, freqs, props, w = _random_inputs(topo, S, C, 300, seed=2)
    rootw = (props[:, None] * freqs[None, :]).reshape(-1)
    children = torch.as_tensor(topo.children)
    site, partials, scale = _emulate_forward(tips, pm, children, rootw,
                                             topo.levels)
    dP, drootw = _emulate_backward(tips, pm, children, rootw, topo.levels,
                                   partials, scale, w, sms)

    leaves = [x.clone().requires_grad_(True) for x in (pm, freqs, props)]
    ref = wide.wide_site_log_reference(tips, leaves[0], topo, leaves[1],
                                       leaves[2])
    ref_dP, ref_dfreqs, ref_dprops = torch.autograd.grad(
        torch.sum(w * ref), leaves)
    # d rootw -> d freqs, d props through rootw = props (x) freqs
    dr = drootw.view(C, S)
    torch.testing.assert_close(site, ref.detach(), rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(dP, ref_dP, rtol=1e-12,
                               atol=1e-12 * float(ref_dP.abs().max()))
    torch.testing.assert_close((props[:, None] * dr).sum(0), ref_dfreqs,
                               rtol=1e-12, atol=1e-12)
    torch.testing.assert_close((freqs[None, :] * dr).sum(1), ref_dprops,
                               rtol=1e-12, atol=1e-12)


# -- CPU behaviour of the wrappers and the engine routing ---------------------


def test_cpu_runs_plain_version_without_launch():
    """Importing the module builds nothing; a CPU call launches nothing."""
    topo = balanced_topology(8)
    tips, pm, freqs, props, w = _random_inputs(topo, 20, 4, 60, seed=1)
    wide.WIDE_FORWARD_LAUNCHES = wide.WIDE_BACKWARD_LAUNCHES = 0
    pm.requires_grad_(True)
    ll, _ = wide.wide_tree_log_likelihood(tips, pm, topo, freqs, props, w)
    ll.backward()
    assert torch.isfinite(pm.grad).all()
    assert wide.WIDE_FORWARD_LAUNCHES == wide.WIDE_BACKWARD_LAUNCHES == 0
    assert wide._lib is None


def test_kernel_wrappers_refuse_cpu_tensors():
    topo = balanced_topology(8)
    tips, pm, freqs, props, _ = _random_inputs(topo, 20, 4, 60, seed=1)
    children = torch.as_tensor(topo.children)
    rootw = (props[:, None] * freqs[None, :]).reshape(-1)
    schedule = (torch.as_tensor(np.concatenate(topo.levels)),
                cuda_build.level_schedule(topo, tips)[1])
    with pytest.raises(ValueError, match="CUDA tensors"):
        wide.wide_forward(tips, pm, children, rootw, schedule)
    assert wide.WIDE_FORWARD_LAUNCHES == 0


def test_level_schedule():
    topo = caterpillar_topology(9)
    nodes, offsets = cuda_build.level_schedule(topo, torch.zeros(1))
    assert nodes.dtype == torch.int32 and offsets == tuple(range(9))
    topo = balanced_topology(12)
    nodes, offsets = cuda_build.level_schedule(topo, torch.zeros(1))
    np.testing.assert_array_equal(nodes.numpy(), np.concatenate(topo.levels))
    assert offsets[-1] == topo.I and len(offsets) == len(topo.levels) + 1


@pytest.mark.parametrize("engine,device,S,expected", [
    ("auto", "cuda", 4, "cuda-fused"),
    ("auto", "cuda", 20, "cuda-wide"),    # was cuda-fused, which raises
    ("auto", "cuda", 61, "cuda-wide"),
    ("cuda", "cuda", 20, "cuda-wide"),
    ("cuda", "cuda", 4, "cuda-fused"),
    ("auto", "cpu", 20, "torch"),
    ("torch", "cuda", 61, "torch"),
])
def test_engine_routing(engine, device, S, expected):
    """``auto`` chooses by state count: K1'/K2' at S = 4, K7'/K8' at any
    other S (K1'/K2' take S != 4 only when named)."""
    assert select_engine(engine, device, S) == expected


def test_engine_name_on_cpu():
    from physher_tpu_torch.models.protein import WAG

    kw = dict(dtype=torch.float64, device="cpu")
    topo = balanced_topology(8)
    sp = random_sitepattern(8, 40, seed=1, datatype="aa")
    assert isinstance(sp, SitePattern)
    tlk = TreeLikelihood(sp, topo, WAG(**kw), **kw)
    assert tlk.engine_name() == "torch"
    tlk_cuda = TreeLikelihood(sp, topo, WAG(**kw), engine="cuda", **kw)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tlk_cuda.engine_name()
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tlk_cuda(tlk_cuda.param_space().init_params(**kw))
