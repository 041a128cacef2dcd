"""ops/loop.py and the batched level-array engine on the CPU, held against the
JAX package: the engine chain by chain against JAX's ``pruning_root_levels``
/ ``tree_log_likelihood`` (float64, rtol 1e-12: the same arithmetic in
another order), the plain version of K5'/K6' against JAX's loop kernel in
interpret mode with the cases and tolerances of
tests/test_pallas_engine.py (float32: logL rtol 1e-5, site logs rtol 2e-4,
gradients rtol 5e-4 with an absolute floor of 1e-4 of the largest entry),
the kernels' own schedule emulated against the plain version (float64,
1e-12; S = 4 and the S != 4 kernels' schedule at S from 2 to 64, C up to
8, polytomies of up to 16 children), the
routing of ``select_engine``, a batch of parameter dicts through the models
(float64, 1e-12 against one dict at a time), and batches through the codon
and protein models against ``jax.vmap`` of the JAX package's (float64, rtol
1e-10: 20 x 20 and 61 x 61 eigendecompositions by two LAPACK paths).
"""

from collections import OrderedDict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physher_tpu.data.distance import distance_matrix as j_distance_matrix
from physher_tpu.data.sitepattern import SitePattern as JSitePattern
from physher_tpu.io.treeio import read_newick as j_read_newick
from physher_tpu.models import codon as j_codon
from physher_tpu.models import protein as j_protein
from physher_tpu.models.sitemodel import GammaSiteModel as JGammaSiteModel
from physher_tpu.models.treelikelihood import TreeLikelihood as JTreeLikelihood
from physher_tpu.ops.pallas_pruning_loop import (
    TILE as J_TILE, loop_tree_log_likelihood as j_loop_tree_log_likelihood)
from physher_tpu.ops.pruning import (
    pruning_root_levels as j_pruning_root_levels,
    tree_log_likelihood as j_tree_log_likelihood)
from physher_tpu.trees.build import nj as j_nj
from physher_tpu.trees.topology import Topology as JTopology
from physher_tpu.utils.synthetic import balanced_topology as j_balanced
from physher_tpu_torch.data.distance import distance_matrix
from physher_tpu_torch.data.sitepattern import SitePattern
from physher_tpu_torch.io.seqio import read_alignment
from physher_tpu_torch.io.treeio import read_newick
from physher_tpu_torch.models.clock import StrictClock
from physher_tpu_torch.models.codon import GY94, MG94
from physher_tpu_torch.models.parameters import (
    ParamSpace, ParamSpec, params_from_numpy)
from physher_tpu_torch.models.protein import LG, WAG
from physher_tpu_torch.models.sitemodel import GammaSiteModel
from physher_tpu_torch.models.substitution import F81, GTR, HKY, JC69, K80
from physher_tpu_torch.models.treelikelihood import (
    TreeLikelihood, select_engine)
from physher_tpu_torch.ops import loop
from physher_tpu_torch.ops.pruning import (
    pad_patterns, pruning_root_levels, tree_log_likelihood)
from physher_tpu_torch.trees.build import nj
from physher_tpu_torch.trees.timetree import TimeTreeData
from physher_tpu_torch.trees.topology import Topology
from physher_tpu_torch.utils.synthetic import (
    balanced_topology, random_sitepattern)

F64 = dict(dtype=torch.float64, device="cpu")
POLYTOMY = "((a:0.1,b:0.2):0.05,(c:0.3,d:0.1):0.02,e:0.15);"


def _caterpillar(cls, n_tips):
    nested = {"name": "t0", "length": 0.1, "children": []}
    for i in range(1, n_tips):
        nested = {"name": None, "length": 0.1, "children": [
            nested, {"name": f"t{i}", "length": 0.1, "children": []}]}
    return cls.from_nested(nested)[0]


def _nested_polytomy(cls):
    """A root with three children, one of them a 4-way polytomy."""
    def tip(i):
        return {"name": f"t{i}", "length": 0.1, "children": []}
    return cls.from_nested({"name": None, "children": [
        {"name": None, "length": 0.2, "children": [tip(0), tip(1), tip(2),
                                                   tip(3)]},
        {"name": None, "length": 0.1, "children": [tip(4), tip(5)]},
        tip(6)]})[0]


def _star(cls):
    """A root with 16 children, 15 tips and a cherry."""
    def tip(i):
        return {"name": f"t{i}", "length": 0.1, "children": []}
    return cls.from_nested({"name": None, "children": [
        *(tip(i) for i in range(15)),
        {"name": None, "length": 0.1, "children": [tip(15), tip(16)]}]})[0]


def _topologies(shape):
    """(port topology, JAX topology) with the same node ids."""
    if shape == "star":
        return _star(Topology), _star(JTopology)
    if shape == "balanced":
        return balanced_topology(12), j_balanced(12)
    if shape == "caterpillar":
        return _caterpillar(Topology, 9), _caterpillar(JTopology, 9)
    return _nested_polytomy(Topology), _nested_polytomy(JTopology)


def _batch(topo, L, C, n_sites=300, seed=0):
    """Numpy inputs of L chains: tips [T,4,P], pmats [L,N,C,4,4], freqs
    [L,4], props [L,C], weights [P]."""
    sp = random_sitepattern(topo.T, n_sites, seed=seed)
    tips = sp.tip_partials()[[sp.taxa.index(t) for t in topo.taxa]]
    rng = np.random.default_rng(seed)
    Q = rng.random((L, topo.N, C, 4, 4)) + 0.1
    freqs = rng.dirichlet(np.full(4, 5.0), L)
    props = rng.dirichlet(np.full(C, 5.0), L)
    return tips, Q / Q.sum(-1, keepdims=True), freqs, props, sp.weights * 1.0


# -- the level-array engine, chain by chain -----------------------------------


@pytest.mark.parametrize("shape,C", [("balanced", 4), ("caterpillar", 1),
                                     ("polytomy", 3)])
@pytest.mark.parametrize("rescale", [True, False])
def test_levels_match_jax_chain_by_chain(shape, C, rescale):
    """Roots, scalers, logL, site logs and the gradient of each chain's
    logL w.r.t. its pmats, freqs and props (float64, rtol 1e-12)."""
    topo, jtopo = _topologies(shape)
    tips, pm, freqs, props, w = _batch(topo, 3, C)
    t = [torch.as_tensor(x) for x in (tips, pm, freqs, props, w)]
    leaves = [x.clone().requires_grad_(True) for x in t[1:4]]
    root, scal = pruning_root_levels(t[0], leaves[0], topo, rescale=rescale)
    ll, site = tree_log_likelihood(t[0], *leaves[:1], topo, *leaves[1:],
                                   t[4], rescale=rescale)
    grads = torch.autograd.grad(ll.sum(), leaves)
    assert ll.shape == (3,) and site.shape == (3, tips.shape[-1])

    def jf(pm_, fr, pr):
        return j_tree_log_likelihood(jnp.asarray(tips), pm_, jtopo, fr, pr,
                                     jnp.asarray(w), rescale=rescale)
    for l in range(3):
        jroot, jscal = j_pruning_root_levels(jnp.asarray(tips),
                                             jnp.asarray(pm[l]), jtopo,
                                             rescale=rescale)
        np.testing.assert_allclose(root[l].detach().numpy(), jroot,
                                   rtol=1e-12, atol=1e-300)
        if rescale:
            np.testing.assert_allclose(scal[l].numpy(), jscal, rtol=1e-12,
                                       atol=1e-12)
        (jll, jsite), jg = jax.value_and_grad(
            jf, argnums=(0, 1, 2), has_aux=True)(
                jnp.asarray(pm[l]), jnp.asarray(freqs[l]),
                jnp.asarray(props[l]))
        np.testing.assert_allclose(float(ll[l].detach()), float(jll),
                                   rtol=1e-12)
        np.testing.assert_allclose(site[l].detach().numpy(), jsite,
                                   rtol=1e-12, atol=1e-12)
        for g, jgi in zip(grads, jg):
            np.testing.assert_allclose(g[l].numpy(), jgi, rtol=1e-12,
                                       atol=1e-12 * np.abs(jgi).max())


def test_unbatched_is_one_chain():
    """pmats [N, C, 4, 4] gives exactly the first chain of a batch."""
    topo = balanced_topology(12)
    tips, pm, freqs, props, w = (torch.as_tensor(x) for x in
                                 _batch(topo, 2, 4))
    ll, site = tree_log_likelihood(tips, pm, topo, freqs, props, w,
                                   rescale=True)
    ll0, site0 = tree_log_likelihood(tips, pm[0], topo, freqs[0], props[0],
                                     w, rescale=True)
    assert ll0.shape == () and site0.shape == site.shape[1:]
    torch.testing.assert_close(ll0, ll[0], rtol=0, atol=0)
    torch.testing.assert_close(site0, site[0], rtol=0, atol=0)


# -- the plain version of K5'/K6' against JAX's loop kernel ------------------


def _loop_case(case):
    """tests/test_pallas_engine.py's inputs ("binary", "multifurcating") and
    two at S != 4 ("aa": S = 20 on a balanced 8-taxon tree, C = 2; "codon":
    S = 61 on the 5-taxon polytomy, C = 1; 100 random sites each), float32,
    patterns padded to the TPU tile: (port topology, JAX topology, tips,
    pmats, freqs, props, w)."""
    if case == "binary":
        topo, jtopo = balanced_topology(16), j_balanced(16)
        sp = random_sitepattern(16, 200, seed=0)
        C, seed = 4, 0
    elif case == "aa":
        topo, jtopo = balanced_topology(8), j_balanced(8)
        sp = random_sitepattern(8, 100, seed=0, datatype="aminoacid")
        C, seed = 2, 20
    else:
        topo, _ = read_newick(POLYTOMY)
        jtopo, _ = j_read_newick(POLYTOMY)
        if case == "codon":
            sp = random_sitepattern(5, 100, seed=1, datatype="codon")
            sp.taxa = list(topo.taxa)
            C, seed = 1, 61
        else:
            seqs = OrderedDict([("a", "ACGTACGTAC"), ("b", "ACGTACCTAA"),
                                ("c", "AGGTACGTAT"), ("d", "ACGAACGTAA"),
                                ("e", "CCGTACGTAA")])
            sp = JSitePattern.from_alignment(seqs)
            C, seed = 2, 1
    S = sp.datatype.state_count
    P = pad_patterns(sp.pattern_count, J_TILE)
    tips = sp.tip_partials(pad_to=P)[[sp.taxa.index(t) for t in topo.taxa]]
    rng = np.random.default_rng(seed)
    Q = rng.random((topo.N, C, S, S)) + 0.1
    freqs = np.full(4, 0.25) if S == 4 else rng.dirichlet(np.full(S, 5.0))
    arrays = [np.asarray(a, np.float32) for a in (
        tips, Q / Q.sum(-1, keepdims=True), freqs, np.full(C, 1.0 / C),
        sp.padded_weights(P))]
    return (topo, jtopo, *arrays)


@pytest.mark.parametrize("case,block,rescale", [
    ("binary", 4, True), ("multifurcating", 1, True),
    ("multifurcating", 3, True), ("multifurcating", 2, False),
    ("aa", 2, True), ("aa", 2, False), ("codon", 2, True),
    ("codon", 2, False)])
def test_plain_matches_jax_loop_kernel(case, block, rescale):
    """logL, site logs and d pmats / d freqs / d props of the plain version
    against the JAX loop kernel (interpret mode, its block sizes), which
    takes any S: S = 4, 20 and 61."""
    topo, jtopo, tips, pm, freqs, props, w = _loop_case(case)

    def jf(pm_, fr, pr):
        return j_loop_tree_log_likelihood(
            jnp.asarray(tips), pm_, jtopo, fr, pr, jnp.asarray(w),
            rescale=rescale, interpret=True, block=block)
    (jll, jsl), jg = jax.value_and_grad(jf, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(pm), jnp.asarray(freqs), jnp.asarray(props))
    leaves = [torch.as_tensor(x).requires_grad_(True)
              for x in (pm, freqs, props)]
    ll, sl = loop.loop_tree_log_likelihood(torch.as_tensor(tips), leaves[0],
                                           topo, leaves[1], leaves[2],
                                           torch.as_tensor(w),
                                           rescale=rescale)
    grads = torch.autograd.grad(ll, leaves)
    np.testing.assert_allclose(float(ll.detach()), float(jll), rtol=1e-5)
    np.testing.assert_allclose(sl.detach().numpy()[w > 0],
                               np.asarray(jsl)[w > 0], rtol=2e-4)
    for g, jgi, name in zip(grads, jg, ("dpmats", "dfreqs", "dprops")):
        jgi = np.asarray(jgi, np.float64)
        np.testing.assert_allclose(g.double().numpy(), jgi, rtol=5e-4,
                                   atol=1e-4 * np.abs(jgi).max(),
                                   err_msg=name)


def test_cpu_runs_plain_version_without_launch():
    """Importing the module builds nothing; a CPU call launches nothing,
    batched or not, and the launch wrappers refuse CPU tensors."""
    topo = balanced_topology(8)
    tips, pm, freqs, props, w = (torch.as_tensor(x) for x in
                                 _batch(topo, 3, 2, n_sites=50))
    loop.LOOP_FORWARD_LAUNCHES = loop.LOOP_BACKWARD_LAUNCHES = 0
    pm.requires_grad_(True)
    ll, site = loop.loop_tree_log_likelihood(tips, pm, topo, freqs, props, w)
    ll.sum().backward()
    assert ll.shape == (3,) and torch.isfinite(pm.grad).all()
    ll1, _ = loop.loop_tree_log_likelihood(tips, pm[1], topo, freqs[1],
                                           props[1], w)
    torch.testing.assert_close(ll1, ll[1], rtol=1e-14, atol=0)
    children = torch.as_tensor(topo.children)
    with pytest.raises(ValueError, match="CUDA tensors"):
        loop.loop_forward(tips, pm.detach(), children, freqs, props)
    assert loop.LOOP_FORWARD_LAUNCHES == loop.LOOP_BACKWARD_LAUNCHES == 0
    assert loop._lib is None


# -- the kernels' schedule, emulated on the CPU --------------------------------
#
# csrc/loop.cu cannot run here. These two functions follow its loops: one
# "thread" per (pattern, chain), vectorized over both; postorder ranks, child
# slots with -1 for a missing child (contributing 1), the per-node max over
# (C, 4) divided out only with rescale (scale 1 without); the root
# props . (freqs @ root) clamped at tiny; the reverse sweep with g_raw =
# gbuf / m, other_i = g_raw * prod_{j != i} contrib_j, and per-(chain, block)
# sums of dP, d freqs and d props over loop.BLOCK patterns. The card holds
# the kernels themselves against the plain version (tests/test_torch_cuda.py,
# chip_smoke.py).


def _apply_p(pm, x):
    """out[l, a, p] = sum_b pm[l, a, b] * x[l, b, p]."""
    return sum(pm[:, :, b:b + 1] * x[:, b:b + 1] for b in range(4))


def _child(tips, partials, ch, c, T):
    L = partials.shape[0]
    return (tips[ch].expand(L, -1, -1) if ch < T
            else partials[:, ch - T, c])


def _emulate_forward(tips, pmats, children, freqs, props, rescale):
    T, _, P = tips.shape
    L, _, C = pmats.shape[:3]
    I, maxc = children.shape
    tiny = torch.finfo(tips.dtype).tiny
    partials = tips.new_empty((L, I, C, 4, P))
    scale = tips.new_ones((L, I, P))
    log_sum = tips.new_zeros((L, P))
    for k in range(I):
        res = tips.new_ones((L, C, 4, P))
        for j in range(maxc):
            ch = int(children[k, j])
            if ch < 0:
                continue
            for c in range(C):
                res[:, c] = res[:, c] * _apply_p(
                    pmats[:, ch, c], _child(tips, partials, ch, c, T))
        if rescale:
            m = torch.clamp(res.amax((1, 2)), min=tiny)
            res = res / m[:, None, None]
            scale[:, k] = m
            log_sum = log_sum + torch.log(m)
        partials[:, k] = res
    per_cat = (freqs[:, None, :, None] * partials[:, I - 1]).sum(2)
    site = torch.clamp((props[:, :, None] * per_cat).sum(1), min=tiny)
    return torch.log(site) + log_sum, partials, scale


def _block_sums(v, block=loop.BLOCK):
    """[..., P] -> per-block sums [..., n_blocks] over ``block`` patterns."""
    P = v.shape[-1]
    nb = -(-P // block)
    v = torch.nn.functional.pad(v, (0, nb * block - P))
    return v.reshape(*v.shape[:-1], nb, block).sum(-1)


def _emulate_backward(tips, pmats, children, freqs, props, partials, scale,
                      g):
    T, _, P = tips.shape
    L, N, C = pmats.shape[:3]
    I, maxc = children.shape
    tiny = torch.finfo(tips.dtype).tiny
    gbuf = tips.new_empty((L, I, C, 4, P))
    root = partials[:, I - 1]                                # [L, C, 4, P]
    per_cat = (freqs[:, None, :, None] * root).sum(2)        # [L, C, P]
    inv = g / torch.clamp((props[:, :, None] * per_cat).sum(1), min=tiny)
    gbuf[:, I - 1] = (props[:, :, None, None] * freqs[:, None, :, None]
                      * inv[:, None, None])
    dfreqs_part = _block_sums(
        (props[:, :, None, None] * root * inv[:, None, None]).sum(1))
    dprops_part = _block_sums(per_cat * inv[:, None])
    nb = dfreqs_part.shape[-1]
    dP_part = tips.new_full((L, nb, N, C, 16), float("nan"))
    dP_part[:, :, N - 1] = 0.0
    for k in range(I - 1, -1, -1):
        for c in range(C):
            g_raw = gbuf[:, k, c] / scale[:, k, None]
            for i in range(maxc):
                ch = int(children[k, i])
                if ch < 0:
                    continue
                other = g_raw
                for j in range(maxc):
                    cj = int(children[k, j])
                    if j != i and cj >= 0:
                        other = other * _apply_p(
                            pmats[:, cj, c], _child(tips, partials, cj, c, T))
                x = _child(tips, partials, ch, c, T)
                dP_part[:, :, ch, c] = _block_sums(
                    (other[:, :, None] * x[:, None]).reshape(L, 16, P)
                ).movedim(-1, 1)
                if ch >= T:
                    gbuf[:, ch - T, c] = _apply_p(
                        pmats[:, ch, c].transpose(-1, -2), other)
    assert torch.isfinite(dP_part).all(), "a dP row was never written"
    return (dP_part.sum(1).view(L, N, C, 4, 4), dfreqs_part.sum(-1),
            dprops_part.sum(-1))


@pytest.mark.parametrize("shape,C,L,rescale", [
    ("balanced", 4, 3, True), ("caterpillar", 3, 2, False),
    ("polytomy", 2, 4, True), ("polytomy", 1, 1, False)])
def test_kernel_schedule_matches_plain(shape, C, L, rescale):
    """float64: the emulated K5'/K6' schedule against the plain version
    (site logs, d pmats, d freqs, d props) to rounding; about 290 patterns
    span ten 32-pattern blocks with a ragged last one."""
    topo = _topologies(shape)[0]
    tips, pm, freqs, props, w = (torch.as_tensor(x) for x in
                                 _batch(topo, L, C, seed=2))
    children = torch.as_tensor(topo.children)
    g = w.expand(L, -1) * torch.linspace(0.5, 1.5, L, **F64)[:, None]
    site, partials, scale = _emulate_forward(tips, pm, children, freqs,
                                             props, rescale)
    dP, dfreqs, dprops = _emulate_backward(tips, pm, children, freqs, props,
                                           partials, scale, g)
    leaves = [x.clone().requires_grad_(True) for x in (pm, freqs, props)]
    ref = loop.loop_site_log_reference(tips, *leaves[:1], topo, *leaves[1:],
                                       rescale=rescale)
    grads = torch.autograd.grad(torch.sum(g * ref), leaves)
    torch.testing.assert_close(site, ref.detach(), rtol=1e-12, atol=1e-12)
    for a, b in zip((dP, dfreqs, dprops), grads):
        torch.testing.assert_close(a, b, rtol=1e-12,
                                   atol=1e-12 * float(b.abs().max()))


# The S != 4 kernels (loop_wide_forward_kernel / loop_wide_backward_kernel)
# follow another schedule. The forward: one block per (pattern block,
# category, chain) walks the postorder, the C category blocks of a pattern
# block and chain forming one thread-block cluster; per node each block
# forms its category's product over children of P_j @ x_j (a missing child
# contributes 1), reduces it to a per-pattern max, and the cluster's blocks
# meet for the max over (C, S); at the root each block sums its category's
# freqs-weighted rescaled partials over a thread's rows a = wi + WPC i (WPC
# warps a tile: 2 at S <= 32, 8 above), then over its warps, times props_c,
# and the cluster sums the blocks in order c = 0 .. C - 1. The backward:
# one block per (loop.WIDE_BACKWARD_BLOCK patterns, category, chain) walks
# the reverse postorder in steps of 128 patterns at S <= 32, of 32 above; at
# a node of at most two children each child's y = P x is computed once and
# the sibling's `other` taken from it, at a polytomy the siblings' products
# are recomputed for each child; dP summed per step, then over the block's
# steps, and d rootw per (block, category) (turned into d freqs and d props
# by the caller).

_WARPS = 8
_WIDE_BLOCK = loop.WIDE_BACKWARD_BLOCK
_TILE = 32


def _wide_mul(pm, x):
    """[L, S, S] @ [L, S, P]."""
    return torch.einsum("lab,lbp->lap", pm, x)


def _emulate_wide_forward(tips, pmats, children, freqs, props, rescale):
    T, S, P = tips.shape
    L, _, C = pmats.shape[:3]
    I, maxc = children.shape
    tiny = torch.finfo(tips.dtype).tiny
    wpc = _WARPS // 4 if S <= 32 else _WARPS   # warps a 32-pattern tile
    partials = tips.new_full((L, I, C, S, P), float("nan"))
    scale = tips.new_full((L, I, P), float("nan"))
    log_sum = tips.new_zeros((L, P))
    for k in range(I):
        blocks = []                            # grid.y: one per category
        for c in range(C):
            acc = tips.new_ones((L, S, P))
            for j in range(maxc):
                ch = int(children[k, j])
                if ch >= 0:
                    acc = acc * _wide_mul(pmats[:, ch, c],
                                          _child(tips, partials, ch, c, T))
            blocks.append(acc)
        m = tips.new_ones((L, P))
        if rescale:
            # each block's per-pattern max, then the cluster's blocks meet
            maxima = [torch.clamp(acc.amax(1), min=tiny) for acc in blocks]
            m = maxima[0]
            for b in maxima[1:]:
                m = torch.maximum(m, b)
            log_sum = log_sum + torch.log(m)
        for c in range(C):
            partials[:, k, c] = blocks[c] / m[:, None]
        scale[:, k] = m
    # the root: per block over a thread's rows, then its warps, times
    # props_c; the cluster sums the blocks in category order
    site = None
    for c in range(C):
        per_state = freqs[:, :, None] * partials[:, I - 1, c]   # [L, S, P]
        v = per_state[:, 0::wpc].sum(1)
        for wi in range(1, wpc):
            v = v + per_state[:, wi::wpc].sum(1)
        v = v * props[:, c, None]
        site = v if site is None else site + v
    site = torch.clamp(site, min=tiny)
    return torch.log(site) + log_sum, partials, scale


def _emulate_wide_backward(tips, pmats, children, freqs, props, partials,
                           scale, g):
    T, S, P = tips.shape
    L, N, C = pmats.shape[:3]
    I, maxc = children.shape
    tiny = torch.finfo(tips.dtype).tiny
    gbuf = tips.new_full((L, I, C, S, P), float("nan"))
    root = partials[:, I - 1]                                # [L, C, S, P]
    rootw = props[:, :, None] * freqs[:, None, :]            # [L, C, S]
    inv = g / torch.clamp((rootw[..., None] * root).sum((1, 2)), min=tiny)
    nb = -(-P // _WIDE_BLOCK)
    dP_part = tips.new_full((L, nb, N, C, S, S), float("nan"))
    dP_part[:, :, N - 1] = 0.0
    drootw_part = tips.new_full((L, nb, C, S), float("nan"))

    # patterns a step: the block's four tiles at once at S <= 32, one tile
    # at a time above
    step = _WIDE_BLOCK if S <= 32 else _TILE

    def block_sums(v):
        """[..., P] -> [..., nb]: sums per step, then over a block's steps"""
        return _block_sums(_block_sums(v, step), _WIDE_BLOCK // step)

    for c in range(C):  # the grid's category axis
        gbuf[:, I - 1, c] = rootw[:, c, :, None] * inv[:, None]
        drootw_part[:, :, c] = block_sums(root[:, c] * inv[:, None]
                                          ).movedim(-1, 1)
        for k in range(I - 1, -1, -1):
            g_raw = gbuf[:, k, c] / scale[:, k, None]
            kids = [int(ch) for ch in children[k]]
            if maxc <= 2:
                # each child's product once, reused for its sibling
                ys = [_wide_mul(pmats[:, ch, c], _child(tips, partials, ch,
                                                        c, T))
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
                            other = other * _wide_mul(
                                pmats[:, cj, c],
                                _child(tips, partials, cj, c, T))
                    others.append(other)
            for ch, other in zip(kids, others):
                if ch < 0:
                    continue
                x = _child(tips, partials, ch, c, T)
                dP_part[:, :, ch, c] = block_sums(
                    other[:, :, None] * x[:, None]).movedim(-1, 1)
                if ch >= T:
                    gbuf[:, ch - T, c] = _wide_mul(
                        pmats[:, ch, c].transpose(-1, -2), other)
    assert torch.isfinite(dP_part).all(), "a dP row was never written"
    assert torch.isfinite(drootw_part).all()
    drootw = drootw_part.sum(1)                              # [L, C, S]
    return (dP_part.sum(1), (props[:, :, None] * drootw).sum(1),
            (freqs[:, None, :] * drootw).sum(2))


def _wide_batch(topo, L, C, S, n_sites=300, seed=0):
    """Numpy inputs of L chains at S states: one-hot tips [T,S,P] with some
    all-ones (ambiguous) columns, pmats [L,N,C,S,S], freqs [L,S], props
    [L,C], weights [P]."""
    rng = np.random.default_rng(seed)
    tips = np.eye(S)[rng.integers(0, S, (topo.T, n_sites))].transpose(0, 2,
                                                                       1)
    tips[:, :, rng.random(n_sites) < 0.1] = 1.0
    Q = rng.random((L, topo.N, C, S, S)) + 0.1
    return (np.ascontiguousarray(tips), Q / Q.sum(-1, keepdims=True),
            rng.dirichlet(np.full(S, 5.0), L),
            rng.dirichlet(np.full(C, 5.0), L), rng.uniform(0.5, 2.0, n_sites))


@pytest.mark.parametrize("shape,S,C,L,rescale", [
    ("balanced", 5, 4, 3, True), ("caterpillar", 20, 2, 2, False),
    ("polytomy", 61, 1, 2, True), ("polytomy", 20, 3, 1, False),
    ("balanced", 2, 1, 2, False), ("caterpillar", 33, 3, 2, True),
    ("balanced", 64, 8, 1, True), ("star", 12, 2, 2, True),
    # with those, the forward's clusters: S = 2, 20, 32, 33, 61 and 64 at
    # C = 1, 3 and 8, polytomies of 4 and 16 children, rescale on and off
    ("star", 32, 8, 1, False), ("star", 61, 1, 1, True),
    ("balanced", 32, 3, 2, True), ("caterpillar", 2, 8, 1, True),
    ("polytomy", 33, 8, 1, True), ("star", 20, 1, 2, False),
    ("balanced", 61, 3, 1, False), ("polytomy", 64, 3, 2, False)])
def test_wide_kernel_schedule_matches_plain(shape, S, C, L, rescale):
    """float64: the emulated schedule of the S != 4 kernels against the
    plain version (site logs, d pmats, d freqs, d props) to rounding; 300
    patterns span three forward blocks at S <= 32 and ten above, and three
    backward blocks, all ragged; S from 2 to 64 (the thread tiles of A rows
    and 2 or 8 warps a tile), C up to 8 (clusters of 1 to 8 blocks), binary
    nodes and polytomies of 4 and 16 children, rescale on and off."""
    topo = _topologies(shape)[0]
    tips, pm, freqs, props, w = (torch.as_tensor(x) for x in
                                 _wide_batch(topo, L, C, S, seed=S))
    children = torch.as_tensor(topo.children)
    g = w.expand(L, -1) * torch.linspace(0.5, 1.5, L, **F64)[:, None]
    site, partials, scale = _emulate_wide_forward(tips, pm, children, freqs,
                                                  props, rescale)
    dP, dfreqs, dprops = _emulate_wide_backward(
        tips, pm, children, freqs, props, partials, scale, g)
    leaves = [x.clone().requires_grad_(True) for x in (pm, freqs, props)]
    ref = loop.loop_site_log_reference(tips, *leaves[:1], topo, *leaves[1:],
                                       rescale=rescale)
    grads = torch.autograd.grad(torch.sum(g * ref), leaves)
    torch.testing.assert_close(site, ref.detach(), rtol=1e-12, atol=1e-12)
    for a, b in zip((dP, dfreqs, dprops), grads):
        torch.testing.assert_close(a, b, rtol=1e-12,
                                   atol=1e-12 * float(b.abs().max()))


# -- routing ------------------------------------------------------------------


@pytest.mark.parametrize("engine,device,S,maxc,C,npl,batch,expected", [
    ("auto", "cuda", 4, 2, 1, 2.06, 16, "cuda-loop"),   # fluA JC69 chains
    ("auto", "cuda", 4, 2, 4, 3.24, 8, "cuda-loop"),    # fluA GTR+G4 chains
    ("cuda", "cuda", 4, 2, 4, 18.0, 2, "cuda-loop"),
    ("auto", "cuda", 4, 3, 1, 1.5, None, "cuda-loop"),  # a polytomy
    ("auto", "cuda", 4, 2, 4, 18.0, 1, "cuda-staged"),  # one chain: one dict
    ("auto", "cuda", 4, 2, 1, 2.06, None, "cuda-fused"),
    ("auto", "cpu", 4, 2, 1, 2.06, 16, "torch"),
    ("torch", "cuda", 4, 2, 4, 18.0, 16, "torch"),
    ("cuda-loop", "cuda", 4, 2, 1, 2.06, None, "cuda-loop"),
    ("auto", "cuda", 20, 2, 4, 18.0, 1, "cuda-wide"),
    ("auto", "cuda", 20, 2, 4, 18.0, 4, "cuda-loop"),   # WAG+G4 chains
    ("cuda", "cuda", 61, 2, 1, 1.5, 2, "cuda-loop"),    # GY94 chains
    ("auto", "cuda", 61, 3, 1, 1.5, 8, "cuda-loop"),
    ("auto", "cuda", 2, 2, 1, 1.5, 2, "cuda-loop"),
    ("cuda-loop", "cuda", 64, 2, 8, 1.5, None, "cuda-loop"),
    ("auto", "cuda", 61, 3, 1, 1.5, None, "cuda-wide"),  # one dict: K7'
])
def test_engine_routing(engine, device, S, maxc, C, npl, batch, expected):
    """Batches of two or more chains at any S from 2 to 64 and S = 4
    polytomies go to K5'/K6' on the card, every batch to the plain engine
    on the CPU."""
    assert select_engine(engine, device, S, maxc, C, npl, batch) == expected


@pytest.mark.parametrize("engine,device,S,batch,error", [
    ("auto", "cuda", 65, 4, ValueError),             # past the kernels' 64
    ("cuda", "cuda", 65, 2, ValueError),
    ("cuda-fused", "cuda", 4, 4, ValueError),        # no batch axis
    ("cuda-staged", "cuda", 4, 16, ValueError),
    ("cuda-loop", "cpu", 4, 4, ValueError),
    ("cuda-loop", "cuda", 65, None, ValueError)])
def test_engine_routing_refuses(engine, device, S, batch, error):
    with pytest.raises(error, match="2 to 64" if S == 65 else None):
        select_engine(engine, device, S, 2, 1, 2.0, batch)


# -- a batch of parameter dicts through the models ---------------------------


@pytest.fixture(scope="module")
def flu_tree(data_dir):
    import json
    import os

    with open(os.path.join(data_dir, "jc69-time.json")) as fh:
        cfg = json.load(fh)["model"]["tree"]
    topo, dist = read_newick(cfg["newick"])
    return topo, dist, TimeTreeData.from_dated_tree(topo, dist, cfg["dates"])


def _models(flu_tree, which):
    topo, dist, td = flu_tree
    sp = random_sitepattern(topo.T, 150, seed=4)
    sp.taxa = list(topo.taxa)
    if which == "jc69-time":
        return TreeLikelihood(sp, topo, JC69(**F64),
                              clock=StrictClock(topo.N, "bm.", **F64),
                              time_data=td, include_jacobian=True, **F64)
    subst = {"gtr": GTR, "hky": HKY, "k80": K80, "f81": F81}[which]("sm.",
                                                                    **F64)
    return TreeLikelihood(sp, topo, subst,
                          GammaSiteModel(4, prefix="site.", mu=True, **F64),
                          distances_init=np.nan_to_num(dist, nan=0.1), **F64)


@pytest.mark.parametrize("which", ["jc69-time", "gtr", "hky", "k80", "f81"])
def test_batched_model_matches_one_dict_at_a_time(flu_tree, which):
    """Log-likelihoods (with the ratio Jacobian) and their gradients for a
    batch of 3 parameter dicts made by ParamSpace.constrain from [3, dim]
    against each dict alone (float64)."""
    tlk = _models(flu_tree, which)
    space = tlk.param_space()
    with torch.no_grad():
        u0 = space.flatten_unconstrained(space.unconstrain(
            space.init_params(**F64)))
    rng = np.random.default_rng(7)
    z = (u0 + torch.as_tensor(rng.normal(0, 0.1, (3, len(u0))))
         ).requires_grad_(True)
    up = space.unflatten_unconstrained(z)
    params = space.constrain(up)
    assert params.batch_shape == (3,)
    val = tlk.log_likelihood(params) + space.log_jacobian(up)
    (gz,) = torch.autograd.grad(val.sum(), z)
    assert val.shape == (3,) and tlk.engine_name(3) == "torch"
    for i in range(3):
        zi = z[i].detach().clone().requires_grad_(True)
        upi = space.unflatten_unconstrained(zi)
        vi = tlk.log_likelihood(space.constrain(upi)) + space.log_jacobian(upi)
        (gi,) = torch.autograd.grad(vi, zi)
        np.testing.assert_allclose(float(val[i].detach()), float(vi.detach()),
                                   rtol=1e-12)
        np.testing.assert_allclose(gz[i].numpy(), gi.numpy(), rtol=1e-9,
                                   atol=1e-9 * float(gi.abs().max()))
    flat = space.flatten_unconstrained(space.unconstrain(params))
    torch.testing.assert_close(flat, z.detach(), rtol=1e-10, atol=1e-10)


def test_batch_of_codon_model_runs():
    """A batch of a codon model runs as one batch on the CPU (the plain
    engine), each chain as it would alone; on the card it is K5'/K6'."""
    topo = balanced_topology(4)
    sp = random_sitepattern(4, 30, seed=1, datatype="codon")
    tlk = TreeLikelihood(sp, topo, GY94(fixed_freqs=True, **F64), **F64)
    space = tlk.param_space()
    u = space.flatten_unconstrained(space.unconstrain(
        space.init_params(**F64)))
    z = u + torch.as_tensor(np.random.default_rng(2).normal(0, 0.2,
                                                            (2, len(u))))
    val = tlk.log_likelihood(space.constrain(space.unflatten_unconstrained(
        z)))
    assert val.shape == (2,) and tlk.engine_name(2) == "torch"
    for i in range(2):
        one = tlk.log_likelihood(space.constrain(
            space.unflatten_unconstrained(z[i])))
        np.testing.assert_allclose(float(val[i]), float(one), rtol=1e-12)


# -- codon and protein models over a batch, against jax.vmap ------------------


def _codon_models(data_dir, which):
    seqs = read_alignment(f"{data_dir}/codon_small.fa")
    with open(f"{data_dir}/codon_small.nwk") as fh:
        newick = fh.read().strip()
    topo, dist = read_newick(newick)
    jtopo, _ = j_read_newick(newick)
    # MG94 with free frequencies: a batch of simplexes [L, 61]
    fixed = which == "gy94"
    maker, jmaker = {"gy94": (GY94, j_codon.GY94),
                     "mg94": (MG94, j_codon.MG94)}[which]
    tlk = TreeLikelihood(SitePattern.from_alignment(seqs, "codon"), topo,
                         maker(fixed_freqs=fixed, **F64),
                         distances_init=dist, **F64)
    jtlk = JTreeLikelihood(JSitePattern.from_alignment(seqs, "codon"), jtopo,
                           jmaker(fixed_freqs=fixed), distances_init=dist)
    return tlk, jtlk


def _protein_models(data_dir, which):
    seqs = read_alignment(f"{data_dir}/tiny_aa.fa")
    sp = SitePattern.from_alignment(seqs, "aa")
    jsp = JSitePattern.from_alignment(seqs, "aa")
    topo, dist = nj(sp.taxa, distance_matrix(sp, "kimura"))
    jtopo, _ = j_nj(jsp.taxa, j_distance_matrix(jsp, "kimura"))
    dist0 = np.nan_to_num(dist[: topo.N - 1], nan=0.1)
    if which == "wag-g4":
        subst, jsubst = WAG(**F64), j_protein.WAG()
        site = GammaSiteModel(4, prefix="site.", **F64)
        jsite = JGammaSiteModel(4, prefix="site.")
    else:  # LG+F: free frequencies, one rate
        subst, jsubst = LG(free_freqs=True, **F64), j_protein.LG(
            free_freqs=True)
        site = jsite = None
    tlk = TreeLikelihood(sp, topo, subst, site, distances_init=dist0,
                         tipstates=True, **F64)
    jtlk = JTreeLikelihood(jsp, jtopo, jsubst, jsite, distances_init=dist0,
                           tipstates=True)
    return tlk, jtlk


@pytest.mark.parametrize("which", ["gy94", "mg94", "wag-g4", "lg-f"])
def test_batched_codon_protein_match_jax_vmap(data_dir, which):
    """L = 3 chains of GY94 and MG94 (free frequencies) on codon_small and
    WAG+G4 and LG+F on tiny_aa: the port's batched log-likelihoods and
    their gradients w.r.t. every parameter against jax.vmap of the JAX
    package's (float64, rtol 1e-10)."""
    tlk, jtlk = (_codon_models if which in ("gy94", "mg94")
                 else _protein_models)(data_dir, which)
    rng = np.random.default_rng(5)
    params = {}
    for k, v in jtlk.param_space().init_params().items():
        v = np.asarray(v, np.float64)
        if k.endswith("frequencies"):
            params[k] = rng.dirichlet(v * 200.0 + 1.0, 3)
        else:
            params[k] = v * np.exp(rng.normal(0.0, 0.2, (3,) + v.shape))
    leaves = {k: v.requires_grad_(True)
              for k, v in params_from_numpy(params, **F64).items()}
    val = tlk.log_likelihood(leaves)
    val.sum().backward()
    jval, jg = jax.jit(jax.vmap(jax.value_and_grad(jtlk.log_likelihood)))(
        {k: jnp.asarray(v) for k, v in params.items()})
    assert val.shape == (3,) and tlk.engine_name(3) == "torch"
    np.testing.assert_allclose(val.detach().numpy(), np.asarray(jval),
                               rtol=1e-10)
    # the gradients go through the eigenvectors (Daleckii-Krein): up to
    # 4e-10 of the largest entry apart here, where
    # test_torch_codon_protein.py holds one dict's at rtol 1e-8
    for k, v in leaves.items():
        jgk = np.asarray(jg[k])
        np.testing.assert_allclose(v.grad.numpy(), jgk, rtol=1e-9,
                                   atol=1e-9 * np.abs(jgk).max(), err_msg=k)


def test_param_space_batch():
    """log, interval, simplex and fixed specs: constrain, log_jacobian and
    the flat view of a batch against each row."""
    space = ParamSpace([ParamSpec.vector("a", [0.5, 2.0], lower=0.0),
                        ParamSpec.scalar("b", 0.3, lower=0.0, upper=1.0),
                        ParamSpec.simplex("c", [0.2, 0.3, 0.5]),
                        ParamSpec.fixed("d", [1.0, 2.0]),
                        ParamSpec.scalar("e", -1.0)])
    z = torch.as_tensor(np.random.default_rng(3).normal(0, 1, (4, 6)))
    up = space.unflatten_unconstrained(z)
    cons = space.constrain(up)
    jac = space.log_jacobian(up)
    assert cons.batch_shape == (4,) and jac.shape == (4,)
    assert cons["d"].shape == (4, 2) and cons["c"].shape == (4, 3)
    for i in range(4):
        upi = space.unflatten_unconstrained(z[i])
        ci = space.constrain(upi)
        for k in ci:
            torch.testing.assert_close(cons[k][i], ci[k], rtol=0, atol=0)
        torch.testing.assert_close(jac[i], space.log_jacobian(upi), rtol=0,
                                   atol=0)
    torch.testing.assert_close(space.flatten_unconstrained(up), z)
