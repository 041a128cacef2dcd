"""ops/staged.py on the CPU: the plain version of the staged CUDA kernels'
function (K3'/K4') against the JAX package's staged Pallas kernel in
interpret mode (as tests/test_staged_engine.py runs it), an emulation of the
kernels' level-launch schedule, and the engine routing of TreeLikelihood.

The JAX kernel takes patterns in tiles of 256: its inputs are padded with
all-ones tips and weight 0, the port's are not (the CUDA kernels take any
P), and the comparison is over the real patterns. Tolerances: float64 1e-10
(rounding only); float32 rtol 1e-5 with an absolute floor of 1e-5 of the
largest entry for the gradients (the kernel's MXU-ordered products and the
port's einsums sum in other orders).
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physher_tpu.ops.pallas_staged import staged_site_log as j_staged_site_log
from physher_tpu.trees.topology import Topology as JTopology
from physher_tpu.utils import synthetic as j_synthetic
from physher_tpu_torch.models.treelikelihood import (
    STAGED_MIN_LEVEL_WORK, TreeLikelihood, select_engine)
from physher_tpu_torch.models.sitemodel import GammaSiteModel
from physher_tpu_torch.models.substitution import JC69
from physher_tpu_torch.ops import staged
from physher_tpu_torch.ops.pruning import pad_patterns, pruning_root_levels
from physher_tpu_torch.io.treeio import read_newick
from physher_tpu_torch.ops.cuda_build import level_schedule
from physher_tpu_torch.trees.topology import Topology
from physher_tpu_torch.utils.synthetic import (
    balanced_topology, caterpillar_topology, random_sitepattern)

TILE = 256
DATA = Path(__file__).parent / "data"


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the emulated schedules run many ops on small
    tensors, which gain nothing from more threads, and beside other test
    processes on the same cores each op's thread barrier stalls."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _j_caterpillar(n_tips):
    nested = {"name": "t0", "length": 0.1, "children": []}
    for i in range(1, n_tips):
        nested = {"name": None, "length": 0.1, "children": [
            nested, {"name": f"t{i}", "length": 0.1, "children": []}]}
    return JTopology.from_nested(nested)[0]


def _topologies(shape):
    if shape == "balanced":
        return balanced_topology(12), j_synthetic.balanced_topology(12)
    return caterpillar_topology(12), _j_caterpillar(12)


def _setup(topo, P, C, seed=0):
    """Numpy inputs at exactly P patterns: tips [T,4,P] of random states
    (some ambiguous), row-stochastic pmats [N,C,4,4], freqs, props,
    weights."""
    rng = np.random.default_rng(seed)
    tips = np.eye(4)[rng.integers(0, 4, (topo.T, P))].transpose(0, 2, 1)
    tips[:, :, rng.random(P) < 0.05] = 1.0
    Q = rng.random((topo.N, C, 4, 4)) + 0.1
    f = rng.random(4) + 0.2
    return (np.ascontiguousarray(tips), Q / Q.sum(-1, keepdims=True),
            f / f.sum(), rng.dirichlet(np.ones(C)), rng.uniform(0.5, 2.0, P))


def _port(fn, topo, inputs, dtype):
    tips, pm, freqs, props, w = (torch.as_tensor(x, dtype=dtype)
                                 for x in inputs)
    leaves = [x.clone().requires_grad_(True) for x in (pm, freqs, props)]
    site = fn(tips, leaves[0], topo, leaves[1], leaves[2])
    grads = torch.autograd.grad(torch.sum(w * site), leaves)
    return (site.detach().double().numpy(),
            [g.double().numpy() for g in grads])


def _jax_staged(jtopo, inputs, dtype):
    tips, pm, freqs, props, w = inputs
    P = tips.shape[-1]
    Pp = pad_patterns(P, TILE)
    tips = np.pad(tips, ((0, 0), (0, 0), (0, Pp - P)), constant_values=1.0)
    w = np.pad(w, (0, Pp - P))
    tips, w = jnp.asarray(tips, dtype), jnp.asarray(w, dtype)

    def f(pm_, fr_, pr_):
        site = j_staged_site_log(tips, pm_, jtopo, fr_, pr_, interpret=True)
        return jnp.sum(w * site), site

    # jit: one compile of the interpret-mode kernel runs faster than its
    # eager grid loop
    (_, site), g = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True))(
        *(jnp.asarray(x, dtype) for x in (pm, freqs, props)))
    return (np.asarray(site, np.float64)[:P],
            [np.asarray(x, np.float64) for x in g])


def _tol(dtype):
    return 1e-10 if dtype == torch.float64 else 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape,P,C", [
    ("balanced", 256, 4), ("balanced", 300, 1), ("caterpillar", 300, 4),
    ("caterpillar", 256, 1)])
def test_plain_matches_pallas_staged(shape, P, C, dtype):
    """The plain version against the JAX staged kernel in interpret mode:
    site logs and d (pmats, freqs, props) against jax.grad."""
    topo, jtopo = _topologies(shape)
    inputs = _setup(topo, P, C)
    site, grads = _port(staged.staged_site_log, topo, inputs, dtype)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    jsite, jgrads = _jax_staged(jtopo, inputs, jdt)
    tol = _tol(dtype)
    np.testing.assert_allclose(site, jsite, rtol=tol, atol=tol)
    for a, b in zip(grads, jgrads):
        np.testing.assert_allclose(a, b, rtol=tol,
                                   atol=tol * np.abs(b).max())


# -- the CUDA kernels' schedule, emulated on the CPU --------------------------
#
# csrc/staged.cu cannot run here. These functions follow its launches. K3':
# the levels of topo.levels below the switch level (staged.walk_level, as
# the wrapper picks it) one launch each, every node of a level at once (the
# grid's y axis), every category at once (vectorized: K3' holds them in one
# thread), each node's partials divided by their max over (C, 4) and its
# log-scaler written to the stage; then one walk of the rest to the root,
# summing every rank's log-scaler into the site log: the S = 4 walk level by
# level, reading a child below the switch from the stage and a walked one
# from the block's hand-off (its slot from staged._walk_tables), or the
# chain walk node by node, every child from the stage (NaN until written).
# A switch past the last level is the level-launch schedule alone, the
# root's launch summing the scalers. K4''s
# root seed, then the levels in reverse, each reading its nodes' cotangents
# and writing their internal children's.
# A binary node computes each child's product once and forms both "other"
# vectors from it; any other node takes one child at a time. dP is summed
# over each block's patterns (block_patterns(C) x the level's patterns a
# thread, level_ppt), the block sums go to the scratch rows of
# backward_rows, and the last pass sums each child's rows in block order.
# SMS: a card of one SM (the wide levels at MAX_PPT patterns a thread) and
# the H100's 132.

SMS = (1, 132)


def _apply_p(pm, x):
    """[n, C, 4, 4] @ [n, C, 4, P] -> [n, C, 4, P]."""
    return torch.einsum("ncab,ncbp->ncap", pm, x)


def _children_x(tips, partials, ch, C, T):
    """Partials [n, C, 4, P] of child ids ``ch`` (tips broadcast over C)."""
    out = []
    for c in ch.tolist():
        out.append(tips[c][None].expand(C, -1, -1) if c < T
                   else partials[c - T])
    return torch.stack(out)


def _node_step(tips, pmats, topo, ks, read):
    """The rescaled partials and log-scalers of internal ranks ``ks``, each
    internal child's partials from ``read(rank)``."""
    T, C, P = topo.T, pmats.shape[1], tips.shape[-1]
    tiny = torch.finfo(tips.dtype).tiny
    res = tips.new_ones((len(ks), C, 4, P))
    for j in range(topo.children.shape[1]):
        ch = torch.as_tensor(topo.children[ks.numpy(), j])
        have = ch >= 0
        kids = torch.where(have, ch, 0)
        x = torch.stack([tips[c][None].expand(C, -1, -1) if c < T
                         else read(c - T) for c in kids.tolist()])
        contrib = _apply_p(pmats[kids], x)
        res = res * torch.where(have[:, None, None, None], contrib, 1.0)
    m = torch.clamp(res.amax((1, 2)), min=tiny)
    return res / m[:, None, None], torch.log(m)


def _emulate_forward(tips, pmats, topo, rootw, top=None, walk=None,
                     sms=132):
    T, _, P = tips.shape
    C = pmats.shape[1]
    I = topo.I
    tiny = torch.finfo(tips.dtype).tiny
    partials = tips.new_full((I, C, 4, P), float("nan"))
    logscale = tips.new_full((I, P), float("nan"))
    nodes, offsets = level_schedule(topo, tips)
    n_levels = len(offsets) - 1
    level, kind = staged.walk_level(offsets, C, P, sms)
    top = level if top is None else top
    walk = kind if walk is None else walk
    levels = list(zip(offsets[:-1], offsets[1:]))
    # the launches below the switch: children from the stage
    for lo, hi in levels[:top]:
        ks = nodes[lo:hi].long()
        partials[ks], logscale[ks] = _node_step(
            tips, pmats, topo, ks, lambda k: partials[k])
    if top == n_levels:  # no walk: the root's launch sums the scalers
        assert int(nodes[-1]) == I - 1
        site = torch.clamp((rootw.view(C, 4, 1) * partials[I - 1]).sum(
            (0, 1)), min=tiny)
        site_log = torch.log(site) + (logscale[I - 1]
                                      + logscale[:I - 1].sum(0))
    elif walk == "chain":
        below = logscale[nodes[:offsets[top]].long()].sum(0)
        for k in nodes[offsets[top]:].long():
            x, lm = _node_step(tips, pmats, topo, k[None],
                               lambda c: partials[c])
            partials[k], logscale[k] = x[0], lm[0]
        assert int(k) == I - 1
        site = torch.clamp((rootw.view(C, 4, 1) * partials[I - 1]).sum(
            (0, 1)), min=tiny)
        site_log = torch.log(site) + (below
                                      + logscale[nodes[offsets[top]:]
                                                 .long()].sum(0))
    else:
        # the S = 4 walk: walked children from the hand-off, the rest from
        # the stage (NaN there until the level that writes them)
        _, slots = staged._walk_tables(nodes, offsets, top)
        hand = tips.new_full((I - offsets[top], C, 4, P), float("nan"))

        def read(k):
            return hand[slots[k]] if slots[k] >= 0 else partials[k]
        for lo, hi in levels[top:]:
            ks = nodes[lo:hi].long()
            x, lm = _node_step(tips, pmats, topo, ks, read)
            hand[slots[ks].long()] = x
            partials[ks], logscale[ks] = x, lm
        assert torch.equal(slots[nodes[offsets[top]:].long()],
                           torch.arange(I - offsets[top], dtype=torch.int32))
        assert bool((slots[nodes[:offsets[top]].long()] == -1).all())
        site = torch.clamp((rootw.view(C, 4, 1) * hand[-1]).sum((0, 1)),
                           min=tiny)
        site_log = torch.log(site) + logscale.sum(0)
    assert torch.isfinite(partials).all() and torch.isfinite(logscale).all()
    return site_log, partials, logscale


def _block_sums(v, span):
    """[..., P] -> per-block sums [n_blocks, ...] over blocks of ``span``
    patterns."""
    P = v.shape[-1]
    nb = -(-P // span)
    v = torch.nn.functional.pad(v, (0, nb * span - P))
    return v.reshape(*v.shape[:-1], nb, span).sum(-1).movedim(-1, 0)


def _others(graw, u, ch):
    """Each present child's "other" vector: the cotangent times every
    sibling's product u. A binary node reuses each child's u once; any other
    node recomputes the siblings' products for each child."""
    present = [i for i in range(len(ch)) if ch[i] >= 0]
    if len(ch) == 2 and len(present) == 2:
        return {0: graw * u[1], 1: graw * u[0]}
    out = {}
    for i in present:
        other = graw
        for j in present:
            if j != i:
                other = other * u[j]
        out[i] = other
    return out


def _emulate_backward(tips, pmats, topo, rootw, partials, logscale, g, sms):
    T, _, P = tips.shape
    N, C = pmats.shape[:2]
    I = topo.I
    maxc = topo.children.shape[1]
    tiny = torch.finfo(tips.dtype).tiny
    nodes, offsets = level_schedule(topo, tips)
    ppt = staged.level_ppt(offsets, C, P, sms)
    qb = staged.block_patterns(C)
    rows, size = staged.backward_rows(offsets, ppt, C, maxc, P)
    gbuf = tips.new_full((I, C, 4, P), float("nan"))
    # the root seed, in blocks of the root's level
    root = partials[I - 1]
    inv = g / torch.clamp((rootw.view(C, 4, 1) * root).sum((0, 1)), min=tiny)
    gbuf[I - 1] = rootw.view(C, 4, 1) * inv
    drootw_part = _block_sums((root * inv).reshape(C * 4, P), qb * ppt[-1])
    dP_part = tips.new_full((size,), float("nan"))
    for lv in reversed(range(len(offsets) - 1)):
        for q in range(offsets[lv], offsets[lv + 1]):
            k = int(nodes[q])
            graw = gbuf[k] * torch.exp(-logscale[k])
            ch = torch.as_tensor(topo.children[k])
            x = {i: _children_x(tips, partials, ch[i:i + 1], C, T)[0]
                 for i in range(maxc) if ch[i] >= 0}
            u = {i: _apply_p(pmats[ch[i:i + 1]], x[i][None])[0] for i in x}
            base, nb = rows[q]
            block = dP_part[base:base + nb * maxc * C * 16].view(
                nb, maxc, C, 16)
            for i, other in _others(graw, u, ch).items():
                block[:, i] = _block_sums(
                    (other[:, :, None] * x[i][:, None, :]).reshape(C, 16, P),
                    qb * ppt[lv])
                if ch[i] >= T:
                    gbuf[ch[i] - T] = torch.einsum(
                        "cab,cap->cbp", pmats[ch[i]], other)
    # the last pass: each child's block rows summed in order
    dP = tips.new_full((N, C, 16), float("nan"))
    dP[N - 1] = 0.0
    for q, (base, nb) in enumerate(rows):
        block = dP_part[base:base + nb * maxc * C * 16].view(nb, maxc, C, 16)
        for i, c in enumerate(topo.children[int(nodes[q])]):
            if c >= 0:
                dP[c] = block[:, i].sum(0)
    assert torch.isfinite(dP).all(), "a dP row was never written"
    return dP.view(N, C, 4, 4), drootw_part.sum(0)


def _polytomy():
    def tip(i):
        return {"name": f"t{i}", "length": 0.1, "children": []}
    nested = {"name": None, "children": [
        {"name": None, "length": 0.2, "children": [tip(0), tip(1), tip(2),
                                                   tip(3)]},
        {"name": None, "length": 0.1, "children": [tip(4), tip(5)]},
        tip(6)]}
    return Topology.from_nested(nested)[0]


def _gtrg4_flua_topology():
    """The GTR+G4 fluA golden's tree (69 taxa, 21 levels)."""
    with open(DATA / "goldens" / "gtrg4_fluA.json") as fh:
        return read_newick(json.load(fh)["model"]["tree"]["newick"])[0]


SCHEDULE_TOPOLOGIES = {
    "balanced": lambda: _topologies("balanced")[0],
    "caterpillar": lambda: _topologies("caterpillar")[0],
    "polytomy": _polytomy,
    "balanced128": lambda: balanced_topology(128),
    "fluA": _gtrg4_flua_topology}


# the switch: as walk_level picks it at 132 SMs (the S = 4 walk from level
# 0 at these P), or forced: each walk from level 0 or a middle level, or
# past the last level (no walk)
@pytest.mark.parametrize("shape,C,P,top,walk", [
    ("balanced", 4, 300, "auto", None), ("caterpillar", 1, 257, "auto", None),
    ("polytomy", 3, 129, "auto", None), ("balanced", 1, 1000, "mid", "s4"),
    ("balanced", 8, 37, "past", None), ("caterpillar", 8, 300, "mid", "s4"),
    ("polytomy", 4, 700, "mid", "chain"), ("polytomy", 8, 300, "past", None),
    ("balanced", 5, 300, 0, "chain"), ("caterpillar", 5, 130, "past", None),
    ("fluA", 4, 238, "auto", None), ("fluA", 1, 300, "mid", "chain"),
    ("fluA", 5, 129, "past", None), ("balanced128", 4, 300, "mid", "chain"),
    ("balanced128", 8, 257, 0, "s4"), ("balanced128", 1, 129, "past", None),
    ("caterpillar", 4, 200, 0, "chain"), ("balanced", 3, 257, "mid", "chain")])
def test_kernel_schedule_matches_plain(shape, C, P, top, walk):
    """float64: the kernels' emulated schedule against the plain version
    (site logs, d pmats, d rootw) to rounding, on a card of one SM and of
    132: the switch to each walk at level 0 and a middle level, and past
    the last; ragged P over several blocks, P under one block (C = 8), C =
    1, 5 and 8, the fluA tree, a caterpillar (one node a level), balanced
    128 and a polytomy."""
    _schedule_against_plain(shape, C, P, top=top, walk=walk)


@pytest.mark.parametrize("shape,C,P", [
    ("balanced", 5, 300), ("caterpillar", 3, 257), ("polytomy", 5, 129),
    ("balanced", 3, 1000)])
def test_kernel_schedule_identity_category(shape, C, P):
    """The same at C = 5 (Gamma4+I) and C = 3 with category 0's P the
    identity on every branch (an invariable category): its partials are
    exactly 0 at every internal node of a variable pattern."""
    _schedule_against_plain(shape, C, P, identity=True)


def _schedule_against_plain(shape, C, P, identity=False, top="auto",
                            walk=None):
    topo = SCHEDULE_TOPOLOGIES[shape]()
    tips, pm, freqs, props, w = (torch.as_tensor(x) for x in
                                 _setup(topo, P, C, seed=2))
    if identity:
        pm[:, 0] = torch.eye(4, dtype=pm.dtype)
    rootw = (props[:, None] * freqs[None, :]).reshape(-1).requires_grad_(True)
    # the plain sweep, differentiated with respect to rootw itself
    pm_ = pm.clone().requires_grad_(True)
    root, scal = pruning_root_levels(tips, pm_, topo, rescale=True)
    ref = torch.log(torch.einsum("cs,csp->p", rootw.view(C, 4), root)) + scal
    ref_dP, ref_drootw = torch.autograd.grad(torch.sum(w * ref), [pm_, rootw])
    n_levels = len(topo.levels)
    level = {"auto": None, "mid": n_levels // 2, "past": n_levels}.get(top,
                                                                      top)
    site, partials, logscale = _emulate_forward(tips, pm, topo,
                                                rootw.detach(), level, walk)
    torch.testing.assert_close(site, ref.detach(), rtol=1e-12, atol=1e-12)
    for sms in SMS:
        dP, drootw = _emulate_backward(tips, pm, topo, rootw.detach(),
                                       partials, logscale, w, sms)
        torch.testing.assert_close(dP, ref_dP, rtol=1e-12,
                                   atol=1e-12 * float(ref_dP.abs().max()))
        torch.testing.assert_close(drootw, ref_drootw, rtol=1e-12,
                                   atol=1e-12)


# level widths of the 128-taxon GTR+G4 config's tree
# (chip_smoke.random_dated_tree(128, 13), 16 291 patterns)
CONFIG_128_WIDTHS = (45, 25, 17, 11, 8, 6, 3, 3, 3, 2, 1, 1, 1, 1)


def _offsets(widths):
    return tuple(int(x) for x in np.cumsum((0,) + tuple(widths)))


def test_walk_level():
    """K3''s switch on the H100's 132 SMs: the S = 4 walk where P x C' is at
    most WALK_S4_PATTERNS, from the first level whose nodes x 128-pattern
    tiles fall under WALK_BLOCKS blocks an SM; else the chain walk from the
    first level of at most CHAIN_NODES nodes; past the last level where no
    level qualifies. The GTR+G4 fluA tree is walked whole (238 patterns),
    the 128-taxon config (16 291 patterns, C = 4) from level 6 (3 nodes),
    balanced 128 x 16 384 from level 5 (2 nodes)."""
    flua = _gtrg4_flua_topology()
    flua_offsets = level_schedule(flua, torch.zeros(1))[1]
    assert staged.walk_level(flua_offsets, 4, 238, 132) == (0, "s4")
    assert staged.forward_launches(flua_offsets, 0) == 1
    config = _offsets(CONFIG_128_WIDTHS)
    assert staged.walk_level(config, 4, 16291, 132) == (6, "chain")
    assert staged.forward_launches(config, 6) == 7
    balanced = _offsets((64, 32, 16, 8, 4, 2, 1))
    assert staged.walk_level(balanced, 4, 16384, 132) == (5, "chain")
    assert staged.forward_launches(balanced, 5) == 6
    # C' x P at the S = 4 walk's limit; the first level under one block an
    # SM of 128-pattern tiles
    assert staged.walk_level(balanced, 4, 4096, 132) == (4, "s4")
    assert staged.walk_level(balanced, 3, 4096, 132) == (4, "s4")
    assert staged.walk_level(balanced, 5, 4096, 132) == (5, "chain")
    assert staged.walk_level(balanced, 1, 16384, 132) == (6, "s4")
    assert staged.walk_level(balanced, 1, 16384, 1) == (7, "s4")
    assert staged.forward_launches(balanced, 7) == 7
    caterpillar = _offsets((1,) * 127)
    assert staged.walk_level(caterpillar, 4, 16384, 132) == (0, "chain")
    assert staged.walk_level(_offsets((5, 4)), 4, 40000, 132) == (2,
                                                                  "chain")


def test_forward_ppt():
    """K3''s patterns a thread below the switch: in float32, 16 bytes of
    each row (8 above C = 4) where P is a multiple of them and the level's
    blocks of 128 threads give every SM VECTOR_BLOCKS, else one."""
    config = _offsets(CONFIG_128_WIDTHS)
    assert staged.forward_ppt(config, 3, 4, 16384, 132, 4) == (4, 4, 4)
    assert staged.forward_ppt(config, 3, 4, 16384, 132, 8) == (1, 1, 1)
    assert staged.forward_ppt(config, 3, 5, 16384, 132, 4) == (2, 2, 2)
    assert staged.forward_ppt(config, 3, 8, 16384, 132, 8) == (1, 1, 1)
    # 16 291 patterns take no vectors; 17 nodes x 28 tiles of 512 patterns
    # fall under 4 blocks an SM of 132
    assert staged.forward_ppt(config, 3, 4, 16291, 132, 4) == (1, 1, 1)
    assert staged.forward_ppt(config, 3, 4, 14336, 132, 4) == (4, 4, 1)
    assert staged.forward_ppt(config, 0, 4, 16384, 132, 4) == ()
    # one tile a node on a card of one SM: the levels of four nodes or more
    assert staged.forward_ppt(config, 14, 4, 300, 1, 4) == (4,) * 6 + (1,) * 8


def test_backward_schedule():
    """level_ppt: at each level the patterns a thread (a power of two up to
    MAX_PPT) with the fewest waves x (FIXED + ppt), so the root's level
    takes one and the leaves' MAX_PPT; backward_rows: each node's block rows
    in turn, a level's blocks from its own patterns a thread."""
    offsets = (0, 64, 96, 112, 120, 124, 126, 127)  # balanced, 128 taxa
    assert staged.block_patterns(4) == 64
    assert [staged.block_patterns(C) for C in (1, 2, 3, 5, 8)] == [
        256, 128, 64, 32, 32]
    ppt = staged.level_ppt(offsets, 4, 16384, 132)
    slots = staged.BLOCKS * 132
    for n, lo, hi in zip(ppt, offsets, offsets[1:]):
        def cost(m):
            blocks = -(-16384 // (64 * m)) * (hi - lo)
            return -(-blocks // slots) * (staged.FIXED + m)
        assert all(cost(n) <= cost(1 << i)
                   for i in range(staged.MAX_PPT.bit_length()))
    assert ppt[0] == staged.MAX_PPT and ppt[-1] == 1
    rows, size = staged.backward_rows(offsets, ppt, 4, 2, 16384)
    nb = [-(-16384 // (64 * n)) for n in ppt]
    assert [b for _, b in rows] == [b for b, lo, hi in zip(
        nb, offsets, offsets[1:]) for _ in range(lo, hi)]
    assert all(b[0] - a[0] == a[1] * 2 * 4 * 16
               for a, b in zip(rows, rows[1:]))
    assert size == sum(b for _, b in rows) * 2 * 4 * 16
    assert staged.level_ppt(offsets, 4, 100, 132) == (1,) * 7


# -- CPU behaviour of the wrappers and the engine routing ---------------------


def test_cpu_runs_plain_version_without_launch():
    """Importing the module builds nothing; a CPU call launches nothing."""
    topo = balanced_topology(8)
    tips, pm, freqs, props, w = (torch.as_tensor(x)
                                 for x in _setup(topo, 50, 4))
    staged.STAGED_FORWARD_LAUNCHES = staged.STAGED_BACKWARD_LAUNCHES = 0
    pm.requires_grad_(True)
    ll, _ = staged.staged_tree_log_likelihood(tips, pm, topo, freqs, props, w)
    ll.backward()
    assert torch.isfinite(pm.grad).all()
    assert staged.STAGED_FORWARD_LAUNCHES == 0
    assert staged.STAGED_BACKWARD_LAUNCHES == 0
    assert staged._lib is None


def test_kernel_wrappers_refuse_cpu_tensors():
    topo = balanced_topology(8)
    tips, pm, freqs, props, _ = (torch.as_tensor(x)
                                 for x in _setup(topo, 50, 4))
    children = torch.as_tensor(topo.children, dtype=torch.int32)
    rootw = (props[:, None] * freqs[None, :]).reshape(-1)
    schedule = level_schedule(topo, tips)
    with pytest.raises(ValueError, match="CUDA tensors"):
        staged.staged_forward(tips, pm, children, rootw, schedule)
    assert staged.STAGED_FORWARD_LAUNCHES == 0


# (C, mean internal nodes per level) on either side of the gate: the fluA
# tree (68 nodes in 33 levels) with C = 4 and 1, a caterpillar at C = 4 (at
# the gate) and 3 (below it), and a balanced 64-taxon tree with C = 1
FLUA = 68 / 33


@pytest.mark.parametrize("engine,device,S,maxc,C,npl,expected", [
    ("auto", "cuda", 4, 2, 4, FLUA, "cuda-staged"),
    ("auto", "cuda", 4, 2, 1, FLUA, "cuda-fused"),
    ("auto", "cuda", 4, 2, 4, 1.0, "cuda-staged"),   # a caterpillar
    ("auto", "cuda", 4, 2, 3, 1.0, "cuda-fused"),
    ("auto", "cuda", 4, 2, 1, 10.5, "cuda-staged"),
    ("auto", "cuda", 4, 2, 2, STAGED_MIN_LEVEL_WORK / 2, "cuda-staged"),
    ("auto", "cuda", 4, 2, 1, STAGED_MIN_LEVEL_WORK - 0.01, "cuda-fused"),
    ("cuda", "cuda", 4, 2, 4, 18.0, "cuda-staged"),
    ("auto", "cuda", 4, 3, 4, 18.0, "cuda-loop"),    # polytomies: K5'/K6'
    ("auto", "cuda", 20, 2, 4, 18.0, "cuda-wide"),
    ("auto", "cpu", 4, 2, 4, 18.0, "torch"),
    ("torch", "cuda", 4, 2, 4, 18.0, "torch"),
    ("cuda-staged", "cuda", 4, 3, 1, 1.0, "cuda-staged"),
    ("cuda-fused", "cuda", 4, 2, 4, 18.0, "cuda-fused"),
    ("cuda-wide", "cuda", 4, 2, 1, 1.0, "cuda-wide"),
    # named pairs at S != 4: the level-staged sweep (csrc/wide.cu's level
    # kernels) and K1'/K2' in category-split mode
    ("cuda-staged", "cuda", 20, 2, 4, 18.0, "cuda-staged"),
    ("cuda-fused", "cuda", 61, 2, 1, 1.0, "cuda-fused"),
])
def test_engine_routing(engine, device, S, maxc, C, npl, expected):
    """The measured rule: staged on a binary S = 4 tree where C times the
    mean internal nodes per level reaches STAGED_MIN_LEVEL_WORK, fused
    below it, wide for any other S; each named kernel pair can be
    forced, at any S from 2 to 64."""
    assert select_engine(engine, device, S, maxc, C, npl) == expected


@pytest.mark.parametrize("engine,device,S", [
    ("cuda-staged", "cuda", 65), ("cuda-fused", "cuda", 65),
    ("cuda-wide", "cuda", 65), ("cuda-staged", "cpu", 4),
    ("pallas-staged", "cuda", 4)])
def test_engine_routing_refuses(engine, device, S):
    """A named kernel that cannot take the shape (S past the kernels' 64),
    or a CUDA engine on the CPU, raises; so does a JAX engine name (the
    builder maps those)."""
    with pytest.raises(ValueError):
        select_engine(engine, device, S, 2, 4, 18.0)


def test_engine_name_reads_the_gate_inputs(monkeypatch):
    """``engine_name`` gives the gate the model's own state count, widest
    node, categories and mean internal nodes per level."""
    from physher_tpu_torch.models import treelikelihood as tl

    seen = []
    monkeypatch.setattr(tl, "select_engine",
                        lambda *a: seen.append(a) or "torch")
    kw = dict(dtype=torch.float64, device="cpu")
    topo = balanced_topology(16)
    sp = random_sitepattern(16, 40, seed=1)
    TreeLikelihood(sp, topo, JC69(**kw),
                   GammaSiteModel(4, **kw), **kw).engine_name()
    assert seen == [("auto", "cpu", 4, 2, 4, 15 / 4)]


def test_engine_name_on_cpu():
    kw = dict(dtype=torch.float64, device="cpu")
    topo = balanced_topology(8)
    sp = random_sitepattern(8, 40, seed=1)
    assert TreeLikelihood(sp, topo, JC69(**kw), **kw).engine_name() == "torch"
    forced = TreeLikelihood(sp, topo, JC69(**kw), engine="cuda-staged", **kw)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        forced(forced.param_space().init_params(**kw))
