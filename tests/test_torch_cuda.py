"""The CUDA pruning kernels (K1'/K2' of ops/fused.py at S = 4 and, in the
packed and category-split modes, at S from 2 to 64, K3'/K4' of
ops/staged.py, K5'/K6' of ops/loop.py at S = 4 and at S from 2 to 64,
K7'/K8' of ops/wide.py) against their plain PyTorch version, on the card;
the forward of K5' at S != 4 and K7' (thread-block clusters of the C
category blocks) also at every cluster size, bit for bit run to run; K6'
at S = 4 and K2' (their shared reverse step, csrc/s4_backward.cuh) and K5'
at S = 4 and K1' (their shared forward step, csrc/s4_forward.cuh) also on
large trees and bit for bit run to run, the forward also at C from 1 to 8
and refusing a malformed schedule.

Marked ``cuda``: each test skips without a CUDA device. On a machine with
one (and nvcc), run them with ``python -m pytest -m cuda
tests/test_torch_cuda.py``; this file imports no JAX. Tolerances: float64
rounding only (1e-12 of the largest entry); float32 those of
tests/test_fused_engine.py (site logs rtol 5e-4 / atol 1e-4, gradients rtol
5e-3 with a floor of 1e-3 of the largest entry).
"""

import numpy as np
import pytest
import torch

from physher_tpu_torch.ops import cuda_build, fused, loop, staged, wide
from physher_tpu_torch.ops.pruning import pruning_root_levels
from physher_tpu_torch.trees.topology import Topology
from physher_tpu_torch.utils.synthetic import (
    balanced_topology, caterpillar_topology)

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _polytomy():
    """A root with three children, one of them a 4-way polytomy."""
    def tip(i):
        return {"name": f"t{i}", "length": 0.1, "children": []}
    nested = {"name": None, "children": [
        {"name": None, "length": 0.2, "children": [tip(0), tip(1), tip(2),
                                                   tip(3)]},
        {"name": None, "length": 0.1, "children": [tip(4), tip(5)]},
        tip(6)]}
    return Topology.from_nested(nested)[0]


def _inputs(topo, P, C, dtype, device, seed=0, S=4):
    rng = np.random.default_rng(seed)
    states = rng.integers(0, S, (topo.T, P))
    tips = np.eye(S)[states].transpose(0, 2, 1)
    tips[:, :, -3:] = 1.0                     # pad-like all-ones columns
    Q = rng.random((topo.N, C, S, S)) + 0.1
    arrays = (tips, Q / Q.sum(-1, keepdims=True), rng.dirichlet(np.ones(S)),
              rng.dirichlet(np.ones(C)), rng.uniform(0.5, 2.0, P))
    return [torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                            device=device) for a in arrays]


def _value_and_grad(fn, topo, tips, pm, freqs, props, w):
    leaves = [x.clone().requires_grad_(True) for x in (pm, freqs, props)]
    site = fn(tips, leaves[0], topo, leaves[1], leaves[2])
    grads = torch.autograd.grad(torch.sum(w * site), leaves)
    return site.detach(), grads


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape,P,C", [
    ("balanced", 300, 4), ("balanced", 128, 1), ("polytomy", 257, 3)])
def test_kernels_match_plain(device, dtype, shape, P, C):
    topo = balanced_topology(16) if shape == "balanced" else _polytomy()
    inputs = _inputs(topo, P, C, dtype, device)
    f0, b0 = fused.FORWARD_LAUNCHES, fused.BACKWARD_LAUNCHES
    site_k, grads_k = _value_and_grad(fused.fused_site_log, topo, *inputs)
    assert (fused.FORWARD_LAUNCHES, fused.BACKWARD_LAUNCHES) == (f0 + 1,
                                                                 b0 + 1)
    site_p, grads_p = _value_and_grad(fused.fused_site_log_reference, topo,
                                      *inputs)
    if dtype == torch.float64:
        rtol, atol, grtol = 1e-12, 1e-12, 1e-12
    else:
        rtol, atol, grtol = 5e-4, 1e-4, 5e-3
    torch.testing.assert_close(site_k, site_p, rtol=rtol, atol=atol)
    for a, b in zip(grads_k, grads_p):
        torch.testing.assert_close(a, b, rtol=grtol,
                                   atol=grtol * float(b.abs().max()))


def test_wrapper_rejects_bad_input(device):
    topo = balanced_topology(8)
    tips, pm, freqs, props, _ = _inputs(topo, 64, 4, torch.float32, device)
    children = torch.as_tensor(topo.children, device=device)
    rootw = (props[:, None] * freqs[None, :]).reshape(-1)
    schedule = cuda_build.postorder_schedule(topo, tips)
    with pytest.raises(ValueError, match="dtype"):
        fused.pruning_forward(tips, pm.double(), children, rootw, schedule)
    with pytest.raises(ValueError, match="contiguous"):
        fused.pruning_forward(tips, pm.transpose(2, 3), children, rootw,
                              schedule)
    with pytest.raises(ValueError, match="rate categories"):
        fused.pruning_forward(tips, pm.repeat(1, 3, 1, 1).contiguous(),
                              children, rootw.repeat(3), schedule)


def _tolerances(dtype):
    """(site rtol, site atol, gradient rtol) as in the module docstring."""
    return (1e-12, 1e-12, 1e-12) if dtype == torch.float64 else \
        (5e-4, 1e-4, 5e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape,S,C,P", [
    ("balanced", 61, 1, 300), ("balanced", 20, 4, 257),
    ("caterpillar", 61, 4, 129), ("caterpillar", 20, 1, 64),
    ("polytomy", 5, 4, 300), ("polytomy", 20, 1, 100),
    ("balanced", 5, 1, 33),
    # with those, one case per tile shape of K8' (A rows a thread: 2 to 16
    # at S <= 32, 5 to 8 above), C = 8, polytomies up to 16 children
    ("balanced", 2, 1, 77), ("caterpillar", 12, 8, 100),
    ("balanced", 16, 4, 130), ("caterpillar", 28, 1, 77),
    ("balanced", 24, 8, 45), ("balanced", 32, 2, 161),
    ("polytomy", 33, 1, 95), ("balanced", 48, 1, 70),
    ("caterpillar", 56, 2, 45), ("star", 64, 2, 99),
    ("star", 20, 8, 50), ("polytomy", 40, 8, 300),
    # enough patterns that the lower levels of the 16-taxon tree outgrow one
    # block an SM, so that K8' takes a whole node a block there (its child a
    # block above)
    ("balanced", 20, 4, 2048), ("balanced", 32, 8, 2048),
    ("balanced", 61, 4, 2100)])
def test_wide_kernels_match_plain(device, dtype, shape, S, C, P):
    """K7'/K8' against the plain version: S from 2 to 64 (every tile shape
    of K8'), C in {1, 2, 4, 8}, balanced, caterpillar and polytomy trees (up
    to 16 children), ragged P, levels of a node a block and of a child a
    block."""
    topo = {"balanced": lambda: balanced_topology(16),
            "caterpillar": lambda: caterpillar_topology(12),
            "polytomy": _polytomy, "star": _star}[shape]()
    inputs = _inputs(topo, P, C, dtype, device, S=S)
    f0, b0 = wide.WIDE_FORWARD_LAUNCHES, wide.WIDE_BACKWARD_LAUNCHES
    site_k, grads_k = _value_and_grad(wide.wide_site_log, topo, *inputs)
    assert (wide.WIDE_FORWARD_LAUNCHES,
            wide.WIDE_BACKWARD_LAUNCHES) == (f0 + 1, b0 + 1)
    site_p, grads_p = _value_and_grad(wide.wide_site_log_reference, topo,
                                      *inputs)
    rtol, atol, grtol = _tolerances(dtype)
    torch.testing.assert_close(site_k, site_p, rtol=rtol, atol=atol)
    for a, b in zip(grads_k, grads_p):
        torch.testing.assert_close(a, b, rtol=grtol,
                                   atol=grtol * float(b.abs().max()))


def _wide_args(device, S=20, C=4, dtype=torch.float32):
    topo = balanced_topology(8)
    tips, pm, freqs, props, _ = _inputs(topo, 64, C, dtype, device, S=S)
    children = torch.as_tensor(topo.children, device=device)
    rootw = (props[:, None] * freqs[None, :]).reshape(-1)
    return tips, pm, children, rootw, cuda_build.level_schedule(topo, tips)


def test_wide_wrapper_rejects_bad_input(device):
    tips, pm, children, rootw, schedule = _wide_args(device)
    n0 = wide.WIDE_FORWARD_LAUNCHES
    with pytest.raises(ValueError, match="dtype"):
        wide.wide_forward(tips, pm.double(), children, rootw, schedule)
    with pytest.raises(ValueError, match="contiguous"):
        wide.wide_forward(tips, pm.transpose(2, 3), children, rootw,
                          schedule)
    with pytest.raises(ValueError, match="rate categories"):
        wide.wide_forward(tips, pm.repeat(1, 3, 1, 1).contiguous(),
                          children, rootw.repeat(3), schedule)
    with pytest.raises(ValueError, match="states"):
        wide.wide_forward(*_wide_args(device, S=65, C=1))
    with pytest.raises(ValueError, match="states"):
        wide.wide_forward(*_wide_args(device, S=1, C=1))
    assert wide.WIDE_FORWARD_LAUNCHES == n0


STAGED_TOPOLOGIES = {"balanced": lambda: balanced_topology(16),
                     "balanced64": lambda: balanced_topology(64),
                     "caterpillar": lambda: caterpillar_topology(12),
                     "polytomy": _polytomy}


def _forced_walk(name, n_levels):
    """A forced switch to K3''s walk: (level 0, a middle level, or past the
    last level: no walk; the walk)."""
    walk, _, at = name.partition("-")
    return {"0": 0, "mid": n_levels // 2, "": n_levels}[at], walk


@pytest.mark.parametrize("schedule", ["card", "max-ppt", "s4-0", "s4-mid",
                                      "chain-0", "chain-mid", "none"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape,P,C", [
    ("balanced", 300, 4), ("balanced", 128, 1), ("caterpillar", 257, 4),
    ("caterpillar", 64, 1), ("polytomy", 129, 3), ("balanced", 8192 + 37, 4),
    ("balanced", 1000 + 3, 4), ("balanced", 37, 8), ("balanced", 2000, 1),
    ("caterpillar", 700, 8), ("polytomy", 1500, 4),
    ("balanced64", 20000 + 5, 4), ("balanced64", 20000, 5)])
def test_staged_kernels_match_plain(device, dtype, shape, P, C, schedule,
                                    monkeypatch, request):
    """K3'/K4' against the plain version: balanced, caterpillar and polytomy
    trees, C in {1, 3, 4, 5, 8}, ragged P, P under one block; K3''s switch
    to its walk and K4''s patterns a thread as walk_level and level_ppt pick
    them for this card, K4' at MAX_PPT at every level ("max-ppt"), and each
    walk forced from level 0 and a middle level, and no walk."""
    if schedule == "max-ppt":
        monkeypatch.setattr(staged, "level_ppt", lambda offsets, *_: (
            staged.MAX_PPT,) * (len(offsets) - 1))
        staged._backward_plan.cache_clear()
        request.addfinalizer(staged._backward_plan.cache_clear)
    elif schedule != "card":
        monkeypatch.setattr(staged, "walk_level", lambda offsets, *_: (
            _forced_walk("s4-" if schedule == "none" else schedule,
                         len(offsets) - 1)))
    topo = STAGED_TOPOLOGIES[shape]()
    inputs = _inputs(topo, P, C, dtype, device)
    f0, b0 = staged.STAGED_FORWARD_LAUNCHES, staged.STAGED_BACKWARD_LAUNCHES
    site_k, grads_k = _value_and_grad(staged.staged_site_log, topo, *inputs)
    assert (staged.STAGED_FORWARD_LAUNCHES,
            staged.STAGED_BACKWARD_LAUNCHES) == (f0 + 1, b0 + 1)
    site_p, grads_p = _value_and_grad(staged.staged_site_log_reference, topo,
                                      *inputs)
    rtol, atol, grtol = _tolerances(dtype)
    torch.testing.assert_close(site_k, site_p, rtol=rtol, atol=atol)
    for a, b in zip(grads_k, grads_p):
        torch.testing.assert_close(a, b, rtol=grtol,
                                   atol=grtol * float(b.abs().max()))


def _chains(topo, P, C, L, dtype, device, seed=0, S=4):
    """Tips [T,S,P] and L chains' pmats [L,N,C,S,S], freqs [L,S], props
    [L,C], and a cotangent [L,P]."""
    rng = np.random.default_rng(seed)
    tips = np.eye(S)[rng.integers(0, S, (topo.T, P))].transpose(0, 2, 1)
    tips[:, :, -3:] = 1.0
    Q = rng.random((L, topo.N, C, S, S)) + 0.1
    arrays = (tips, Q / Q.sum(-1, keepdims=True),
              rng.dirichlet(np.ones(S), L), rng.dirichlet(np.ones(C), L),
              rng.uniform(0.5, 2.0, (L, P)))
    return [torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                            device=device) for a in arrays]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape,P,C,L,rescale", [
    ("balanced", 300, 4, 3, True), ("balanced", 238, 1, 16, True),
    ("caterpillar", 64, 1, 2, False), ("polytomy", 257, 3, 1, True),
    ("polytomy", 100, 2, 4, False)])
def test_loop_kernels_match_plain(device, dtype, shape, P, C, L, rescale):
    """K5'/K6' against the plain version: L chains, balanced, caterpillar
    and polytomy trees, C in {1, 2, 3, 4}, rescale on and off, ragged P;
    d pmats, d freqs and d props."""
    topo = {"balanced": lambda: balanced_topology(16),
            "caterpillar": lambda: caterpillar_topology(12),
            "polytomy": _polytomy}[shape]()
    tips, pm, freqs, props, g = _chains(topo, P, C, L, dtype, device)

    def run(fn):
        leaves = [x.clone().requires_grad_(True) for x in (pm, freqs, props)]
        site = fn(leaves)
        return site.detach(), torch.autograd.grad(torch.sum(g * site),
                                                  leaves)
    f0, b0 = loop.LOOP_FORWARD_LAUNCHES, loop.LOOP_BACKWARD_LAUNCHES
    site_k, grads_k = run(lambda x: loop.loop_site_log(topo, rescale, tips,
                                                       *x))
    assert (loop.LOOP_FORWARD_LAUNCHES,
            loop.LOOP_BACKWARD_LAUNCHES) == (f0 + 1, b0 + 1)
    site_p, grads_p = run(lambda x: loop.loop_site_log_reference(
        tips, x[0], topo, x[1], x[2], rescale=rescale))
    rtol, atol, grtol = _tolerances(dtype)
    torch.testing.assert_close(site_k, site_p, rtol=rtol, atol=atol)
    for a, b in zip(grads_k, grads_p):
        torch.testing.assert_close(a, b, rtol=grtol,
                                   atol=grtol * float(b.abs().max()))


def _star():
    """A root with 16 children (K6''s largest maxc): 15 tips and a
    cherry."""
    def tip(i):
        return {"name": f"t{i}", "length": 0.1, "children": []}
    return Topology.from_nested({"name": None, "children": [
        *(tip(i) for i in range(15)),
        {"name": None, "length": 0.1, "children": [tip(15), tip(16)]}]})[0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape,S,C,L,P,rescale", [
    ("balanced", 5, 4, 3, 300, True), ("balanced", 20, 4, 3, 257, True),
    ("balanced", 61, 1, 1, 129, True), ("caterpillar", 61, 1, 3, 64, False),
    ("polytomy", 20, 1, 3, 100, False), ("polytomy", 5, 4, 1, 33, True),
    # with those, one case per instantiation of K6' (A rows a thread: 2 to
    # 16 at S <= 32, 5 to 8 above), C = 8 and maxc = 16
    ("balanced", 2, 1, 2, 77, False), ("caterpillar", 12, 8, 2, 100, True),
    ("balanced", 16, 4, 2, 130, False), ("caterpillar", 28, 1, 2, 77, True),
    ("balanced", 24, 8, 1, 45, False), ("balanced", 32, 2, 2, 161, True),
    ("polytomy", 33, 1, 2, 95, True), ("balanced", 48, 1, 1, 70, False),
    ("caterpillar", 56, 2, 1, 45, True), ("star", 64, 2, 2, 99, False),
    ("star", 20, 8, 1, 50, True)])
def test_loop_wide_kernels_match_plain(device, dtype, shape, S, C, L, P,
                                       rescale):
    """K5'/K6' at S != 4 (loop_wide_*_kernel) against the plain version:
    S from 2 to 64 (every instantiation of K6'), C in {1, 2, 4, 8},
    L in {1, 2, 3}, balanced, caterpillar and polytomy trees (up to 16
    children), rescale on and off, ragged P."""
    topo = {"balanced": lambda: balanced_topology(16),
            "caterpillar": lambda: caterpillar_topology(12),
            "polytomy": _polytomy, "star": _star}[shape]()
    tips, pm, freqs, props, g = _chains(topo, P, C, L, dtype, device, S=S)

    def run(fn):
        leaves = [x.clone().requires_grad_(True) for x in (pm, freqs, props)]
        site = fn(leaves)
        return site.detach(), torch.autograd.grad(torch.sum(g * site),
                                                  leaves)
    f0, b0 = loop.LOOP_FORWARD_LAUNCHES, loop.LOOP_BACKWARD_LAUNCHES
    site_k, grads_k = run(lambda x: loop.loop_site_log(topo, rescale, tips,
                                                       *x))
    torch.cuda.synchronize()
    assert (loop.LOOP_FORWARD_LAUNCHES,
            loop.LOOP_BACKWARD_LAUNCHES) == (f0 + 1, b0 + 1)
    site_p, grads_p = run(lambda x: loop.loop_site_log_reference(
        tips, x[0], topo, x[1], x[2], rescale=rescale))
    rtol, atol, grtol = _tolerances(dtype)
    torch.testing.assert_close(site_k, site_p, rtol=rtol, atol=atol)
    for a, b in zip(grads_k, grads_p):
        torch.testing.assert_close(a, b, rtol=grtol,
                                   atol=grtol * float(b.abs().max()))


def test_loop_wide_backward_is_deterministic(device):
    """K6' at S != 4 sums without atomics: two launches on the same inputs
    give bit-identical d pmats, d freqs and d props."""
    topo = balanced_topology(16)
    tips, pm, freqs, props, g = _chains(topo, 1000, 4, 2, torch.float32,
                                        device, S=20)
    children = torch.as_tensor(topo.children, dtype=torch.int32,
                               device=device)
    _, partials, scale = loop.loop_forward(
        tips, pm, children, freqs, props,
        cuda_build.postorder_schedule(topo, tips))
    schedule = cuda_build.preorder_schedule(topo, tips)
    runs = [loop.loop_backward(tips, pm, children, freqs, props, schedule,
                               partials, scale, g) for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def _s4_backward_runs(topo, P, C, L, dtype, device, runs=1):
    """K6' at S = 4 (L chains) and K2' (chain 0) on the same inputs after
    their forwards, each ``runs`` times: ([K6' outputs], [K2' outputs]),
    the plain version's gradients for both, and the launch counts."""
    tips, pm, freqs, props, g = _chains(topo, P, C, L, dtype, device)
    children = torch.as_tensor(topo.children, dtype=torch.int32,
                               device=device)
    rootw = (props[0][:, None] * freqs[0][None, :]).reshape(-1)
    pm0, g0 = pm[0].contiguous(), g[0].contiguous()
    postorder = cuda_build.postorder_schedule(topo, tips)
    _, part, sc = loop.loop_forward(tips, pm, children, freqs, props,
                                    postorder)
    _, part0, sc0 = fused.pruning_forward(tips, pm0, children, rootw,
                                          postorder)
    schedule = cuda_build.preorder_schedule(topo, tips)
    n6, n2 = loop.LOOP_BACKWARD_LAUNCHES, fused.BACKWARD_LAUNCHES
    k6 = [loop.loop_backward(tips, pm, children, freqs, props, schedule,
                             part, sc, g) for _ in range(runs)]
    k2 = [fused.pruning_backward(tips, pm0, children, rootw, schedule, part0,
                                 sc0, g0) for _ in range(runs)]
    torch.cuda.synchronize()
    launches = (loop.LOOP_BACKWARD_LAUNCHES - n6,
                fused.BACKWARD_LAUNCHES - n2)
    leaves = [x.clone().requires_grad_(True) for x in (pm, freqs, props)]
    site = loop.loop_site_log_reference(tips, leaves[0], topo, leaves[1],
                                        leaves[2])
    plain6 = torch.autograd.grad(torch.sum(g * site), leaves)
    leaves0 = [x.clone().requires_grad_(True) for x in (pm0, rootw)]
    root, scal = pruning_root_levels(tips, leaves0[0], topo, rescale=True)
    site0 = torch.log(torch.einsum("cs,csp->p", leaves0[1].view(-1, 4),
                                   root)) + scal
    plain2 = torch.autograd.grad(torch.sum(g0 * site0), leaves0)
    return k6, k2, plain6, plain2, launches


def _merged_tree(n_tips, max_children, seed):
    """A random tree: groups of 2 to ``max_children`` lineages, picked at
    random, merge until one is left."""
    rng = np.random.default_rng(seed)
    nodes = [{"name": f"t{i}", "length": 0.1, "children": []}
             for i in range(n_tips)]
    while len(nodes) > 1:
        k = min(len(nodes), int(rng.integers(2, max_children + 1)))
        picked = sorted(rng.choice(len(nodes), k, replace=False),
                        reverse=True)
        merged = {"name": None, "length": 0.1,
                  "children": [nodes.pop(i) for i in picked]}
        nodes.append(merged)
    return Topology.from_nested(nodes[0])[0]


@pytest.mark.parametrize("tree,P,C,dtype,from_device", [
    ("caterpillar-128", 16384, 1, torch.float32, ""),
    ("caterpillar-128", 16384, 1, torch.float64, ""),
    ("caterpillar-128", 16384, 2, torch.float32, ""),
    ("caterpillar-128", 16384, 2, torch.float64, ""),
    ("balanced-1024", 300, 3, torch.float64, "P"),
    ("balanced-1024", 300, 3, torch.float32, "P"),
    ("binary-4200", 300, 3, torch.float32, "P, tables"),
    ("binary-4200", 300, 3, torch.float64, "P, tables"),
    ("polytomies-6000", 300, 3, torch.float32, "P, tables")])
def test_s4_backward_large_trees(device, tree, P, C, dtype, from_device):
    """K6' at S = 4 (2 chains) and K2' against the plain version, one launch
    count a wrapper call, on large trees: a 128-taxon caterpillar with
    16 384 patterns (127 preorder levels of one node, eight dP chunks), and
    trees whose walk reads from device memory what it keeps in shared
    memory on smaller ones (``from_device``, csrc/s4_backward.cuh): one
    chain's P matrices past 96 KB (1536 nodes in float32, 768 in float64;
    row stride C x 16), the index tables past 48 KB (levels + 1 +
    I (1 + maxc) ints: about 4100 internal nodes of a binary tree, 2460
    with up to 4 children)."""
    topo = {"caterpillar-128": lambda: caterpillar_topology(128),
            "balanced-1024": lambda: balanced_topology(1024),
            "binary-4200": lambda: _merged_tree(4200, 2, 5),
            "polytomies-6000": lambda: _merged_tree(6000, 4, 6)}[tree]()
    maxc = topo.children.shape[1]
    tables = (len(topo.preorder_levels) + 1 + topo.I * (1 + maxc)) * 4
    assert (topo.N * 16 * dtype.itemsize > 96 * 1024,
            tables > 48 * 1024) == ("P" in from_device,
                                    "tables" in from_device)
    k6, k2, plain6, plain2, launches = _s4_backward_runs(topo, P, C, 2,
                                                         dtype, device)
    assert launches == (1, 1)
    grtol = _tolerances(dtype)[2]
    for got, want in ((k6[0], plain6), (k2[0], plain2)):
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=grtol,
                                       atol=grtol * float(b.abs().max()))


def test_s4_backward_is_deterministic(device):
    """K6' at S = 4 and K2' sum in fixed orders with no atomics: two
    launches on the same inputs give bit-identical d pmats and d freqs,
    d props or d rootw (one dP chunk at 1000 patterns, three at 5000;
    binary and polytomy trees)."""
    for topo, P, C, L in ((balanced_topology(64), 1000, 4, 4),
                          (caterpillar_topology(32), 5000, 2, 3),
                          (_polytomy(), 4100, 3, 2)):
        k6, k2, *_ = _s4_backward_runs(topo, P, C, L, torch.float32, device,
                                       runs=2)
        for runs in (k6, k2):
            for a, b in zip(*runs):
                assert torch.equal(a, b)


# K1' and K5' at S = 4 share one forward step (csrc/s4_forward.cuh): a walk
# by postorder level, a pattern's C x 4 values on 4 C' lanes (C' = C rounded
# up to 1, 2, 4 or 8, the padded lanes idle): (shape, P, C, L, rescale)
S4_FORWARD_CASES = [
    ("balanced", 300, 1, 1, True), ("balanced", 300, 2, 3, False),
    ("balanced", 257, 3, 16, True), ("caterpillar", 1, 4, 3, True),
    ("caterpillar", 100, 5, 1, False), ("polytomy", 257, 6, 3, True),
    ("star", 300, 7, 16, False), ("star", 129, 8, 1, True)]


def _s4_forward_runs(topo, tips, pm, freqs, props, rescale, runs=1):
    """K5' at S = 4 (L chains) and K1' (chain 0, always rescaled) by the
    postorder schedule, each ``runs`` times, and the launch counts."""
    children = torch.as_tensor(topo.children, dtype=torch.int32,
                               device=tips.device)
    schedule = cuda_build.postorder_schedule(topo, tips)
    rootw = (props[0][:, None] * freqs[0][None, :]).reshape(-1)
    pm0 = pm[0].contiguous()
    n5, n1 = loop.LOOP_FORWARD_LAUNCHES, fused.FORWARD_LAUNCHES
    k5 = [loop.loop_forward(tips, pm, children, freqs, props, schedule,
                            rescale) for _ in range(runs)]
    k1 = [fused.pruning_forward(tips, pm0, children, rootw, schedule)
          for _ in range(runs)]
    torch.cuda.synchronize()
    return k5, k1, (loop.LOOP_FORWARD_LAUNCHES - n5,
                    fused.FORWARD_LAUNCHES - n1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape,P,C,L,rescale", S4_FORWARD_CASES)
def test_s4_forward_matches_plain(device, dtype, shape, P, C, L, rescale):
    """K5' at S = 4 and K1' against the plain version: C from 1 to 8 (padded
    lane groups at 3, 5, 6, 7), P not a multiple of a block (and P = 1),
    L = 1, 3 and 16, binary trees and polytomies of up to 16 children,
    rescale on and off; one launch a wrapper call; the rescaled partials
    peak at exactly 1 over (C, 4) at every node and pattern (the lane
    group's max), unrescaled scalers are 1, and K1''s partials and scalers
    are K5''s of chain 0, bit for bit."""
    topo = {"balanced": lambda: balanced_topology(16),
            "caterpillar": lambda: caterpillar_topology(12),
            "polytomy": _polytomy, "star": _star}[shape]()
    tips, pm, freqs, props, _ = _chains(topo, P, C, L, dtype, device)
    (k5,), (k1,), launches = _s4_forward_runs(topo, tips, pm, freqs, props,
                                              rescale)
    assert launches == (1, 1)
    rtol, atol, _ = _tolerances(dtype)
    ref = loop.loop_site_log_reference(tips, pm, topo, freqs, props,
                                       rescale=rescale)
    torch.testing.assert_close(k5[0], ref, rtol=rtol, atol=atol)
    _check_rescaled(k5[1], k5[2], rescale, (2, 3))
    ref0 = loop.loop_site_log_reference(tips, pm[0], topo, freqs[0],
                                        props[0])
    torch.testing.assert_close(k1[0], ref0, rtol=rtol, atol=atol)
    _check_rescaled(k1[1], k1[2], True, (1, 2))
    if rescale:
        assert torch.equal(k1[1], k5[1][0]) and torch.equal(k1[2], k5[2][0])


@pytest.mark.parametrize("tree,P,C,dtype,from_device", [
    ("caterpillar-128", 16384, 1, torch.float32, ""),
    ("caterpillar-128", 16384, 2, torch.float64, ""),
    ("balanced-1024", 300, 3, torch.float64, "P"),
    ("binary-4200", 300, 1, torch.float32, "P, tables"),
    ("polytomies-6000", 300, 3, torch.float32, "P, tables")])
def test_s4_forward_large_trees(device, tree, P, C, dtype, from_device):
    """K5' at S = 4 (2 chains) and K1' against the plain version on large
    trees: a 128-taxon caterpillar with 16 384 patterns (127 postorder
    levels of one node), and trees whose walk reads from device memory what
    it keeps in shared memory on smaller ones (``from_device``,
    csrc/s4_forward.cuh): one chain's P matrices past 96 KB (N x C x 16
    scalars), the index tables past 48 KB (levels + 1 + I (1 + maxc)
    ints)."""
    topo = {"caterpillar-128": lambda: caterpillar_topology(128),
            "balanced-1024": lambda: balanced_topology(1024),
            "binary-4200": lambda: _merged_tree(4200, 2, 5),
            "polytomies-6000": lambda: _merged_tree(6000, 4, 6)}[tree]()
    maxc = topo.children.shape[1]
    tables = (len(topo.levels) + 1 + topo.I * (1 + maxc)) * 4
    assert (topo.N * C * 16 * dtype.itemsize > 96 * 1024,
            tables > 48 * 1024) == ("P" in from_device,
                                    "tables" in from_device)
    tips, pm, freqs, props, _ = _chains(topo, P, C, 2, dtype, device)
    (k5,), (k1,), launches = _s4_forward_runs(topo, tips, pm, freqs, props,
                                              True)
    assert launches == (1, 1)
    rtol, atol, _ = _tolerances(dtype)
    ref = loop.loop_site_log_reference(tips, pm, topo, freqs, props)
    torch.testing.assert_close(k5[0], ref, rtol=rtol, atol=atol)
    torch.testing.assert_close(k1[0], ref[0], rtol=rtol, atol=atol)
    _check_rescaled(k5[1], k5[2], True, (2, 3))
    assert torch.equal(k1[1], k5[1][0]) and torch.equal(k1[2], k5[2][0])


def test_s4_forward_is_deterministic(device):
    """K5' at S = 4 and K1' sum in fixed orders with no atomics: two
    launches on the same inputs give bit-identical site logs, partials and
    scalers (binary trees and a polytomy, C = 2 to 4)."""
    for topo, P, C, L in ((balanced_topology(64), 1000, 4, 4),
                          (caterpillar_topology(32), 5000, 2, 3),
                          (_polytomy(), 4100, 3, 2)):
        tips, pm, freqs, props, _ = _chains(topo, P, C, L, torch.float32,
                                            device)
        k5, k1, _ = _s4_forward_runs(topo, tips, pm, freqs, props, True,
                                     runs=2)
        for runs in (k5, k1):
            for a, b in zip(*runs):
                assert torch.equal(a, b)


def test_s4_forward_rejects_bad_schedule(device):
    """K1' and K5' refuse a schedule of another tree, on another device, in
    another dtype or with more level offsets than nodes, and launch
    nothing."""
    topo = balanced_topology(8)
    tips, pm, freqs, props, _ = _chains(topo, 64, 2, 2, torch.float32,
                                        device)
    children = torch.as_tensor(topo.children, dtype=torch.int32,
                               device=device)
    rootw = (props[0][:, None] * freqs[0][None, :]).reshape(-1)
    order, offsets = cuda_build.postorder_schedule(topo, tips)
    bad = [(cuda_build.postorder_schedule(balanced_topology(9), tips),
            "order has shape"),
           ((order.cpu(), offsets), "order is on cpu"),
           ((order, offsets.long()), "offsets has dtype"),
           ((order, torch.zeros(topo.I + 2, dtype=torch.int32,
                                device=device)), "level offsets")]
    n5, n1 = loop.LOOP_FORWARD_LAUNCHES, fused.FORWARD_LAUNCHES
    for schedule, match in bad:
        with pytest.raises(ValueError, match=match):
            loop.loop_forward(tips, pm, children, freqs, props, schedule)
        with pytest.raises(ValueError, match=match):
            fused.pruning_forward(tips, pm[0].contiguous(), children, rootw,
                                  schedule)
    assert (loop.LOOP_FORWARD_LAUNCHES, fused.FORWARD_LAUNCHES) == (n5, n1)


def test_wide_backward_is_deterministic(device):
    """K8' sums without atomics: two launches on the same inputs give
    bit-identical d pmats and d rootw."""
    topo = balanced_topology(16)
    children = torch.as_tensor(topo.children, dtype=torch.int32,
                               device=device)
    for S, C in ((20, 4), (61, 1)):
        tips, pm, freqs, props, g = _inputs(topo, 1000, C, torch.float32,
                                            device, S=S)
        rootw = (props[:, None] * freqs[None, :]).reshape(-1)
        schedule = cuda_build.level_schedule(topo, tips)
        _, partials, scale = wide.wide_forward(tips, pm, children, rootw,
                                               schedule)
        runs = [wide.wide_backward(tips, pm, children, rootw, schedule,
                                   partials, scale, g) for _ in range(2)]
        for a, b in zip(*runs):
            assert torch.equal(a, b)


def _polytomy3():
    """Internal nodes of two and three children (maxc 3)."""
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


# K1'/K2' at any other S than 4 (csrc/pruning.cu fused_wide_*_kernel: one
# launch a sweep, the node steps of K5'/K6' spread over the card by the
# schedules of ops/fused.forward_plan / backward_plan), in the TPU
# wrapper's two modes: (shape, S, C, P, split) with the split cases of the
# TPU kernel's tests (S = 20, C = 4; S = 61, C = 1), packed at S = 20,
# C = 1, split at S = 4, both step shapes, C up to 8, polytomies (maxc 3
# and 4), ragged P and several backward blocks, and chains: a 128-taxon
# caterpillar (127 nodes in a row) packed and split, at more (item,
# pattern block) pairs than the persistent grid holds
FUSED_WIDE_CASES = [
    ("balanced", 20, 4, 300, True), ("balanced", 61, 1, 257, True),
    ("caterpillar", 20, 1, 129, False), ("polytomy", 20, 4, 300, True),
    ("polytomy", 61, 2, 95, True), ("balanced", 5, 3, 300, False),
    ("star", 33, 8, 2049, False), ("balanced", 4, 4, 300, True),
    ("caterpillar", 12, 8, 77, True), ("balanced", 64, 2, 130, False),
    ("balanced", 20, 4, 2048, False), ("star", 61, 3, 600, True),
    ("caterpillar128", 20, 1, 8192, False),
    ("caterpillar128", 61, 2, 1000, True),
    ("polytomy3", 20, 3, 700, False), ("polytomy3", 61, 1, 300, True)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape,S,C,P,split", FUSED_WIDE_CASES)
def test_fused_wide_kernels_match_plain(device, dtype, shape, S, C, P,
                                        split):
    """K1'/K2' at S != 4 (and split at S = 4) against the plain version of
    the mode, one launch each a value and gradient."""
    topo = {"balanced": lambda: balanced_topology(16),
            "caterpillar": lambda: caterpillar_topology(12),
            "caterpillar128": lambda: caterpillar_topology(128),
            "polytomy": _polytomy, "polytomy3": _polytomy3,
            "star": _star}[shape]()
    inputs = _inputs(topo, P, C, dtype, device, S=S)
    f0, b0 = fused.FORWARD_LAUNCHES, fused.BACKWARD_LAUNCHES

    def kernel(*a):
        return fused.fused_site_log(*a, split_categories=split)
    site_k, grads_k = _value_and_grad(kernel, topo, *inputs)
    assert (fused.FORWARD_LAUNCHES, fused.BACKWARD_LAUNCHES) == (f0 + 1,
                                                                 b0 + 1)
    plain = (fused.fused_split_site_log_reference if split
             else fused.fused_site_log_reference)
    site_p, grads_p = _value_and_grad(plain, topo, *inputs)
    rtol, atol, grtol = _tolerances(dtype)
    torch.testing.assert_close(site_k, site_p, rtol=rtol, atol=atol)
    for a, b in zip(grads_k, grads_p):
        torch.testing.assert_close(a, b, rtol=grtol,
                                   atol=grtol * float(b.abs().max()))


@pytest.mark.parametrize("S,C", [(20, 4), (61, 1), (12, 3)])
def test_fused_split_forward_is_k5_over_categories(device, S, C):
    """Category-split K1' computes K5''s function with the categories on its
    chain axis: the same rescaled partials and scalers bit for bit (the
    same node step at C = 1), the site logs to rounding (the root's weight
    rounds in another order); each category's partials peak at exactly 1
    over its states."""
    topo = balanced_topology(16)
    tips, pm, freqs, props, _ = _inputs(topo, 1000, C, torch.float64,
                                        device, S=S)
    children = torch.as_tensor(topo.children, dtype=torch.int32,
                               device=device)
    rootw = (props[:, None] * freqs[None, :]).reshape(-1)
    per, partials, scale = fused.fused_wide_forward(tips, pm, children,
                                                    rootw, True)
    chains = pm.transpose(0, 1)[:, :, None].contiguous()  # [C, N, 1, S, S]
    site5, part5, scale5 = loop.loop_forward(
        tips, chains, children, freqs.expand(C, -1).contiguous(),
        props[:, None].contiguous(), cuda_build.postorder_schedule(topo, tips))
    assert torch.equal(partials, part5[:, :, 0].transpose(0, 1))
    assert torch.equal(scale, scale5)
    torch.testing.assert_close(per, site5, rtol=1e-13, atol=1e-13)
    assert torch.all(partials.amax(2) == 1)


def test_fused_wide_is_deterministic(device):
    """K1' and K2' at S != 4 take fixed orders for every sum, no atomics:
    two launches on the same inputs are bit-identical, in both modes."""
    topo = balanced_topology(16)
    children = torch.as_tensor(topo.children, dtype=torch.int32,
                               device=device)
    for S, C, split in ((20, 4, True), (61, 1, True), (20, 1, False),
                        (20, 4, False)):
        tips, pm, freqs, props, g = _inputs(topo, 1000, C, torch.float32,
                                            device, S=S)
        rootw = (props[:, None] * freqs[None, :]).reshape(-1)
        g = g.expand(C, -1).contiguous() if split else g
        fwd = [fused.fused_wide_forward(tips, pm, children, rootw, split)
               for _ in range(2)]
        for a, b in zip(*fwd):
            assert torch.equal(a, b)
        _, partials, scale = fwd[0]
        bwd = [fused.fused_wide_backward(tips, pm, children, rootw, split,
                                         partials, scale, g)
               for _ in range(2)]
        for a, b in zip(*bwd):
            assert torch.equal(a, b)


def test_fused_wide_replays_in_cuda_graph(device):
    """One K1' and one K2' sweep at S != 4 captured in a CUDA graph and
    replayed three times: each replay bit for bit the eager call's, in both
    modes, at a balanced tree (split levels, waiting items) and a
    caterpillar (chains). The kernels' counters and flags come back to zero
    inside each launch; a flag left set would let a replay read rows before
    they are written."""
    for topo, S, C, P, split in (
            (balanced_topology(64), 20, 4, 4096, True),
            (balanced_topology(32), 61, 1, 4096, True),
            (balanced_topology(64), 20, 1, 8192, False),
            (caterpillar_topology(64), 20, 1, 4096, False)):
        tips, pm, freqs, props, g = _inputs(topo, P, C, torch.float32,
                                            device, S=S)
        children = torch.as_tensor(topo.children, dtype=torch.int32,
                                   device=device)
        rootw = (props[:, None] * freqs[None, :]).reshape(-1)
        g = g.expand(C, -1).contiguous() if split else g

        def sweep():
            site, partials, scale = fused.fused_wide_forward(
                tips, pm, children, rootw, split)
            return (site, partials, scale) + fused.fused_wide_backward(
                tips, pm, children, rootw, split, partials, scale, g)
        eager = sweep()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            sweep()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = sweep()
        for _ in range(3):
            for x in captured:
                x.fill_(float("nan"))
            graph.replay()
            torch.cuda.synchronize()
            for a, b in zip(captured, eager):
                assert torch.equal(a, b)
        del graph


def test_fused_wide_schedules_agree(device):
    """K1' and K2' at S != 4 walked (one block per pattern block and
    category visits every node) and on the tree's schedule run the same
    node steps and sum log m in the same rank order: bit for bit the same
    outputs, both modes, at a balanced tree and a caterpillar."""
    try:
        for topo, S, C, P, split in (
                (balanced_topology(32), 20, 4, 3000, True),
                (balanced_topology(32), 20, 3, 3000, False),
                (caterpillar_topology(40), 61, 1, 1000, True)):
            tips, pm, freqs, props, g = _inputs(topo, P, C, torch.float64,
                                                device, S=S)
            children = torch.as_tensor(topo.children, dtype=torch.int32,
                                       device=device)
            rootw = (props[:, None] * freqs[None, :]).reshape(-1)
            g = g.expand(C, -1).contiguous() if split else g
            outs = []
            for sched in ("walk", "tree"):
                fused.SCHEDULE = sched
                fwd = fused.fused_wide_forward(tips, pm, children, rootw,
                                               split)
                outs.append(fwd + fused.fused_wide_backward(
                    tips, pm, children, rootw, split, fwd[1], fwd[2], g))
            for a, b in zip(*outs):
                assert torch.equal(a, b)
    finally:
        fused.SCHEDULE = None


def test_fused_wide_wrapper_rejects_bad_input(device):
    topo = balanced_topology(8)
    tips, pm, freqs, props, g = _inputs(topo, 64, 4, torch.float32, device,
                                        S=20)
    children = torch.as_tensor(topo.children, dtype=torch.int32,
                               device=device)
    rootw = (props[:, None] * freqs[None, :]).reshape(-1)
    n0 = fused.FORWARD_LAUNCHES
    with pytest.raises(ValueError, match="dtype"):
        fused.fused_wide_forward(tips, pm.double(), children, rootw, True)
    with pytest.raises(ValueError, match="states"):
        t65, p65, f65, r65, _ = _inputs(topo, 64, 1, torch.float32, device,
                                        S=65)
        fused.fused_wide_forward(t65, p65, children,
                                 (r65[:, None] * f65[None, :]).reshape(-1),
                                 True)
    assert fused.FORWARD_LAUNCHES == n0
    _, partials, scale = fused.fused_wide_forward(tips, pm, children, rootw,
                                                  True)
    with pytest.raises(ValueError, match="shape"):  # split takes g [C, P]
        fused.fused_wide_backward(tips, pm, children, rootw, True, partials,
                                  scale, g)


# K5' at S != 4 and K7' share one forward node step (csrc/wide_forward.cuh):
# with the cases above, one case per instantiation (A rows a thread: 2 to
# 16 at S <= 32, 5 to 8 above) at every cluster size C from 1 to 8, a
# 16-child star and a caterpillar at P >= 2048: (shape, S, C, P)
FORWARD_CASES = [
    ("balanced", 2, 1, 300), ("balanced", 8, 2, 300),
    ("balanced", 12, 3, 300), ("balanced", 16, 4, 300),
    ("balanced", 20, 5, 300), ("balanced", 24, 6, 300),
    ("balanced", 28, 7, 300), ("balanced", 32, 8, 300),
    ("balanced", 33, 3, 300), ("balanced", 48, 5, 300),
    ("balanced", 56, 7, 300), ("balanced", 64, 8, 300),
    ("star", 20, 3, 2048), ("star", 61, 7, 2100),
    ("caterpillar", 40, 6, 2049)]


def _check_rescaled(partials, scale, rescale, cs_dims):
    """Rescaled partials peak at exactly 1 over (C, S) at every node and
    pattern (x / max x); unrescaled ones have scale 1."""
    if rescale:
        assert torch.all(partials.amax(cs_dims) == 1)
    else:
        assert torch.all(scale == 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape,S,C,P", FORWARD_CASES)
def test_forward_clusters_match_plain(device, dtype, shape, S, C, P):
    """K5' (L = 2, rescale on and off) and K7' against the plain version:
    site logs, the rescaled partials' peak of 1 (the cluster's max over
    every category), and the gradients of K6' and K8', which read the
    forward's partials and scalers."""
    topo = {"balanced": lambda: balanced_topology(16),
            "caterpillar": lambda: caterpillar_topology(12),
            "star": _star}[shape]()
    tips, pm, freqs, props, g = _chains(topo, P, C, 2, dtype, device, S=S)
    children = torch.as_tensor(topo.children, dtype=torch.int32,
                               device=device)
    rtol, atol, grtol = _tolerances(dtype)
    postorder = cuda_build.postorder_schedule(topo, tips)
    for rescale in (True, False):
        site, part, scale = loop.loop_forward(tips, pm, children, freqs,
                                              props, postorder, rescale)
        ref = loop.loop_site_log_reference(tips, pm, topo, freqs, props,
                                           rescale=rescale)
        torch.testing.assert_close(site, ref, rtol=rtol, atol=atol)
        _check_rescaled(part, scale, rescale, (2, 3))
    leaves = [x.clone().requires_grad_(True) for x in (pm, freqs, props)]
    grads_k = torch.autograd.grad(torch.sum(g * loop.loop_site_log(
        topo, True, tips, *leaves)), leaves)
    grads_p = torch.autograd.grad(torch.sum(g * loop.loop_site_log_reference(
        tips, leaves[0], topo, leaves[1], leaves[2])), leaves)
    for a, b in zip(grads_k, grads_p):
        torch.testing.assert_close(a, b, rtol=grtol,
                                   atol=grtol * float(b.abs().max()))
    rootw = (props[0][:, None] * freqs[0][None, :]).reshape(-1)
    schedule = cuda_build.level_schedule(topo, tips)
    site, part, scale = wide.wide_forward(tips, pm[0], children, rootw,
                                          schedule)
    ref = wide.wide_site_log_reference(tips, pm[0], topo, freqs[0], props[0])
    torch.testing.assert_close(site, ref, rtol=rtol, atol=atol)
    _check_rescaled(part, scale, True, (1, 2))
    inputs = (tips, pm[0], freqs[0], props[0], g[0])
    _, grads_k = _value_and_grad(wide.wide_site_log, topo, *inputs)
    _, grads_p = _value_and_grad(wide.wide_site_log_reference, topo, *inputs)
    for a, b in zip(grads_k, grads_p):
        torch.testing.assert_close(a, b, rtol=grtol,
                                   atol=grtol * float(b.abs().max()))


def test_staged_is_deterministic(device):
    """K3' and K4' take fixed orders for every sum: two launches on the same
    inputs give bit-identical site logs, partials, scalers, d pmats and
    d rootw, with K3''s switch where walk_level puts it, each walk from
    level 0 and a middle level, and past the last level."""
    for topo, P, C in ((balanced_topology(64), 20000 + 5, 4),
                       (_polytomy(), 1500, 3)):
        tips, pm, freqs, props, g = _inputs(topo, P, C, torch.float32,
                                            device)
        children = torch.as_tensor(topo.children, dtype=torch.int32,
                                   device=device)
        rootw = (props[:, None] * freqs[None, :]).reshape(-1)
        schedule = cuda_build.level_schedule(topo, tips)
        n_levels = len(topo.levels)
        for top, walk in ((None, None), (0, "s4"), (n_levels // 2, "s4"),
                          (0, "chain"), (n_levels // 2, "chain"),
                          (n_levels, None)):
            runs = [staged.staged_forward(tips, pm, children, rootw,
                                          schedule, top, walk)
                    for _ in range(2)]
            runs += [staged.staged_backward(tips, pm, children, rootw,
                                            schedule, *runs[0][1:], g)
                     for _ in range(2)]
            torch.cuda.synchronize()
            for a, b in zip(*runs[:2]):
                assert torch.equal(a, b)
            for a, b in zip(*runs[2:]):
                assert torch.equal(a, b)


def test_forward_is_deterministic(device):
    """K5' at S != 4 and K7' take fixed orders for every sum (the cluster's
    root sum over categories included): two launches on the same inputs
    give bit-identical site logs, partials and scalers."""
    topo = balanced_topology(16)
    children = torch.as_tensor(topo.children, dtype=torch.int32,
                               device=device)
    for S, C in ((20, 4), (61, 1), (33, 7)):
        tips, pm, freqs, props, _ = _chains(topo, 1000, C, 2, torch.float32,
                                            device, S=S)
        postorder = cuda_build.postorder_schedule(topo, tips)
        runs = [loop.loop_forward(tips, pm, children, freqs, props,
                                  postorder) for _ in range(2)]
        rootw = (props[0][:, None] * freqs[0][None, :]).reshape(-1)
        schedule = cuda_build.level_schedule(topo, tips)
        runs += [wide.wide_forward(tips, pm[0], children, rootw, schedule)
                 for _ in range(2)]
        torch.cuda.synchronize()
        for a, b in zip(*runs[:2]):
            assert torch.equal(a, b)
        for a, b in zip(*runs[2:]):
            assert torch.equal(a, b)


def test_forward_cluster_occupancy(device):
    """Clusters of every size up to 8 fit on the card at S = 20 and 61."""
    for dtype in (torch.float32, torch.float64):
        for S in (20, 61):
            for C in (1, 4, 8):
                assert loop.wide_forward_clusters(dtype, S, C) >= 1
                assert wide.forward_clusters(dtype, S, C) >= 1


def test_loop_wide_wrapper_rejects_bad_input(device):
    topo = balanced_topology(8)
    tips, pm, freqs, props, _ = _chains(topo, 64, 2, 2, torch.float32,
                                        device, S=20)
    children = torch.as_tensor(topo.children, device=device)
    schedule = cuda_build.postorder_schedule(topo, tips)
    n0 = loop.LOOP_FORWARD_LAUNCHES
    with pytest.raises(ValueError, match="freqs"):
        loop.loop_forward(tips, pm, children, freqs[:, :4].contiguous(),
                          props, schedule)
    tips65, pm65, freqs65, props65, _ = _chains(
        topo, 64, 1, 2, torch.float32, device, S=65)
    with pytest.raises(ValueError, match="2 to 64"):
        loop.loop_forward(tips65, pm65, children, freqs65, props65, schedule)
    assert loop.LOOP_FORWARD_LAUNCHES == n0


def test_loop_wrapper_rejects_bad_input(device):
    topo = balanced_topology(8)
    tips, pm, freqs, props, _ = _chains(topo, 64, 4, 2, torch.float32,
                                        device)
    children = torch.as_tensor(topo.children, device=device)
    schedule = cuda_build.postorder_schedule(topo, tips)
    n0 = loop.LOOP_FORWARD_LAUNCHES
    with pytest.raises(ValueError, match="dtype"):
        loop.loop_forward(tips, pm.double(), children, freqs, props, schedule)
    with pytest.raises(ValueError, match="freqs"):
        loop.loop_forward(tips, pm, children, freqs[:1], props, schedule)
    with pytest.raises(ValueError, match=r"\[L, N, C, S, S\]"):
        loop.loop_forward(tips, pm[0], children, freqs, props, schedule)
    assert loop.LOOP_FORWARD_LAUNCHES == n0


def test_staged_wrapper_rejects_bad_input(device):
    topo = balanced_topology(8)
    tips, pm, freqs, props, _ = _inputs(topo, 64, 4, torch.float32, device)
    children = torch.as_tensor(topo.children, device=device)
    rootw = (props[:, None] * freqs[None, :]).reshape(-1)
    schedule = cuda_build.level_schedule(topo, tips)
    n0 = staged.STAGED_FORWARD_LAUNCHES
    with pytest.raises(ValueError, match="dtype"):
        staged.staged_forward(tips, pm.double(), children, rootw, schedule)
    with pytest.raises(ValueError, match="contiguous"):
        staged.staged_forward(tips, pm.transpose(2, 3), children, rootw,
                              schedule)
    with pytest.raises(ValueError, match="rate categories"):
        staged.staged_forward(tips, pm.repeat(1, 3, 1, 1).contiguous(),
                              children, rootw.repeat(3), schedule)
    assert staged.STAGED_FORWARD_LAUNCHES == n0


def test_api_on_card(device):
    """The Interface API on the card (its default) in float64 against the
    API on the CPU: LogLikelihood one K1' launch, Gradient one K1' and one
    K2' launch."""
    from physher_tpu_torch import api

    seqs = {f"t{i}": s for i, s in enumerate(
        ["ACGTACGTACGTTA", "ACGTACCTAAGTTA", "AGGTACGTATGTCA",
         "ACGAACGTAAGTTC", "TCGAACGTAAGATC"])}
    newick = "(((t0:0.1,t1:0.2):0.05,t2:0.3):0.05,(t3:0.1,t4:0.15):0.02);"
    out = []
    for kw in ({}, {"device": "cpu"}):
        tm = api.UnRootedTreeModelInterface(newick)
        tlk = api.TreeLikelihoodInterface(
            seqs, tm, api.HKYInterface(kappa=2.5),
            api.ConstantSiteModelInterface(), **kw)
        f0, b0 = fused.FORWARD_LAUNCHES, fused.BACKWARD_LAUNCHES
        ll = tlk.LogLikelihood()
        f1 = fused.FORWARD_LAUNCHES
        g = tlk.Gradient()
        out.append((ll, g, f1 - f0, fused.FORWARD_LAUNCHES - f1,
                    fused.BACKWARD_LAUNCHES - b0, tlk.tlk.engine_name()))
    (ll, g, *card), (ll_cpu, g_cpu, *cpu) = out
    assert card == [1, 1, 1, "cuda-fused"] and cpu == [0, 0, 0, "torch"]
    np.testing.assert_allclose(ll, ll_cpu, rtol=1e-12)
    np.testing.assert_allclose(g, g_cpu, rtol=0,
                               atol=1e-12 * np.abs(g_cpu).max())


@pytest.mark.parametrize("engine,S,L", [
    ("cuda-fused", 4, None), ("cuda-staged", 4, None), ("cuda-wide", 20, None),
    ("cuda-loop", 4, 4)])
@pytest.mark.parametrize("n", [2, 4])
def test_sharded_kernels_on_card(device, engine, S, L, n):
    """A TreeLikelihood sharded over the card listed n times against the
    unsharded one, float64, at 1e-12 of the largest entry (of logP, the
    site logs and the model's gradient vector): each kernel pair at the
    shard's pattern count (K5'/K6' on a 2 x n/2 chains x patterns mesh)."""
    from physher_tpu_torch.models.parameters import ParamBatch
    from physher_tpu_torch.models.protein import WAG
    from physher_tpu_torch.models.sitemodel import GammaSiteModel
    from physher_tpu_torch.models.substitution import GTR
    from physher_tpu_torch.models.treelikelihood import TreeLikelihood
    from physher_tpu_torch.parallel.mesh import (
        chain_pattern_mesh, pattern_mesh, shard_tree_likelihood)
    from physher_tpu_torch.utils.synthetic import random_sitepattern

    kw = dict(dtype=torch.float64, device=device)
    topo = balanced_topology(32)

    def build():
        sp = random_sitepattern(32, 1000, seed=7,
                                datatype="nucleotide" if S == 4 else "aa")
        subst = GTR(**kw) if S == 4 else WAG(**kw)
        return TreeLikelihood(sp, topo, subst, GammaSiteModel(4, **kw),
                              engine=engine, pattern_pad_multiple=4, **kw)

    base = build()
    devs = [device] * n
    mesh = (chain_pattern_mesh(2, devs) if L else pattern_mesh(devices=devs))
    shd = shard_tree_likelihood(build(), mesh)
    space = base.param_space()
    params = space.init_params(**kw)
    if L:
        g = torch.Generator(device=device).manual_seed(0)
        u = space.unconstrain(params)
        params = space.constrain({k: v.expand((L,) + v.shape)
                                  + 0.05 * torch.randn((L,) + v.shape,
                                                       generator=g, **kw)
                                  for k, v in u.items()})
    res = []
    for tlk in (base, shd):
        leaves = {k: v.detach().clone().requires_grad_()
                  for k, v in params.items()}
        p = ParamBatch(leaves, (L,)) if L else leaves
        logp = tlk.log_likelihood(p)
        grads = torch.autograd.grad(logp.sum(), list(leaves.values()))
        # the model's gradient: one vector over all its parameters
        res.append([logp.detach(), tlk.site_log_likelihoods(p).detach(),
                    torch.cat([g.reshape(-1) for g in grads])])
    assert shd.engine_name(L) == base.engine_name(L) == engine
    for a, b in zip(*res):
        torch.testing.assert_close(b, a, rtol=0,
                                   atol=1e-12 * float(a.abs().max()))


def _kernel_spans(prof) -> list:
    """(name, [the program's spans around its launch]) of each kernel that
    no aten op launched (this repo's, through ctypes) in a finished
    ``torch.profiler`` run. A kernel shares its correlation id with the
    runtime call that launched it, and is linked to the host event
    innermost there, whose thread the spans are looked for on."""
    from torch.autograd import DeviceType

    events = list(prof.profiler.kineto_results.events())
    host = [e for e in events if e.device_type() == DeviceType.CPU]
    runtime = {e.correlation_id(): e for e in host
               if e.name().startswith("cu")}
    ops = {}
    for e in host:
        if not e.name().startswith("cu"):
            ops.setdefault(e.correlation_id(), e)
    spans = [e for e in host if e.name().startswith("physher.")]
    out = []
    for k in events:
        if k.device_type() != DeviceType.CUDA or k.is_user_annotation():
            continue
        launch = runtime.get(k.correlation_id())
        op = ops.get(k.linked_correlation_id())
        if launch is None or op is None or op.name().startswith("aten::"):
            continue
        t, thread = launch.start_ns(), op.start_thread_id()
        out.append((k.name(), [s.name() for s in spans
                               if s.start_thread_id() == thread
                               and s.start_ns() <= t <= s.end_ns()]))
    return out


@pytest.mark.parametrize("engine,S,L", [
    ("cuda-fused", 4, None), ("cuda-staged", 4, None), ("cuda-wide", 20, None),
    ("cuda-loop", 4, 4), ("cuda-loop", 20, 4)])
def test_ops_spans_enclose_their_kernels(device, engine, S, L):
    """Under ``torch.profiler``, a value and gradient through each kernel
    pair: one ``physher.ops.<pair>.forward`` span and one ``.backward``
    span (the latter on the autograd engine's thread), as many as the
    launch counters count, and every launch of the pair's kernels inside
    one of them, under ``physher.treelikelihood.forward`` for the
    forward."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from physher_tpu_torch.models.parameters import ParamBatch
    from physher_tpu_torch.models.protein import WAG
    from physher_tpu_torch.models.sitemodel import GammaSiteModel
    from physher_tpu_torch.models.substitution import GTR
    from physher_tpu_torch.models.treelikelihood import TreeLikelihood
    from physher_tpu_torch.utils.synthetic import random_sitepattern

    kw = dict(dtype=torch.float32, device=device)
    topo = balanced_topology(32)
    sp = random_sitepattern(32, 1000, seed=7,
                            datatype="nucleotide" if S == 4 else "aa")
    tlk = TreeLikelihood(sp, topo, GTR(**kw) if S == 4 else WAG(**kw),
                         GammaSiteModel(4, **kw), engine=engine,
                         batch_engine=engine, **kw)
    space = tlk.param_space()
    params = space.init_params(**kw)
    if L:
        params = {k: v.expand((L,) + v.shape).clone()
                  for k, v in params.items()}
    leaves = {k: v.requires_grad_() for k, v in params.items()}
    batch = ParamBatch(leaves, (L,)) if L else leaves
    pair = engine.split("-")[1]
    mod = {"fused": fused, "staged": staged, "wide": wide, "loop": loop}[pair]
    counters = [n for n in dir(mod) if n.endswith("_LAUNCHES")]

    def run():
        torch.autograd.grad(tlk.log_likelihood(batch).sum(),
                            list(leaves.values()))
        torch.cuda.synchronize(device)
    run()                                   # builds and warms
    before = {n: getattr(mod, n) for n in counters}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    calls = sum(getattr(mod, n) - before[n] for n in counters)
    # the host's rows (each span also has a shadow on the device's)
    host = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    names = [e.name for e in host
             if e.name.startswith(f"physher.ops.{pair}.")]
    assert sorted(names) == [f"physher.ops.{pair}.backward",
                             f"physher.ops.{pair}.forward"] and calls == 2
    threads = {e.name: e.thread for e in host
               if e.name.startswith("physher.")}
    assert threads[f"physher.ops.{pair}.backward"] != \
        threads["physher.treelikelihood.forward"]
    kernels = _kernel_spans(prof)
    assert kernels
    for name, around in kernels:
        ops = [s for s in around if s.startswith(f"physher.ops.{pair}.")]
        assert len(ops) == 1, (name, around)
        if ops[0].endswith(".forward"):
            assert "physher.treelikelihood.forward" in around, (name, around)
