"""The CUDA pruning kernels (K1'/K2' of ops/fused.py, K3'/K4' of
ops/staged.py, K5'/K6' of ops/loop.py at S = 4 and at S from 2 to 64,
K7'/K8' of ops/wide.py) against their plain PyTorch version, on the card;
the forward of K5' at S != 4 and K7' (thread-block clusters of the C
category blocks) also at every cluster size, bit for bit run to run.

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
    with pytest.raises(ValueError, match="dtype"):
        fused.pruning_forward(tips, pm.double(), children, rootw)
    with pytest.raises(ValueError, match="contiguous"):
        fused.pruning_forward(tips, pm.transpose(2, 3), children, rootw)
    with pytest.raises(ValueError, match="rate categories"):
        fused.pruning_forward(tips, pm.repeat(1, 3, 1, 1).contiguous(),
                              children, rootw.repeat(3))


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape,P,C", [
    ("balanced", 300, 4), ("balanced", 128, 1), ("caterpillar", 257, 4),
    ("caterpillar", 64, 1), ("polytomy", 129, 3), ("balanced", 8192 + 37, 4)])
def test_staged_kernels_match_plain(device, dtype, shape, P, C):
    """K3'/K4' against the plain version: balanced, caterpillar and polytomy
    trees, C in {1, 3, 4}, ragged P."""
    topo = {"balanced": lambda: balanced_topology(16),
            "caterpillar": lambda: caterpillar_topology(12),
            "polytomy": _polytomy}[shape]()
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
    _, partials, scale = loop.loop_forward(tips, pm, children, freqs, props)
    runs = [loop.loop_backward(tips, pm, children, freqs, props, partials,
                               scale, g) for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


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
    for rescale in (True, False):
        site, part, scale = loop.loop_forward(tips, pm, children, freqs,
                                              props, rescale)
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
        runs = [loop.loop_forward(tips, pm, children, freqs, props)
                for _ in range(2)]
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
    n0 = loop.LOOP_FORWARD_LAUNCHES
    with pytest.raises(ValueError, match="freqs"):
        loop.loop_forward(tips, pm, children, freqs[:, :4].contiguous(),
                          props)
    tips65, pm65, freqs65, props65, _ = _chains(
        topo, 64, 1, 2, torch.float32, device, S=65)
    with pytest.raises(ValueError, match="2 to 64"):
        loop.loop_forward(tips65, pm65, children, freqs65, props65)
    assert loop.LOOP_FORWARD_LAUNCHES == n0


def test_loop_wrapper_rejects_bad_input(device):
    topo = balanced_topology(8)
    tips, pm, freqs, props, _ = _chains(topo, 64, 4, 2, torch.float32,
                                        device)
    children = torch.as_tensor(topo.children, device=device)
    n0 = loop.LOOP_FORWARD_LAUNCHES
    with pytest.raises(ValueError, match="dtype"):
        loop.loop_forward(tips, pm.double(), children, freqs, props)
    with pytest.raises(ValueError, match="freqs"):
        loop.loop_forward(tips, pm, children, freqs[:1], props)
    with pytest.raises(ValueError, match=r"\[L, N, C, S, S\]"):
        loop.loop_forward(tips, pm[0], children, freqs, props)
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
