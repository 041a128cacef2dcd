"""The coalescent models (``models/coalescent.py``) and their config
branches (``config/compound.py``) on the CPU in float64, held against the
JAX package:

- the six models (constant, exponential, skyride with theta and delta
  parameterizations, skyline, skygrid, piecewise-linear) at the fluA time
  tree's heights: log_prob and its gradient in the heights and the
  population sizes at 1e-10 relative;
- a batch of 3 chains (heights ``[3, N]``, parameters ``[3, ...]``) equal to
  its rows run one by one at 1e-12;
- tests/test_coalescent.py's skygrid, piecewise-linear and skyline values
  on its small tree, at its tolerances;
- fluA-elbo.json with its coalescent replaced by each model: the same joint
  log posterior from both packages' builders at the initial point, 1e-9
  relative.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physher_tpu.config.builder import build_config as j_build_config
from physher_tpu.io.treeio import read_newick as j_read_newick
from physher_tpu.models import coalescent as j_coal
from physher_tpu.trees.timetree import TimeTreeData as JTimeTreeData
from physher_tpu_torch.config.builder import build_config, load_json
from physher_tpu_torch.io.treeio import read_newick
from physher_tpu_torch.models import coalescent
from physher_tpu_torch.models.parameters import params_from_numpy

KW = dict(dtype=torch.float64, device="cpu")
SMALL = "(((a:2,b:2):4,c:6):6,d:12);"
# fluA: 69 taxa, 68 coalescences; its root is about 21 years above the
# latest tip
N_INTERNAL = 68
GRID, CUTOFF = 8, 18.0


def _models(I):
    """(name, class name, keyword arguments) of the six models over a tree
    with I coalescences."""
    rng = np.random.default_rng(5)
    return [
        ("constant", "ConstantCoalescent", dict(theta_init=6.0)),
        ("exponential", "ExponentialCoalescent",
         dict(n0_init=6.0, rate_init=0.08)),
        ("skyride", "SkyrideCoalescent",
         dict(thetas_init=np.log(rng.uniform(2.0, 9.0, I)),
              log_space=True)),
        ("skyride-delta", "SkyrideCoalescent",
         dict(thetas_init=np.concatenate(
             [[5.0], rng.normal(0.0, 1.0, I - 1), [2.0, 0.5]]),
              delta=True)),
        ("skyline", "SkylineCoalescent",
         dict(groups=[I // 3, I // 3, I - 2 * (I // 3)],
              thetas_init=np.log([3.0, 5.0, 8.0]), log_space=True)),
        ("skygrid", "SkygridCoalescent",
         dict(grid=GRID, cutoff=CUTOFF,
              thetas_init=np.log(rng.uniform(2.0, 9.0, GRID)),
              log_space=True)),
        ("piecewise-linear", "PiecewiseLinearCoalescent",
         dict(grid=GRID, cutoff=CUTOFF,
              thetas_init=rng.uniform(2.0, 9.0, GRID))),
    ]


@pytest.fixture(scope="module")
def flua(data_dir):
    """(JAX topology, port topology, node heights [N]) of the fluA time
    tree of jc69-time.json."""
    cfg = load_json(os.path.join(data_dir, "jc69-time.json"))
    tree = cfg["model"]["tree"]
    jtopo, dist = j_read_newick(tree["newick"])
    td = JTimeTreeData.from_dated_tree(jtopo, dist, tree["dates"])
    topo, _ = read_newick(tree["newick"])
    assert topo.I == N_INTERNAL
    return jtopo, topo, np.asarray(td.node_heights0)


def _pair(jtopo, topo, cls, kw):
    return getattr(j_coal, cls)(jtopo, **kw), getattr(coalescent, cls)(
        topo, **kw)


@pytest.mark.parametrize("name,cls,kw", _models(N_INTERNAL),
                         ids=[m[0] for m in _models(N_INTERNAL)])
def test_log_prob_and_gradient_match_jax(flua, name, cls, kw):
    jtopo, topo, h = flua
    jm, m = _pair(jtopo, topo, cls, kw)
    jp = jm.param_space().init_params()
    value, (gh, gp) = jax.value_and_grad(
        lambda hh, pp: jm.log_prob_from_heights(hh, pp), argnums=(0, 1))(
            jnp.asarray(h), jp)
    p = {k: v.requires_grad_(True) for k, v in params_from_numpy(
        {k: np.asarray(v) for k, v in jp.items()}, **KW).items()}
    ht = torch.tensor(h, requires_grad=True)
    got = m.log_prob_from_heights(ht, p)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(value), rtol=1e-10)
    np.testing.assert_allclose(ht.grad.numpy(), np.asarray(gh), rtol=1e-10,
                               atol=1e-10 * np.abs(np.asarray(gh)).max())
    for k in jp:
        np.testing.assert_allclose(p[k].grad.numpy(), np.asarray(gp[k]),
                                   rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("name,cls,kw", _models(N_INTERNAL),
                         ids=[m[0] for m in _models(N_INTERNAL)])
def test_batch_equals_rows(flua, name, cls, kw):
    """Heights [3, N] and parameters [3, ...] give the three rows' values:
    the per-interval thetas are gathered per chain."""
    _, topo, h = flua
    m = getattr(coalescent, cls)(topo, **kw)
    p0 = m.param_space().init_params(**KW)
    rng = np.random.default_rng(9)
    L = 3
    # internal heights scaled per chain keep every chain's ordering of
    # events different from the others'
    scale = torch.tensor(1.0 + 0.2 * rng.random((L, 1)))
    heights = torch.tensor(h).expand(L, -1).clone()
    heights[:, topo.T:] = heights[:, topo.T:] * scale
    params = {k: v.expand((L,) + v.shape) * torch.tensor(
        1.0 + 0.05 * rng.random((L,) + (1,) * v.dim())) for k, v in
        p0.items()}
    batch = m.log_prob_from_heights(heights, params)
    assert batch.shape == (L,)
    rows = torch.stack([m.log_prob_from_heights(
        heights[i], {k: v[i] for k, v in params.items()}) for i in range(L)])
    np.testing.assert_allclose(batch.numpy(), rows.numpy(), rtol=1e-12)


@pytest.fixture(scope="module")
def small():
    topo, _ = read_newick(SMALL)
    heights = torch.tensor([0.0, 0.0, 0.0, 0.0, 2.0, 6.0, 12.0], **KW)
    return topo, heights


def _value_grads(m, heights):
    p = {k: v.requires_grad_(True)
         for k, v in m.param_space().init_params(**KW).items()}
    h = heights.clone().requires_grad_(True)
    value = m.log_prob_from_heights(h, p)
    value.backward()
    return (float(value.detach()), p[m.key("thetas")].grad.numpy(),
            h.grad.numpy())


def test_skygrid_small_tree(small):
    """tests/test_coalescent.py::test_skygrid's values."""
    topo, heights = small
    m = coalescent.SkygridCoalescent(
        topo, grid=5, cutoff=10.0,
        thetas_init=np.log([3.0, 10.0, 4.0, 2.0, 3.0]), log_space=True)
    value, g, _ = _value_grads(m, heights)
    np.testing.assert_allclose(value, -11.8751856, atol=1e-6)
    np.testing.assert_allclose(g, [3.5, 0.75, 0.1250, 1.25, -0.333333],
                               atol=1e-5)


def test_piecewise_linear_small_tree(small):
    """tests/test_coalescent.py::test_piecewise_linear's values."""
    topo, heights = small
    m = coalescent.PiecewiseLinearCoalescent(
        topo, grid=5, cutoff=10.0, thetas_init=[3.0, 10.0, 4.0, 2.0, 3.0],
        log_space=False)
    value, g, gh = _value_grads(m, heights)
    np.testing.assert_allclose(value, -11.08185677776700117647, atol=1e-8)
    np.testing.assert_allclose(
        g, [0.32063498962941356, 0.11153798261181064, 0.17750252451894566,
            0.33669080273686075, 0.06921832582596682], atol=1e-8)
    np.testing.assert_allclose(
        gh[topo.T:], [-0.6744186046511627, -0.375, -0.3333333333333333],
        atol=1e-8)


def test_skyline_small_tree_is_grouped_skyride(small):
    """tests/test_coalescent.py::test_skyline_grouped: group sizes [2, 1]
    equal a skyride whose first two thetas are shared."""
    topo, heights = small
    m = coalescent.SkylineCoalescent(topo, groups=[2, 1],
                                     thetas_init=np.log([3.0, 4.0]))
    ref = coalescent.SkyrideCoalescent(
        topo, thetas_init=np.log([3.0, 3.0, 4.0]), log_space=True)
    np.testing.assert_allclose(
        float(m.log_prob_from_heights(heights, m.param_space().init_params(
            **KW))),
        float(ref.log_prob_from_heights(heights, ref.param_space(
        ).init_params(**KW))), atol=1e-10)


def _coalescent_node(name, I):
    """A fluA-elbo.json coalescent node for model ``name``, and whether the
    config's oneonx prior on its sizes stays (positive sizes with an id)."""
    rng = np.random.default_rng(3)

    def thetas(n):
        return {"id": "thetas", "type": "parameter",
                "values": [float(x) for x in rng.uniform(4.0, 12.0, n)],
                "lower": 0}

    node = {"id": "coalescent", "type": "coalescent", "tree": "&tree"}
    if name == "exponential":
        node.update(model="exponential", parameters={
            "n0": {"id": "thetas", "type": "parameter", "value": 10,
                   "lower": 0},
            "rate": {"id": "growth", "type": "parameter", "value": 0.05}})
    elif name == "skyride":
        node.update(model="skyride", parameters={"thetas": thetas(I)})
    elif name == "skyride-delta":
        v = np.concatenate([[8.0], rng.normal(0.0, 1.0, I - 1), [2.0, 0.5]])
        node.update(model="skyride", parameterization="delta", parameters={
            "thetas": {"id": "thetas", "type": "parameter",
                       "values": [float(x) for x in v]}})
        return node, False
    elif name == "skyline":
        node.update(model="skyline", groups=[30, 20, I - 50],
                    parameters={"thetas": thetas(3)})
    elif name == "skygrid":
        node.update(model="skygrid", grid=GRID, cutoff=CUTOFF,
                    parameters={"thetas": thetas(GRID)})
    else:
        node.update(model=name, grid=GRID, cutoff=CUTOFF,
                    parameters={"thetas": thetas(GRID)})
    return node, True


@pytest.fixture(scope="module")
def jax_like(data_dir):
    """The JAX package's tree likelihood of fluA-elbo.json, jitted once; the
    configs below change only the prior."""
    cfg = load_json(os.path.join(data_dir, "fluA-elbo.json"))
    ctx, _ = j_build_config(cfg, base_dir=data_dir)
    tlk = ctx.objects["treelikelihood"]
    return jax.jit(tlk.log_likelihood)


@pytest.mark.parametrize("name", ["exponential", "skyride", "skyride-delta",
                                  "skyline", "skygrid", "piecewise-linear"])
def test_builder_joint_matches_jax(data_dir, jax_like, name):
    cfg = load_json(os.path.join(data_dir, "fluA-elbo.json"))
    prior = cfg["model"]["distributions"][1]
    node, keep = _coalescent_node(name, N_INTERNAL)
    prior["distributions"][0] = node
    if keep:
        prior["distributions"][1]["x"] = "&thetas"
    else:
        prior["distributions"].pop(1)
    cfg.pop("varmodel")
    jctx, _ = j_build_config(copy.deepcopy(cfg), base_dir=data_dir)
    jpost = jctx.objects["posterior"]
    jp = jpost.param_space().init_params()
    # the JAX joint: its jitted likelihood plus its prior compound, eager
    expected = float(jax_like(jp)) + float(jctx.objects["prior"].log_prob(jp))
    ctx, _ = build_config(cfg, base_dir=data_dir, **KW)
    post = ctx.objects["posterior"]
    assert isinstance(ctx.objects["coalescent"], getattr(
        coalescent, type(jctx.objects["coalescent"]).__name__))
    params = post.param_space().init_params(**KW)
    assert sorted(params) == sorted(jp)
    np.testing.assert_allclose(float(post.log_prob(params)), expected,
                               rtol=1e-9)
