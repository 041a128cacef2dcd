"""Pattern sharding in the port (physher_tpu_torch/parallel/mesh.py): one
process over a list of devices, here the CPU listed up to four times (the
JAX tests' virtual CPU devices). A sharded TreeLikelihood runs its engine
once per pattern shard and sums the shards' log-likelihoods in shard
order; it must match the unsharded model at 1e-12 relative in float64
(logP, site logs and every gradient), for one parameter dict and a batch
of chains, on a patterns mesh and a chains x patterns mesh. Through the
config builder, the cases of tests/test_mesh_config.py: the mesh built
from init.devices / init.mesh / devices=, and mcmc on a 2 x 4 mesh, mmcmc,
a VB fit and Adam ML (30 steps) giving the unsharded runs' results (rtol
1e-9, the JAX test's bound); and --devices 4 --device cpu through the CLI.
"""

import copy
import io
import json
import math

import numpy as np
import pytest
import torch

from physher_tpu.config.builder import build_config as j_build_config
from physher_tpu.config.builder import load_json as j_load_json
from physher_tpu_torch import cli
from physher_tpu_torch.config.actions import Runner
from physher_tpu_torch.config.builder import build_config, load_json
from physher_tpu_torch.inference import marginal, ml
from physher_tpu_torch.models.clock import StrictClock
from physher_tpu_torch.models.parameters import ParamBatch
from physher_tpu_torch.models.sitemodel import GammaSiteModel
from physher_tpu_torch.models.substitution import GTR, JC69
from physher_tpu_torch.models.treelikelihood import TreeLikelihood
from physher_tpu_torch.parallel.mesh import (
    Mesh, chain_pattern_mesh, cuda_devices, pattern_mesh,
    shard_tree_likelihood)
from physher_tpu_torch.trees.timetree import TimeTreeData
from physher_tpu_torch.utils.synthetic import (
    balanced_topology, random_sitepattern)

KW = dict(dtype=torch.float64, device="cpu")
RTOL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the models here run many ops on small tensors,
    which gain nothing from more threads, and beside other test processes
    on the same cores each op's thread barrier stalls."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fixed(pad):
    topo = balanced_topology(16)
    return TreeLikelihood(random_sitepattern(16, 96, seed=3), topo, GTR(**KW),
                          GammaSiteModel(4, **KW), rescale=True,
                          pattern_pad_multiple=pad, **KW)


def _time(pad):
    topo = balanced_topology(16)
    heights = np.zeros(topo.N)
    for k in range(topo.I):
        cs = topo.children[k, : topo.child_count[k]]
        heights[topo.T + k] = heights[cs].max() + 0.4
    return TreeLikelihood(
        random_sitepattern(16, 93, seed=5), topo, JC69(**KW),
        GammaSiteModel(4, **KW),
        clock=StrictClock(topo.N, rate_init=1e-2, **KW),
        time_data=TimeTreeData.from_heights(topo, heights),
        include_jacobian=True, rescale=True, pattern_pad_multiple=pad, **KW)


def _batch(tlk, L, seed=0):
    """L chains around the initial values (unconstrained noise)."""
    space = tlk.param_space()
    u = space.unconstrain(space.init_params(**KW))
    g = torch.Generator().manual_seed(seed)
    ub = {k: v.expand((L,) + v.shape).clone()
          + 0.05 * torch.randn((L,) + v.shape, generator=g, dtype=v.dtype)
          for k, v in u.items()}
    return space.constrain(ub)


def _value_grads(tlk, params):
    leaves = {k: v.detach().clone().requires_grad_() for k, v in
              params.items()}
    p = (ParamBatch(leaves, params.batch_shape)
         if isinstance(params, ParamBatch) else leaves)
    logp = tlk.log_likelihood(p)
    grads = torch.autograd.grad(logp.sum(), list(leaves.values()))
    site = tlk.site_log_likelihoods(p)
    return [logp.detach(), site.detach(), *grads]


def _close(ref, got):
    for a, b in zip(ref, got, strict=True):
        scale = max(float(a.abs().max()), 1e-300)
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0,
                                   atol=RTOL * scale)


@pytest.mark.parametrize("build", [_fixed, _time], ids=["fixed", "time"])
@pytest.mark.parametrize("n", [2, 4])
def test_sharded_matches_unsharded(build, n):
    base = build(4)
    shd = shard_tree_likelihood(build(4), pattern_mesh(devices=["cpu"] * n))
    assert shd.mesh.shape == {"patterns": n}
    params = base.param_space().init_params(**KW)
    _close(_value_grads(base, params), _value_grads(shd, params))
    # a batch of chains: over the one row of the patterns mesh, and split
    # in two chain groups on a 2 x (n / 2) mesh
    batch = _batch(base, 4)
    ref = _value_grads(base, batch)
    _close(ref, _value_grads(shd, batch))
    if n == 4:
        grp = shard_tree_likelihood(
            build(2), chain_pattern_mesh(2, devices=["cpu"] * 4))
        assert grp.mesh.shape == {"chains": 2, "patterns": 2}
        _close(ref, _value_grads(grp, batch))
        # a batch the chain rows do not divide runs on the first row
        _close(_value_grads(base, _batch(base, 3, seed=1)),
               _value_grads(grp, _batch(base, 3, seed=1)))


def test_mesh_errors():
    with pytest.raises(ValueError, match="not divisible by mesh axis 4"):
        shard_tree_likelihood(_time(1), pattern_mesh(devices=["cpu"] * 4))
    with pytest.raises(ValueError, match="not divisible into 3 chain"):
        chain_pattern_mesh(3, devices=["cpu"] * 4)
    # more devices than the CUDA devices visible: the count is named
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match=f"{n} are visible"):
        pattern_mesh(n + 1)
    with pytest.raises(ValueError, match=f"{n} are visible"):
        cuda_devices(n + 2)
    mesh = Mesh([["cpu", "cpu"], ["cpu", "cpu"]], ("chains", "patterns"))
    assert mesh.size == 4 and mesh.rows() == [[torch.device("cpu")] * 2] * 2


# -- through the config builder (tests/test_mesh_config.py) -----------------

@pytest.fixture(scope="module")
def cfg(data_dir):
    return load_json(f"{data_dir}/jc69-time.json")


def _mcmc_node(length=48, every=8, **kw):
    return {"type": "mcmc", "id": "mc", "model": "&treelikelihood",
            "length": length, "log": [{"every": every}], **kw}


def test_config_mesh_builds_and_shards(cfg, data_dir):
    ctx, _ = build_config(copy.deepcopy(cfg), base_dir=data_dir,
                          devices={"chains": 2, "patterns": 4}, **KW)
    assert ctx.mesh.shape == {"chains": 2, "patterns": 4}
    tlk = ctx.objects["treelikelihood"]
    assert tlk.mesh is ctx.mesh and tlk.tip_partials.shape[-1] % 4 == 0
    # the shards hold the whole's columns, once per (block, device)
    assert len(tlk._shard_rows) == 2 and tlk._shard_rows[0] == \
        tlk._shard_rows[1]
    torch.testing.assert_close(
        torch.cat([t for _, t, _ in tlk._shard_rows[0]], -1),
        tlk.tip_partials, rtol=0, atol=0)
    ctx1, _ = build_config(copy.deepcopy(cfg), base_dir=data_dir, **KW)
    p = ctx1.objects["treelikelihood"].param_space().init_params(**KW)
    l1 = float(ctx1.objects["treelikelihood"].log_likelihood(p))
    lN = float(tlk.log_likelihood(p))
    np.testing.assert_allclose(lN, l1, rtol=RTOL)
    # and the JAX package's logP on the same config
    jctx, _ = j_build_config(j_load_json(f"{data_dir}/jc69-time.json"),
                             base_dir=data_dir)
    jt = jctx.objects["treelikelihood"]
    np.testing.assert_allclose(
        lN, float(jt.log_likelihood(jt.param_space().init_params())),
        rtol=1e-10)


@pytest.mark.parametrize("how", ["init.devices", "init.mesh", "Mesh"])
def test_mesh_requests(cfg, data_dir, how):
    c = copy.deepcopy(cfg)
    devices = None
    if how == "init.devices":
        c["init"] = {"seed": 3, "devices": 4}
    elif how == "init.mesh":
        c["init"] = {"seed": 3, "mesh": {"chains": 2, "patterns": 2}}
    else:
        c["init"] = {"seed": 3, "devices": 8}    # overridden by devices=
        devices = pattern_mesh(devices=["cpu"] * 3)
    ctx, _ = build_config(c, base_dir=data_dir, devices=devices, **KW)
    expect = {"init.devices": {"patterns": 4},
              "init.mesh": {"chains": 2, "patterns": 2},
              "Mesh": {"patterns": 3}}[how]
    assert ctx.mesh.shape == expect and ctx.seed == 3
    tlk = ctx.objects["treelikelihood"]
    assert tlk.mesh is ctx.mesh
    assert tlk.tip_partials.shape[-1] % expect["patterns"] == 0


def test_action_mcmc_on_mesh_matches_single_device(cfg, data_dir):
    """mcmc on a 2 x 4 chains x patterns mesh: the same seed gives the
    unsharded run's samples (one generator on the first device)."""
    ctx1, _ = build_config(copy.deepcopy(cfg), base_dir=data_dir, **KW)
    res1 = Runner(ctx1, seed=7, out=io.StringIO()).action_mcmc(
        _mcmc_node(chains=2))
    ctxN, _ = build_config(copy.deepcopy(cfg), base_dir=data_dir,
                           devices={"chains": 2, "patterns": 4}, **KW)
    rN = Runner(ctxN, seed=7, out=io.StringIO())
    resN = rN.action_mcmc(_mcmc_node())      # 2 chains: the mesh's rows
    assert resN.samples_u.shape == res1.samples_u.shape == (6, 2, 69)
    np.testing.assert_allclose(resN.samples_u, res1.samples_u,
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(resN.log_posterior, res1.log_posterior,
                               rtol=1e-9)
    with pytest.raises(ValueError, match="not divisible by mesh axis"):
        rN.action_mcmc(_mcmc_node(chains=3))


def test_action_mmcmc_on_mesh(cfg, data_dir):
    action = {"type": "mmcmc", "id": "ml", "model": "&treelikelihood",
              "temperatures": 4, "length": 40, "every": 8, "burnin": 8}
    outs = []
    for devices in (None, {"chains": 2, "patterns": 4}):
        ctx, _ = build_config(copy.deepcopy(cfg), base_dir=data_dir,
                              devices=devices, **KW)
        temps, lls, _ = Runner(ctx, seed=11, out=io.StringIO()).action_mmcmc(
            dict(action))
        ss, _ = marginal.log_stepping_stone(lls, temps)
        ps, _ = marginal.log_path_sampling(lls, temps)
        assert np.isfinite(ss) and np.isfinite(ps)
        outs.append((np.stack(lls), ss, ps))
    for a, b in zip(outs[0], outs[1]):
        np.testing.assert_allclose(b, a, rtol=1e-9)


def test_action_vb_fit_on_mesh_matches_single_device(data_dir):
    base = load_json(f"{data_dir}/fluA-elbo.json")
    elbos = []
    for devices in (None, {"chains": 1, "patterns": 4}):
        ctx, actions = build_config(copy.deepcopy(base), base_dir=data_dir,
                                    devices=devices, **KW)
        node = dict(actions[0], max=40, tol=0.0)
        node.pop("checkpoint", None)
        res = Runner(ctx, seed=5, out=io.StringIO()).action_optimizer(node)
        assert np.isfinite(res.elbo)
        elbos.append(res.elbo)
    np.testing.assert_allclose(elbos[1], elbos[0], rtol=1e-9)


def test_ml_adam_on_mesh_matches_single_device(cfg, data_dir):
    """Adam ML of the config's model, sharded and not (30 steps: the
    optimizer action runs Adam with its defaults, 5000 steps, whatever
    "max" says)."""
    logps = []
    for devices in (None, {"chains": 1, "patterns": 4}):
        ctx, _ = build_config(copy.deepcopy(cfg), base_dir=data_dir,
                              devices=devices, **KW)
        tlk = ctx.objects["treelikelihood"]
        space = tlk.param_space()
        res = ml.optimize(tlk.log_likelihood, space,
                          space.init_params(**KW), method="adam",
                          max_iter=30, tol=0.0)
        assert np.isfinite(res.logp) and len(res.history) == 30
        logps.append(res.logp)
    np.testing.assert_allclose(logps[1], logps[0], rtol=1e-9)


@pytest.mark.parametrize("flag", [["--devices", "4"], ["--mesh", "2x2"]])
def test_cli_devices_flag(cfg, data_dir, tmp_path, flag):
    c = copy.deepcopy(cfg)
    c["physher"] = [_mcmc_node(length=16, every=8)]
    f = tmp_path / "cfg.json"
    f.write_text(json.dumps(c).replace("fluA.fa", f"{data_dir}/fluA.fa"))
    out = io.StringIO()
    runner = cli.run([str(f), *flag, "--device", "cpu"], out=out)
    assert "MCMC finished" in out.getvalue()
    shape = runner.ctx.mesh.shape
    assert math.prod(shape.values()) == 4
    assert runner.results["mc"].samples_u.shape[1] == shape.get("chains", 1)
    # an in-process caller's own device list
    runner = cli.run([str(f), *flag, "--device", "cpu"], out=io.StringIO(),
                     mesh_devices=[torch.device("cpu")] * 4)
    assert runner.ctx.mesh.size == 4
    with pytest.raises(ValueError, match="3 mesh devices"):
        cli.run([str(f), *flag, "--device", "cpu"], out=io.StringIO(),
                mesh_devices=["cpu"] * 3)
