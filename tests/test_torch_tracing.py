"""The program's spans (``utils/profiling.span``) on the CPU: without a
profiler a span is one shared no-op; under ``torch.profiler`` each hot
path records its layers by name, nested as they are called, each around
its own aten ops; a step gives the same bits with and without the
profiler; and ``cli.py --trace DIR`` writes a trace that holds them.

The three paths are those of the benchmark's cells at a small size: an
ADVI ``vb.step`` on the fluA ELBO config, a block of ``MCMC.run`` on a
GTR+Γ4 model (which decomposes Q every evaluation), and an Interface API
``LogLikelihood`` and ``Gradient``.
"""

import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from physher_tpu_torch import api, cli
from physher_tpu_torch.config.builder import build_config
from physher_tpu_torch.inference import vb
from physher_tpu_torch.inference.mcmc import MCMC
from physher_tpu_torch.models.parameters import simplex_constrain
from physher_tpu_torch.models.sitemodel import GammaSiteModel
from physher_tpu_torch.models.substitution import GTR
from physher_tpu_torch.models.treelikelihood import TreeLikelihood
from physher_tpu_torch.utils import profiling
from physher_tpu_torch.utils.synthetic import (balanced_topology,
                                               random_sitepattern)

DATA = os.path.join(os.path.dirname(__file__), "data")
KW = dict(dtype=torch.float64, device="cpu")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: small models beside other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spans(prof) -> list:
    return [e for e in prof.events() if e.name.startswith("physher.")]


def _ancestors(ev) -> list:
    out, p = [], ev.cpu_parent
    while p is not None:
        out.append(p.name)
        p = p.cpu_parent
    return out


def _has_aten(ev) -> bool:
    return any(c.name.startswith("aten::") or _has_aten(c)
               for c in ev.cpu_children)


def _check_nesting(prof, parents: dict, counts: dict, no_ops=()):
    """The spans are those named in ``parents``, each with its parent
    span among its ancestors (where one is given), ``counts`` of each name,
    and every span but ``no_ops`` encloses aten ops of its own."""
    spans = _spans(prof)
    assert {e.name for e in spans} == set(parents)
    got = {n: sum(e.name == n for e in spans) for n in counts}
    assert got == counts
    for e in spans:
        above = [a for a in _ancestors(e) if a.startswith("physher.")]
        assert parents[e.name] in above + [None], (e.name, above)
        if e.name not in no_ops:
            assert _has_aten(e), e.name


# -- the span itself -----------------------------------------------------------


def test_span_without_profiler_is_the_shared_noop(monkeypatch):
    def made(name):
        raise AssertionError(f"record_function({name!r}) made")
    monkeypatch.setattr(torch.profiler, "record_function", made)
    assert not torch.autograd._profiler_enabled()
    a, b = profiling.span("physher.a"), profiling.span("physher.b")
    assert a is b is profiling._OFF
    with a:
        pass

    @profiling.spanned("physher.c")
    def f(x, y=1):
        return x + y
    assert f(2, y=3) == 5 and f.__name__ == "f"


def test_span_under_profiler_records_each_call():
    @profiling.spanned("physher.outer")
    def f():
        with profiling.span("physher.inner"):
            return torch.ones(3).sum()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            f()
    names = [e.name for e in _spans(prof)]
    assert names.count("physher.outer") == names.count("physher.inner") == 3
    for e in _spans(prof):
        if e.name == "physher.inner":
            assert e.cpu_parent.name == "physher.outer"


def test_span_backward_encloses_the_node():
    """A backward that synchronizes inside a library call (cumprod's, in
    the simplex transform) is recorded around that autograd node, and the
    node is left alone without a profiler."""
    y = torch.tensor([0.3, -0.2, 0.1], dtype=torch.float64,
                     requires_grad=True)
    plain = simplex_constrain(y)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        # a graph made without the profiler carries no span
        (g0,) = torch.autograd.grad(plain[1], y)
    assert not _spans(prof)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        (g1,) = torch.autograd.grad(simplex_constrain(y)[1], y)
    assert torch.equal(g0, g1)
    spans = [e for e in _spans(prof) if e.name == "physher.sync.cumprod"]
    assert len(spans) == 1
    below = [c.name for c in spans[0].cpu_children]
    assert any("cumprod" in n.lower() for n in below), below


# -- the three paths -----------------------------------------------------------


def _advi():
    """A function taking one Adam step of the fluA ELBO's mean-field family
    and returning the parameters and gradients after it."""
    with open(os.path.join(DATA, "fluA-elbo.json")) as fh:
        cfg = json.load(fh)
    ctx, _ = build_config(cfg, base_dir=DATA, **KW)
    fam = ctx.objects["varnormal"].family
    vparams = {k: v.detach().clone().requires_grad_(True)
               for k, v in fam.init.items()}
    opt, schedule = vb.adam(vparams, 0.1)
    gen = torch.Generator().manual_seed(7)

    def step():
        vb.step(fam, vparams, opt, schedule, gen, 1)
        return [v.detach().clone() for v in vparams.values()] + \
            [v.grad.clone() for v in vparams.values()]
    return step


def _gtr_model():
    topo = balanced_topology(8)
    sp = random_sitepattern(8, 60, seed=3)
    return TreeLikelihood(sp, topo, GTR(**KW), GammaSiteModel(4, **KW),
                          **KW)


def _mcmc(n_iter=4):
    tlk = _gtr_model()
    space = tlk.param_space()
    sampler = MCMC(space, tlk.log_likelihood)
    params = space.init_params(**KW)
    gen = torch.Generator().manual_seed(11)

    def block():
        res = sampler.run(gen, params, n_iter=n_iter, every=n_iter,
                          n_chains=2)
        return [res.samples_u, res.log_posterior, res.step_sizes]
    return block


def _api():
    seqs = {f"t{i}": s for i, s in enumerate(
        ["ACGTACGTACGTTA", "ACGTACCTAAGTTA", "AGGTACGTATGTCA",
         "ACGAACGTAAGTTC", "TCGAACGTAAGATC"])}
    newick = "(((t0:0.1,t1:0.2):0.05,t2:0.3):0.05,(t3:0.1,t4:0.15):0.02);"
    tm = api.UnRootedTreeModelInterface(newick)
    tlk = api.TreeLikelihoodInterface(
        seqs, tm, api.GTRInterface(), api.GammaSiteModelInterface(0.5, 4),
        device="cpu")
    values = tm.GetParameters() * 1.1

    def evaluation():
        tm.SetParameters(values)
        return [np.asarray(tlk.LogLikelihood()), tlk.Gradient()]
    return evaluation


PATHS = {"advi": _advi, "mcmc": _mcmc, "api": _api}


def test_advi_step_spans():
    step = _advi()
    step()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step()
    step_children = ("physher.vb.elbo", "physher.vb.backward",
                     "physher.vb.adam")
    for e in _spans(prof):
        if e.name in step_children:
            assert e.cpu_parent.name == "physher.vb.step"
    _check_nesting(prof, {
        "physher.vb.step": None, "physher.vb.elbo": "physher.vb.step",
        "physher.vb.backward": "physher.vb.step",
        "physher.vb.adam": "physher.vb.step",
        "physher.treelikelihood.forward": "physher.vb.elbo",
        "physher.sitemodel.rates": "physher.treelikelihood.forward",
        "physher.heights": "physher.vb.elbo",
        "physher.sync.h2d": "physher.vb.elbo",
        "physher.coalescent": "physher.vb.elbo"},
        {"physher.vb.step": 1, "physher.treelikelihood.forward": 1,
         "physher.coalescent": 1})


def test_mcmc_block_spans():
    n_iter = 4
    block = _mcmc(n_iter)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        block()
    _check_nesting(prof, {
        "physher.mcmc.step": None, "physher.mcmc.block": None,
        "physher.mcmc.propose": "physher.mcmc.step",
        "physher.mcmc.target": None,
        "physher.mcmc.accept": "physher.mcmc.step",
        "physher.sync.h2d": None,
        "physher.sync.samples": "physher.mcmc.block",
        "physher.sync.adapt": "physher.mcmc.block",
        "physher.treelikelihood.forward": "physher.mcmc.target",
        "physher.sitemodel.rates": "physher.treelikelihood.forward",
        "physher.subst.p_t": "physher.treelikelihood.forward",
        "physher.subst.eig": "physher.subst.p_t",
        "physher.sync.eigh": "physher.subst.eig"},
        # the start's evaluation and one a step
        {"physher.mcmc.step": n_iter, "physher.mcmc.target": n_iter + 1,
         "physher.subst.eig": n_iter + 1, "physher.sync.h2d": 2,
         "physher.sync.eigh": n_iter + 1,
         "physher.sync.samples": 3, "physher.mcmc.block": 2})
    in_step = [e for e in _spans(prof)
               if e.name == "physher.treelikelihood.forward"
               and "physher.mcmc.step" in _ancestors(e)]
    assert len(in_step) == n_iter


def test_api_spans():
    evaluation = _api()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        evaluation()
    _check_nesting(prof, {
        "physher.api.set_parameters": None,
        "physher.api.log_likelihood": None, "physher.api.gradient": None,
        "physher.sync.load": None,
        "physher.sync.float": "physher.api.log_likelihood",
        "physher.sync.numpy": "physher.api.gradient",
        "physher.treelikelihood.forward": None,
        "physher.sitemodel.rates": "physher.treelikelihood.forward",
        "physher.subst.p_t": "physher.treelikelihood.forward",
        "physher.subst.eig": "physher.subst.p_t",
        "physher.sync.eigh": "physher.subst.eig",
        "physher.subst.p_t.backward": "physher.api.gradient"},
        {"physher.api.set_parameters": 1, "physher.sync.load": 2,
         "physher.treelikelihood.forward": 2, "physher.subst.eig": 2,
         "physher.subst.p_t.backward": 1},
        no_ops=("physher.api.set_parameters",))
    # a load and a forward in each of the two calls
    for name in ("physher.sync.load", "physher.treelikelihood.forward"):
        assert sorted(_ancestors(e)[-1] for e in _spans(prof)
                      if e.name == name) == [
            "physher.api.gradient", "physher.api.log_likelihood"]


@pytest.mark.parametrize("path", sorted(PATHS))
def test_profiler_changes_no_bit(path):
    """The same step from the same state and seed, without and with the
    profiler: the same log densities, gradients and samples, bit for
    bit."""
    plain, traced = PATHS[path](), PATHS[path]()
    a = plain()
    with profile(activities=[ProfilerActivity.CPU]):
        b = traced()
    assert len(a) == len(b)
    for x, y in zip(a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.shape == y.shape and np.array_equal(x, y)


def test_cli_trace_writes_the_programs_spans(tmp_path):
    with open(os.path.join(DATA, "fluA-elbo.json")) as fh:
        cfg = json.load(fh)
    cfg["physher"][0].update(max=2, checkpoint="checkpoint.csv")
    cfg["varmodel"]["elbosamples"] = 2
    for name in ("fluA.fa", "fluA-rooted.nxs"):
        (tmp_path / name).symlink_to(os.path.join(DATA, name))
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    out = tmp_path / "trace"
    assert cli.main([str(tmp_path / "config.json"), "--device", "cpu",
                     "--trace", str(out)]) == 0
    events = json.loads((out / "trace.json").read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"physher.vb.step", "physher.treelikelihood.forward",
            "physher.coalescent"} <= names
