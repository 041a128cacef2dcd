"""The port's numpy tools, symbolic differentiation, config generators,
profiling and the sbn and dumper actions, held against the JAX package on
the CPU: the copies (ga, simulated annealing, modelavg, resampling,
neutrality, stats, configgen) give exactly the JAX functions' results on
the same seeded inputs; ``compile_torch``'s autograd gradient matches the
symbolic derivative at 1e-12; ``legacy_cli --dry`` prints the JAX JSON;
the profiling helpers run on the CPU; the sbn and dumper actions match the
JAX Runner's on the same tree file and pool.
"""

import contextlib
import io
import json
import os
from collections import OrderedDict

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physher_tpu import configgen as j_configgen
from physher_tpu import legacy_cli as j_legacy
from physher_tpu.config.actions import Runner as JRunner
from physher_tpu.config.builder import Context as JContext
from physher_tpu.data import neutrality as j_neutrality
from physher_tpu.data import resampling as j_resampling
from physher_tpu.data.sitepattern import SitePattern as JSitePattern
from physher_tpu.inference import ga as j_ga
from physher_tpu.inference import modelavg as j_modelavg
from physher_tpu.inference.sbn import SBN as JSBN
from physher_tpu.io.treeio import read_newick as j_read_newick
from physher_tpu.utils import stats as j_stats
from physher_tpu.utils import symdiff as j_symdiff
from physher_tpu_torch import configgen, legacy_cli
from physher_tpu_torch.config.actions import Runner
from physher_tpu_torch.config.builder import Context, build_config
from physher_tpu_torch.data import neutrality, resampling
from physher_tpu_torch.data.sitepattern import SitePattern
from physher_tpu_torch.inference import ga, modelavg
from physher_tpu_torch.inference.sbn import SBN
from physher_tpu_torch.io.treeio import read_newick, write_newick
from physher_tpu_torch.utils import profiling, stats, symdiff

KW = dict(dtype=torch.float64, device="cpu")
SEQS = OrderedDict([("a", "ACGTACGTAAGT"), ("b", "ACGTACGTACGA"),
                    ("c", "ACGAACGTAAGT"), ("d", "ACGTACCTAACT"),
                    ("e", "TCGTACCTAAGT")])


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the models here run many ops on small tensors,
    which gain nothing from more threads, and beside other test processes
    on the same cores each op's thread barrier stalls."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _equal(a, b):
    """Exactly equal, through nested dicts, lists, tuples and arrays."""
    if isinstance(a, dict):
        assert sorted(a, key=repr) == sorted(b, key=repr)
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# -- search engines -----------------------------------------------------------

TARGET = np.array([2, 0, 1, 2, 1, 0, 0, 2] * 3)


@pytest.mark.parametrize("case", ["onemax", "chc", "anneal"])
def test_ga_and_annealing_match(case):
    def run(mod):
        if case == "onemax":
            return mod.GeneticAlgorithm(
                lambda pop: pop.sum(axis=1), length=30, n_states=2,
                pop_size=60, rng=0).run(generations=60,
                                        max_no_improvement=40)
        if case == "chc":
            return mod.GeneticAlgorithm(
                lambda pop: -(pop != TARGET).sum(axis=1), length=len(TARGET),
                n_states=3, pop_size=80, chc=True, rng=1).run(
                    generations=60, max_no_improvement=60)
        return mod.SimulatedAnnealing(
            lambda s: (10 * s[0] + s[1] - 37) ** 2, length=2, n_states=10,
            initial_temp=20.0, cooling=0.9, rng=0).run(max_no_improvement=300)

    _equal(vars(run(j_ga)), vars(run(ga)))


# -- model averaging ----------------------------------------------------------

LOG = """#NEXUS
begin trees;
tree TREE1 [&LnL=-10.0,IC=20.0] = ((a[&rate=1.0]:0.1,b[&rate=2.0]:0.2)[&rate=3.0]:0.1,c[&rate=4.0]:0.3);
tree TREE2 [&LnL=-11.0,IC=22.0] = ((a[&rate=2.0]:0.1,b[&rate=4.0]:0.2)[&rate=5.0]:0.1,c[&rate=6.0]:0.3);
tree TREE3 [&LnL=-10.5,IC=21.3] = ((a[&rate=1.5]:0.1,c[&rate=2.5]:0.2)[&rate=3.5]:0.1,b[&rate=4.5]:0.3);
end;
"""


def test_modelavg_matches(tmp_path):
    _equal(j_modelavg.ic_weights([20.0, 22.0, 21.3]),
           modelavg.ic_weights([20.0, 22.0, 21.3]))
    _equal(vars(j_modelavg.model_average_from_log(LOG, "rate")),
           vars(modelavg.model_average_from_log(LOG, "rate")))
    path = tmp_path / "log.trees"
    path.write_text(LOG)
    outs = []
    for main in (j_modelavg.cli_main, modelavg.cli_main):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main([str(path)]) == 0
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] and outs[0].startswith("split\tmean")


# -- symbolic differentiation -------------------------------------------------

EXPRESSIONS = ["x^3 + 2*x", "sin(x^2) * exp(x) / (1 + x^2)",
               "y*x + y^2", "log(x*y) - sqrt(x) + cosh(y)/tanh(x)",
               "exp(2)*x - -y^3"]


@pytest.mark.parametrize("expr", EXPRESSIONS)
def test_symdiff_matches(expr):
    point = {"x": 0.7, "y": 1.3}
    for var in ("x", "y"):
        d = symdiff.differentiate(expr, var)
        assert d == j_symdiff.differentiate(expr, var)
        assert symdiff.simplify(symdiff.parse(d)) == j_symdiff.simplify(
            j_symdiff.parse(d))
        assert symdiff.to_string(symdiff.parse(expr)) == \
            j_symdiff.to_string(j_symdiff.parse(expr))
        assert symdiff.evaluate(d, point) == j_symdiff.evaluate(d, point)
    # compile_torch: its value is compile_jax's, its autograd gradient the
    # symbolic derivative's value
    args = [torch.tensor(point[v], dtype=torch.float64, requires_grad=True)
            for v in ("x", "y")]
    value = symdiff.compile_torch(expr, ["x", "y"])(*args)
    jvalue = j_symdiff.compile_jax(expr, ["x", "y"])(
        jnp.float64(point["x"]), jnp.float64(point["y"]))
    np.testing.assert_allclose(value.item(), float(jvalue), rtol=1e-14)
    grads = torch.autograd.grad(value, args, allow_unused=True)
    for var, g in zip(("x", "y"), grads):
        # an unused variable's derivative is the symbolic 0
        np.testing.assert_allclose(
            0.0 if g is None else g.item(),
            symdiff.evaluate(symdiff.differentiate(expr, var), point),
            rtol=1e-12)


# -- resampling, neutrality, stats --------------------------------------------

def test_resampling_matches():
    jsp, sp = JSitePattern.from_alignment(SEQS), SitePattern.from_alignment(
        SEQS)
    _equal(j_resampling.bootstrap_alignment(SEQS, rng=3),
           resampling.bootstrap_alignment(SEQS, rng=3))
    _equal(j_resampling.jackknife_alignment(SEQS, 4),
           resampling.jackknife_alignment(SEQS, 4))
    _equal(j_resampling.jackknife_alignment_n(SEQS, 3, rng=5),
           resampling.jackknife_alignment_n(SEQS, 3, rng=5))
    _equal(j_resampling.bootstrap_weights(jsp, rng=0, n_replicates=6),
           resampling.bootstrap_weights(sp, rng=0, n_replicates=6))
    _equal(j_resampling.jackknife_weights(jsp, 2),
           resampling.jackknife_weights(sp, 2))
    _equal(j_resampling.jackknife_weights_n(jsp, 4, rng=7),
           resampling.jackknife_weights_n(sp, 4, rng=7))
    for name, arg in (("bootstrap_sitepattern", dict(rng=9)),
                      ("jackknife_sitepattern", dict(index=1)),
                      ("reweight", dict(weights=np.arange(sp.pattern_count)))):
        a = getattr(j_resampling, name)(jsp, **arg)
        b = getattr(resampling, name)(sp, **arg)
        _equal((a.codes, a.weights, a.indexes, a.taxa),
               (b.codes, b.weights, b.indexes, b.taxa))


@pytest.mark.parametrize("name", [
    "mean_pairwise_differences", "segregating_sites", "singleton_sites",
    "watterson_theta", "tajima_d", "fu_li_d_star", "fu_li_f_star"])
def test_neutrality_matches(name):
    rng = np.random.default_rng(4)
    seqs = OrderedDict((f"t{i}", "".join(rng.choice(list("ACGT"), 40)))
                       for i in range(7))
    for s in (SEQS, seqs):
        _equal(getattr(j_neutrality, name)(s), getattr(neutrality, name)(s))


def test_stats_matches():
    rng = np.random.default_rng(0)
    x, y = rng.normal(size=500), rng.normal(size=500)
    chains = rng.normal(size=(4, 300)) + np.arange(4)[:, None] * 0.1
    for name, args in (("mean", (x,)), ("variance", (x,)),
                       ("standard_deviation", (x,)), ("covariance", (x, y)),
                       ("correlation", (x, y)), ("median", (x,)),
                       ("quantile", (x, 0.3)), ("percentiles", (x,)),
                       ("choose", (9, 4)), ("autocorrelation", (x, 30)),
                       ("effective_sample_size", (x,)),
                       ("split_r_hat", (chains,)),
                       ("jenks_breaks", (x[:60], 4)),
                       ("summarize", ({"x": x, "y": y},))):
        _equal(getattr(j_stats, name)(*args), getattr(stats, name)(*args))


# -- config generators --------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_tree(tmp_path_factory, data_dir):
    """An NJ tree of tiny.fa written as newick."""
    from physher_tpu_torch.data.distance import distance_matrix
    from physher_tpu_torch.io.seqio import read_alignment
    from physher_tpu_torch.trees.build import nj

    sp = SitePattern.from_alignment(read_alignment(
        os.path.join(data_dir, "tiny.fa")))
    topo, d = nj(sp.taxa, distance_matrix(sp, "jc69"))
    path = tmp_path_factory.mktemp("tree") / "t.nwk"
    path.write_text(write_newick(topo, d))
    return str(path)


def _stdout_json(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return json.loads(buf.getvalue())


@pytest.mark.parametrize("cmd,extra", [
    ("optimize", ["-m", "GTR", "-c", "4"]),
    ("advi", ["--clock", "strict", "--coalescent", "constant"]),
    ("mcmc", ["-m", "HKY", "--length", "100"])])
def test_configgen_matches(data_dir, tiny_tree, cmd, extra):
    argv = [cmd, "-i", os.path.join(data_dir, "tiny.fa"), "-t", tiny_tree,
            *extra]
    cfg = _stdout_json(configgen.main, argv)
    assert cfg == _stdout_json(j_configgen.main, argv)
    # the generated config builds through the port's builder
    ctx, actions = build_config(cfg, base_dir=os.path.dirname(tiny_tree),
                                **KW)
    assert actions and ctx.objects


@pytest.mark.parametrize("argv", [
    ["-i", "aln.fa", "-m", "JC69", "-D", "nj"],
    ["-i", "aln.fa", "-t", "t.nwk", "-m", "GTR", "-c", "4", "-a", "0.3",
     "-I", "0.1", "-f", "e", "-r", "1,2,1,1,2,1", "-O", "spr", "-R", "7"],
    ["-i", "aln.fa", "-m", "HKY", "-D", "upgma", "-f", "0.1,0.2,0.3,0.4",
     "-o", "out", "--dist", "weibull", "-c", "3"]])
def test_legacy_dry_matches(argv):
    buf = io.StringIO()
    assert legacy_cli.run(argv + ["--dry"], out=buf) is None
    assert json.loads(buf.getvalue()) == _stdout_json(j_legacy.main,
                                                      argv + ["--dry"])


def test_legacy_runs_on_cpu(tmp_path, capsys):
    """The generated config runs through the port's CLI on the CPU: the meta
    optimizer from an NJ tree, then the logger."""
    aln = tmp_path / "aln.fa"
    aln.write_text("".join(f">{k}\n{v}\n" for k, v in SEQS.items()))
    out = io.StringIO()
    runner = legacy_cli.run(["-i", str(aln), "-m", "JC69", "-D", "nj",
                             "--device", "cpu"], out=out)
    res = runner.results["metaopt"]
    assert np.isfinite(res.logp) and res.logp < 0
    assert "Maximum log likelihood" in out.getvalue()
    assert runner.ctx.objects["treelikelihood"].engine_name() == "torch"
    assert legacy_cli.main(["-i", str(aln)]) == (
        0 if torch.cuda.is_available() else 2)
    if not torch.cuda.is_available():
        assert "no CUDA device" in capsys.readouterr().err


# -- profiling ----------------------------------------------------------------

def test_profiling_on_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert profiling.detect_chip() == "cpu"
    x = torch.ones(1000, dtype=torch.float64)
    t = profiling.time_fn(lambda v: (v * 2).sum(), x, calls=5)
    assert t.calls == 5 and t.compile_s > 0 and t.per_call_s > 0
    with profiling.trace(str(tmp_path / "trace")):
        (x * 3).sum()
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    total, rows = profiling.trace_op_times(lambda v: (v * 2).sum(),
                                           [(x,), (x + 1,)])
    assert total > 0 and rows and all(r[2] >= 1 for r in rows)


# -- the sbn and dumper actions -----------------------------------------------

TREES = ["((a:1,b:1):1,(c:1,d:1):1);", "((a:1,c:1):1,(b:1,d:1):1);",
         "((a:1,b:1):1,(c:1,d:1):1);", "(((a:1,b:1):1,c:1):1,d:1);",
         "((a:1,b:1):1,(c:1,d:1):1);"]


@pytest.mark.parametrize("fmt", ["newick", "nexus"])
def test_sbn_action_matches(tmp_path, fmt):
    if fmt == "newick":
        text = "\n".join(TREES) + "\n"
    else:
        text = "#NEXUS\nbegin trees;\n" + "".join(
            f"tree t{i} = {t}\n" for i, t in enumerate(TREES)) + "end;\n"
    (tmp_path / "trees.txt").write_text(text)
    node = {"id": "sbn", "type": "sbn", "file": "trees.txt", "burnin": 0.2}
    jout, out = io.StringIO(), io.StringIO()
    jsbn = JRunner(JContext(str(tmp_path)), out=jout).action_sbn(node)
    sbn = Runner(Context(str(tmp_path), **KW), out=out).action_sbn(node)
    assert out.getvalue() == jout.getvalue()
    _equal(jsbn.probabilities(), sbn.probabilities())
    roots, _ = sbn.probabilities()
    assert np.isclose(sum(roots.values()), 1.0) and sbn.n_trees == 4
    for t in TREES:
        assert sbn.log_prob(read_newick(t)[0]) == jsbn.log_prob(
            j_read_newick(t)[0])
    _equal(SBN.from_trees([read_newick(t)[0] for t in TREES]).probabilities(),
           JSBN.from_trees([j_read_newick(t)[0] for t in TREES])
           .probabilities())


def test_dumper_action_matches(tmp_path):
    rng = np.random.default_rng(1)
    pool = {"rate": np.float64(1e-3), "tree.ratios": rng.random(5),
            "freqs": rng.dirichlet(np.ones(4))}
    jr = JRunner(JContext(str(tmp_path)), out=io.StringIO())
    jr.pool = {k: jnp.asarray(v) for k, v in pool.items()}
    r = Runner(Context(str(tmp_path), **KW), out=io.StringIO())
    r.pool = {k: torch.as_tensor(v, **KW) for k, v in pool.items()}
    for runner, name in ((jr, "jax.json"), (r, "port.json")):
        out = runner.action_dumper({"type": "dumper", "file": name})
        assert json.loads((tmp_path / name).read_text()) == out
    assert (tmp_path / "jax.json").read_text() == \
        (tmp_path / "port.json").read_text()
    # without a file, the JSON goes to the output
    r.action_dumper({"type": "dumper"})
    assert json.loads(r.out.getvalue()) == json.loads(
        (tmp_path / "port.json").read_text())
