"""inference/mcmc.py, inference/marginal.py and the mcmc / mmcmc /
marginallikelihood actions on the CPU, held against the JAX package.

- The batched tempered target of ``tests/data/fluA-elbo.json``'s model (16
  temperatures, ``MCMC._split_target`` over one batch) against JAX's
  vmapped one, float64, rtol 1e-10 (the model graph in another order).
- MCMC, HMC, stepping-stone and path sampling on the conjugate normal and
  Gaussian targets of tests/test_inference.py and tests/test_hmc_adapt.py,
  at those tests' tolerances (the random streams differ from JAX's).
- The marginal-likelihood estimators against JAX's on fixed arrays
  (rtol 1e-10).
- mcmc, mmcmc and marginallikelihood configs through the port's CLI on the
  CPU and the JAX package's Runner: the same printed lines (up to the
  random numbers) and the same log headers; an mcmc config over a codon
  model (GY94 on codon_small, 2 chains as one batch) likewise, its logged
  values recomputed one chain at a time (float64, rtol 1e-10).
"""

import io
import json
import math
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import torch

from physher_tpu.config.actions import Runner as JRunner
from physher_tpu.config.builder import build_config as j_build_config
from physher_tpu.inference import marginal as j_marginal
from physher_tpu.inference import mcmc as j_mcmc
from physher_tpu_torch import cli
from physher_tpu_torch.config.actions import Runner
from physher_tpu_torch.config.builder import build_config
from physher_tpu_torch.inference import marginal, mcmc
from physher_tpu_torch.models.distributions import normal_logpdf
from physher_tpu_torch.models.parameters import ParamSpace, ParamSpec

F64 = dict(dtype=torch.float64, device="cpu")

# conjugate normal model of tests/test_inference.py: y_i ~ N(theta, s2),
# theta ~ N(0, t2)
Y = np.array([0.3, 1.2, -0.4, 0.8, 1.9, 0.1, 0.7, 1.1])
S2, T2 = 1.0, 4.0
SPACE = ParamSpace([ParamSpec.scalar("theta", 0.0)])


def log_like(params):
    """A batch of parameter dicts -> [L]."""
    return normal_logpdf(torch.as_tensor(Y), params["theta"][..., None],
                         math.sqrt(S2)).sum(-1)


def log_prior(params):
    return normal_logpdf(params["theta"], 0.0, math.sqrt(T2))


def log_post(params):
    return log_like(params) + log_prior(params)


def posterior_moments():
    prec = len(Y) / S2 + 1 / T2
    return (Y.sum() / S2) / prec, 1.0 / prec


def analytic_log_marginal():
    from scipy.stats import multivariate_normal

    n = len(Y)
    return multivariate_normal.logpdf(
        Y, np.zeros(n), S2 * np.eye(n) + T2 * np.ones((n, n)))


def test_mcmc_posterior_moments():
    res = mcmc.MCMC(SPACE, log_post).run(
        torch.Generator().manual_seed(0), SPACE.init_params(**F64),
        n_iter=40000, every=10, burnin=4000, n_chains=4)
    mean, var = posterior_moments()
    thetas = res.samples_u.reshape(-1)
    assert res.samples_u.shape == (4000, 4, 1)
    np.testing.assert_allclose(thetas.mean(), mean, atol=0.05)
    np.testing.assert_allclose(thetas.var(), var, rtol=0.2)
    assert 0.05 < np.nanmean(res.acceptance) < 0.9


def test_mcmc_vb_independence_move():
    """The "vb" operator: independence proposals from a fitted mean-field
    normal, with the Hastings correction, keep the posterior and are
    mostly accepted (the family is exact for this target)."""
    from physher_tpu_torch.inference import vb

    gen = torch.Generator().manual_seed(3)
    fam = vb.MeanFieldNormalVB(log_post, SPACE, SPACE.init_params(**F64))
    fit = vb.fit(fam, gen, steps=1500, learning_rate=0.05, grad_samples=4)
    sampler = mcmc.MCMC(SPACE, log_post,
                        vb_proposal=mcmc.vb_proposal_from(fam, fit.vparams))
    assert sampler.blocks == ["theta", "<vb>"]
    res = sampler.run(gen, SPACE.init_params(**F64), n_iter=10000, every=10,
                      burnin=1000, n_chains=4)
    mean, var = posterior_moments()
    np.testing.assert_allclose(res.samples_u.mean(), mean, atol=0.05)
    np.testing.assert_allclose(res.samples_u.var(), var, rtol=0.2)
    assert res.acceptance[1] > 0.7


def test_marginal_stepping_and_path():
    logz = analytic_log_marginal()
    val, info = marginal.marginal_likelihood(
        torch.Generator().manual_seed(4), SPACE, log_like, log_prior,
        SPACE.init_params(**F64), method="stepping", n_temps=16,
        n_iter=8000, every=5, burnin=1000)
    np.testing.assert_allclose(val, logz, atol=0.15)
    lls = [info["mcmc"].log_likelihood[:, k]
           for k in range(len(info["temperatures"]))]
    ps, _ = marginal.log_path_sampling(lls, info["temperatures"])
    np.testing.assert_allclose(ps, logz, atol=0.3)
    ps2, _ = marginal.log_path_sampling_modified(lls, info["temperatures"])
    np.testing.assert_allclose(ps2, logz, atol=0.3)


def test_estimators_match_jax():
    """Every estimator on the same fixed arrays (float64, rtol 1e-10)."""
    rng = np.random.default_rng(0)
    temps = marginal.ladder_temperatures(6)
    np.testing.assert_allclose(
        temps, (np.arange(6) / 5) ** (1 / 0.3), rtol=0, atol=0)
    lls = [rng.normal(-20.0 + 5 * t, 1.0 + t, 200) for t in temps]
    v = lls[-1]
    pairs = [
        (marginal.log_arithmetic_mean(v), j_marginal.log_arithmetic_mean(v)),
        (marginal.log_harmonic_mean(v), j_marginal.log_harmonic_mean(v)),
        (marginal.log_smoothed_harmonic_mean(-18.0, v),
         j_marginal.log_smoothed_harmonic_mean(-18.0, v)),
        (marginal.log_stabilized_harmonic_mean(v),
         j_marginal.log_stabilized_harmonic_mean(v))]
    for fn in ("log_stepping_stone", "log_path_sampling",
               "log_path_sampling_modified"):
        got, steps = getattr(marginal, fn)(lls, temps)
        want, jsteps = getattr(j_marginal, fn)(lls, temps)
        pairs.append((got, want))
        np.testing.assert_allclose(steps, jsteps, rtol=1e-10)
    for got, want in pairs:
        np.testing.assert_allclose(got, float(want), rtol=1e-10)


def test_hmc_gaussian_moments():
    space = ParamSpace([ParamSpec.vector("x", np.zeros(3))])
    mean = torch.tensor([1.0, -2.0, 0.5], **F64)
    sd = torch.tensor([0.5, 1.0, 2.0], **F64)

    def log_prob(p):
        return torch.sum(-0.5 * ((p["x"] - mean) / sd) ** 2, -1)

    res = mcmc.HMC(space, log_prob, n_leapfrog=8).run(
        torch.Generator().manual_seed(0), {"x": torch.zeros(3, **F64)},
        n_iter=1500, n_chains=8, burnin=300, step_size=0.2)
    draws = res.to_dict_of_arrays()["x"].reshape(-1, 3)
    np.testing.assert_allclose(draws.mean(0), mean.numpy(), atol=0.15)
    np.testing.assert_allclose(draws.std(0), sd.numpy(), rtol=0.2)
    # acceptance after adaptation should be reasonable
    assert res.acceptance[-1] > 0.4


def test_hmc_constrained_space():
    """Gamma(5, rate 2) on a positive parameter through the log transform."""
    space = ParamSpace([ParamSpec.scalar("r", 1.0, lower=0.0)])

    def log_prob(p):
        return 4.0 * torch.log(p["r"]) - 2.0 * p["r"]

    res = mcmc.HMC(space, log_prob, n_leapfrog=10).run(
        torch.Generator().manual_seed(1), {"r": torch.tensor(1.0, **F64)},
        n_iter=2000, n_chains=4, burnin=400, step_size=0.2)
    draws = res.to_dict_of_arrays()["r"].ravel()
    assert abs(draws.mean() - 2.5) < 0.2          # mean = a/b = 5/2
    assert abs(draws.var() - 1.25) < 0.4          # var = a/b^2


# -- the fluA model: the batched tempered target ------------------------------


def test_tempered_target_matches_jax(data_dir):
    """``_split_target`` of the tempered ladder (16 temperatures, one batch)
    on fluA-elbo.json's model, split into likelihood and prior as the
    mmcmc action splits it, against the JAX package's vmapped one."""
    with open(os.path.join(data_dir, "fluA-elbo.json")) as fh:
        cfg = json.load(fh)
    jctx, _ = j_build_config(cfg, base_dir=data_dir)
    ctx, _ = build_config(cfg, base_dir=data_dir, **F64)
    jpost, post = jctx.objects["posterior"], ctx.objects["posterior"]
    jm = j_mcmc.MCMC(jpost.param_space(),
                     **dict(zip(("log_like", "log_prior"),
                                JRunner(jctx)._split_like_prior(jpost))))
    m = mcmc.MCMC(post.param_space(),
                  **dict(zip(("log_like", "log_prior"),
                             Runner(ctx)._split_like_prior(post))))
    jspace = jpost.param_space()
    u0 = np.asarray(jspace.flatten_unconstrained(jspace.unconstrain(
        jspace.init_params())))
    z = u0 + np.random.default_rng(0).normal(0.0, 0.05, (16, len(u0)))
    temps = marginal.ladder_temperatures(16)
    jlp, jll = jax.jit(jax.vmap(jm._split_target))(jnp.asarray(z),
                                                   jnp.asarray(temps))
    with torch.no_grad():
        lp, ll = m._split_target(torch.as_tensor(z), torch.as_tensor(temps))
    assert lp.shape == ll.shape == (16,)
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), rtol=1e-10)
    np.testing.assert_allclose(ll.numpy(), np.asarray(jll), rtol=1e-10)


# -- the actions through the CLI ---------------------------------------------


def _tiny_config(data_dir):
    """fluA-elbo.json's model on tests/data/tiny.fa (10 taxa) with a dated
    caterpillar tree over its taxa, and mcmc (3 chains, tabular, tree and
    sitewise loggers), mmcmc (4 temperatures) and marginallikelihood
    actions."""
    with open(os.path.join(data_dir, "fluA-elbo.json")) as fh:
        cfg = json.load(fh)
    tlk = cfg["model"]["distributions"][0]
    tlk["sitepattern"]["alignment"]["file"] = "tiny.fa"
    with open(os.path.join(data_dir, "tiny.fa")) as fh:
        taxa = [ln[1:].strip() for ln in fh if ln.startswith(">")]
    dates = {t: tlk["tree"]["dates"][t] for t in taxa}
    top = max(dates.values())
    order = sorted(taxa, key=lambda t: top - dates[t])
    newick, h = order[0], top - dates[order[0]]
    for t in order[1:]:
        ht = top - dates[t]
        ph = max(h, ht) + 1.5
        newick = f"({newick}:{ph - h},{t}:{ph - ht})"
        h = ph
    tlk["tree"] = {"id": "tree", "type": "tree", "time": True,
                   "newick": newick + ";", "dates": dates,
                   "reparam": "tree.scalers"}
    cfg.pop("varmodel")
    cfg["physher"] = [
        {"id": "mc", "type": "mcmc", "model": "&posterior", "length": 30,
         "chains": 3,
         "operators": [{"id": "op", "type": "operator",
                        "algorithm": "scaler", "x": "&rate",
                        "weight": 3.0}],
         "log": [{"id": "lg", "type": "logger", "every": 10,
                  "file": "mc.log", "models": ["&posterior",
                                               "&treelikelihood"],
                  "x": ["&rate", "&n0"]},
                 {"id": "lt", "type": "logger", "every": 10,
                  "file": "mc.trees", "models": ["&tree"]},
                 {"id": "ls", "type": "logger", "every": 15,
                  "file": "mc.site", "models": ["&treelikelihood"],
                  "sitewise": True}]},
        {"id": "mmcmc", "type": "mmcmc", "model": "&posterior",
         "length": 20, "temperatures": 4, "every": 5, "burnin": 5},
        {"id": "ml", "type": "marginallikelihood", "mmcmc": "&mmcmc",
         "methods": ["stepping", "path", "path2", "harmonic", "stabilized",
                     "arithmetic"]}]
    return cfg


def _masked(line):
    """A printed line with its numbers replaced (the random streams
    differ)."""
    return re.sub(r"-?\d+\.\d+|nan", "#", line)


def test_cli_mcmc_mmcmc_marginal_match_jax(data_dir, tmp_path):
    cfg = _tiny_config(data_dir)
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    for d in (jdir, pdir):
        d.mkdir()
        (d / "tiny.fa").symlink_to(os.path.join(data_dir, "tiny.fa"))
        (d / "config.json").write_text(json.dumps(cfg))
    jctx, jactions = j_build_config(cfg, base_dir=str(jdir))
    jout = io.StringIO()
    JRunner(jctx, seed=0, out=jout).run(jactions)
    out = io.StringIO()
    runner = cli.run([str(pdir / "config.json"), "--device", "cpu"],
                     out=out)
    jlines = jout.getvalue().splitlines()
    lines = out.getvalue().splitlines()
    assert lines[-1].startswith("Total runtime: ")
    assert [_masked(x) for x in lines[:-1]] == [_masked(x) for x in jlines]
    assert lines[0].startswith("MCMC finished: 30 iterations; acceptance ")
    assert lines[1].startswith("log marginal likelihood: stepping-stone ")
    assert [x.split(":")[0] for x in lines[2:-1]] == [
        "stepping", "path", "path2", "harmonic", "stabilized", "arithmetic"]
    for name in ("mc.log", "mc.trees", "mc.site"):
        jtext = (jdir / name).read_text().splitlines()
        text = (pdir / name).read_text().splitlines()
        assert len(text) == len(jtext), name
        if name == "mc.trees":
            assert text[:2] == jtext[:2] == ["#NEXUS", "begin trees;"]
            assert text[2].startswith("tree STATE_0 = (")
            assert [_masked(x) for x in text] == [_masked(x) for x in jtext]
        else:
            # the tabular header; the sitewise weights line and header
            n = 2 if name == "mc.site" else 1
            assert text[:n] == jtext[:n], name
            assert [x.split("\t")[0] for x in text] == [
                x.split("\t")[0] for x in jtext]
    res = runner.results["mc"]
    # 8 ratios, the root height, the clock rate and the coalescent's theta
    assert res.samples_u.shape == (3, 3, 11)
    # the logged log-posterior of chain 0 is the sampler's own (its target
    # without the transforms' Jacobian)
    table = np.loadtxt(pdir / "mc.log", skiprows=1)
    np.testing.assert_allclose(table[:, 1], res.log_likelihood[:, 0],
                               rtol=1e-9)
    temps, lls, ladder = runner.results["mmcmc"]
    assert ladder.samples_u.shape[1] == 4 and len(lls) == 4


def _gy94_config(data_dir):
    """GY94 (free frequencies) over tests/data/codon_small.fa on its tree
    with branch lengths, and an mcmc action with 2 chains, 40 steps and a
    tabular logger."""
    with open(os.path.join(data_dir, "codon_small.nwk")) as fh:
        newick = fh.read().strip()
    return {
        "model": {
            "id": "treelikelihood", "type": "treelikelihood",
            "sitepattern": {"id": "patterns", "type": "sitepattern",
                            "datatype": "codon",
                            "alignment": {"id": "seqs", "type": "alignment",
                                          "file": "codon_small.fa"}},
            "sitemodel": {"id": "sitemodel", "type": "sitemodel",
                          "substitutionmodel": {
                              "id": "sm", "type": "substitutionmodel",
                              "model": "gy94", "datatype": "codon"}},
            "tree": {"id": "tree", "type": "tree", "newick": newick}},
        "physher": [
            {"id": "mc", "type": "mcmc", "model": "&treelikelihood",
             "length": 40, "chains": 2,
             "operators": [{"id": "op", "type": "operator",
                            "algorithm": "scaler", "x": "%sm.omega",
                            "weight": 20.0}],
             "log": [{"id": "lg", "type": "logger", "every": 10,
                      "file": "mc.log", "models": ["&treelikelihood"],
                      "x": ["%sm.kappa", "%sm.omega"]}]}]}


def test_cli_mcmc_codon_matches_jax(data_dir, tmp_path):
    """mcmc over a GY94 config through the port's CLI on the CPU (the two
    chains one batch through the model) and the JAX Runner: the same
    printed line up to the numbers and the same log header; the logged
    log-likelihoods of chain 0 are the model's, recomputed one chain at a
    time."""
    cfg = _gy94_config(data_dir)
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    for d in (jdir, pdir):
        d.mkdir()
        (d / "codon_small.fa").symlink_to(
            os.path.join(data_dir, "codon_small.fa"))
        (d / "config.json").write_text(json.dumps(cfg))
    jctx, jactions = j_build_config(cfg, base_dir=str(jdir))
    jout = io.StringIO()
    JRunner(jctx, seed=0, out=jout).run(jactions)
    out = io.StringIO()
    runner = cli.run([str(pdir / "config.json"), "--device", "cpu"],
                     out=out)
    lines = out.getvalue().splitlines()
    assert [_masked(x) for x in lines[:-1]] == [
        _masked(x) for x in jout.getvalue().splitlines()]
    assert lines[0].startswith("MCMC finished: 40 iterations; acceptance ")
    text = (pdir / "mc.log").read_text().splitlines()
    assert text[0] == (jdir / "mc.log").read_text().splitlines()[0] == \
        "state\ttreelikelihood\tsm.kappa\tsm.omega"
    res = runner.results["mc"]
    tlk = runner.ctx.objects["treelikelihood"]
    # 14 branch lengths, kappa, omega and the 61 frequencies' 60
    assert res.samples_u.shape == (4, 2, 76)
    assert tlk.engine_name(2) == "torch"
    logged = np.loadtxt(pdir / "mc.log", skiprows=1)
    with torch.no_grad():
        again = [float(tlk.log_likelihood(res.params_at(i)))
                 for i in range(len(logged))]
    np.testing.assert_allclose(logged[:, 1], again, rtol=1e-10)
    # the sampler's own value of its target without the Jacobian
    np.testing.assert_allclose(logged[:, 1], res.log_likelihood[:, 0],
                               rtol=1e-9)
