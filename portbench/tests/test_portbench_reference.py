"""The plain reference against cases worked by hand, and against the
program on the CPU at a small size."""

import math

import numpy as np
import pytest
import torch

from portbench import plain
from portbench.models import gtrg4_time, gy94_m0
from portbench.tests.small import ROOT, SIZES

F64 = torch.float64


def jc(t):
    e = math.exp(-4.0 * t / 3.0)
    return 0.25 + 0.75 * e, 0.25 - 0.25 * e


def test_two_taxa_by_hand():
    tree = plain.parse_newick("(a:0.1,b:0.2);")
    Q = plain.gtr_q(torch.ones(6, dtype=F64), torch.full((4,), 0.25,
                                                        dtype=F64))
    bl = torch.tensor([0.1, 0.2, 0.0], dtype=F64)
    pm = plain.transition_matrices(Q, bl[:, None])
    pats = torch.tensor([[0, 0], [0, 1]])         # columns: AA, AC
    w = torch.tensor([3, 2])
    logL, _ = plain.prune(tree, pats, w, pm, torch.full((4,), 0.25,
                                                       dtype=F64),
                          torch.ones(1, dtype=F64))
    (s1, d1), (s2, d2) = jc(0.1), jc(0.2)
    same = 0.25 * (s1 * s2 + 3 * d1 * d2)
    diff = 0.25 * (s1 * d2 + d1 * s2 + 2 * d1 * d2)
    assert float(logL) == pytest.approx(3 * math.log(same)
                                        + 2 * math.log(diff), rel=1e-13)


def test_gamma_median_rates_and_their_derivative():
    from scipy.stats import gamma

    for alpha in (0.1, 0.5, 0.8, 3.0):
        x = gamma.ppf((2 * np.arange(4) + 1) / 8, alpha)
        a = torch.tensor(alpha, dtype=F64, requires_grad=True)
        r = plain.gamma_median_rates(a, 4)
        assert np.allclose(r.detach().numpy(), x / x.mean(), rtol=1e-10)
        (g,) = torch.autograd.grad(r[0], a)
        h = 1e-6 * alpha
        xp = gamma.ppf((2 * np.arange(4) + 1) / 8, alpha + h)
        xm = gamma.ppf((2 * np.arange(4) + 1) / 8, alpha - h)
        fd = ((xp / xp.mean())[0] - (xm / xm.mean())[0]) / (2 * h)
        assert float(g) == pytest.approx(fd, rel=1e-5)


def test_coalescent_ratio_transform_and_priors_by_hand():
    tree = plain.parse_newick("((a:1,b:2):1,c:1);")
    tip_h = np.array([1.0, 0.0, 2.0])              # a, b, c
    low = plain.lowers(tree, tip_h)
    assert list(low) == [1.0, 0.0, 2.0, 1.0, 2.0]
    h = plain.heights_from_ratios(tree, torch.tensor([0.5], dtype=F64),
                                  torch.tensor(4.0, dtype=F64), tip_h, low)
    # the (a, b) node halfway between its oldest tip (1) and the root (4)
    assert h.tolist() == [1.0, 0.0, 2.0, 2.5, 4.0]
    assert float(plain.ratio_log_jacobian(tree, h, low)) == pytest.approx(
        math.log(3.0))
    theta = torch.tensor(2.0, dtype=F64)
    # lineages: 1 on [0, 1), 2 on [1, 2), 3 on [2, 2.5), 2 on [2.5, 4)
    want = -(1 * 1 + 3 * 0.5 + 1 * 1.5) / 2.0 - 2 * math.log(2.0)
    assert float(plain.constant_coalescent(h, 3, theta)) == pytest.approx(
        want)
    r, T = torch.tensor(0.01, dtype=F64), torch.tensor(7.5, dtype=F64)
    assert float(plain.ctmc_scale(r, T)) == pytest.approx(
        0.5 * math.log(7.5) - 0.5 * math.log(math.pi * 0.01) - 0.075)


def test_stick_breaking_round_trip():
    x = np.array([0.1, 0.2, 0.3, 0.4])
    y = plain.stick_breaking_inverse(x)
    back, _ = plain.stick_breaking(torch.as_tensor(y))
    assert np.allclose(back.numpy(), x, rtol=1e-14)


def test_codon_classes():
    cls = plain.codon_classes()
    i = plain.SENSE_CODONS.index
    assert len(plain.SENSE_CODONS) == 61
    assert cls[i("AAA"), i("AAG")] == 1          # Lys-Lys, transition
    assert cls[i("CTT"), i("CTA")] == 2          # Leu-Leu, transversion
    assert cls[i("AAA"), i("GAA")] == 3          # Lys-Glu, transition
    assert cls[i("AAA"), i("CAA")] == 4          # Lys-Gln, transversion
    assert cls[i("AAA"), i("CCA")] == 0


def _gtr_case(tmp_path):
    import json
    cfg = json.loads((ROOT / "portbench/configs/gtrg4-time-1024x64k.json")
                     .read_text())
    cfg.update(SIZES["gtrg4-time-1024x64k"])
    return gtrg4_time.make(cfg, 2 ** 31 + 3, "cpu", tmp_path)


def test_reference_against_the_program_gtrg4(tmp_path):
    from physher_tpu_torch.config.builder import build_config

    case = _gtr_case(tmp_path)
    ctx, _ = build_config(case.physher, base_dir=case.base_dir, dtype=F64,
                          device="cpu")
    post = ctx.objects["posterior"]
    space = post.param_space()
    u0 = plain.unconstrain(case.layout, case.init)
    rng = np.random.default_rng(1)
    for _ in range(2):
        u = u0 + 0.05 * rng.standard_normal(u0.shape)
        ut = torch.tensor(u, requires_grad=True)
        up = space.unflatten_unconstrained(ut)
        val = post.log_prob(space.constrain(up)) + space.log_jacobian(up)
        (g,) = torch.autograd.grad(val, ut)
        ref, gref = gtrg4_time.log_target(case, u, F64, "cpu", True)
        assert float(val.detach()) == pytest.approx(ref, rel=1e-12)
        assert np.abs(g.numpy() - gref).max() <= 1e-9 * np.abs(gref).max()
    fam = ctx.objects["varnormal"].family
    init = gtrg4_time.vb_init(case)
    assert np.allclose(fam.init["loc"].numpy(), init["loc"], rtol=1e-12)
    assert np.allclose(fam.init["log_scale"].numpy(), init["log_scale"])


def test_reference_against_the_program_api(tmp_path):
    from physher_tpu_torch import api
    from physher_tpu_torch.io.seqio import read_alignment

    case = _gtr_case(tmp_path)
    v = case.api_start()
    tree = api.ReparameterizedTimeTreeModelInterface(
        case.newick, None, case.dates, device="cpu")
    tlk = api.TreeLikelihoodInterface(
        read_alignment(case.fasta), tree,
        api.GTRInterface(v["rates"], v["frequencies"]),
        api.GammaSiteModelInterface(float(v["shape"]), 4),
        api.StrictClockModelInterface(float(v["rate"]), tree),
        include_jacobian=True, device="cpu")
    ref, gref = gtrg4_time.api_loglik(case, v, F64, "cpu")
    assert tlk.LogLikelihood() == pytest.approx(ref, rel=1e-12)
    g = tlk.Gradient()
    names = {"tree.ratios": "ratios", "tree.root_height": "root_height"}
    at = 0
    for k in sorted(tlk._slices):
        n = tlk._slices[k].stop - tlk._slices[k].start
        want = gref[names.get(k, k)]
        assert np.allclose(g[at:at + n], want, rtol=1e-8,
                           atol=1e-9 * np.abs(want).max())
        at += n


def test_reference_against_the_program_gy94(tmp_path):
    import json
    from physher_tpu_torch.config.builder import build_config

    cfg = json.loads((ROOT / "portbench/configs/gy94-m0-32x4096.json")
                     .read_text())
    cfg.update(SIZES["gy94-m0-32x4096"])
    case = gy94_m0.make(cfg, 7, "cpu", tmp_path)
    ctx, _ = build_config(case.physher, base_dir=case.base_dir, dtype=F64,
                          device="cpu")
    tlk = ctx.objects["treelikelihood"]
    space = tlk.param_space()
    u = plain.unconstrain(case.layout, case.init) + 0.05 * \
        np.random.default_rng(2).standard_normal(space.unconstrained_size)
    up = space.unflatten_unconstrained(torch.tensor(u))
    val = tlk.log_likelihood(space.constrain(up)) + space.log_jacobian(up)
    ref, _ = gy94_m0.log_target(case, u, F64, "cpu")
    assert float(val) == pytest.approx(ref, rel=1e-12)
