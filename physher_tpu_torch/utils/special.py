"""Special functions of the site and clock models (PyTorch, differentiable).

Port of ``physher_tpu/utils/special.py`` (reference: src/phyc/gamma.c
qgamma, src/phyc/gausslaguerre.c). PyTorch has no ``gammaincinv``,
``betainc`` or ``betaincinv``, and ``torch.special.gammainc`` has no
gradient in its first argument, so:

- :func:`gammaincinv` is an ``autograd.Function``: a Wilson-Hilferty start
  plus 60 damped Newton steps on P(a, x) = p in the forward, and the
  implicit derivative in the backward, with dP/da from a 4-point central
  difference (the reference also falls back to finite differences,
  src/phyc/sitemodel.h:72);
- :func:`gammainc` is ``torch.special.gammainc`` with a derivative in ``a``
  (the same 4-point central difference);
- :func:`betainc` is the regularized incomplete beta by its continued
  fraction (modified Lentz) at a fixed number of terms, and
  :func:`betaincinv` inverts it by the JAX package's 80 guarded Newton
  steps, with the JAX package's custom JVP as its backward;
- :func:`qgamma_fixed_p` interpolates host-tabulated log-quantiles at fixed
  probabilities (the float32 path of the median Gamma quadrature; the table
  is built once with ``scipy.special.gammaincinv``).
"""

from __future__ import annotations

import numpy as np
import torch

from .profiling import span


def _log_pdf(a, x):
    return (a - 1.0) * torch.log(x) - x - torch.lgamma(a)


def _gammaincinv_newton(a: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """x with P(a, x) = p: Wilson-Hilferty start, 60 damped Newton steps."""
    g = torch.special.ndtri(p)
    c = 2.0 / (9.0 * a)
    x = a * (1.0 - c + g * torch.sqrt(c)) ** 3
    x = torch.clamp(x, min=1e-8)
    for _ in range(60):
        f = torch.special.gammainc(a, x) - p
        step = f / torch.exp(_log_pdf(a, x))
        # dampen: limit to halving/doubling
        step = torch.maximum(torch.minimum(step, 0.5 * x), -0.5 * x)
        x = torch.clamp(x - step, min=1e-300)
    return x


def _dgammainc_da(a, x, step=1e-5):
    """dP(a, x)/da by a 4-point central difference at ``step`` times
    max(a, 1) (needs a > 2 of those)."""
    eps = step * torch.clamp(a, min=1.0)
    P = torch.special.gammainc
    return (8.0 * (P(a + eps, x) - P(a - eps, x))
            - (P(a + 2 * eps, x) - P(a - 2 * eps, x))) / (12.0 * eps)


class _GammaIncInv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, p):
        a_b, p_b = torch.broadcast_tensors(a, p)
        x = _gammaincinv_newton(a_b, p_b)
        ctx.save_for_backward(a, p, x)
        return x

    @staticmethod
    def backward(ctx, gx):
        a, p, x = ctx.saved_tensors
        a_b = a.expand_as(x)
        dPdx = torch.exp(_log_pdf(a_b, x))
        dPda = _dgammainc_da(a_b, x)
        ga = gp = None
        if ctx.needs_input_grad[0]:
            ga = (-gx * dPda / dPdx).sum_to_size(a.shape)
        if ctx.needs_input_grad[1]:
            gp = (gx / dPdx).sum_to_size(p.shape)
        return ga, gp


def gammaincinv(a: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """x such that P(a, x) = p (regularized lower incomplete gamma inverse),
    differentiable in ``a`` and ``p``."""
    return _GammaIncInv.apply(a, p)


def qgamma(p, shape, rate):
    """Lower-tail gamma quantile (reference: src/phyc/gamma.c qgamma)."""
    return gammaincinv(shape, p) / rate


# -- fixed-probability gamma quantiles (the float32 path) --------------------
#
# Site models only need quantiles at a fixed probability vector with a free
# shape parameter, so log q(alpha) := log gammaincinv(alpha, p) is tabulated
# once on a dense log-alpha grid on the host (scipy, float64) and
# interpolated with a Catmull-Rom cubic: C1-differentiable, max relative
# error < 1e-7 over alpha in [1e-3, 1e3].

_QGAMMA_TABLE_CACHE: dict = {}
_QGAMMA_LO, _QGAMMA_HI, _QGAMMA_N = 1e-3, 1e3, 16384


def _qgamma_table(p_tuple):
    hit = _QGAMMA_TABLE_CACHE.get(p_tuple)
    if hit is not None:
        return hit
    from scipy.special import gammaincinv as sp_gammaincinv

    u = np.linspace(np.log(_QGAMMA_LO), np.log(_QGAMMA_HI), _QGAMMA_N)
    q = np.stack([sp_gammaincinv(np.exp(u), p) for p in p_tuple], 0)
    with np.errstate(divide="ignore"):
        # tiny-alpha quantiles underflow float64 to 0; clamp at the float32
        # exp underflow bound (those rates are exactly 0 in float32 anyway)
        logq = np.maximum(np.log(q), -87.0)
    tab = (float(u[0]), float(u[1] - u[0]), logq)
    _QGAMMA_TABLE_CACHE[p_tuple] = tab
    return tab


def _rows(table: torch.Tensor, *index: torch.Tensor) -> list:
    """``table[j]`` for each index tensor ``j``; a 0-d index is read on the
    host, one host-device synchronization each."""
    if index[0].dim():
        return [table[j] for j in index]
    rows = []
    for j in index:
        with span("physher.sync.index"):
            rows.append(table[j])
    return rows


def qgamma_fixed_p(p_tuple: tuple, alpha: torch.Tensor) -> torch.Tensor:
    """Gamma(alpha, rate=alpha) quantiles at fixed probabilities ``p_tuple``:
    ``[..., K]`` for shapes ``alpha [...]``.

    Catmull-Rom interpolation of host-precomputed log-quantiles in
    log-alpha; differentiable w.r.t. ``alpha`` through the interpolant.
    Outside [1e-3, 1e3] the shape is clamped."""
    p_tuple = tuple(float(x) for x in p_tuple)
    u0, du, logq_np = _qgamma_table(p_tuple)
    key = (p_tuple, alpha.device, alpha.dtype)
    logq = _QGAMMA_TABLE_CACHE.get(key)
    if logq is None:
        # [grid, K]: a row per grid point
        logq = torch.as_tensor(logq_np.T.copy(), dtype=alpha.dtype,
                               device=alpha.device)
        _QGAMMA_TABLE_CACHE[key] = logq
    n = logq.shape[0]
    u = torch.log(torch.clamp(alpha, _QGAMMA_LO, _QGAMMA_HI))
    t = (u - u0) / du
    i = torch.clamp(torch.floor(t).long(), 1, n - 3)
    f = (t - i)[..., None]
    y0, y1, y2, y3 = _rows(logq, i - 1, i, i + 1, i + 2)
    a0 = y1
    a1 = 0.5 * (y2 - y0)
    a2 = y0 - 2.5 * y1 + 2.0 * y2 - 0.5 * y3
    a3 = 0.5 * (y3 - y0) + 1.5 * (y1 - y2)
    logv = a0 + f * (a1 + f * (a2 + f * a3))
    return torch.exp(logv) / alpha[..., None]


class _GammaInc(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, x):
        ctx.save_for_backward(a, x)
        return torch.special.gammainc(a, x)

    @staticmethod
    def backward(ctx, g):
        a, x = ctx.saved_tensors
        a_b, x_b = torch.broadcast_tensors(a, x)
        ga = gx = None
        if ctx.needs_input_grad[0]:
            ga = (g * _dgammainc_da(a_b, x_b, 1e-3)).sum_to_size(a.shape)
        if ctx.needs_input_grad[1]:
            gx = (g * torch.exp(_log_pdf(a_b, x_b))).sum_to_size(x.shape)
        return ga, gx


def gammainc(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Regularized lower incomplete gamma P(a, x), differentiable in ``a``
    (needs a > 2e-3) and ``x``."""
    return _GammaInc.apply(a, x)


def qweibull1(p, shape):
    """Weibull quantile with scale lambda=1 (reference:
    src/phyc/sitemodel.c icdf_weibull_1)."""
    return (-torch.log1p(-p)) ** (1.0 / shape)


def qlognormal(p, mu, sigma):
    return torch.exp(mu + sigma * torch.special.ndtri(p))


def qnorm(p, mu, sigma):
    return mu + sigma * torch.special.ndtri(p)


# -- the regularized incomplete beta and its inverse -------------------------

# terms of the continued fraction: past the symmetry switch below it
# converges in O(sqrt(max(a, b))) terms; 32 already agree with
# jax.scipy.special.betainc to 2e-13 for shapes up to 50
_BETACF_TERMS = 48


def _betacf(a, b, x):
    """The continued fraction of I_x(a, b) (modified Lentz, a fixed number of
    terms; reference: Numerical Recipes betacf)."""
    fpmin = torch.finfo(x.dtype).tiny / torch.finfo(x.dtype).eps

    def fix(v):
        return torch.where(v.abs() < fpmin, torch.full_like(v, fpmin), v)

    qab, qap, qam = a + b, a + 1.0, a - 1.0
    c = torch.ones_like(x)
    d = 1.0 / fix(1.0 - qab * x / qap)
    h = d
    for m in range(1, _BETACF_TERMS + 1):
        m2 = 2.0 * m
        for aa in (m * (b - m) * x / ((qam + m2) * (a + m2)),
                   -(a + m) * (qab + m) * x / ((a + m2) * (qap + m2))):
            d = 1.0 / fix(1.0 + aa * d)
            c = fix(1.0 + aa / c)
            h = h * d * c
    return h


def _log_beta(a, b):
    return torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)


def betainc(a, b, x):
    """Regularized incomplete beta I_x(a, b), batched, in the dtype of its
    inputs (no gradient; :func:`betaincinv` differentiates it by central
    differences, as the JAX package does)."""
    a, b, x = torch.broadcast_tensors(a, b, x)
    swap = x > (a + 1.0) / (a + b + 2.0)
    a2, b2 = torch.where(swap, b, a), torch.where(swap, a, b)
    xs = torch.clamp(torch.where(swap, 1.0 - x, x), 0.0, 1.0)
    inner = (xs > 0) & (xs < 1)
    xi = torch.where(inner, xs, torch.full_like(xs, 0.5))
    front = torch.exp(a2 * torch.log(xi) + b2 * torch.log1p(-xi)
                      - _log_beta(a2, b2)) / a2
    val = torch.where(inner, front * _betacf(a2, b2, xi),
                      torch.where(xs <= 0, torch.zeros_like(xs),
                                  torch.ones_like(xs)))
    return torch.where(swap, 1.0 - val, val)


def _beta_log_pdf(a, b, x):
    return (a - 1) * torch.log(x) + (b - 1) * torch.log1p(-x) - _log_beta(a, b)


def _betaincinv_newton(a, b, p):
    """x with I_x(a, b) = p: the JAX package's 80 Newton steps from the
    mean, a step that leaves (0, 1) replaced by half the way to the bound
    it crosses, clipped to [1e-15, 1 - 1e-15]."""
    x = torch.clamp(a / (a + b), 1e-8, 1 - 1e-8)
    for _ in range(80):
        f = betainc(a, b, x) - p
        xn = x - f / torch.exp(_beta_log_pdf(a, b, x))
        xn = torch.where((xn <= 0) | (xn >= 1),
                         x - torch.sign(f) * x * (1 - x) * 0.5, xn)
        x = torch.clamp(xn, 1e-15, 1 - 1e-15)
    return x


class _BetaIncInv(torch.autograd.Function):
    """The JAX package's custom JVP, transposed: dx = (dp - dI/da da -
    dI/db db) / (dI/dx), with dI/da and dI/db by central differences of
    :func:`betainc` at a step of 1e-6."""

    @staticmethod
    def forward(ctx, a, b, p):
        a_b, b_b, p_b = torch.broadcast_tensors(a, b, p)
        x = _betaincinv_newton(a_b, b_b, p_b)
        ctx.save_for_backward(a, b, p, x)
        return x

    @staticmethod
    def backward(ctx, gx):
        a, b, p, x = ctx.saved_tensors
        a_b, b_b = a.expand_as(x), b.expand_as(x)
        g = gx / torch.exp(_beta_log_pdf(a_b, b_b, x))
        eps = 1e-6
        ga = gb = gp = None
        if ctx.needs_input_grad[0]:
            dIda = (betainc(a_b + eps, b_b, x)
                    - betainc(a_b - eps, b_b, x)) / (2 * eps)
            ga = (-g * dIda).sum_to_size(a.shape)
        if ctx.needs_input_grad[1]:
            dIdb = (betainc(a_b, b_b + eps, x)
                    - betainc(a_b, b_b - eps, x)) / (2 * eps)
            gb = (-g * dIdb).sum_to_size(b.shape)
        if ctx.needs_input_grad[2]:
            gp = g.sum_to_size(p.shape)
        return ga, gb, gp


def betaincinv(a: torch.Tensor, b: torch.Tensor,
               p: torch.Tensor) -> torch.Tensor:
    """x such that I_x(a, b) = p (regularized incomplete beta inverse),
    differentiable in ``a``, ``b`` and ``p``."""
    return _BetaIncInv.apply(a, b, p)


def gauss_laguerre(n: int):
    """Nodes/weights of n-point Gauss-Laguerre quadrature (host-side numpy),
    generalized weight x^alpha handled by caller (reference:
    src/phyc/gausslaguerre.c gaulag)."""
    return np.polynomial.laguerre.laggauss(n)


def log1mexp(x):
    """log(1 - exp(-x)) for x > 0, numerically stable."""
    return torch.where(x < np.log(2.0), torch.log(-torch.expm1(-x)),
                       torch.log1p(-torch.exp(-x)))
