"""Gamma quantiles for the median-Gamma site model (PyTorch, differentiable).

Port of the parts of ``physher_tpu/utils/special.py`` that the discretized
Gamma site model needs (reference: src/phyc/gamma.c qgamma). PyTorch has no
``gammaincinv``, and ``torch.special.gammainc`` has no gradient in its first
argument, so:

- :func:`gammaincinv` is an ``autograd.Function``: a Wilson-Hilferty start
  plus 60 damped Newton steps on P(a, x) = p in the forward, and the
  implicit derivative in the backward, with dP/da from a 4-point central
  difference (the reference also falls back to finite differences,
  src/phyc/sitemodel.h:72);
- :func:`qgamma_fixed_p` interpolates host-tabulated log-quantiles at fixed
  probabilities (the float32 path; the table is built once with
  ``scipy.special.gammaincinv``).
"""

from __future__ import annotations

import numpy as np
import torch


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
        eps = 1e-5 * torch.clamp(a_b, min=1.0)
        P = torch.special.gammainc
        dPda = (8.0 * (P(a_b + eps, x) - P(a_b - eps, x))
                - (P(a_b + 2 * eps, x) - P(a_b - 2 * eps, x))) / (12.0 * eps)
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
    y0 = logq[i - 1]
    y1 = logq[i]
    y2 = logq[i + 1]
    y3 = logq[i + 2]
    a0 = y1
    a1 = 0.5 * (y2 - y0)
    a2 = y0 - 2.5 * y1 + 2.0 * y2 - 0.5 * y3
    a3 = 0.5 * (y3 - y0) + 1.5 * (y1 - y2)
    logv = a0 + f * (a1 + f * (a2 + f * a3))
    return torch.exp(logv) / alpha[..., None]
