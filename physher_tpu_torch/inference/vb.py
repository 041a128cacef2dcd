"""Variational inference: ADVI with mean-field and full-rank normal,
mean-field gamma and Weibull families, and the forward-KL fit.

Port of ``physher_tpu/inference/vb.py`` (reference: src/phyc/vb.c
variational_t and blocks, src/phyc/klqp.c reverse-KL ELBO with the
reparameterization trick, multi-sample ELBO klqp.h:17-19, src/phyc/gamvi.c
and weibullvi.c, src/phyc/klpq.c, transforms and log-Jacobians
src/phyc/transforms.c). The variational posterior lives on the
unconstrained space of a ParamSpace; ``constrain`` and ``log_jacobian``
reproduce the reference's transform bookkeeping (klqp.c:340-430).

Random draws come from a ``torch.Generator``; the two packages' streams
differ, so their fits agree in converged values, not step by step. Where
the JAX package ``vmap``s the target over an ELBO's draws, the port hands
the model all the draws as one batch of chains (tensors ``[n, ...]``): on
the card one K5' launch for a convergence check (forward only, under
``torch.no_grad()``) and one K5'/K6' pair for a step with ``grad_samples >
1``, in chunks of at most ``max_chains`` rows (``ml.batched_rows``; the
config builder passes ``ml.hessian_chunk`` of the posterior). A one-draw
step stays one chain: the one-chain kernels. The optimizer is
``torch.optim.Adam``, with the reference's eta/sqrt(t) step-size schedule
in the ADVI fit (the JAX package's ``adam(rsqrt_decay=True)``) and without
it in the forward-KL fit, as there.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from ..models.parameters import ParamSpace
from ..ops.loop import MAX_CHAINS
from ..utils.profiling import span
from .ml import batched_rows

LOG_2PI = math.log(2.0 * math.pi)


@dataclass
class VBResult:
    vparams: dict
    elbo: float
    iterations: int
    history: list = field(default_factory=list)
    # host seconds of the fit, and of its multi-sample convergence checks
    seconds: float = 0.0
    check_seconds: float = 0.0


class MeanFieldNormalVB:
    """Fully factorized normal over the unconstrained space (reference:
    klqp.c klqp_block_meanfield_normal_*). ``max_chains``: the rows of
    one batched call of the target."""

    def __init__(self, log_prob: Callable, space: ParamSpace, params: dict,
                 init_sigma: float = 0.1, max_chains: int = MAX_CHAINS):
        self.log_prob = log_prob
        self.space = space
        self.max_chains = max_chains
        self.dim = space.unconstrained_size
        with torch.no_grad():
            u0 = space.flatten_unconstrained(space.unconstrain(params))
        self.init = {"loc": u0.clone(),
                     "log_scale": torch.full_like(u0, math.log(init_sigma))}

    def _target(self, z):
        """log p(constrain(z)) + log |J| at unconstrained points z ``[(n,)
        dim]``."""
        uparams = self.space.unflatten_unconstrained(z)
        return (self.log_prob(self.space.constrain(uparams))
                + self.space.log_jacobian(uparams))

    def log_target(self, z):
        """:meth:`_target` at the rows of z ``[n, dim]`` -> ``[n]``: each
        chunk of at most ``max_chains`` rows one batch of chains through the
        model; one row is one chain (the one-chain kernels)."""
        if z.shape[0] == 1:
            return torch.reshape(self._target(z[0]), (1,))
        return batched_rows(self._target, z, self.max_chains)

    def draw(self, vparams, generator: torch.Generator, n: int):
        """Standard normal draws [n, dim] for :meth:`elbo`."""
        loc = vparams["loc"]
        return torch.randn((n, self.dim), generator=generator,
                           dtype=loc.dtype, device=loc.device)

    def sample_unconstrained(self, vparams, eps):
        return vparams["loc"] + torch.exp(vparams["log_scale"]) * eps

    def log_q(self, vparams, z):
        scale = torch.exp(vparams["log_scale"])
        r = (z - vparams["loc"]) / scale
        return torch.sum(-0.5 * (LOG_2PI + r * r) - vparams["log_scale"], -1)

    def entropy(self, vparams):
        return (torch.sum(vparams["log_scale"])
                + 0.5 * self.dim * (1.0 + LOG_2PI))

    def elbo(self, vparams, generator: torch.Generator = None,
             n_samples: int = 1, eps=None):
        """Monte-Carlo ELBO over ``n_samples`` draws from ``generator``, or
        over the given standard draws ``eps`` [n, dim], evaluated as one
        batch (:meth:`log_target`)."""
        if eps is None:
            eps = self.draw(vparams, generator, n_samples)
        z = self.sample_unconstrained(vparams, eps)
        return torch.mean(self.log_target(z)) + self.entropy(vparams)

    def sample(self, vparams, generator: torch.Generator = None,
               n: int = 1, eps=None):
        """Constrained-space draws (a batch of ``n`` parameter dicts) and
        their log q less the transform's log-Jacobian ``[n]``, the proposal
        density of importance sampling; from ``generator`` or the given
        standard draws ``eps``."""
        if eps is None:
            eps = self.draw(vparams, generator, n)
        z = self.sample_unconstrained(vparams, eps)
        uparams = self.space.unflatten_unconstrained(z)
        logq = self.log_q(vparams, z) - self.space.log_jacobian(uparams)
        return self.space.constrain(uparams), logq


class FullRankNormalVB(MeanFieldNormalVB):
    """Multivariate normal with a Cholesky scale (reference: klqp.c fullrank
    and vb.c multivariatenormal block)."""

    def __init__(self, log_prob, space, params, init_sigma: float = 0.1,
                 max_chains: int = MAX_CHAINS):
        super().__init__(log_prob, space, params, init_sigma, max_chains)
        d = self.dim
        self.tril_idx = np.tril_indices(d, -1)
        loc = self.init["loc"]
        self.init = {"loc": loc,
                     "log_diag": torch.full_like(loc, math.log(init_sigma)),
                     "off": loc.new_zeros(len(self.tril_idx[0]))}

    def scale_tril(self, vparams):
        d = self.dim
        loc = vparams["loc"]
        rows = torch.as_tensor(self.tril_idx[0], device=loc.device)
        cols = torch.as_tensor(self.tril_idx[1], device=loc.device)
        L = loc.new_zeros((d, d)).index_put((rows, cols), vparams["off"])
        return L + torch.diag(torch.exp(vparams["log_diag"]))

    def sample_unconstrained(self, vparams, eps):
        return vparams["loc"] + eps @ self.scale_tril(vparams).T

    def log_q(self, vparams, z):
        L = self.scale_tril(vparams)
        y = torch.linalg.solve_triangular(
            L, (z - vparams["loc"]).reshape(-1, self.dim).T, upper=False).T
        y = y.reshape(z.shape)
        return (-0.5 * torch.sum(y * y, -1) - 0.5 * self.dim * LOG_2PI
                - torch.sum(vparams["log_diag"]))

    def entropy(self, vparams):
        return (torch.sum(vparams["log_diag"])
                + 0.5 * self.dim * (1.0 + LOG_2PI))


class GammaMeanFieldVB(MeanFieldNormalVB):
    """Fully factorized gamma family (reference: src/phyc/gamvi.c, gamma
    mean-field by the Generalized Reparameterization Gradient).

    As in the JAX package, the block lives on the unconstrained space as a
    log-gamma: z = log g with g ~ Gamma(alpha, rate beta); for a positive
    parameter (z = log x) the induced distribution of x is the reference's
    Gamma(alpha, beta). The standard draws are Gamma(alpha, 1)
    (``torch._standard_gamma``, whose implicit-reparameterization gradient
    in alpha replaces the reference's GRG correction terms,
    gamvi.c:12-30).
    """

    def __init__(self, log_prob, space, params, init_shape: float = 10.0,
                 max_chains: int = MAX_CHAINS):
        super().__init__(log_prob, space, params, max_chains=max_chains)
        u0 = self.init["loc"]
        log_alpha = torch.full_like(u0, math.log(init_shape))
        # match the mode: log(alpha / beta) = u0
        self.init = {"log_alpha": log_alpha, "log_beta": log_alpha - u0}

    def draw(self, vparams, generator: torch.Generator, n: int):
        """Gamma(alpha, 1) draws [n, dim]."""
        alpha = torch.exp(vparams["log_alpha"])
        return torch._standard_gamma(
            alpha.expand(n, self.dim).contiguous(), generator=generator)

    def sample_unconstrained(self, vparams, eps):
        return torch.log(eps) - vparams["log_beta"]

    def log_q(self, vparams, z):
        alpha = torch.exp(vparams["log_alpha"])
        beta = torch.exp(vparams["log_beta"])
        # log-gamma density: b^a / Gamma(a) exp(a z - b e^z)
        return torch.sum(alpha * vparams["log_beta"] - torch.lgamma(alpha)
                         + alpha * z - beta * torch.exp(z), -1)

    def entropy(self, vparams):
        alpha = torch.exp(vparams["log_alpha"])
        # -E[log q(z)]: E[z] = digamma(a) - log b, E[e^z] = a / b
        return -torch.sum(alpha * torch.digamma(alpha) - alpha
                          - torch.lgamma(alpha))


class WeibullMeanFieldVB(MeanFieldNormalVB):
    """Fully factorized Weibull family (reference: src/phyc/weibullvi.c
    klqp_block_meanfield_weibull_* with qweibull inverse-CDF sampling).

    x ~ Weibull(shape k, scale lam) on the positive axis, expressed on the
    unconstrained space as z = log x. The inverse CDF x = lam (-log(1 -
    u))^(1/k) of a uniform draw u is an explicit reparameterization
    (weibullvi.c:17-19).
    """

    def __init__(self, log_prob, space, params, init_shape: float = 5.0,
                 max_chains: int = MAX_CHAINS):
        super().__init__(log_prob, space, params, max_chains=max_chains)
        u0 = self.init["loc"]
        self.init = {"log_shape": torch.full_like(u0, math.log(init_shape)),
                     "log_scale": u0}

    def draw(self, vparams, generator: torch.Generator, n: int):
        """Uniform draws [n, dim] on [1e-12, 1 - 1e-12]."""
        like = vparams["log_shape"]
        u = torch.rand((n, self.dim), generator=generator, dtype=like.dtype,
                       device=like.device)
        return 1e-12 + (1.0 - 2e-12) * u

    def sample_unconstrained(self, vparams, eps):
        k = torch.exp(vparams["log_shape"])
        return vparams["log_scale"] + torch.log(-torch.log1p(-eps)) / k

    def log_q(self, vparams, z):
        k = torch.exp(vparams["log_shape"])
        y = z - vparams["log_scale"]          # log(x / lam)
        # the Weibull log-density in x with the Jacobian x of z = log x:
        # log k + k log(x / lam) - (x / lam)^k
        return torch.sum(vparams["log_shape"] + k * y - torch.exp(k * y), -1)

    def entropy(self, vparams):
        # e^{k y} ~ Exp(1), so E[e^{k y}] = 1 and E[k y] = -euler_gamma
        euler = 0.5772156649015329
        return torch.sum(-vparams["log_shape"] + euler + 1.0)


def fit_klpq(vb, generator: torch.Generator, *, steps: int = 2000,
             learning_rate: float = 0.05, n_samples: int = 32,
             log_every: int = 0) -> VBResult:
    """Forward-KL variational fit: minimize KL(p || q) (reference:
    src/phyc/klpq.c grad_klpq_normal_meanfield).

    The gradient of E_p[log q] is estimated by self-normalized importance
    sampling with q as the proposal: w_i = p(z_i) / q(z_i), normalized and
    detached, loss = -sum_i w_i log q(z_i). The draws and their weights
    carry no gradient, so the target's batch is forward only (one K5'
    launch a step on the card). Adam at a constant rate, as in the JAX
    package."""
    vparams = {k: v.detach().clone().requires_grad_(True)
               for k, v in vb.init.items()}
    opt = torch.optim.Adam(list(vparams.values()), lr=learning_rate)
    history = []
    kl = float("nan")
    t0 = time.perf_counter()
    for it in range(steps):
        with torch.no_grad():
            z = vb.sample_unconstrained(
                vparams, vb.draw(vparams, generator, n_samples))
            logp = vb.log_target(z)
        logq = vb.log_q(vparams, z)
        logw = (logp - logq).detach()
        w = torch.softmax(logw, 0)
        opt.zero_grad(set_to_none=True)
        (-torch.sum(w * logq)).backward()
        opt.step()
        if log_every and (it + 1) % log_every == 0:
            kl = float(torch.sum(w * logw))
            history.append(kl)
            print(f"iter {it + 1} E_w[logp-logq] {kl:.4f}")
    if steps:
        kl = float(torch.sum(w * logw))
    _sync(next(iter(vparams.values())).device)
    return VBResult({k: v.detach() for k, v in vparams.items()}, kl, steps,
                    history, seconds=time.perf_counter() - t0)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def adam(vparams: dict, learning_rate: float):
    """(optimizer, schedule) over the leaf tensors ``vparams``: Adam whose
    t-th step (from 1) has the size learning_rate / sqrt(t), the reference's
    stochastic-Adam schedule (gradascent.c:257 ``eta_scaled = eta /
    sqrt(iter)``); with one-sample ELBO gradients a constant rate stalls a
    few nats above the optimum."""
    opt = torch.optim.Adam(list(vparams.values()), lr=learning_rate)
    return opt, torch.optim.lr_scheduler.LambdaLR(
        opt, lambda t: (t + 1) ** -0.5)


def step(vb, vparams: dict, opt, schedule, generator: torch.Generator,
         grad_samples: int = 1):
    """One Adam step, in place, of the leaf tensors ``vparams`` on the
    negative ELBO over ``grad_samples`` draws."""
    with span("physher.vb.step"):
        opt.zero_grad(set_to_none=True)
        with span("physher.vb.elbo"):
            loss = -vb.elbo(vparams, generator, grad_samples)
        with span("physher.vb.backward"):
            loss.backward()
        with span("physher.vb.adam"):
            opt.step()
            schedule.step()


def fit(vb, generator: torch.Generator, *, steps: int = 5000,
        learning_rate: float = 0.02, grad_samples: int = 1,
        elbo_samples: int = 100, elbo_every: int = 100, tol: float = 1e-4,
        patience: int = 10) -> VBResult:
    """Adam on the negative ELBO (reference: optimizer.c OPT_SG_ADAM and the
    gradascent.c loop with periodic multi-sample ELBO checks).

    The step size follows the reference's eta/sqrt(t) schedule
    (:func:`adam`). Every ``elbo_every`` steps the ELBO is
    estimated over ``elbo_samples`` draws that are fixed for the whole fit
    (common random numbers, so that successive checks are comparable: one
    seed, as in the JAX package), as one batch of chains (chunked by
    ``vb.max_chains``); the fit stops after ``patience`` checks without a
    gain of ``tol`` and returns the best checked variational parameters."""
    vparams = {k: v.detach().clone().requires_grad_(True)
               for k, v in vb.init.items()}
    opt, schedule = adam(vparams, learning_rate)
    device = next(iter(vparams.values())).device

    def snapshot():
        return {k: v.detach().clone() for k, v in vparams.items()}

    # the convergence checks redraw their draws from one fixed seed
    seed = int(torch.randint(2 ** 62, (1,), generator=generator,
                             device=device))
    eval_gen = torch.Generator(device=device)

    def check():
        return float(vb.elbo(vparams, eval_gen.manual_seed(seed),
                             elbo_samples))

    best, best_v, since = -np.inf, snapshot(), 0
    history = []
    it = 0
    check_s = 0.0
    t0 = time.perf_counter()
    for it in range(1, steps + 1):
        step(vb, vparams, opt, schedule, generator, grad_samples)
        if it % elbo_every == 0:
            _sync(device)  # the check's time excludes the steps' queued work
            tc = time.perf_counter()
            with torch.no_grad():
                e = check()
            check_s += time.perf_counter() - tc
            history.append(e)
            if e > best + tol:
                best, best_v, since = e, snapshot(), 0
            else:
                since += 1
                if since >= patience:
                    break
    if not history:
        # no periodic check ran (steps < elbo_every): report the final state
        # with one multi-sample evaluation
        tc = time.perf_counter()
        with torch.no_grad():
            best = check()
        check_s += time.perf_counter() - tc
        best_v = snapshot()
    _sync(device)
    return VBResult(best_v, best, it, history,
                    seconds=time.perf_counter() - t0, check_seconds=check_s)
