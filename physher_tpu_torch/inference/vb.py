"""Variational inference: ADVI with mean-field and full-rank normal families.

Port of ``physher_tpu/inference/vb.py`` (reference: src/phyc/vb.c
variational_t and blocks, src/phyc/klqp.c reverse-KL ELBO with the
reparameterization trick, multi-sample ELBO klqp.h:17-19, transforms and
log-Jacobians src/phyc/transforms.c). The variational posterior lives on the
unconstrained space of a ParamSpace; ``constrain`` and ``log_jacobian``
reproduce the reference's transform bookkeeping (klqp.c:340-430).

Random draws come from a ``torch.Generator``; the two packages' streams
differ, so their fits agree in converged values, not step by step. The JAX
package ``vmap``s the target over the ELBO's samples; the port's kernels
have no batch axis yet, so a multi-sample ELBO is a loop of one-sample
evaluations (forward-only under ``torch.no_grad()`` in the convergence
checks), and a one-sample gradient step is one forward and one backward.
The optimizer is ``torch.optim.Adam`` with the reference's eta/sqrt(t)
step-size schedule (the JAX package's ``adam(rsqrt_decay=True)``). The
gamma and Weibull families are not ported yet.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from ..models.parameters import ParamSpace

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
    klqp.c klqp_block_meanfield_normal_*)."""

    def __init__(self, log_prob: Callable, space: ParamSpace, params: dict,
                 init_sigma: float = 0.1):
        self.log_prob = log_prob
        self.space = space
        self.dim = space.unconstrained_size
        with torch.no_grad():
            u0 = space.flatten_unconstrained(space.unconstrain(params))
        self.init = {"loc": u0.clone(),
                     "log_scale": torch.full_like(u0, math.log(init_sigma))}

    def _target(self, z):
        """log p(constrain(z)) + log |J| at one unconstrained point z."""
        uparams = self.space.unflatten_unconstrained(z)
        return (self.log_prob(self.space.constrain(uparams))
                + self.space.log_jacobian(uparams))

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
        over the given standard normal draws ``eps`` [n, dim]."""
        if eps is None:
            eps = self.draw(vparams, generator, n_samples)
        z = self.sample_unconstrained(vparams, eps)
        lp = sum(self._target(zi) for zi in z) / z.shape[0]
        return lp + self.entropy(vparams)


class FullRankNormalVB(MeanFieldNormalVB):
    """Multivariate normal with a Cholesky scale (reference: klqp.c fullrank
    and vb.c multivariatenormal block)."""

    def __init__(self, log_prob, space, params, init_sigma: float = 0.1):
        super().__init__(log_prob, space, params, init_sigma)
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
    opt.zero_grad(set_to_none=True)
    (-vb.elbo(vparams, generator, grad_samples)).backward()
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
    (common random numbers, so that successive checks are comparable); the
    fit stops after ``patience`` checks without a gain of ``tol`` and
    returns the best checked variational parameters."""
    vparams = {k: v.detach().clone().requires_grad_(True)
               for k, v in vb.init.items()}
    opt, schedule = adam(vparams, learning_rate)
    device = vparams["loc"].device

    def snapshot():
        return {k: v.detach().clone() for k, v in vparams.items()}

    # the fixed evaluation draws of the convergence checks
    eval_eps = vb.draw(vparams, generator, elbo_samples)
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
                e = float(vb.elbo(vparams, eps=eval_eps))
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
            best = float(vb.elbo(vparams, eps=eval_eps))
        check_s += time.perf_counter() - tc
        best_v = snapshot()
    _sync(device)
    return VBResult(best_v, best, it, history,
                    seconds=time.perf_counter() - t0, check_seconds=check_s)
