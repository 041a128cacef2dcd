"""Maximum-likelihood / MAP optimization (Adam).

Port of ``optimize_adam``, ``_make_loss`` and the ``method="adam"`` branch
of ``optimize`` of ``physher_tpu/inference/ml.py`` (reference:
src/phyc/gradascent.c optimize_stochastic_gradient_adam). The JAX package's
own Adam (``physher_tpu/utils/optim.py``) is the same algorithm as
``torch.optim.Adam`` (same bias correction, eps outside the square root),
so the port uses ``torch.optim.Adam`` on the unconstrained parameters. The
meta strategy, L-BFGS, the Brent pass and the CSV checkpoint are not ported
yet (ROADMAP Queue 1 item 8).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from ..models.parameters import ParamSpace


@dataclass
class OptResult:
    params: dict
    logp: float
    iterations: int
    converged: bool
    history: list = field(default_factory=list)
    # host seconds of the optimization
    seconds: float = 0.0


def _make_loss(log_prob: Callable, space: ParamSpace):
    def loss(uparams):
        return -log_prob(space.constrain(uparams))

    return loss


def optimize_adam(log_prob, space: ParamSpace, params: dict, *,
                  learning_rate: float = 0.05, max_iter: int = 5000,
                  tol: float = 1e-6, patience: int = 100,
                  log_every: int = 0) -> OptResult:
    """Adam on the unconstrained reparameterization.

    As in the JAX package, each step evaluates the loss at the current
    point and then moves; ``history`` holds those logP values, and the
    returned parameters are the ones reached by the step whose starting
    point had the best logP.
    """
    uparams = {k: v.detach().clone().requires_grad_(True)
               for k, v in space.unconstrain(params).items()}
    opt = torch.optim.Adam(list(uparams.values()), lr=learning_rate)
    loss = _make_loss(log_prob, space)
    best = np.inf
    best_u = {k: v.detach().clone() for k, v in uparams.items()}
    since = 0
    history = []
    it = 0
    t0 = time.perf_counter()
    for it in range(max_iter):
        opt.zero_grad(set_to_none=True)
        val = loss(uparams)
        val.backward()
        opt.step()
        v = float(val.detach())
        history.append(-v)
        if log_every and it % log_every == 0:
            print(f"iter {it} logP {-v:.6f}")
        if v < best - tol:
            best, since = v, 0
            best_u = {k: t.detach().clone() for k, t in uparams.items()}
        else:
            since += 1
            if since >= patience:
                break
    with torch.no_grad():
        final = space.constrain(best_u)
    return OptResult(final, -best, it + 1, since < patience, history,
                     seconds=time.perf_counter() - t0)


def optimize(log_prob, space: ParamSpace, params: dict, *,
             method: str = "adam", **kw) -> OptResult:
    """The JAX package's ``optimize`` for ``method="adam"`` (as
    ``config/actions.py`` calls it); any other method raises."""
    if method != "adam":
        raise NotImplementedError(
            f"optimizer method {method!r} is not ported to physher_tpu_torch "
            "yet (ROADMAP Queue 1 item 8); use 'adam'")
    return optimize_adam(log_prob, space, params, **kw)
