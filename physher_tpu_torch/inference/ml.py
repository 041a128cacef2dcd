"""Maximum-likelihood / MAP optimization.

Port of ``physher_tpu/inference/ml.py`` (reference: src/phyc/optimizer.c:
meta/Brent/serial-Brent/BFGS/CG/SG/Adam, src/phyc/checkpoint.c). Every
optimizer works on the unconstrained parameters:

- Adam is ``torch.optim.Adam`` (the JAX package's own Adam,
  ``physher_tpu/utils/optim.py``, is the same algorithm: same bias
  correction, eps outside the square root);
- L-BFGS is ``torch.optim.LBFGS`` with the strong-Wolfe line search, one
  ``step`` an iteration (optax's zoom line search takes other paths to the
  same optimum);
- the meta strategy runs (a batched multistart warmup,) Adam, then rounds
  of L-BFGS and a bounded Brent pass over the scalar parameters, as the
  JAX package does.

The batched parts evaluate every start, learning rate or difference point
as one chain of a batch (``log_prob`` takes a parameter dict whose tensors
carry a leading axis ``[L, ...]``, as the MCMC samplers hand it): on the
card that is one K5'/K6' launch pair a step whatever the number of rows.
The Hessian is a central difference of the exact (autograd) gradient over
such a batch, not a second derivative through the kernels' backward.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from ..models.parameters import ParamSpace
from ..ops.loop import MAX_CHAINS

# device bytes the rows of one batched Hessian call may take (the K5'/K6'
# buffers of TreeLikelihood.chain_bytes); more rows run in chunks
HESSIAN_BYTES = 8 << 30


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


def _leaves(space: ParamSpace, params: dict) -> dict:
    with torch.no_grad():
        u = space.unconstrain(params)
    return {k: v.detach().clone().requires_grad_(True) for k, v in u.items()}


def _flat_start(space: ParamSpace, params: dict) -> torch.Tensor:
    with torch.no_grad():
        return space.flatten_unconstrained(space.unconstrain(params))


def _flat_loss(log_prob, space: ParamSpace, flat: torch.Tensor):
    """-logP of each row of ``flat [L, n]`` (one batched model call)."""
    return -log_prob(space.constrain(space.unflatten_unconstrained(flat)))


def optimize_adam(log_prob, space: ParamSpace, params: dict, *,
                  learning_rate: float = 0.05, max_iter: int = 5000,
                  tol: float = 1e-6, patience: int = 100,
                  checkpoint: Optional[str] = None,
                  checkpoint_every: int = 1000,
                  log_every: int = 0) -> OptResult:
    """Adam on the unconstrained reparameterization (reference:
    src/phyc/gradascent.c optimize_stochastic_gradient_adam).

    As in the JAX package, each step evaluates the loss at the current
    point and then moves; ``history`` holds those logP values, and the
    returned parameters are the ones reached by the step whose starting
    point had the best logP. ``checkpoint`` names a CSV written every
    ``checkpoint_every`` steps and at the end.
    """
    uparams = _leaves(space, params)
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
        if checkpoint and it % checkpoint_every == 0 and it > 0:
            with torch.no_grad():
                save_checkpoint(checkpoint, space.constrain(best_u))
    with torch.no_grad():
        final = space.constrain(best_u)
    if checkpoint:
        save_checkpoint(checkpoint, final)
    return OptResult(final, -best, it + 1, since < patience, history,
                     seconds=time.perf_counter() - t0)


def optimize_adam_adapt(log_prob, space: ParamSpace, params: dict, *,
                        etas=(1.0, 0.1, 0.01, 0.001), trial_iter: int = 100,
                        **kw) -> OptResult:
    """Learning-rate search, then a full Adam run at the winner (reference:
    src/phyc/gradascent.c:141-203 optimize_stochastic_gradient_adapt, which
    trials the etas on a thread pool). The trials run as ONE batched
    optimization, a row of ``[len(etas), n]`` an eta: Adam written out with
    a per-row learning rate (the update of ``torch.optim.Adam``)."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    flat0 = _flat_start(space, params)
    eta = torch.as_tensor(list(etas), dtype=flat0.dtype,
                          device=flat0.device)[:, None]
    flat = flat0.expand(eta.shape[0], -1).clone()
    m = torch.zeros_like(flat)
    v = torch.zeros_like(flat)
    for t in range(1, trial_iter + 1):
        leaf = flat.requires_grad_(True)
        (g,) = torch.autograd.grad(
            _flat_loss(log_prob, space, leaf).sum(), [leaf])
        with torch.no_grad():
            m = b1 * m + (1.0 - b1) * g
            v = b2 * v + (1.0 - b2) * g * g
            c1, c2 = 1.0 - b1 ** t, 1.0 - b2 ** t
            flat = leaf.detach() - eta * (m / c1) / (torch.sqrt(v / c2) + eps)
    with torch.no_grad():
        finals = _flat_loss(log_prob, space, flat)
    finals = torch.where(torch.isfinite(finals), finals,
                         torch.full_like(finals, np.inf))
    best_eta = float(etas[int(torch.argmin(finals))])
    return optimize_adam(log_prob, space, params, learning_rate=best_eta,
                         **kw)


def optimize_lbfgs(log_prob, space: ParamSpace, params: dict, *,
                   max_iter: int = 500, tol: float = 1e-8,
                   history_size: int = 20,
                   checkpoint: Optional[str] = None) -> OptResult:
    """L-BFGS with the strong-Wolfe line search on the unconstrained space
    (replacement for the reference's BFGS/CG, src/phyc/bfgs.c, frpmrn.c).
    Stops when the loss moves by less than ``tol``, turns non-finite, or
    after ``max_iter`` iterations; ``checkpoint`` names a CSV that gets the
    final parameters. A trial point of the line search where the loss is
    not finite counts as a loss above the start's."""
    uparams = _leaves(space, params)
    leaves = list(uparams.values())
    # one iteration a step; the line search gets its 25 evaluations past
    # the step's first (max_eval bounds both); the stopping rule is the
    # loop's below, so torch's own tolerances are off (its 1e-9 on g.d
    # stops it short of the optimum along directions of little curvature)
    opt = torch.optim.LBFGS(leaves, lr=1.0, max_iter=1, max_eval=26,
                            tolerance_grad=0.0, tolerance_change=0.0,
                            history_size=history_size,
                            line_search_fn="strong_wolfe")
    loss = _make_loss(log_prob, space)
    first = []

    def closure():
        opt.zero_grad(set_to_none=True)
        val = loss(uparams)
        if not first:
            first.append(abs(float(val.detach())))
        if bool(torch.isfinite(val)):
            val.backward()
            return val
        # a trial point where the model is not finite (the search's
        # extrapolation far out): a finite loss above the run's first and
        # no gradient, so that the strong-Wolfe search brackets the point
        # and backs off from it, as optax's zoom search does in the JAX
        # package; torch's search would step on past a NaN
        for leaf in leaves:
            leaf.grad = torch.zeros_like(leaf)
        return val.new_tensor(10.0 * first[0] + 1e6).detach()

    prev = np.inf
    it = 0
    converged = False
    t0 = time.perf_counter()
    for it in range(max_iter):
        v = float(opt.step(closure).detach())
        if not np.isfinite(v):
            break
        if abs(prev - v) < tol:
            converged = True
            break
        prev = v
    with torch.no_grad():
        final_val = float(loss(uparams))
        final = space.constrain({k: t.detach() for k, t in uparams.items()})
    if checkpoint:
        save_checkpoint(checkpoint, final)
    return OptResult(final, -final_val, it + 1, converged,
                     seconds=time.perf_counter() - t0)


def brent_minimize(f, lo: float, hi: float, *, tol: float = 1e-8,
                   max_iter: int = 100):
    """Bounded scalar minimization: golden-section start + parabolic steps
    (reference: src/phyc/brent.c — the workhorse the meta-optimizer uses
    for per-parameter line searches)."""
    gr = 0.3819660112501051  # 2 - golden ratio
    a, b = float(lo), float(hi)
    x = w = v = a + gr * (b - a)
    fx = fw = fv = f(x)
    d = e = 0.0
    for _ in range(max_iter):
        m = 0.5 * (a + b)
        tol1 = tol * abs(x) + 1e-12
        if abs(x - m) <= 2 * tol1 - 0.5 * (b - a):
            break
        use_gold = True
        if abs(e) > tol1:
            # parabolic fit through x, w, v
            r = (x - w) * (fx - fv)
            q = (x - v) * (fx - fw)
            p = (x - v) * q - (x - w) * r
            q = 2.0 * (q - r)
            if q > 0:
                p = -p
            q = abs(q)
            if (abs(p) < abs(0.5 * q * e) and p > q * (a - x)
                    and p < q * (b - x)):
                e, d = d, p / q
                u = x + d
                if (u - a) < 2 * tol1 or (b - u) < 2 * tol1:
                    d = tol1 if x < m else -tol1
                use_gold = False
        if use_gold:
            e = (b if x < m else a) - x
            d = gr * e
        u = x + (d if abs(d) >= tol1 else (tol1 if d > 0 else -tol1))
        fu = f(u)
        if fu <= fx:
            if u >= x:
                a = x
            else:
                b = x
            v, w, x = w, x, u
            fv, fw, fx = fw, fx, fu
        else:
            if u < x:
                a = u
            else:
                b = u
            if fu <= fw or w == x:
                v, w = w, u
                fv, fw = fw, fu
            elif fu <= fv or v == x or v == w:
                v, fv = u, fu
    return x, fx


def _brent_scalar_pass(log_prob, space: ParamSpace, params: dict,
                       tol: float) -> dict:
    """One round of bounded Brent over each *scalar* parameter with the
    rest fixed (reference: serial-Brent sub-optimizers inside meta,
    optimizer.c:100-152). Escapes coordinate-wise local basins that joint
    gradient descent falls into (e.g. extreme gamma-shape starts). Each
    evaluation is one forward call of the model, without a graph."""
    params = dict(params)
    for spec in space.free_specs():
        if spec.unconstrained_size != 1 or params[spec.name].numel() != 1:
            continue
        name = spec.name
        like = params[name]
        uspec = ParamSpace([spec])

        def value(p):
            with torch.no_grad():
                return float(log_prob(p))

        def constrained(u):
            x = uspec.constrain({name: torch.tensor(u, dtype=torch.float64)})
            return x[name].to(dtype=like.dtype, device=like.device)

        def f(u):
            return -value({**params, name: constrained(u)})

        with torch.no_grad():
            u0 = float(uspec.unconstrain(
                {name: like.detach().to(torch.float64).cpu()})[name])
        span = max(3.0, abs(u0))
        ub, fb = brent_minimize(f, u0 - span, u0 + span, tol=tol)
        if fb < -value(params) - tol:
            params[name] = constrained(ub)
    return params


def _multistart_warmup(log_prob, space: ParamSpace, params: dict, *,
                       n_starts: int = 6, iters: int = 300,
                       learning_rate: float = 0.05, jitter: float = 1.5,
                       seed: int = 0) -> dict:
    """Batched Adam from jittered starts; returns the best start's params.

    The reference's meta-optimizer escapes coordinate-local basins with
    serial bounded Brent per scalar (optimizer.c:100-152); here the starts
    are the rows of one ``[n_starts, n]`` unconstrained leaf, optimized
    together (``torch.optim.Adam`` moves each entry on its own, so the
    rows stay independent): one batched model call a step. Scalar
    parameters (gamma shape, kappa, pinv...) get unconstrained-space jitter
    from a generator seeded by ``seed``; vectors keep their initial values,
    and row 0 is the start itself.
    """
    u0 = _flat_start(space, params)
    mask = torch.zeros(space.unconstrained_size, dtype=u0.dtype)
    for off, size in space.unconstrained_slices().values():
        if size == 1:
            mask[off] = 1.0
    gen = torch.Generator().manual_seed(seed)
    noise = torch.randn((n_starts, u0.numel()), generator=gen,
                        dtype=u0.dtype)
    starts = u0 + (jitter * mask * noise).to(u0.device)
    starts[0] = u0
    flat = starts.requires_grad_(True)
    opt = torch.optim.Adam([flat], lr=learning_rate)
    for _ in range(iters):
        opt.zero_grad(set_to_none=True)
        _flat_loss(log_prob, space, flat).sum().backward()
        opt.step()
    with torch.no_grad():
        losses = _flat_loss(log_prob, space, flat)
        losses = torch.where(torch.isfinite(losses), losses,
                             torch.full_like(losses, np.inf))
        best = flat[int(torch.argmin(losses))].detach()
        return space.constrain(space.unflatten_unconstrained(best))


def optimize(log_prob, space: ParamSpace, params: dict, *,
             method: str = "meta", n_starts: int = 1, **kw) -> OptResult:
    """``method="adam"``, ``"lbfgs"`` or ``"meta"``. Meta: (a batched
    multistart warmup if ``n_starts > 1``,) Adam, then up to 10 rounds of
    L-BFGS and a bounded-Brent pass over the scalars, with 1000 more Adam
    steps after a Brent gain, until no round improves by more than ``tol``
    (the reference's meta-optimizer loop contract, optimizer.c:154-210 with
    serial-Brent sub-optimizers). A ``checkpoint`` CSV gets the first Adam
    run's checkpoints and, at the end, the meta result."""
    if method == "adam":
        return optimize_adam(log_prob, space, params, **kw)
    if method == "lbfgs":
        return optimize_lbfgs(log_prob, space, params, **kw)
    if method != "meta":
        raise ValueError(f"unknown method {method!r}")
    t0 = time.perf_counter()
    tol = kw.pop("tol", 1e-6)
    if n_starts > 1:
        params = _multistart_warmup(log_prob, space, params,
                                    n_starts=n_starts)
    lr = kw.pop("learning_rate", 0.05)
    res = optimize_adam(log_prob, space, params, tol=tol, learning_rate=lr,
                        max_iter=kw.pop("adam_iter", 2000), **kw)
    total_it = res.iterations
    for _round in range(10):
        res2 = optimize_lbfgs(log_prob, space, res.params, tol=tol)
        total_it += res2.iterations
        if res2.logp > res.logp:
            res = res2
        # scalar Brent escape pass (reference: meta rounds re-run serial
        # Brent until the gain drops below tolfx)
        brent_params = _brent_scalar_pass(log_prob, space, res.params, tol)
        with torch.no_grad():
            blogp = float(log_prob(brent_params))
        if blogp > res.logp + max(tol, 1e-4):
            res = OptResult(brent_params, blogp, total_it, False)
            res3 = optimize_adam(log_prob, space, res.params, tol=tol,
                                 learning_rate=lr, max_iter=1000)
            total_it += res3.iterations
            if res3.logp > res.logp:
                res = res3
        elif res2.logp <= res.logp + tol:
            break
    if kw.get("checkpoint"):
        save_checkpoint(kw["checkpoint"], res.params)
    return OptResult(res.params, res.logp, total_it, True,
                     seconds=time.perf_counter() - t0)


# -- the Hessian --------------------------------------------------------------


def hessian(log_prob, space: ParamSpace, params: dict, *,
            jacobian: bool = False, max_chains: int = MAX_CHAINS):
    """The Hessian of ``f(u) = log_prob(constrain(u))`` (``+ log|J|(u)``
    with ``jacobian``) in the unconstrained space at ``params``:
    (H [n, n] float64 on the CPU, f(u), the gradient at u).

    Central differences of the exact gradient: the rows ``u + h_i e_i``,
    ``u - h_i e_i`` and ``u`` go through the model as one batch of 2n + 1
    chains (one forward and one backward call; chunks of at most
    ``max_chains`` rows where that is less), ``H[i] = (G+_i - G-_i) / 2h_i``
    and H is symmetrized. ``h_i = eps^(1/3) max(1, |u_i|)`` in the model's
    dtype. A second derivative through the model would need the kernels'
    backward to be differentiable, and the plain engine's eigendecomposition
    of Q carries no graph (``models/substitution._PtReversible``) nor is
    its eigh differentiable at repeated eigenvalues (JC69); the reference's
    Hessian is a finite difference too (src/phyc/hessian.c).
    """
    u = _flat_start(space, params)
    n = u.numel()
    eps = torch.finfo(u.dtype).eps
    h = eps ** (1.0 / 3.0) * torch.clamp(u.abs(), min=1.0)
    eye = torch.eye(n, dtype=u.dtype, device=u.device)
    plus = u + h[:, None] * eye
    minus = u - h[:, None] * eye
    # the steps as the rows hold them after rounding
    steps = (plus.diagonal() - minus.diagonal()).to(torch.float64).cpu()

    def fn(leaf):
        up = space.unflatten_unconstrained(leaf)
        f = log_prob(space.constrain(up))
        return f + space.log_jacobian(up) if jacobian else f

    values, G = batched_rows(fn, torch.cat([plus, minus, u[None]]),
                             max_chains, grad=True)
    H = (G[:n] - G[n: 2 * n]) / steps[:, None]
    return 0.5 * (H + H.T), float(values[-1]), G[-1]


def batched_rows(fn, rows: torch.Tensor, max_chains: int = MAX_CHAINS, *,
                 grad: bool = False):
    """``fn`` of the rows ``[L, n]`` -> ``[L, ...]``, one batched call of
    ``fn`` a chunk of at most ``max_chains`` rows. Without ``grad``: the
    values, where autograd records them with their graph. With ``grad``:
    the values and the gradient of each row's value by its row, float64 on
    the CPU, one backward a chunk."""
    values, grads = [], []
    chunk = max(1, int(max_chains))
    for i in range(0, rows.shape[0], chunk):
        r = rows[i: i + chunk]
        if grad:
            r = r.detach().requires_grad_(True)
            f = fn(r)
            (g,) = torch.autograd.grad(f.sum(), [r])
            values.append(f.detach())
            grads.append(g.detach())
        else:
            f = torch.as_tensor(fn(r), dtype=r.dtype, device=r.device)
            values.append(torch.broadcast_to(f, r.shape[:1] + f.shape[1:]))
    if not grad:
        return torch.cat(values)
    return (torch.cat(values).to(torch.float64).cpu(),
            torch.cat(grads).to(torch.float64).cpu())


def hessian_chunk(model) -> int:
    """Rows of one batched Hessian call for ``model``: as many as fit in
    ``HESSIAN_BYTES`` by its tree likelihoods' ``chain_bytes``."""
    comps = getattr(model, "components", [model])
    per_chain = sum(c.chain_bytes() for c in comps
                    if hasattr(c, "chain_bytes"))
    return max(1, HESSIAN_BYTES // per_chain) if per_chain else MAX_CHAINS


# -- checkpointing (reference: src/phyc/checkpoint.c name,value CSV) --------


def save_checkpoint(path: str, params: dict) -> None:
    """Atomic-ish name,value CSV (reference: checkpoint.c:40-62)."""
    lines = []
    for name, value in params.items():
        arr = np.ravel(np.asarray(torch.as_tensor(value).detach().cpu(),
                                  np.float64))
        if arr.size == 1:
            lines.append(f"{name},{float(arr[0]):.17g}")
        else:
            for i, v in enumerate(arr):
                lines.append(f"{name}.{i},{float(v):.17g}")
    tmp = path + ".new"
    with open(tmp, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    os.replace(tmp, path)


def load_checkpoint(path: str, params: dict) -> dict:
    """Restore values by name into an existing parameter dict (reference:
    checkpoint.c checkpoint_apply): tensors in the dtype and on the device
    of ``params``; names the file lacks keep their values."""
    values: dict[str, float] = {}
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            name, _, val = line.rpartition(",")
            values[name] = float(val)
    out = {}
    for name, value in params.items():
        arr = np.array(value.detach().cpu(), dtype=np.float64)
        if arr.ndim == 0:
            if name in values:
                arr = np.asarray(values[name])
        else:
            for i in range(arr.size):
                k = f"{name}.{i}"
                if k in values:
                    arr.flat[i] = values[k]
        out[name] = torch.as_tensor(arr, dtype=value.dtype,
                                    device=value.device)
    return out
