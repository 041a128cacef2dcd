"""MCMC: Metropolis-Hastings with block proposals over a batch of chains,
tempering, and HMC.

Port of ``MCMCResult``, ``MCMC``, ``HMC`` and ``vb_proposal_from`` of
``physher_tpu/inference/mcmc.py`` (reference: src/phyc/mcmc.c:60-185
store/propose/accept loop, src/phyc/operator.c operators with the 0.24
acceptance self-tuning at operator.c:403-414, src/phyc/mmcmc.c temperature
ladders, src/phyc/ophmc.c):

- the chain state is a flat unconstrained vector; proposals are Gaussian
  random walks on parameter blocks (one block per ParamSpec, chosen with
  the per-spec weights), which subsumes the reference's scaler/slider/
  randomwalk operators after the constrain transform,
- the chains are a leading batch axis L that runs through the target: the
  target gets a batch of parameter dicts (tensors ``[L, ...]``) and returns
  ``[L]`` log-densities, so one MH iteration of every chain is one pass
  through the model (on the card, one launch of the batched kernels K5'/K6'
  of ``ops/loop.py``), where the JAX package ``vmap``s the chains,
- tempered targets ``T * ll + lp + jac``, one temperature per chain (a
  ladder is one batch), and the generalized stepping stone's ``log_ref``,
- step sizes adapt every ``adapt_interval`` iterations toward 0.24
  acceptance.

Randomness comes from one ``torch.Generator`` on the chains' device:
``torch.multinomial`` for the block, ``randn`` for the walk and ``rand`` for
the accept test, which give other numbers than the JAX keys. Accept and
reject stay on the device (``torch.where``); the samples come to the host
once per ``every`` iterations, as in the JAX package. ``MixedMCMC`` adds a
bit vector per chain (bits ``[L, n_bits]``) with the reference's bitflip
move.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..models.parameters import ParamSpace
from ..utils.profiling import span


def _per_chain(x, like: torch.Tensor) -> torch.Tensor:
    """A target's value as ``[L]`` (a constant term broadcasts)."""
    return torch.broadcast_to(torch.as_tensor(x, dtype=like.dtype,
                                              device=like.device),
                              like.shape[:1])


def _host(x: torch.Tensor, name: str) -> np.ndarray:
    """``x`` copied to the host (a host-device synchronization) inside the
    span ``name``."""
    with span(name):
        return x.cpu().numpy()


@dataclass
class MCMCResult:
    samples_u: np.ndarray        # [n_samples, n_chains, dim] unconstrained
    log_posterior: np.ndarray    # [n_samples, n_chains]
    log_likelihood: np.ndarray   # [n_samples, n_chains] (if like/prior split)
    acceptance: np.ndarray       # [n_blocks] final acceptance rates
    step_sizes: np.ndarray
    space: ParamSpace = None
    # True when the run was cut short by SIGINT between chunks; samples hold
    # what was collected so far (reference: mcmc.c:21-28 clean finalize)
    interrupted: bool = False
    # where params_at / to_dict_of_arrays put the constrained values
    dtype: torch.dtype = torch.float64
    device: torch.device = torch.device("cpu")

    def constrain(self, u: np.ndarray) -> dict:
        """Unconstrained samples [..., dim] -> constrained values (a batch
        for a leading axis), on the result's device."""
        with span("physher.sync.h2d"):
            z = torch.as_tensor(u, dtype=self.dtype, device=self.device)
        with torch.no_grad():
            return self.space.constrain(self.space.unflatten_unconstrained(z))

    def params_at(self, i, chain=0) -> dict:
        return self.constrain(self.samples_u[i, chain])

    def to_dict_of_arrays(self) -> dict:
        """Constrained samples stacked per parameter: {name: [S, C, ...]}."""
        S, C, _ = self.samples_u.shape
        cons = self.constrain(self.samples_u.reshape(S * C, -1))
        return {k: v.cpu().numpy().reshape((S, C) + tuple(v.shape[1:]))
                for k, v in cons.items()}


class HMC:
    """Hamiltonian Monte Carlo over a ParamSpace (reference: src/phyc/
    ophmc.c, leapfrog with the model's dlogP): the gradient of the
    unconstrained log-posterior comes from one ``backward`` of its sum over
    the chains (they are independent), and the step size adapts toward
    ``target_accept`` during burn-in.

    ``log_prob`` takes a batch of parameter dicts and returns ``[L]``.
    """

    def __init__(self, space: ParamSpace, log_prob: Callable, *,
                 n_leapfrog: int = 10):
        self.space = space
        self.log_prob = log_prob
        self.L = n_leapfrog
        self._dim = space.unconstrained_size

    def _target(self, z):
        uparams = self.space.unflatten_unconstrained(z)
        return _per_chain(self.log_prob(self.space.constrain(uparams))
                          + self.space.log_jacobian(uparams), z)

    def _value_and_grad(self, z):
        with torch.enable_grad():
            q = z.detach().requires_grad_(True)
            v = self._target(q)
            (g,) = torch.autograd.grad(v.sum(), q)
        return v.detach(), g

    def run(self, generator: torch.Generator, params: dict, *,
            n_iter: int = 1000, every: int = 1, n_chains: int = 4,
            step_size: float = 0.05, burnin: int = 100, adapt: bool = True,
            target_accept: float = 0.8) -> MCMCResult:
        space = self.space
        dim = self._dim
        with torch.no_grad():
            u0 = space.flatten_unconstrained(space.unconstrain(params))
        kw = dict(dtype=u0.dtype, device=u0.device)
        us = u0 + 0.01 * torch.randn((n_chains, dim), generator=generator,
                                     **kw)
        lp, g = self._value_and_grad(us)
        n_samples = n_iter // every
        burn_chunks = burnin // every
        samples = np.empty((n_samples, n_chains, dim))
        lps = np.empty((n_samples, n_chains))
        eps = step_size
        si = 0
        acc_hist = []
        for ci in range(n_samples + burn_chunks):
            n_ok = torch.zeros(n_chains, **kw)
            for _ in range(every):
                p0 = torch.randn(us.shape, generator=generator, **kw)
                q, p, gq = us, p0, g
                for _ in range(self.L):
                    p = p + 0.5 * eps * gq
                    q = q + eps * p
                    new_lp, gq = self._value_and_grad(q)
                    p = p + 0.5 * eps * gq
                log_alpha = (new_lp - lp - 0.5 * torch.sum(p * p, -1)
                             + 0.5 * torch.sum(p0 * p0, -1))
                u = torch.rand(n_chains, generator=generator, **kw)
                ok = (torch.log(u) < log_alpha) & torch.isfinite(new_lp)
                us = torch.where(ok[:, None], q, us)
                lp = torch.where(ok, new_lp, lp)
                g = torch.where(ok[:, None], gq, g)
                n_ok = n_ok + ok.to(u0.dtype)
            rate = float(n_ok.sum()) / (n_chains * every)
            acc_hist.append(rate)
            if adapt and ci < burn_chunks:
                eps *= float(np.exp(0.5 * (rate - target_accept)))
            if ci >= burn_chunks:
                samples[si] = us.cpu().numpy()
                lps[si] = lp.cpu().numpy()
                si += 1
        return MCMCResult(samples, lps, lps.copy(), np.asarray(acc_hist),
                          np.asarray([eps]), space, dtype=u0.dtype,
                          device=u0.device)


def vb_proposal_from(family, vparams):
    """(sample_fn(generator, n) -> u [n, dim], logq_fn(u [n, dim]) -> [n])
    over the flat unconstrained vector from a fitted variational family
    (``MeanFieldNormalVB`` / ``FullRankNormalVB``): the MCMC independence-
    proposal form of the reference's "vb" operator (src/phyc/opvb.c)."""
    def sample_fn(generator, n):
        return family.sample_unconstrained(
            vparams, family.draw(vparams, generator, n))

    def logq_fn(u):
        return family.log_q(vparams, u)

    return sample_fn, logq_fn


class MCMC:
    """Metropolis-Hastings over a ParamSpace, a batch of chains at a time.

    ``log_like`` / ``log_prior`` enable tempered targets
    logP_T = T * log_like + log_prior (+ unconstraining Jacobian); with only
    ``log_prob`` the target is untempered. Each callable takes a batch of
    parameter dicts (tensors ``[L, ...]``) and returns ``[L]``.
    """

    def __init__(self, space: ParamSpace, log_prob: Callable = None, *,
                 log_like: Callable = None, log_prior: Callable = None,
                 log_ref: Callable = None, weights: dict | None = None,
                 vb_proposal=None, vb_weight: float = 1.0):
        self.space = space
        if log_prob is None and log_like is None:
            raise ValueError("need log_prob or log_like")
        self.log_prob = log_prob
        self.log_like = log_like
        self.log_prior = log_prior
        # generalized stepping stone: with a reference (working) distribution
        # the tempered target is (like*prior)^T * ref^(1-T)
        # (reference: mmcmc.c:18-105 GSS mode)
        self.log_ref = log_ref
        # independence proposals from a fitted variational distribution
        # (reference: src/phyc/opvb.c "vb" operator, whose own logHR is an
        # acknowledged TODO at opvb.c:55; here the Hastings correction
        # log q(u) - log q(u') is applied), from ``vb_proposal_from``
        self.vb_proposal = vb_proposal
        self.vb_weight = float(vb_weight)
        # one proposal block per free spec
        self.blocks = []
        idx = 0
        dim = space.unconstrained_size
        self._dim = dim
        masks = []
        w = []
        for s in space.free_specs():
            n = s.unconstrained_size
            m = np.zeros(dim)
            m[idx: idx + n] = 1.0
            masks.append(m)
            w.append((weights or {}).get(s.name, float(n)))
            self.blocks.append(s.name)
            idx += n
        if self.vb_proposal is not None:
            # extra roulette slot for the independence move; mask unused
            masks.append(np.zeros(dim))
            w.append(self.vb_weight)
            self.blocks.append("<vb>")
        self.masks = np.stack(masks)
        self.weights = np.asarray(w) / np.sum(w)

    # -- targets -----------------------------------------------------------

    def _split_target(self, z, temperature):
        """(tempered log-target [L], recorded statistic [L]) at unconstrained
        points z [L, dim] and temperatures [L]."""
        uparams = self.space.unflatten_unconstrained(z)
        params = self.space.constrain(uparams)
        jac = self.space.log_jacobian(uparams)
        if self.log_like is not None:
            ll = _per_chain(self.log_like(params), z)
            lp = self.log_prior(params) if self.log_prior else 0.0
            if self.log_ref is not None:
                ref = self.log_ref(params)
                base = ll + lp
                # recorded "log-likelihood" is the GSS ratio statistic
                return (_per_chain(temperature * base
                                   + (1.0 - temperature) * ref + jac, z),
                        _per_chain(base - ref, z))
            return _per_chain(temperature * ll + lp + jac, z), ll
        lp = _per_chain(self.log_prob(params), z)
        return _per_chain(lp + jac, z), lp

    # -- sampling ----------------------------------------------------------

    def run(self, generator: torch.Generator, params: dict, *,
            n_iter: int = 10000, every: int = 10, n_chains: int = 1,
            temperatures=None, adapt: bool = True, adapt_interval: int = 200,
            burnin: int = 0, init_step: float = 0.1,
            init_jitter: float = 0.0) -> MCMCResult:
        space = self.space
        dim = self._dim
        with torch.no_grad():
            u0 = space.flatten_unconstrained(space.unconstrain(params))
        kw = dict(dtype=u0.dtype, device=u0.device)
        if temperatures is None:
            temps = torch.ones(n_chains, **kw)
        else:
            with span("physher.sync.h2d"):
                temps = torch.as_tensor(np.asarray(temperatures), **kw)
            n_chains = temps.shape[0]
        us = u0.expand(n_chains, dim).clone()
        if init_jitter:
            us = us + init_jitter * torch.randn(us.shape, generator=generator,
                                                **kw)
        n_blocks = len(self.blocks)
        with span("physher.sync.h2d"):
            masks = torch.as_tensor(self.masks, **kw)
        with span("physher.sync.h2d"):
            probs = torch.as_tensor(self.weights, **kw).expand(n_chains,
                                                               n_blocks)
        sigmas = torch.full((n_blocks,), init_step, **kw)
        ones = torch.ones((n_chains, 1), **kw)
        vb = self.vb_proposal

        def target(u):
            with span("physher.mcmc.target"):
                return self._split_target(u, temps)

        def step(u, logp, ll, acc, tries):
            with span("physher.mcmc.propose"):
                b = torch.multinomial(probs, 1, generator=generator)
                noise = torch.randn(u.shape, generator=generator, **kw)
                u_new = u + sigmas[b] * masks[b[:, 0]] * noise   # b [L, 1]
                log_hr = 0.0
                if vb is not None:
                    sample_fn, logq_fn = vb
                    u_vb = sample_fn(generator, n_chains).to(u.dtype)
                    is_vb = b == n_blocks - 1                    # [L, 1]
                    u_new = torch.where(is_vb, u_vb, u_new)
                    # Hastings ratio of an independence proposal
                    log_hr = torch.where(is_vb[:, 0],
                                         logq_fn(u) - logq_fn(u_vb), 0.0)
            logp_new, ll_new = target(u_new)
            with span("physher.mcmc.accept"):
                log_alpha = logp_new - logp + log_hr
                accept = (torch.log(torch.rand(n_chains, generator=generator,
                                               **kw)) < log_alpha)
                accept = accept & torch.isfinite(logp_new)
                acc.scatter_add_(1, b, accept[:, None].to(u.dtype))
                tries.scatter_add_(1, b, ones)
                return (torch.where(accept[:, None], u_new, u),
                        torch.where(accept, logp_new, logp),
                        torch.where(accept, ll_new, ll))

        with torch.no_grad():
            logp, ll = target(us)
            acc = torch.zeros((n_chains, n_blocks), **kw)
            tries = torch.zeros((n_chains, n_blocks), **kw)
            n_samples = n_iter // every
            burn_chunks = burnin // every
            samples = np.empty((n_samples, n_chains, dim), dtype=np.float64)
            lps = np.empty((n_samples, n_chains))
            lls = np.empty((n_samples, n_chains))
            adapt_every_chunks = max(1, adapt_interval // every)
            si = 0
            cum_acc = np.zeros(n_blocks)
            cum_tries = np.zeros(n_blocks)
            interrupted = False
            # SIGINT between chunks finalizes cleanly with the samples
            # collected so far (reference: mcmc.c:21-28)
            try:
                for ci in range(n_samples + burn_chunks):
                    for _ in range(every):
                        with span("physher.mcmc.step"):
                            us, logp, ll = step(us, logp, ll, acc, tries)
                    with span("physher.mcmc.block"):
                        if ci >= burn_chunks:
                            samples[si] = _host(us, "physher.sync.samples")
                            lps[si] = _host(logp, "physher.sync.samples")
                            lls[si] = _host(ll, "physher.sync.samples")
                            si += 1
                        if adapt and (ci + 1) % adapt_every_chunks == 0:
                            a = _host(acc.sum(0), "physher.sync.adapt")
                            t = _host(tries.sum(0), "physher.sync.adapt")
                            cum_acc += a
                            cum_tries += t
                            rate = np.where(t > 0, a / np.maximum(t, 1),
                                            0.24)
                            factor = np.exp(np.clip(rate - 0.24, -0.5, 0.5))
                            with span("physher.sync.h2d"):
                                sigmas = sigmas * torch.as_tensor(factor,
                                                                  **kw)
                            acc.zero_()
                            tries.zero_()
            except KeyboardInterrupt:
                interrupted = True
            with span("physher.mcmc.block"):
                cum_acc += _host(acc.sum(0), "physher.sync.adapt")
                cum_tries += _host(tries.sum(0), "physher.sync.adapt")
                sigmas_host = _host(sigmas, "physher.sync.adapt")
        res = MCMCResult(
            samples[:si], lps[:si], lls[:si],
            np.where(cum_tries > 0, cum_acc / np.maximum(cum_tries, 1),
                     np.nan),
            sigmas_host, space, interrupted, u0.dtype, u0.device)
        return res


class MixedMCMC:
    """MH over a continuous ParamSpace PLUS a binary indicator vector, a
    batch of chains at a time.

    Port of the JAX package's ``MixedMCMC`` (reference: src/phyc/operator.c
    bitflip entry, used for SSVS clock-model averaging by branch-model
    indicators, branchmodel.h:64-67): each iteration a chain proposes, with
    probability ``p_flip``, a flip of one uniformly chosen bit (symmetric,
    log q ratio 0), else a Gaussian random walk on one uniformly chosen
    parameter block; step sizes adapt toward 0.24 acceptance.

    ``log_prob(params, bits)`` is the unnormalized target over a batch of
    constrained parameter dicts (tensors ``[L, ...]``) and the chains' bits
    ``[L, n_bits]`` (int64), and returns ``[L]``; with an
    ``SSVSLocalClock`` the bits go to ``rates_from_indicators``.
    """

    def __init__(self, space: ParamSpace, log_prob: Callable, n_bits: int,
                 *, p_flip: float = 0.3):
        self.space = space
        self.log_prob = log_prob
        self.n_bits = int(n_bits)
        self.p_flip = float(p_flip)
        self.blocks = [s.name for s in space.free_specs()]
        dim = space.unconstrained_size
        masks, idx = [], 0
        for s in space.free_specs():
            m = np.zeros(dim)
            m[idx: idx + s.unconstrained_size] = 1.0
            masks.append(m)
            idx += s.unconstrained_size
        self.masks = np.stack(masks) if masks else np.zeros((1, dim))
        self._dim = dim

    def _target(self, u, bits):
        uparams = self.space.unflatten_unconstrained(u)
        params = self.space.constrain(uparams)
        return _per_chain(self.log_prob(params, bits)
                          + self.space.log_jacobian(uparams), u)

    def run(self, generator: torch.Generator, params: dict, bits0, *,
            n_iter: int = 10000, every: int = 10, init_step: float = 0.1,
            adapt: bool = True, adapt_interval: int = 200, burnin: int = 0,
            n_chains: int = 1) -> dict:
        """``bits0`` ``[n_bits]`` (every chain) or ``[n_chains, n_bits]``.
        Returns JAX's keys with a chain axis: ``samples_u`` ``[S, L, dim]``,
        ``bits`` ``[S, L, n_bits]``, ``log_posterior`` ``[S, L]``, the
        blocks' and the bitflip's ``acceptance`` and the ``space``."""
        space = self.space
        with torch.no_grad():
            u0 = space.flatten_unconstrained(space.unconstrain(params))
        kw = dict(dtype=u0.dtype, device=u0.device)
        L, dim = n_chains, self._dim
        nb = max(self.n_bits, 1)
        bits = torch.as_tensor(np.asarray(bits0), dtype=torch.int64,
                               device=u0.device).expand(L, nb).clone()
        u = u0.expand(L, dim).clone()
        n_blocks = len(self.masks)
        masks = torch.as_tensor(self.masks, **kw)
        sigmas = torch.full((n_blocks,), init_step, **kw)
        p_flip = self.p_flip if self.n_bits else 0.0
        rows = torch.arange(L, device=u0.device)
        ones = torch.ones((L, 1), **kw)

        def step(u, bits, logp, acc, tries):
            do_flip = torch.rand(L, generator=generator, **kw) < p_flip
            b = torch.randint(n_blocks, (L,), generator=generator,
                              device=u0.device)
            noise = torch.randn(u.shape, generator=generator, **kw)
            u_cont = u + sigmas[b][:, None] * masks[b] * noise
            j = torch.randint(nb, (L,), generator=generator,
                              device=u0.device)
            bits_flip = bits.clone()
            bits_flip[rows, j] = 1 - bits[rows, j]
            u_new = torch.where(do_flip[:, None], u, u_cont)
            bits_new = torch.where(do_flip[:, None], bits_flip, bits)
            logp_new = self._target(u_new, bits_new)
            accept = ((torch.log(torch.rand(L, generator=generator, **kw))
                       < logp_new - logp) & torch.isfinite(logp_new))
            slot = torch.where(do_flip, n_blocks, b)[:, None]
            acc.scatter_add_(1, slot, accept[:, None].to(u.dtype))
            tries.scatter_add_(1, slot, ones)
            return (torch.where(accept[:, None], u_new, u),
                    torch.where(accept[:, None], bits_new, bits),
                    torch.where(accept, logp_new, logp))

        n_samples = n_iter // every
        burn_chunks = burnin // every
        us = np.empty((n_samples, L, dim))
        bit_samples = np.empty((n_samples, L, nb), dtype=np.int32)
        lps = np.empty((n_samples, L))
        adapt_chunks = max(1, adapt_interval // every)
        si = 0
        with torch.no_grad():
            logp = self._target(u, bits)
            acc = torch.zeros((L, n_blocks + 1), **kw)
            tries = torch.zeros((L, n_blocks + 1), **kw)
            for ci in range(n_samples + burn_chunks):
                for _ in range(every):
                    u, bits, logp = step(u, bits, logp, acc, tries)
                if ci >= burn_chunks:
                    us[si] = u.cpu().numpy()
                    bit_samples[si] = bits.cpu().numpy()
                    lps[si] = logp.cpu().numpy()
                    si += 1
                if adapt and (ci + 1) % adapt_chunks == 0:
                    a = acc.sum(0)[:-1].cpu().numpy()
                    t = tries.sum(0)[:-1].cpu().numpy()
                    rate = np.where(t > 0, a / np.maximum(t, 1), 0.24)
                    sigmas = sigmas * torch.as_tensor(
                        np.exp(np.clip(rate - 0.24, -0.5, 0.5)), **kw)
                    acc.zero_()
                    tries.zero_()
            a = acc.sum(0).cpu().numpy()
            t = tries.sum(0).cpu().numpy()
        return {"samples_u": us, "bits": bit_samples, "log_posterior": lps,
                "acceptance": np.where(t > 0, a / np.maximum(t, 1), np.nan),
                "space": space}
