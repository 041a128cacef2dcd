"""Substitution models: Q construction and transition probabilities P(t).

Port of ``physher_tpu/models/substitution.py`` (reference:
src/phyc/substmodel.c, jc69.c, K80.c, f81.c, hky.c, gtr.c, gensubst.c,
nucsubst.c, unrest.c, nonstat.c):

- JC69, K80, F81 and HKY use their closed-form P(t),
- GTR and the general reversible model (the 5-digit rate-class codes)
  symmetrize Q with sqrt(pi) and use a self-adjoint ``eigh``, in float64
  whatever the model's dtype (P(t) is cast back).
  ``torch.linalg.eigh``'s own gradient is NaN/inf at repeated eigenvalues,
  which JC-like GTR states have (a triple eigenvalue), so
  :func:`p_t_reversible` is an ``autograd.Function`` whose backward is the
  transpose of the Daleckii-Krein divided-difference JVP of the JAX package,
- the non-reversible UNREST and NONSTAT take P(t) = expm(Q t) by the JAX
  package's scaling-and-squaring Pade(7), :func:`expm_pade`, differentiated
  by autograd.

``p_t`` is vectorized over leading batch dims of ``t`` (node x category
branch lengths) and returns the ``[..., S, S]`` stack the pruning engines
consume. The nucleotide models also take a batch of parameter dicts (MCMC
chains): parameters ``[L, ...]`` with branch lengths ``t [L, N, C]`` give
``[L, N, C, 4, 4]``. ``P[i, j] = P(child state j | parent state i, t)``; partials
propagate as ``P @ partial_child`` (reference:
src/phyc/treelikelihood4.c:420-480).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.profiling import span, spanned
from .parameters import ParamSpec, ParamSpace


class SubstitutionModel:
    """Base: subclasses define q(params) (normalized) and frequencies(params)."""

    name = "subst"
    state_count: int
    reversible = True

    def __init__(self, prefix: str = "", *, dtype: torch.dtype, device):
        self.prefix = prefix
        self.dtype = dtype
        self.device = torch.device(device)

    def key(self, k):
        return f"{self.prefix}{k}" if self.prefix else k

    def param_space(self) -> ParamSpace:
        return ParamSpace(self.param_specs())

    def param_specs(self) -> list:
        return []

    def frequencies(self, params) -> torch.Tensor:
        raise NotImplementedError

    def q(self, params) -> torch.Tensor:
        """Normalized generator: -sum_i pi_i Q_ii = 1 (expected subst rate 1),
        (reference: src/phyc/substmodel.c update_Q + normalize)."""
        raise NotImplementedError

    def p_t(self, params, t: torch.Tensor) -> torch.Tensor:
        """Transition probabilities for branch lengths t [...]: [..., S, S]."""
        Q = self.q(params)
        if self.reversible:
            return p_t_reversible(Q, self.frequencies(params), t)
        return expm_pade(_bcast(Q, t, 2) * t[..., None, None])

    def dp_dt(self, params, t: torch.Tensor) -> torch.Tensor:
        """d P(t) / dt = P(t) Q for branch lengths t [...]: [..., S, S]."""
        return self.p_t(params, t) @ _bcast(self.q(params), t, 2)


def normalize_q(Q: torch.Tensor, pi: torch.Tensor) -> torch.Tensor:
    mu = -torch.einsum("...i,...ii->...", pi, Q)
    return Q / mu[..., None, None]


def _set_diagonal_neg_rowsum(Q: torch.Tensor) -> torch.Tensor:
    S = Q.shape[-1]
    eye = torch.eye(S, dtype=Q.dtype, device=Q.device)
    off = Q * (1 - eye)
    return off - eye * off.sum(-1)[..., :, None]


@spanned("physher.subst.eig")
def reversible_eig(Q: torch.Tensor, pi: torch.Tensor):
    """Eigendecomposition of a reversible generator via symmetrization.

    S = D Q D^-1 with D = diag(sqrt pi) is symmetric; eigh(S) = (lam, W)
    gives Q = V diag(lam) V^-1 with V = D^-1 W, V^-1 = W^T D.
    """
    sq = torch.sqrt(pi)
    S = Q * (sq[..., :, None] / sq[..., None, :])
    S = 0.5 * (S + S.transpose(-1, -2))
    # a generator with a non-finite entry (a line search's trial point far
    # out) gives NaN, as jnp.linalg.eigh does, where torch's eigh raises
    bad = ~torch.isfinite(S).all(-1).all(-1)
    S = torch.where(bad[..., None, None], torch.eye(
        S.shape[-1], dtype=S.dtype, device=S.device), S)
    # on the card eigh checks its info output on the host
    with span("physher.sync.eigh"):
        lam, W = torch.linalg.eigh(S)
    lam = torch.where(bad[..., None], torch.full_like(lam, float("nan")),
                      lam)
    # a generator's spectrum is <= 0; clamp the numerical-noise positive tail
    # (in float32 a +1e-6 eigenvalue times a long branch explodes exp())
    lam = torch.clamp(lam, max=0.0)
    V = W / sq[..., :, None]
    Vinv = W.transpose(-1, -2) * sq[..., None, :]
    return lam, V, Vinv


def _flat_t(t: torch.Tensor, lead: tuple) -> torch.Tensor:
    """Branch lengths ``[*lead, ...]`` -> ``[*lead, M]``."""
    return t.reshape(lead + (-1,))


def pt_from_eig(lam, V, Vinv, t) -> torch.Tensor:
    """P(t) = V exp(lam t) V^-1 for branch lengths t [*B, ...], with the
    decomposition batched over B (``lam [*B, S]``; reference:
    src/phyc/substmodel.c:518-556)."""
    lead = lam.shape[:-1]
    elt = torch.exp(lam[..., None, :] * _flat_t(t, lead)[..., None])
    P = torch.einsum("...ij,...mj,...jk->...mik", V, elt, Vinv)
    return P.reshape(t.shape + P.shape[-2:])


class _PtReversible(torch.autograd.Function):
    """P(t) = expm(Q t) with the divided-difference (Daleckii-Krein)
    gradient, valid at repeated eigenvalues.

    JVP (as in the JAX package): ``dP = V (F o (V^-1 dQ V)) V^-1 +
    V diag(lam e^{lam t}) V^-1 dt`` with ``F_ij = (e^{l_i t} - e^{l_j t}) /
    (l_i - l_j)`` and ``F_ii = t e^{l_i t}``. Its transpose gives
    ``Qbar = sum_t V^-T (F o (V^T Pbar V^-T)) V^T`` and
    ``tbar = <Pbar, V diag(lam e^{lam t}) V^-1>``. ``pi`` only enables the
    symmetric decomposition; all sensitivity flows through ``Q``. A batch of
    generators ``Q [*B, S, S]`` goes with branch lengths ``t [*B, ...]``.
    """

    @staticmethod
    def forward(ctx, Q, pi, t):
        lam, V, Vinv = reversible_eig(Q, pi)
        ctx.save_for_backward(lam, V, Vinv, t)
        return pt_from_eig(lam, V, Vinv, t)

    @staticmethod
    @spanned("physher.subst.p_t.backward")
    def backward(ctx, Pbar):
        lam, V, Vinv, t = ctx.saved_tensors
        lead = lam.shape[:-1]
        tb = _flat_t(t, lead)[..., None]                 # [*B, M, 1]
        Pb = Pbar.reshape(lead + (-1,) + Pbar.shape[-2:])  # [*B, M, S, S]
        elt = torch.exp(lam[..., None, :] * tb)          # [*B, M, S]
        gQ = gt = None
        if ctx.needs_input_grad[0]:
            li = lam[..., None, :, None]
            lj = lam[..., None, None, :]
            ei = elt[..., :, None]
            ej = elt[..., None, :]
            diff = li - lj
            near = torch.abs(diff) < 1e-10
            F = torch.where(near, tb[..., None] * 0.5 * (ei + ej),
                            (ei - ej) / torch.where(near, torch.ones_like(diff),
                                                    diff))
            G = torch.einsum("...ji,...mjk,...lk->...mil", V, Pb, Vinv)
            FG = (F * G).sum(-3)
            gQ = Vinv.transpose(-1, -2) @ FG @ V.transpose(-1, -2)
        if ctx.needs_input_grad[2]:
            dPdt = torch.einsum("...ij,...mj,...jk->...mik", V,
                                lam[..., None, :] * elt, Vinv)
            gt = (Pb * dPdt).sum((-1, -2)).reshape(t.shape)
        return gQ, None, gt


@spanned("physher.subst.p_t")
def p_t_reversible(Q: torch.Tensor, pi: torch.Tensor,
                   t: torch.Tensor) -> torch.Tensor:
    """P(t) = expm(Q t) for a reversible generator ``Q [*B, S, S]``, over
    branch lengths ``t [*B, ...]``. Differentiable w.r.t. Q and t even at
    degenerate eigenvalues.

    The decomposition, P(t) and the backward run in float64 whatever Q's
    dtype, and P comes back in Q's (a float64 Q is not copied). A float32
    ``eigh`` of a 61-state codon generator rebuilds P with ~1e-7 absolute
    error, so entries whose true value is smaller come out negative (a
    negative site likelihood), and eigenvalues that are equal up to
    rounding noise pass the 1e-10 degeneracy test as distinct, whose
    divided differences then cancel (a wrong gradient at kappa = omega =
    1). The JAX package's float32 keeps that fault."""
    f64 = torch.float64
    P = _PtReversible.apply(Q.to(f64), pi.to(f64), t.to(f64))
    return P.to(Q.dtype)


def expm_pade(A: torch.Tensor, max_squarings: int = 10) -> torch.Tensor:
    """Batched scaling-and-squaring Pade(7) matrix exponential of ``A
    [..., S, S]``, as the JAX package computes it: each matrix is scaled by
    ``2**-k`` with ``k = clip(ceil(log2(||A||_inf / 0.5)), 0,
    max_squarings)``, and ``max_squarings`` squaring slots run with only
    the first ``k`` of them applied (a ``where`` mask per matrix)."""
    S = A.shape[-1]
    norm = A.abs().sum(-1).amax(-1)                       # [...]: inf-norm
    k = torch.ceil(torch.log2(torch.clamp(norm, min=1e-30) / 0.5))
    k = torch.clamp(k, 0.0, float(max_squarings)).detach()
    A = A * (2.0 ** -k)[..., None, None]
    b = (17297280.0, 8648640.0, 1995840.0, 277200.0, 25200.0, 1512.0, 56.0,
         1.0)
    eye = torch.eye(S, dtype=A.dtype, device=A.device)
    A2 = A @ A
    A4 = A2 @ A2
    A6 = A4 @ A2
    U = A @ (b[7] * A6 + b[5] * A4 + b[3] * A2 + b[1] * eye)
    V = b[6] * A6 + b[4] * A4 + b[2] * A2 + b[0] * eye
    # solve_ex: a singular or non-finite system gives non-finite values, as
    # jnp.linalg.solve does, where solve raises
    P = torch.linalg.solve_ex(V - U, V + U)[0]
    for i in range(max_squarings):
        P = torch.where((k > i)[..., None, None], P @ P, P)
    return P


def _bcast(x: torch.Tensor, t: torch.Tensor, event_ndim: int = 0):
    """Model parameter ``x [*B, *event]`` shaped to broadcast against branch
    lengths ``t [*B, ...]``: ``[*B, 1, ..., 1, *event]``."""
    n = x.dim() - event_ndim
    return x.reshape(x.shape[:n] + (1,) * (t.dim() - n) + x.shape[n:])


# ---------------------------------------------------------------------------
# Nucleotide models
# ---------------------------------------------------------------------------


class JC69(SubstitutionModel):
    """Jukes-Cantor: equal rates/frequencies, closed-form P(t)
    (reference: src/phyc/jc69.c)."""

    name = "jc69"
    state_count = 4

    def frequencies(self, params):
        return torch.full((4,), 0.25, dtype=self.dtype, device=self.device)

    def q(self, params):
        S = 4
        eye = torch.eye(S, dtype=self.dtype, device=self.device)
        return torch.full((S, S), 1.0 / 3.0, dtype=self.dtype,
                          device=self.device) - eye * (1.0 / 3.0 + 1.0)

    def p_t(self, params, t):
        e = torch.exp(-4.0 / 3.0 * t)[..., None, None]
        eye = torch.eye(4, dtype=e.dtype, device=e.device)
        return 0.25 + e * (eye - 0.25)

    def dp_dt(self, params, t):
        e = torch.exp(-4.0 / 3.0 * t)[..., None, None] * (-4.0 / 3.0)
        eye = torch.eye(4, dtype=e.dtype, device=e.device)
        return e * (eye - 0.25)


class K80(SubstitutionModel):
    """Kimura 1980: kappa, equal frequencies, closed form
    (reference: src/phyc/K80.c)."""

    name = "k80"
    state_count = 4

    def param_specs(self):
        return [ParamSpec.scalar(self.key("kappa"), 1.0, lower=0.0)]

    def frequencies(self, params):
        return torch.full((4,), 0.25, dtype=self.dtype, device=self.device)

    def q(self, params):
        kappa = params[self.key("kappa")]
        one = torch.ones_like(kappa)
        R = _nuc_rate_matrix(torch.stack([one, kappa, one, one, kappa, one]))
        Q = _set_diagonal_neg_rowsum(R * 0.25)
        return normalize_q(Q, self.frequencies(params))

    def p_t(self, params, t):
        kappa = _bcast(params[self.key("kappa")], t)
        # rate normalization: mu = (kappa + 2) / 4
        d = t * (4.0 / (kappa + 2.0))
        e1 = torch.exp(-d)
        e2 = torch.exp(-d * (kappa + 1.0) / 2.0)
        same = 0.25 + 0.25 * e1 + 0.5 * e2
        transition = 0.25 + 0.25 * e1 - 0.5 * e2
        transversion = 0.25 - 0.25 * e1
        # A, C, G, T: transitions are A<->G and C<->T
        rows = [[same, transversion, transition, transversion],
                [transversion, same, transversion, transition],
                [transition, transversion, same, transversion],
                [transversion, transition, transversion, same]]
        return torch.stack([torch.stack(r, -1) for r in rows], -2)


class F81(SubstitutionModel):
    """Felsenstein 81: free frequencies, closed form
    (reference: src/phyc/f81.c)."""

    name = "f81"
    state_count = 4

    def __init__(self, prefix="", freqs_init=None, fixed_freqs=False, *,
                 dtype, device):
        super().__init__(prefix, dtype=dtype, device=device)
        self.freqs_init = (np.full(4, 0.25) if freqs_init is None
                           else np.asarray(freqs_init))
        self.fixed_freqs = fixed_freqs

    def param_specs(self):
        mk = ParamSpec.fixed if self.fixed_freqs else ParamSpec.simplex
        return [mk(self.key("frequencies"), self.freqs_init)]

    def frequencies(self, params):
        return params[self.key("frequencies")]

    def q(self, params):
        pi = self.frequencies(params)
        R = 1.0 - torch.eye(4, dtype=pi.dtype, device=pi.device)
        Q = _set_diagonal_neg_rowsum(R * pi[None, :])
        return normalize_q(Q, pi)

    def p_t(self, params, t):
        pi = _bcast(self.frequencies(params), t, 1)
        beta = 1.0 / (1.0 - torch.sum(pi * pi, -1))
        e = torch.exp(-beta * t)[..., None, None]
        eye = torch.eye(4, dtype=pi.dtype, device=pi.device)
        return e * eye + (1.0 - e) * pi[..., None, :]


class HKY(SubstitutionModel):
    """HKY85: kappa + free frequencies, analytic P(t)
    (reference: src/phyc/hky.c:230-560)."""

    name = "hky"
    state_count = 4

    def __init__(self, prefix="", kappa_init=1.0, freqs_init=None,
                 fixed_freqs=False, fixed_kappa=False, *, dtype, device):
        super().__init__(prefix, dtype=dtype, device=device)
        self.kappa_init = kappa_init
        self.freqs_init = (np.full(4, 0.25) if freqs_init is None
                           else np.asarray(freqs_init))
        self.fixed_freqs = fixed_freqs
        self.fixed_kappa = fixed_kappa

    def param_specs(self):
        mkf = ParamSpec.fixed if self.fixed_freqs else ParamSpec.simplex
        specs = [mkf(self.key("frequencies"), self.freqs_init)]
        if self.fixed_kappa:
            specs.append(ParamSpec.fixed(self.key("kappa"), self.kappa_init))
        else:
            specs.append(ParamSpec.scalar(self.key("kappa"), self.kappa_init,
                                          lower=0.0))
        return specs

    def frequencies(self, params):
        return params[self.key("frequencies")]

    def q(self, params):
        pi = self.frequencies(params)
        kappa = params[self.key("kappa")]
        one = torch.ones_like(kappa)
        R = _nuc_rate_matrix(torch.stack([one, kappa, one, one, kappa, one],
                                         -1))
        Q = _set_diagonal_neg_rowsum(R * pi[..., None, :])
        return normalize_q(Q, pi)

    def p_t(self, params, t):
        """Analytic HKY transition probabilities (Hasegawa-Kishino-Yano
        1985)."""
        pi = _bcast(self.frequencies(params), t, 1)
        kappa = _bcast(params[self.key("kappa")], t)
        A, C, G, T = (pi[..., i] for i in range(4))
        piR, piY = A + G, C + T
        # normalization so that the expected rate is 1
        beta = 0.5 / (piR * piY + kappa * (A * G + C * T))
        d = beta * t
        e1 = torch.exp(-d)
        eR = torch.exp(-d * (1.0 + piR * (kappa - 1.0)))  # purines
        eY = torch.exp(-d * (1.0 + piY * (kappa - 1.0)))  # pyrimidines
        rows = []
        for i in range(4):
            cols = []
            for j in range(4):
                pj = pi[..., j]
                purine_j = j in (0, 2)
                pclass = piR if purine_j else piY
                ec = eR if purine_j else eY
                base = pj + pj * (1.0 - pclass) / pclass * e1
                if i == j:
                    cols.append(base + (pclass - pj) / pclass * ec)
                elif (i in (0, 2)) == purine_j:
                    cols.append(base - pj / pclass * ec)
                else:
                    cols.append(pj * (1.0 - e1))
            rows.append(torch.stack(torch.broadcast_tensors(*cols), -1))
        return torch.stack(rows, -2)


def _nuc_rate_matrix(rates6: torch.Tensor) -> torch.Tensor:
    """Symmetric 4x4 exchangeability matrix from 6 rates (AC,AG,AT,CG,CT,GT)."""
    ac, ag, at, cg, ct, gt = (rates6[..., i] for i in range(6))
    z = torch.zeros_like(ac)
    return torch.stack([
        torch.stack([z, ac, ag, at], -1),
        torch.stack([ac, z, cg, ct], -1),
        torch.stack([ag, cg, z, gt], -1),
        torch.stack([at, ct, gt, z], -1),
    ], -2)


class GTR(SubstitutionModel):
    """General time-reversible: 6 exchange rates + frequencies via eigh
    (reference: src/phyc/gtr.c; rate order AC,AG,AT,CG,CT,GT)."""

    name = "gtr"
    state_count = 4

    def __init__(self, prefix="", rates_init=None, freqs_init=None,
                 rates_simplex=False, fixed_freqs=False, *, dtype, device):
        super().__init__(prefix, dtype=dtype, device=device)
        self.rates_init = np.ones(6) if rates_init is None else np.asarray(rates_init)
        self.freqs_init = np.full(4, 0.25) if freqs_init is None else np.asarray(freqs_init)
        self.rates_simplex = rates_simplex
        self.fixed_freqs = fixed_freqs

    def param_specs(self):
        if self.rates_simplex:
            rspec = ParamSpec.simplex(self.key("rates"), self.rates_init)
        else:
            rspec = ParamSpec.vector(self.key("rates"), self.rates_init, lower=0.0)
        mkf = ParamSpec.fixed if self.fixed_freqs else ParamSpec.simplex
        return [rspec, mkf(self.key("frequencies"), self.freqs_init)]

    def frequencies(self, params):
        return params[self.key("frequencies")]

    def q(self, params):
        pi = self.frequencies(params)
        R = _nuc_rate_matrix(params[self.key("rates")])
        Q = _set_diagonal_neg_rowsum(R * pi[..., None, :])
        return normalize_q(Q, pi)


class GeneralReversible(SubstitutionModel):
    """Reversible model over an arbitrary datatype with rate-class mapping
    (reference: src/phyc/gensubst.c, nucsubst.c 5-digit codes like
    "01234")."""

    name = "gensubst"

    def __init__(self, state_count, mapping, prefix="", freqs_init=None,
                 rates_init=None, fixed_freqs=False, normalize=True, *,
                 dtype, device):
        super().__init__(prefix, dtype=dtype, device=device)
        self.state_count = state_count
        mapping = np.asarray(mapping, dtype=np.int64)
        npairs = state_count * (state_count - 1) // 2
        if mapping.shape == (state_count, state_count):
            mapping = mapping[np.triu_indices(state_count, 1)]
        if mapping.shape != (npairs,):
            raise ValueError("mapping must give a rate class per state pair")
        self.mapping = mapping
        self.n_classes = int(mapping.max()) + 1
        self.freqs_init = (np.full(state_count, 1.0 / state_count)
                           if freqs_init is None else np.asarray(freqs_init))
        self.rates_init = (np.ones(self.n_classes) if rates_init is None
                           else np.asarray(rates_init))
        self.fixed_freqs = fixed_freqs
        self.normalize = normalize

    def param_specs(self):
        mkf = ParamSpec.fixed if self.fixed_freqs else ParamSpec.simplex
        return [
            ParamSpec.vector(self.key("rates"), self.rates_init, lower=0.0),
            mkf(self.key("frequencies"), self.freqs_init),
        ]

    def frequencies(self, params):
        return params[self.key("frequencies")]

    def q(self, params):
        pi = self.frequencies(params)
        rates = params[self.key("rates")][..., self.mapping]  # [(L,) pairs]
        S = self.state_count
        iu = np.triu_indices(S, 1)
        R = rates.new_zeros(rates.shape[:-1] + (S, S))
        R[..., iu[0], iu[1]] = rates
        R = R + R.transpose(-1, -2)
        Q = _set_diagonal_neg_rowsum(R * pi[..., None, :])
        return normalize_q(Q, pi) if self.normalize else Q


# the off-diagonal entries of a 4 x 4 generator in row-major order: UNREST's
# 12 rates
_OFF_DIAGONAL = np.nonzero(~np.eye(4, dtype=bool))


class UNREST(SubstitutionModel):
    """Non-reversible 12-parameter nucleotide model (reference:
    src/phyc/unrest.c). P(t) via expm; frequencies are the stationary
    distribution of Q (left null vector)."""

    name = "unrest"
    state_count = 4
    reversible = False

    def __init__(self, prefix="", rates_init=None, *, dtype, device):
        super().__init__(prefix, dtype=dtype, device=device)
        self.rates_init = (np.ones(12) if rates_init is None
                           else np.asarray(rates_init))

    def param_specs(self):
        return [ParamSpec.vector(self.key("rates"), self.rates_init,
                                 lower=0.0)]

    def _q_unnorm(self, params):
        r = params[self.key("rates")]
        Q = r.new_zeros(r.shape[:-1] + (4, 4))
        Q[..., _OFF_DIAGONAL[0], _OFF_DIAGONAL[1]] = r
        return _set_diagonal_neg_rowsum(Q)

    def stationary(self, params):
        """pi with pi Q = 0 and sum pi = 1. The JAX package takes the
        least-squares solution of that consistent augmented system; its
        exact solution is the same, here a square solve of the system with
        the last of the S equations pi Q = 0 (the sum of the others, since
        Q's rows sum to 0) replaced by sum pi = 1 (non-finite where that
        system is singular, where lstsq would give a least-squares pi)."""
        Q = self._q_unnorm(params)
        M = torch.cat([Q[..., :, :-1], torch.ones_like(Q[..., :, :1])], -1)
        e = torch.zeros_like(Q[..., 0, :])
        e[..., -1] = 1.0
        return torch.linalg.solve_ex(M.transpose(-1, -2), e)[0]

    def frequencies(self, params):
        return self.stationary(params)

    def q(self, params):
        return normalize_q(self._q_unnorm(params), self.stationary(params))


class NONSTAT(UNREST):
    """Non-reversible + free root frequencies (reference:
    src/phyc/nonstat.c)."""

    name = "nonstat"

    def param_specs(self):
        return super().param_specs() + [
            ParamSpec.simplex(self.key("frequencies"), np.full(4, 0.25))
        ]

    def frequencies(self, params):
        return params[self.key("frequencies")]
