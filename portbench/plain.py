"""The plain reference: phylogenetic likelihoods and posteriors in plain
PyTorch, written from the models' published definitions.

It imports nothing of the program under test and takes nothing the program
made: it parses the tree itself, compresses the alignment itself, computes
P(t) by ``torch.linalg.matrix_exp`` of the generator, the discrete-gamma
rates by its own inverse of the incomplete gamma function, node heights by
the ratio transform walked down the tree one node at a time, and the tree
likelihood by Felsenstein's pruning level by level with a per-node scale.

Conventions shared with the models' definitions (and with the program's
interfaces, which the comparison reads):

- node numbering: tips 0..T-1 in the order the newick string lists them,
  internal nodes T + k with k their postorder rank, the root last;
- GTR exchangeabilities in the order AC, AG, AT, CG, CT, GT; Q_ij = r_ij
  pi_j, scaled to one substitution per unit time under pi;
- Gamma(4) rates at the median of each quarter, normalized to mean 1
  (Yang 1994);
- GY94 over the 61 sense codons of the universal code in the order AAA ..
  TTT; a single-nucleotide change has rate kappa if a transition, times
  omega if nonsynonymous; Q_ij = rate_ij pi_j, scaled to one substitution
  per unit time;
- the ratio transform of node heights: h(root) is free, h(n) = l(n) +
  r(n) (h(parent) - l(n)) below it with l(n) the oldest tip beneath n;
  its log-Jacobian is the sum of log(h(parent) - l(n)) over non-root
  internal nodes;
- the constant coalescent over heterochronous tips, the 1/x prior and the
  CTMC-scale reference prior (Ferreira and Suchard 2008) on the clock rate;
- unconstrained coordinates: logit for (0, 1), log(x - lower) for x >
  lower, log for x > 0, Stan's stick-breaking for a simplex.
"""

from __future__ import annotations

import math
import re

import numpy as np
import torch

NUC = "ACGT"
UNIVERSAL_CODE = ("KNKNTTTTRSRSIIMIQHQHPPPPRRRRLLLLEDEDAAAAGGGGVVVV"
                  "*Y*YSSSS*CWCLFLF")
CODONS = [a + b + c for a in NUC for b in NUC for c in NUC]
SENSE_CODONS = [c for c, aa in zip(CODONS, UNIVERSAL_CODE) if aa != "*"]
TRANSITIONS = {("A", "G"), ("G", "A"), ("C", "T"), ("T", "C")}


# -- trees -------------------------------------------------------------------


class Tree:
    """A rooted tree: ``parent[N]`` (-1 at the root), ``children`` (one
    list a node), branch ``lengths[N]`` (nan where the newick gives none),
    ``taxa[T]``."""

    def __init__(self, taxa, parent, children, lengths):
        self.taxa = list(taxa)
        self.parent = np.asarray(parent)
        self.children = children
        self.lengths = np.asarray(lengths, dtype=np.float64)
        self.T = len(self.taxa)
        self.N = len(self.parent)
        self.I = self.N - self.T
        self.root = self.N - 1
        depth = np.zeros(self.N, dtype=np.int64)
        for n in range(self.T, self.N):
            depth[n] = 1 + max(depth[c] for c in children[n])
        # internal nodes grouped leaves first: each level's children are done
        self.levels = [np.nonzero(depth == d)[0]
                       for d in range(1, int(depth.max()) + 1)]


def parse_newick(text: str) -> Tree:
    """A newick string of named tips with branch lengths."""
    tokens = re.findall(r"\(|\)|,|;|:[^,();]+|[^,():;]+", text.strip())
    pos = 0
    tips, internals = [], []

    def node():
        nonlocal pos
        kids = []
        name = None
        if tokens[pos] == "(":
            pos += 1
            kids.append(node())
            while tokens[pos] == ",":
                pos += 1
                kids.append(node())
            if tokens[pos] != ")":
                raise ValueError(f"newick: ')' expected at token {pos}")
            pos += 1
        if pos < len(tokens) and tokens[pos] not in "(),;" and \
                not tokens[pos].startswith(":"):
            name = tokens[pos]
            pos += 1
        length = float("nan")
        if pos < len(tokens) and tokens[pos].startswith(":"):
            length = float(tokens[pos][1:])
            pos += 1
        rec = {"name": name, "length": length, "children": kids}
        (internals if kids else tips).append(rec)
        return rec

    node()
    T = len(tips)
    for i, rec in enumerate(tips):
        rec["id"] = i
    for k, rec in enumerate(internals):
        rec["id"] = T + k
    N = T + len(internals)
    parent = np.full(N, -1, dtype=np.int64)
    children = [[] for _ in range(N)]
    lengths = np.full(N, np.nan)
    for rec in tips + internals:
        lengths[rec["id"]] = rec["length"]
        for c in rec["children"]:
            parent[c["id"]] = rec["id"]
            children[rec["id"]].append(c["id"])
    return Tree([r["name"] for r in tips], parent, children, lengths)


def tip_heights_from_dates(tree: Tree, dates: dict) -> np.ndarray:
    d = np.asarray([float(dates[t]) for t in tree.taxa])
    return d.max() - d


def dated_heights(tree: Tree, tip_heights: np.ndarray) -> np.ndarray:
    """Internal heights from the newick branch lengths: the oldest of
    (child height + its branch length, at least 1e-6)."""
    h = np.zeros(tree.N)
    h[:tree.T] = tip_heights
    for n in range(tree.T, tree.N):
        h[n] = max(h[c] + max(np.nan_to_num(tree.lengths[c], nan=1e-6), 1e-6)
                   for c in tree.children[n])
    return h


def lowers(tree: Tree, tip_heights: np.ndarray) -> np.ndarray:
    """The oldest tip height beneath each node."""
    low = np.zeros(tree.N)
    low[:tree.T] = tip_heights
    for n in range(tree.T, tree.N):
        low[n] = max(low[c] for c in tree.children[n])
    return low


def ratios_from_heights(tree: Tree, h: np.ndarray, low: np.ndarray):
    """(ratios [I-1], root height)."""
    r = np.asarray([(h[n] - low[n]) / (h[tree.parent[n]] - low[n])
                    for n in range(tree.T, tree.N - 1)])
    return r, h[tree.root]


def heights_from_ratios(tree: Tree, ratios: torch.Tensor,
                        root_height: torch.Tensor, tip_heights, low):
    """Node heights [N] from the ratios [I-1] and the root height, walked
    from the root down."""
    h = [None] * tree.N
    for t in range(tree.T):
        h[t] = torch.as_tensor(float(tip_heights[t]), dtype=ratios.dtype)
    h[tree.root] = root_height
    for n in range(tree.N - 2, tree.T - 1, -1):
        low_n = float(low[n])
        h[n] = low_n + ratios[n - tree.T] * (h[tree.parent[n]] - low_n)
    return torch.stack(h)


def ratio_log_jacobian(tree: Tree, h: torch.Tensor, low) -> torch.Tensor:
    idx = np.arange(tree.T, tree.N - 1)
    return torch.sum(torch.log(h[tree.parent[idx]]
                               - torch.as_tensor(low[idx], dtype=h.dtype)))


def durations(tree: Tree, h: torch.Tensor) -> torch.Tensor:
    """Time along the branch above each non-root node [N-1]."""
    idx = np.arange(tree.N - 1)
    return h[tree.parent[idx]] - h[idx]


# -- priors ------------------------------------------------------------------


def constant_coalescent(h: torch.Tensor, T: int, theta) -> torch.Tensor:
    """log density of node heights [N] (tips first) under a constant
    population size theta: tips add a lineage, coalescences remove one."""
    order = torch.argsort(h.detach(), stable=True)
    times = h[order]
    delta = torch.where(order < T, 1.0, -1.0).to(h.dtype)
    k = torch.cumsum(delta, 0)[:-1]
    pairs = k * (k - 1.0) / 2.0
    dt = times[1:] - times[:-1]
    n_coal = h.shape[0] - T
    return -torch.sum(pairs * dt) / theta - n_coal * torch.log(theta)


def one_on_x(x):
    return -torch.log(x)


def ctmc_scale(rate, tree_length):
    """Gamma(1/2, rate T) up to its constant: the CTMC reference prior."""
    return (0.5 * torch.log(tree_length) - 0.5 * math.log(math.pi)
            - 0.5 * torch.log(rate) - rate * tree_length)


# -- unconstrained coordinates -------------------------------------------------


def stick_breaking(y: torch.Tensor):
    """(simplex [K], log |J|) from y [K-1] (Stan's convention)."""
    K = y.shape[-1] + 1
    off = torch.log(torch.arange(K - 1, 0, -1, dtype=y.dtype))
    z = torch.sigmoid(y - off)
    rest = [torch.ones((), dtype=y.dtype)]
    parts = []
    logj = torch.zeros((), dtype=y.dtype)
    for k in range(K - 1):
        parts.append(rest[-1] * z[k])
        logj = logj + torch.log(z[k]) + torch.log1p(-z[k]) + torch.log(
            rest[-1])
        rest.append(rest[-1] * (1 - z[k]))
    parts.append(rest[-1])
    return torch.stack(parts), logj


def stick_breaking_inverse(x: np.ndarray) -> np.ndarray:
    K = len(x)
    off = np.log(np.arange(K - 1, 0, -1))
    rem = 1.0 - np.concatenate([[0.0], np.cumsum(x[:-1])])[:-1]
    z = x[:-1] / rem
    return np.log(z) - np.log1p(-z) + off


def constrain(layout, u: torch.Tensor):
    """({name: value}, log |J|) of the flat unconstrained vector ``u``
    under ``layout``: (name, transform, size, lower) in order, each
    transform one of logit, shifted_log, log, simplex (``size`` the
    simplex's K)."""
    out, logj, i = {}, torch.zeros((), dtype=u.dtype), 0
    for name, transform, size, lower in layout:
        n = size - 1 if transform == "simplex" else size
        y = u[i:i + n]
        i += n
        if transform == "logit":
            out[name] = torch.sigmoid(y)
            logj = logj + torch.sum(torch.nn.functional.logsigmoid(y)
                                    + torch.nn.functional.logsigmoid(-y))
        elif transform == "shifted_log":
            out[name] = torch.exp(y) + lower
            logj = logj + torch.sum(y)
        elif transform == "log":
            out[name] = torch.exp(y)
            logj = logj + torch.sum(y)
        elif transform == "simplex":
            out[name], lj = stick_breaking(y)
            logj = logj + lj
        else:
            raise ValueError(transform)
        if n == 1 and transform != "simplex" and size == 1:
            out[name] = out[name][0]
    if i != u.shape[-1]:
        raise ValueError(f"layout has {i} coordinates, u has {u.shape[-1]}")
    return out, logj


def unconstrain(layout, values: dict) -> np.ndarray:
    out = []
    for name, transform, size, lower in layout:
        x = np.atleast_1d(np.asarray(values[name], dtype=np.float64))
        if transform == "logit":
            out.append(np.log(x) - np.log1p(-x))
        elif transform == "shifted_log":
            out.append(np.log(x - lower))
        elif transform == "log":
            out.append(np.log(x))
        elif transform == "simplex":
            out.append(stick_breaking_inverse(x))
        else:
            raise ValueError(transform)
    return np.concatenate(out)


# -- substitution and site models -------------------------------------------


def gtr_q(rates6: torch.Tensor, pi: torch.Tensor) -> torch.Tensor:
    ac, ag, at, cg, ct, gt = rates6
    z = torch.zeros((), dtype=rates6.dtype)
    R = torch.stack([torch.stack([z, ac, ag, at]),
                     torch.stack([ac, z, cg, ct]),
                     torch.stack([ag, cg, z, gt]),
                     torch.stack([at, ct, gt, z])])
    return _generator(R, pi)


def _generator(R: torch.Tensor, pi: torch.Tensor) -> torch.Tensor:
    off = R * pi[None, :]
    Q = off - torch.diag(off.sum(1))
    return Q / torch.sum(pi * off.sum(1))


def codon_classes() -> np.ndarray:
    """[61, 61]: 0 no single change, 1 synonymous transition, 2 synonymous
    transversion, 3 nonsynonymous transition, 4 nonsynonymous
    transversion."""
    aa = {c: UNIVERSAL_CODE[CODONS.index(c)] for c in SENSE_CODONS}
    S = len(SENSE_CODONS)
    cls = np.zeros((S, S), dtype=np.int64)
    for i, a in enumerate(SENSE_CODONS):
        for j, b in enumerate(SENSE_CODONS):
            diff = [k for k in range(3) if a[k] != b[k]]
            if len(diff) != 1:
                continue
            ts = (a[diff[0]], b[diff[0]]) in TRANSITIONS
            syn = aa[a] == aa[b]
            cls[i, j] = (1 if syn else 3) + (0 if ts else 1)
    return cls


def gy94_q(kappa, omega, pi: torch.Tensor) -> torch.Tensor:
    one = torch.ones((), dtype=pi.dtype)
    zero = torch.zeros((), dtype=pi.dtype)
    by_class = torch.stack([zero, kappa * one, one, kappa * omega,
                            omega * one])
    R = by_class[torch.as_tensor(codon_classes())]
    return _generator(R, pi)


def transition_matrices(Q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """exp(Q t) for each entry of t: [..., S, S]."""
    return torch.linalg.matrix_exp(Q * t[..., None, None])


def _gamma_quantile(alpha: float, p: np.ndarray) -> np.ndarray:
    """x with P(alpha, x) = p (Gamma(alpha, 1)), by bisection on log x and
    Newton polishing, float64."""
    a = torch.tensor(alpha, dtype=torch.float64)
    lo = np.full(p.shape, -745.0)
    hi = np.full(p.shape, math.log(alpha + 50.0 * math.sqrt(alpha) + 100.0))
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        f = torch.special.gammainc(a, torch.as_tensor(np.exp(mid))).numpy()
        below = f < p
        lo = np.where(below, mid, lo)
        hi = np.where(below, hi, mid)
    x = np.exp(0.5 * (lo + hi))
    for _ in range(3):
        xt = torch.as_tensor(x)
        f = torch.special.gammainc(a, xt).numpy()
        dens = np.exp((alpha - 1.0) * np.log(x) - x - math.lgamma(alpha))
        x = np.where(dens > 0, x - (f - p) / np.maximum(dens, 1e-300), x)
    return x


def _d_gammainc_d_alpha(alpha: float, x: np.ndarray) -> np.ndarray:
    """dP(alpha, x)/d alpha by Richardson-extrapolated central
    differences."""
    xt = torch.as_tensor(x, dtype=torch.float64)

    def central(h):
        up = torch.special.gammainc(torch.tensor(alpha + h, dtype=torch.float64), xt)
        dn = torch.special.gammainc(torch.tensor(alpha - h, dtype=torch.float64), xt)
        return ((up - dn) / (2.0 * h)).numpy()
    h = 1e-3 * alpha
    return (4.0 * central(h / 2.0) - central(h)) / 3.0


class _GammaMedianRates(torch.autograd.Function):
    @staticmethod
    def forward(ctx, alpha, K):
        a = float(alpha)
        p = (2.0 * np.arange(K) + 1.0) / (2.0 * K)
        x = _gamma_quantile(a, p)
        # dx/dalpha at fixed p: -(dP/dalpha) / (dP/dx)
        dens = np.exp((a - 1.0) * np.log(x) - x - math.lgamma(a))
        dx = -_d_gammainc_d_alpha(a, x) / dens
        ctx.save_for_backward(torch.as_tensor(x), torch.as_tensor(dx))
        return torch.as_tensor(x / x.mean(), dtype=alpha.dtype)

    @staticmethod
    def backward(ctx, g):
        x, dx = ctx.saved_tensors
        m = x.mean()
        # rates = x / mean(x)
        drates = dx / m - x * dx.mean() / (m * m)
        return torch.sum(g.to(torch.float64) * drates).to(g.dtype), None


def gamma_median_rates(alpha: torch.Tensor, K: int = 4) -> torch.Tensor:
    """Mean-one rates of K equal-probability Gamma(alpha, alpha) classes,
    each at its class's median."""
    return _GammaMedianRates.apply(alpha, K)


# -- data -----------------------------------------------------------------------


def compress(states: torch.Tensor):
    """Unique columns of tip states [T, L]: (patterns [T, P], weights
    [P])."""
    uniq, counts = torch.unique(states, dim=1, return_counts=True)
    return uniq.contiguous(), counts


# -- the pruning sweep ------------------------------------------------------


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32's 10-bit mantissa (to nearest), as
    the tensor cores round a product's operands."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class _TF32Matmul(torch.autograd.Function):
    """A product on TF32 operands, forward and backward (as PyTorch runs
    every float32 product and its gradients where TF32 is on)."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.matmul(tf32(a), tf32(b))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = tf32(g)
        return (torch.matmul(g, tf32(b).transpose(-1, -2)),
                torch.matmul(tf32(a).transpose(-1, -2), g))


def as_precision(precision):
    """(dtype, product) of a precision: a torch dtype with its own
    product, or "tf32" (float32 arithmetic, products on TF32 operands)."""
    if precision == "tf32":
        return torch.float32, _TF32Matmul.apply
    return precision, torch.matmul


def prune(tree: Tree, patterns: torch.Tensor, weights: torch.Tensor,
          pmats: torch.Tensor, freqs: torch.Tensor, props: torch.Tensor,
          block: int = 8192, want_grad: bool = False, matmul=torch.matmul):
    """Tree log-likelihood of ``patterns`` [T, P] (state indices) with
    pattern ``weights`` [P], transition matrices ``pmats`` [N, C, S, S]
    (row: parent state), root frequencies ``freqs`` [S] and category
    proportions ``props`` [C], in pattern blocks, all in ``pmats``'s dtype
    on its device; ``matmul`` computes each product (the control's TF32).
    Returns (logL, (d pmats, d freqs, d props) or None)."""
    dev, dt = pmats.device, pmats.dtype
    N, C, S = pmats.shape[0], pmats.shape[1], pmats.shape[2]
    T = tree.T
    P = patterns.shape[1]
    leaves = [x.detach().requires_grad_(want_grad)
              for x in (pmats, freqs, props)]
    grads = [torch.zeros_like(x) for x in leaves] if want_grad else None
    total = torch.zeros((), dtype=torch.float64, device=dev)
    kids = [np.asarray([tree.children[n][j] for n in lv])
            for lv in tree.levels for j in range(2)]
    if any(len(tree.children[n]) != 2 for n in range(T, N)):
        raise ValueError("prune takes binary trees")
    eye = torch.eye(S, dtype=dt, device=dev)
    for a in range(0, P, block):
        cols = slice(a, min(a + block, P))
        with torch.set_grad_enabled(want_grad):
            pm, fr, pr = leaves
            tips = eye[patterns[:, cols].long()].permute(0, 2, 1)  # [T, S, Pb]
            Pb = tips.shape[-1]
            store = torch.zeros((N, C, S, Pb), dtype=dt, device=dev)
            store[:T] = tips[:, None]
            logscale = torch.zeros(Pb, dtype=dt, device=dev)
            for li, lv in enumerate(tree.levels):
                idx = torch.as_tensor(lv, device=dev)
                prod = None
                for j in range(2):
                    c = torch.as_tensor(kids[2 * li + j], device=dev)
                    y = matmul(pm[c], store[c])             # [n, C, S, Pb]
                    prod = y if prod is None else prod * y
                m = prod.detach().amax(dim=(1, 2), keepdim=True)
                m = torch.where(m > 0, m, torch.ones_like(m))
                store = store.index_copy(0, idx, prod / m)
                logscale = logscale + torch.log(m).sum(dim=(0, 1, 2))
            root = store[tree.root]                          # [C, S, Pb]
            site = torch.log(torch.einsum("c,s,csp->p", pr, fr, root)) \
                + logscale
            part = torch.sum(weights[cols].to(dt) * site)
            if want_grad:
                for g, d in zip(grads, torch.autograd.grad(part, leaves)):
                    g += d
            total = total + part.detach().to(torch.float64)
    return total, grads
