"""Parameter dictionaries and constraint transforms (PyTorch).

Port of ``physher_tpu/models/parameters.py``. Parameters are a plain
``dict[str, Tensor]`` with the JAX package's keys; models are functions of
it. What remains of the reference's Parameter/Model graph is declarative:

- :class:`ParamSpec` — shape/init/bounds/transform of one named parameter,
- :class:`ParamSpace` — an ordered collection with bijections to
  unconstrained space (for gradient-based ML; mirrors
  src/phyc/transforms.c in the reference).

Simplex parameters use the stick-breaking transform (Stan's convention,
reference: src/phyc/simplex.c) so a K-simplex has K-1 unconstrained entries.

A batch of parameter dicts (the chains of an MCMC run) is one dict whose
tensors all carry the same leading batch axes ``[L, ...]``. The ParamSpace
methods take such a batch; since they know each spec's own shape, they read
the batch shape off the tensors, and :meth:`ParamSpace.constrain` returns a
:class:`ParamBatch` that carries it, so that models summing over a
parameter's entries (the priors) sum over those and not over the chains.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.profiling import span_backward


@dataclass(frozen=True)
class ParamSpec:
    """Declarative description of one parameter block."""

    name: str
    init: np.ndarray
    lower: float = -np.inf
    upper: float = np.inf
    # 'none' | 'log' | 'shifted_log' | 'interval' | 'simplex' | 'fixed'
    transform: str = "none"

    @staticmethod
    def scalar(name, value, lower=-np.inf, upper=np.inf, transform=None):
        if transform is None:
            transform = _default_transform(lower, upper)
        return ParamSpec(name, np.asarray(float(value)), lower, upper, transform)

    @staticmethod
    def vector(name, values, lower=-np.inf, upper=np.inf, transform=None):
        if transform is None:
            transform = _default_transform(lower, upper)
        return ParamSpec(name, np.asarray(values, dtype=np.float64), lower,
                         upper, transform)

    @staticmethod
    def simplex(name, values):
        values = np.asarray(values, dtype=np.float64)
        values = values / values.sum()
        return ParamSpec(name, values, 0.0, 1.0, "simplex")

    @staticmethod
    def fixed(name, values):
        return ParamSpec(name, np.asarray(values, dtype=np.float64),
                         transform="fixed")

    @property
    def size(self) -> int:
        return int(np.prod(self.init.shape)) if self.init.shape else 1

    @property
    def unconstrained_size(self) -> int:
        if self.transform == "fixed":
            return 0
        if self.transform == "simplex":
            return self.size - 1
        return self.size

    @property
    def unconstrained_shape(self) -> tuple:
        return ((self.size - 1,) if self.transform == "simplex"
                else tuple(self.init.shape))


class ParamBatch(dict):
    """A parameter dict whose tensors share the leading ``batch_shape``."""

    def __init__(self, params: dict, batch_shape: tuple):
        super().__init__(params)
        self.batch_shape = tuple(batch_shape)


def batch_shape(params: dict) -> tuple:
    """The leading batch shape of a parameter dict: ``()`` unless it is a
    :class:`ParamBatch`."""
    return getattr(params, "batch_shape", ())


def _lead(x: torch.Tensor, event_shape) -> tuple:
    return tuple(x.shape[:x.dim() - len(event_shape)])


def _sum_event(x: torch.Tensor, event_ndim: int) -> torch.Tensor:
    return x.sum(tuple(range(-event_ndim, 0))) if event_ndim else x


def _default_transform(lower, upper) -> str:
    if lower == -np.inf and upper == np.inf:
        return "none"
    if upper == np.inf and lower == 0.0:
        return "log"
    if np.isfinite(lower) and np.isfinite(upper):
        return "interval"
    return "shifted_log" if np.isfinite(lower) else "none"


def params_from_numpy(params: dict, *, dtype: torch.dtype,
                      device) -> dict:
    """Arrays (e.g. the JAX package's parameters after ``np.asarray``) ->
    the port's ``dict[str, Tensor]`` on ``device`` in ``dtype``, for every
    key: tree, substitution, site, clock and coalescent parameters alike
    (the skyline, skygrid and piecewise-linear sizes ``thetas`` and the
    delta skyride's increments too)."""
    return {k: torch.as_tensor(np.array(v), dtype=dtype, device=device)
            for k, v in params.items()}


def vparams_from_numpy(vparams: dict, *, dtype: torch.dtype,
                       device) -> dict:
    """A variational family's parameters (``loc`` / ``log_scale`` of the
    mean-field normal, ``loc`` / ``log_diag`` / ``off`` of the full-rank
    one, ``log_alpha`` / ``log_beta`` of the gamma family, ``log_shape`` /
    ``log_scale`` of the Weibull one) from arrays to tensors on ``device``
    in ``dtype``."""
    return params_from_numpy(vparams, dtype=dtype, device=device)


# -- stick-breaking simplex (Stan convention) --------------------------------


def _offsets(K: int, like: torch.Tensor) -> torch.Tensor:
    return torch.log(torch.arange(K - 1, 0, -1, dtype=like.dtype,
                                  device=like.device))


def _stick(z: torch.Tensor) -> torch.Tensor:
    """The stick left before each break, [1, cumprod(1 - z)]; on the card
    cumprod's backward checks its input for zeros on the host."""
    left = span_backward(torch.cumprod(1 - z, -1), "physher.sync.cumprod")
    return torch.cat([torch.ones_like(z[..., :1]), left], -1)


def simplex_constrain(y: torch.Tensor) -> torch.Tensor:
    """Unconstrained R^{K-1} -> K-simplex (stick breaking, Stan convention)."""
    K = y.shape[-1] + 1
    z = torch.sigmoid(y - _offsets(K, y))
    zl = _stick(z)
    x = zl[..., :-1] * z
    return torch.cat([x, zl[..., -1:]], dim=-1)


def simplex_unconstrain(x: torch.Tensor) -> torch.Tensor:
    K = x.shape[-1]
    rem = 1.0 - torch.cat(
        [torch.zeros_like(x[..., :1]), torch.cumsum(x[..., :-1], -1)], -1
    )[..., :-1]
    z = x[..., :-1] / torch.clamp(rem, min=1e-300)
    return torch.log(z) - torch.log1p(-z) + _offsets(K, x)


def simplex_log_jacobian(y: torch.Tensor) -> torch.Tensor:
    """log |det d(constrain)/dy| for the stick-breaking transform."""
    K = y.shape[-1] + 1
    z = torch.sigmoid(y - _offsets(K, y))
    zl = _stick(z)
    return torch.sum(torch.log(z) + torch.log1p(-z) + torch.log(zl[..., :-1]),
                     -1)


class ParamSpace:
    """Ordered collection of ParamSpecs with constrained/unconstrained
    dictionary views."""

    def __init__(self, specs: list[ParamSpec]):
        seen = {}
        for s in specs:
            if s.name in seen:
                if seen[s.name] is not s and not np.array_equal(
                    seen[s.name].init, s.init
                ):
                    raise ValueError(f"conflicting duplicate parameter {s.name}")
            seen[s.name] = s
        self.specs = list(seen.values())
        self.by_name = seen

    @property
    def names(self):
        return [s.name for s in self.specs]

    def init_params(self, *, dtype: torch.dtype, device) -> dict:
        return {s.name: torch.as_tensor(s.init, dtype=dtype, device=device)
                for s in self.specs}

    def free_specs(self):
        return [s for s in self.specs if s.transform != "fixed"]

    @property
    def unconstrained_size(self) -> int:
        return sum(s.unconstrained_size for s in self.free_specs())

    # -- constrained <-> unconstrained dictionaries ------------------------

    def unconstrain(self, params: dict) -> dict:
        out = {}
        for s in self.free_specs():
            x = params[s.name]
            t = s.transform
            if t == "none":
                out[s.name] = x
            elif t == "log":
                out[s.name] = torch.log(x)
            elif t == "shifted_log":
                out[s.name] = torch.log(x - s.lower)
            elif t == "interval":
                u = (x - s.lower) / (s.upper - s.lower)
                out[s.name] = torch.log(u) - torch.log1p(-u)
            elif t == "simplex":
                out[s.name] = simplex_unconstrain(x)
            else:
                raise ValueError(t)
        return out

    def batch_shape_of(self, uparams: dict) -> tuple:
        """The leading batch shape of an unconstrained dict of this space."""
        free = self.free_specs()
        if not free:
            return ()
        return _lead(uparams[free[0].name], free[0].unconstrained_shape)

    def constrain(self, uparams: dict, params: Optional[dict] = None) -> dict:
        """Unconstrained -> constrained values; a batch (tensors ``[L,
        ...]``) gives a :class:`ParamBatch`."""
        lead = self.batch_shape_of(uparams)
        out = dict(params) if params else {}
        fixed = [s for s in self.specs if s.transform == "fixed"]
        if fixed:
            like = next(iter({**out, **uparams}.values()))
            for s in fixed:
                out.setdefault(s.name, torch.as_tensor(
                    s.init, dtype=like.dtype, device=like.device).expand(
                        lead + s.init.shape))
        for s in self.free_specs():
            y = uparams[s.name]
            t = s.transform
            if t == "none":
                out[s.name] = y
            elif t == "log":
                out[s.name] = torch.exp(y)
            elif t == "shifted_log":
                out[s.name] = torch.exp(y) + s.lower
            elif t == "interval":
                out[s.name] = s.lower + (s.upper - s.lower) * torch.sigmoid(y)
            elif t == "simplex":
                out[s.name] = simplex_constrain(y)
            else:
                raise ValueError(t)
        return ParamBatch(out, lead) if lead else out

    def log_jacobian(self, uparams: dict) -> torch.Tensor:
        """log |det| of constrain(), summed over all free parameters (one
        value per batch entry)."""
        total = 0.0
        for s in self.free_specs():
            y = uparams[s.name]
            t = s.transform
            n = len(s.init.shape)
            if t == "none":
                continue
            elif t in ("log", "shifted_log"):
                total = total + _sum_event(y, n)
            elif t == "interval":
                total = total + _sum_event(
                    math.log(s.upper - s.lower)
                    + F.logsigmoid(y) + F.logsigmoid(-y), n)
            elif t == "simplex":
                total = total + simplex_log_jacobian(y)
        return total

    # -- flat vector view (for variational families) ----------------------

    def unconstrained_slices(self) -> dict:
        """{spec name: (offset, size)} into the flat unconstrained vector."""
        out = {}
        i = 0
        for s in self.free_specs():
            out[s.name] = (i, s.unconstrained_size)
            i += s.unconstrained_size
        return out

    def flatten_unconstrained(self, uparams: dict) -> torch.Tensor:
        """dict -> flat vector ``[(L,) unconstrained_size]``."""
        lead = self.batch_shape_of(uparams)
        return torch.cat([torch.reshape(uparams[s.name],
                                        lead + (s.unconstrained_size,))
                          for s in self.free_specs()], -1)

    def unflatten_unconstrained(self, vec: torch.Tensor) -> dict:
        out = {}
        i = 0
        for s in self.free_specs():
            n = s.unconstrained_size
            out[s.name] = vec[..., i: i + n].reshape(
                vec.shape[:-1] + s.unconstrained_shape)
            i += n
        return out

    def merge(self, *others: "ParamSpace") -> "ParamSpace":
        """This space's specs followed by each other space's, a shared
        name kept once."""
        specs = list(self.specs)
        for o in others:
            specs.extend(o.specs)
        return ParamSpace(specs)
