"""Stateful binding API mirroring the reference's C++ wrapper surface.

Port of ``physher_tpu/api.py``, the rebuild of phycpp (reference:
src/phycpp/physher.hpp:21-465 — the ``*Interface`` classes torchtree binds
against: SetParameters / GetParameters / LogLikelihood / RequestGradient /
Gradient over flat double buffers). Every class, method and enum of the
JAX package's module is here, with the same flat float64 numpy buffers in
and out.

- :class:`TreeLikelihoodInterface` builds the port's ``TreeLikelihood``
  once, on ``device`` (the CUDA device unless ``device="cpu"`` is given;
  with no CUDA device and no ``device`` it raises) in ``dtype`` (float64,
  as the reference's buffers are doubles). ``SetParameters`` on the model
  interfaces only changes the values they hold: each call writes them into
  one flat parameter tensor on the device (one host-to-device copy), and
  the model is never rebuilt. ``LogLikelihood()`` is one forward call
  under ``torch.no_grad()``; ``Gradient()`` one ``torch.autograd.grad`` of
  the same call, through the CUDA kernels' backward on the card.
- The time-tree transforms (``GetNodeHeights``, ``GradientTransformJVP``,
  ``GradientTransformJacobian``), the coalescents and the CTMC-scale prior
  run autograd through the port's ``trees/heights`` ratio transform on the
  tree model's ``device``, which is resolved as above at first use.
"""

from __future__ import annotations

import enum

import numpy as np
import torch

from .data.sitepattern import SitePattern
from .io.treeio import read_newick
from .models.clock import RelaxedClock, StrictClock
from .models.coalescent import (ConstantCoalescent, PiecewiseLinearCoalescent,
                                SkygridCoalescent, SkyrideCoalescent)
from .models.distributions import ctmc_scale_logpdf
from .models.sitemodel import (ConstantSiteModel, GammaSiteModel,
                               InvariantSiteModel, WeibullSiteModel)
from .models.substitution import GTR, HKY, JC69, GeneralReversible
from .models.treelikelihood import TreeLikelihood
from .trees.heights import (branch_durations, heights_from_ratios,
                            ratio_log_jacobian)
from .trees.timetree import TimeTreeData
from .utils.profiling import span, spanned


def resolve_device(device) -> torch.device:
    """``device``, or the current CUDA device for None; raises when there
    is none (the API never carries on quietly on the CPU)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("physher_tpu_torch.api: no CUDA device; pass "
                           "device='cpu' to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def _numpy(t: torch.Tensor) -> np.ndarray:
    """``t`` on the host in float64: a host-device synchronization."""
    with span("physher.sync.numpy"):
        return t.detach().to("cpu", torch.float64).numpy()


class GradientFlags(enum.Enum):
    """reference: physher.hpp:21-25"""
    TREE_RATIO = 1
    TREE_HEIGHT = 2
    COALESCENT_THETA = 3


class TreeLikelihoodGradientFlags(enum.Enum):
    """reference: physher.hpp:27-34"""
    TREE_HEIGHT = 1
    SITE_MODEL = 2
    SUBSTITUTION_MODEL = 3
    SUBSTITUTION_MODEL_RATES = 4
    SUBSTITUTION_MODEL_FREQUENCIES = 5
    BRANCH_MODEL = 6


class ModelInterface:
    """reference: physher.hpp:79-96 ModelInterface."""

    _param_keys: list = []

    def SetParameters(self, parameters) -> None:
        raise NotImplementedError

    def GetParameters(self, parameters=None) -> np.ndarray:
        raise NotImplementedError


class _ValueHolder(ModelInterface):
    """Holds named parameter values as a flat vector."""

    def __init__(self):
        self._values = {}

    @spanned("physher.api.set_parameters")
    def SetParameters(self, parameters) -> None:
        vec = np.asarray(parameters, dtype=np.float64).ravel()
        i = 0
        for k in self._param_keys:
            n = np.size(self._values[k])
            chunk = vec[i: i + n]
            self._values[k] = (float(chunk[0]) if n == 1
                               else np.asarray(chunk))
            i += n

    def GetParameters(self, parameters=None) -> np.ndarray:
        out = np.concatenate([np.atleast_1d(
            np.asarray(self._values[k], dtype=np.float64))
            for k in self._param_keys]) if self._param_keys else np.zeros(0)
        if parameters is not None:
            parameters[: out.size] = out
        return out


# -- tree models (physher.hpp:107-174) --------------------------------------

class TreeModelInterface(_ValueHolder):
    """``device`` (None: the CUDA device, resolved at first use) and
    ``dtype`` are where the time-tree transforms and the coalescent and
    CTMC-scale interfaces built on this tree compute."""

    def __init__(self, newick: str, taxa: list | None = None, *,
                 device=None, dtype: torch.dtype = torch.float64):
        super().__init__()
        self.topo, self.distances = read_newick(newick)
        self.taxa = self.topo.taxa
        self._device = device
        self.dtype = dtype

    @property
    def device(self) -> torch.device:
        return resolve_device(self._device)

    def _tensor(self, x, requires_grad: bool = False) -> torch.Tensor:
        return torch.tensor(np.asarray(x, dtype=np.float64), dtype=self.dtype,
                            device=self.device, requires_grad=requires_grad)


class UnRootedTreeModelInterface(TreeModelInterface):
    """reference: physher.hpp:127-135. Parameters = branch lengths."""

    _param_keys = ["distances"]

    def __init__(self, newick: str, taxa: list | None = None, **kw):
        super().__init__(newick, taxa, **kw)
        self._values["distances"] = np.asarray(
            self.distances[: self.topo.N - 1], dtype=np.float64)
        self.time_data = None


class TimeTreeModelInterface(TreeModelInterface):
    """reference: physher.hpp:137-148. Parameters = node heights mapped to
    the ratio space internally."""

    _param_keys = ["ratios"]

    def __init__(self, newick: str, taxa: list | None = None, dates=None,
                 **kw):
        super().__init__(newick, taxa, **kw)
        self.time_data = TimeTreeData.from_dated_tree(
            self.topo, self.distances, dates)
        I = self.topo.I
        self._values["ratios"] = np.asarray(self.time_data.ratios0[:I],
                                            dtype=np.float64)

    def _heights(self, ratios: torch.Tensor) -> torch.Tensor:
        td = self.time_data
        return heights_from_ratios(ratios, self.topo, td.tip_heights,
                                   td.lowers)


class ReparameterizedTimeTreeModelInterface(TimeTreeModelInterface):
    """reference: physher.hpp:150-174 (ratio/height transforms +
    GradientTransformJVP)."""

    def __init__(self, newick: str, taxa: list | None = None, dates=None,
                 transform: int = 1, **kw):
        super().__init__(newick, taxa, dates, **kw)
        self.transform = transform

    def GetNodeHeights(self) -> np.ndarray:
        with torch.no_grad():
            return _numpy(self._heights(self._tensor(self._values["ratios"])))

    def GradientTransformJVP(self, height_gradient) -> np.ndarray:
        """d logL / d ratios from d logL / d heights (reference:
        treetransform.c:76-92 node_transform_jvp_backprop)."""
        r = self._tensor(self._values["ratios"], requires_grad=True)
        g = np.zeros(self.topo.N)
        g[self.topo.T:] = np.asarray(height_gradient)[: self.topo.I]
        (out,) = torch.autograd.grad(self._heights(r), r,
                                     grad_outputs=self._tensor(g))
        return _numpy(out)

    def GradientTransformJacobian(self) -> np.ndarray:
        """Gradient of the log-det-Jacobian wrt ratios (reference:
        treetransform.c:94-120)."""
        r = self._tensor(self._values["ratios"], requires_grad=True)
        logjac = ratio_log_jacobian(self._heights(r), self.topo,
                                    self.time_data.lowers)
        (out,) = torch.autograd.grad(logjac, r)
        return _numpy(out)


# -- substitution models (physher.hpp:201-267) -------------------------------

class SubstitutionModelInterface(_ValueHolder):
    def _build(self, kw: dict):
        """The port's model, with ``kw`` the dtype and device keywords."""
        raise NotImplementedError


class JC69Interface(SubstitutionModelInterface):
    _param_keys = []

    def _build(self, kw):
        return JC69(**kw), {}


class HKYInterface(SubstitutionModelInterface):
    _param_keys = ["kappa", "frequencies"]

    def __init__(self, kappa: float = 1.0, frequencies=None):
        super().__init__()
        self._values["kappa"] = kappa
        self._values["frequencies"] = np.asarray(
            frequencies if frequencies is not None else [0.25] * 4)

    def _build(self, kw):
        return HKY(kappa_init=float(self._values["kappa"]),
                   freqs_init=np.asarray(self._values["frequencies"]),
                   **kw), {}


class GTRInterface(SubstitutionModelInterface):
    _param_keys = ["rates", "frequencies"]

    def __init__(self, rates=None, frequencies=None):
        super().__init__()
        self._values["rates"] = np.asarray(
            rates if rates is not None else [1.0 / 6] * 6)
        self._values["frequencies"] = np.asarray(
            frequencies if frequencies is not None else [0.25] * 4)

    def _build(self, kw):
        return GTR(rates_init=np.asarray(self._values["rates"]),
                   freqs_init=np.asarray(self._values["frequencies"]),
                   **kw), {}


class GeneralSubstitutionModelInterface(SubstitutionModelInterface):
    """reference: physher.hpp:252-267 (arbitrary datatype + rate mapping)."""

    _param_keys = ["rates", "frequencies"]

    def __init__(self, state_count: int, mapping, rates, frequencies,
                 normalize: bool = True):
        super().__init__()
        self.state_count = state_count
        self.mapping = np.asarray(mapping, dtype=np.int32)
        self.normalize = normalize
        self._values["rates"] = np.asarray(rates, dtype=np.float64)
        self._values["frequencies"] = np.asarray(frequencies,
                                                 dtype=np.float64)

    def _build(self, kw):
        return GeneralReversible(
            self.state_count, self.mapping,
            rates_init=np.asarray(self._values["rates"]),
            freqs_init=np.asarray(self._values["frequencies"]),
            normalize=self.normalize, **kw), {}


# -- site models (physher.hpp:269-358) ---------------------------------------

class SiteModelInterface(_ValueHolder):
    def _build(self, kw: dict):
        raise NotImplementedError


class ConstantSiteModelInterface(SiteModelInterface):
    _param_keys = ["mu"]

    def __init__(self, mu: float | None = None):
        super().__init__()
        self._values["mu"] = 1.0 if mu is None else mu
        self._use_mu = mu is not None

    def _build(self, kw):
        return ConstantSiteModel(mu=self._use_mu,
                                 mu_init=float(self._values["mu"]), **kw), {}


class InvariantSiteModelInterface(SiteModelInterface):
    _param_keys = ["proportion"]

    def __init__(self, proportion: float = 0.1):
        super().__init__()
        self._values["proportion"] = proportion

    def _build(self, kw):
        return InvariantSiteModel(
            pinv_init=float(self._values["proportion"]), **kw), {}


class WeibullSiteModelInterface(SiteModelInterface):
    _param_keys = ["shape"]

    def __init__(self, shape: float = 0.5, categories: int = 4,
                 invariant: float | None = None):
        super().__init__()
        self._values["shape"] = shape
        self.categories = categories
        self.invariant = invariant

    def _build(self, kw):
        return WeibullSiteModel(
            self.categories, invariant=self.invariant is not None,
            shape_init=float(self._values["shape"]),
            pinv_init=self.invariant or 0.1, **kw), {}


class GammaSiteModelInterface(WeibullSiteModelInterface):
    def _build(self, kw):
        return GammaSiteModel(
            self.categories, invariant=self.invariant is not None,
            shape_init=float(self._values["shape"]),
            pinv_init=self.invariant or 0.1, **kw), {}


# -- branch models (physher.hpp:176-199) -------------------------------------

class BranchModelInterface(_ValueHolder):
    pass


class StrictClockModelInterface(BranchModelInterface):
    _param_keys = ["rate"]

    def __init__(self, rate: float, tree_model: TreeModelInterface):
        super().__init__()
        self._values["rate"] = rate
        self.tree_model = tree_model

    def _build(self, N, kw):
        return StrictClock(N, rate_init=float(self._values["rate"]), **kw)


class SimpleClockModelInterface(BranchModelInterface):
    """Per-branch rates (reference: physher.hpp:195-199)."""

    _param_keys = ["rates"]

    def __init__(self, rates, tree_model: TreeModelInterface):
        super().__init__()
        self._values["rates"] = np.asarray(rates, dtype=np.float64)
        self.tree_model = tree_model

    def _build(self, N, kw):
        return RelaxedClock(N, prefix="clock.", rate_init=1e-3, **kw)


# -- tree likelihood (physher.hpp:360-395) -----------------------------------

class TreeLikelihoodInterface:
    """reference: physher.hpp:360-395. LogLikelihood() / RequestGradient /
    Gradient(buffer) over the assembled model, built once on ``device``
    (None: the CUDA device; raises without one) in ``dtype``."""

    def __init__(self, alignment, tree_model: TreeModelInterface,
                 substitution_model: SubstitutionModelInterface,
                 site_model: SiteModelInterface,
                 branch_model: BranchModelInterface | None = None,
                 use_ambiguities: bool = False, use_tip_states: bool = False,
                 include_jacobian: bool = False, *, device=None,
                 dtype: torch.dtype = torch.float64):
        seqs = alignment if isinstance(alignment, dict) else dict(alignment)
        self.device = resolve_device(device)
        self.dtype = dtype
        kw = dict(dtype=dtype, device=self.device)
        self.tree_model = tree_model
        self.substitution_model = substitution_model
        self.site_model = site_model
        self.branch_model = branch_model
        sp = SitePattern.from_alignment(seqs)
        subst, _ = substitution_model._build(kw)
        sm, _ = site_model._build(kw)
        clock = (branch_model._build(tree_model.topo.N, kw)
                 if branch_model is not None else None)
        self.tlk = TreeLikelihood(
            sp, tree_model.topo, subst, sm, clock=clock,
            time_data=tree_model.time_data,
            distances_init=tree_model.distances,
            include_jacobian=include_jacobian,
            tipstates=use_tip_states,
            use_ambiguities=use_ambiguities, **kw)
        self._space = self.tlk.param_space()
        # the parameters as views of one flat tensor on the device, in the
        # order of the space; _vec0 holds their initial values
        init = self._space.init_params(**kw)
        self._shapes = {k: tuple(v.shape) for k, v in init.items()}
        sizes = [v.numel() for v in init.values()]
        ends = np.cumsum(sizes)
        self._slices = {k: slice(int(e - n), int(e))
                        for k, n, e in zip(init, sizes, ends)}
        self._vec0 = np.concatenate(
            [_numpy(v).ravel() for v in init.values()])
        self._flat = torch.empty(len(self._vec0), **kw)
        self._flags = []

    def _values(self) -> np.ndarray:
        """The current parameter values of the model interfaces as one flat
        vector in the space's order (initial values for the rest)."""
        vec = self._vec0.copy()

        def put(key, val):
            if key in self._slices:
                vec[self._slices[key]] = np.ravel(val)

        tm = self.tree_model
        I = self.tlk.topo.I
        if tm.time_data is not None:
            r = np.asarray(tm._values["ratios"], dtype=np.float64)
            put("tree.ratios", r[: I - 1])
            put("tree.root_height", r[I - 1])
        else:
            put("tree.distances", tm._values["distances"])
        for k in self.substitution_model._param_keys:
            put(k, self.substitution_model._values[k])
        sm = self.site_model
        for k in sm._param_keys:
            if k == "proportion":
                p = float(sm._values[k])
                put("proportions", [p, 1.0 - p])
            else:
                put(k, sm._values[k])
        if self.branch_model is not None:
            bm = self.branch_model
            for k in bm._param_keys:
                put("clock." + k if k == "rates" else k, bm._values[k])
        return vec

    def _params(self, flat: torch.Tensor) -> dict:
        return {k: flat[s].view(self._shapes[k])
                for k, s in self._slices.items()}

    def _load(self) -> None:
        """Write the current values into the flat tensor (one copy from
        the host's pageable memory, which waits for the device)."""
        values = torch.from_numpy(self._values())
        with span("physher.sync.load"):
            self._flat.copy_(values)

    @spanned("physher.api.log_likelihood")
    def LogLikelihood(self) -> float:
        self._load()
        with torch.no_grad():
            logl = self.tlk.log_likelihood(self._params(self._flat))
        with span("physher.sync.float"):
            return float(logl)

    def RequestGradient(self, flags=None) -> None:
        """reference: physher.hpp:378-380 + TreeLikelihood_initialize_
        gradient flag logic (treelikelihood.c:180-318). With no flags every
        parameter's gradient is produced."""
        self._flags = list(flags or [])

    @spanned("physher.api.gradient")
    def Gradient(self, gradient=None) -> np.ndarray:
        """The gradient of the log-likelihood, one block a parameter in the
        order of their names (the JAX package's), the blocks that the
        requested flags select."""
        self._load()
        flat = self._flat.detach().requires_grad_()
        (g,) = torch.autograd.grad(
            self.tlk.log_likelihood(self._params(flat)), flat)
        g = _numpy(g)
        F = TreeLikelihoodGradientFlags
        want = set(self._flags)

        def want_key(key):
            if not want:
                return True
            if key.startswith("tree."):
                return F.TREE_HEIGHT in want
            if key in ("shape", "pinv", "mu") or "sitemodel" in key:
                return F.SITE_MODEL in want
            if key == "rate" or key == "rates" and self.branch_model:
                return F.BRANCH_MODEL in want
            return (F.SUBSTITUTION_MODEL in want
                    or F.SUBSTITUTION_MODEL_RATES in want
                    or F.SUBSTITUTION_MODEL_FREQUENCIES in want)

        order = [g[self._slices[k]] for k in sorted(self._slices)
                 if want_key(k)]
        out = np.concatenate(order) if order else np.zeros(0)
        if gradient is not None:
            gradient[: out.size] = out
        return out


# -- coalescent interfaces (physher.hpp:419-465) -----------------------------

class CoalescentModelInterface:
    """reference: physher.hpp:419-441. Computes on the tree model's device
    in its dtype."""

    def __init__(self, coalescent, tree_model: TimeTreeModelInterface,
                 theta_key: str = "thetas"):
        self.coalescent = coalescent
        self.tree_model = tree_model
        self._theta_key = theta_key
        self._space = coalescent.param_space()

    def _heights(self, requires_grad: bool = False) -> torch.Tensor:
        tm = self.tree_model
        return tm._heights(tm._tensor(tm._values["ratios"])).detach(
            ).requires_grad_(requires_grad)

    def _init_params(self, requires_grad: bool = False) -> dict:
        tm = self.tree_model
        params = self._space.init_params(dtype=tm.dtype, device=tm.device)
        return {k: v.requires_grad_(requires_grad)
                for k, v in sorted(params.items())}

    def LogLikelihood(self) -> float:
        with torch.no_grad():
            return float(self.coalescent.log_prob_from_heights(
                self._heights(), self._init_params()))

    def Gradient(self, gradient=None) -> np.ndarray:
        params = self._init_params(requires_grad=True)
        h = self._heights(requires_grad=True)
        grads = torch.autograd.grad(
            self.coalescent.log_prob_from_heights(h, params),
            [*params.values(), h])
        parts = [np.atleast_1d(_numpy(g)) for g in grads[:-1]]
        parts.append(_numpy(grads[-1])[self.tree_model.topo.T:])
        out = np.concatenate(parts)
        if gradient is not None:
            gradient[: out.size] = out
        return out


class ConstantCoalescentModelInterface(CoalescentModelInterface):
    def __init__(self, theta: float, tree_model: TimeTreeModelInterface):
        super().__init__(
            ConstantCoalescent(tree_model.topo, theta_init=theta),
            tree_model)


class PiecewiseConstantCoalescentInterface(CoalescentModelInterface):
    """skyride (physher.hpp:446-450)."""

    def __init__(self, thetas, tree_model: TimeTreeModelInterface):
        super().__init__(
            SkyrideCoalescent(tree_model.topo,
                              thetas_init=np.asarray(thetas)), tree_model)


class PiecewiseConstantCoalescentGridInterface(CoalescentModelInterface):
    """skygrid (physher.hpp:452-457)."""

    def __init__(self, thetas, tree_model: TimeTreeModelInterface,
                 cutoff: float):
        super().__init__(
            SkygridCoalescent(tree_model.topo, len(np.asarray(thetas)),
                              cutoff, thetas_init=np.asarray(thetas)),
            tree_model)


class PiecewiseLinearCoalescentGridInterface(CoalescentModelInterface):
    def __init__(self, thetas, tree_model: TimeTreeModelInterface,
                 cutoff: float):
        super().__init__(
            PiecewiseLinearCoalescent(tree_model.topo,
                                      len(np.asarray(thetas)), cutoff,
                                      thetas_init=np.asarray(thetas)),
            tree_model)


class CTMCScaleModelInterface:
    """reference: physher.hpp:397-417. Computes on the tree model's device
    in its dtype."""

    def __init__(self, rates, tree_model: TimeTreeModelInterface):
        self.rates = np.asarray(rates, dtype=np.float64)
        self.tree_model = tree_model

    def _log_prob(self, rates: torch.Tensor) -> torch.Tensor:
        tm = self.tree_model
        with torch.no_grad():
            h = tm._heights(tm._tensor(tm._values["ratios"]))
        return torch.sum(ctmc_scale_logpdf(
            rates, torch.sum(branch_durations(h, tm.topo))))

    def LogLikelihood(self) -> float:
        with torch.no_grad():
            return float(self._log_prob(self.tree_model._tensor(self.rates)))

    def Gradient(self, gradient=None) -> np.ndarray:
        r = self.tree_model._tensor(self.rates, requires_grad=True)
        (g,) = torch.autograd.grad(self._log_prob(r), r)
        out = _numpy(g)
        if gradient is not None:
            gradient[: out.size] = out
        return out
