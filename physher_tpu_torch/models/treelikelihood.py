"""TreeLikelihood: data + tree + substitution/site/clock models as one
``nn.Module`` whose forward is the log-likelihood of a parameter dict.

Port of ``physher_tpu/models/treelikelihood.py`` (reference:
src/phyc/treelikelihood.c:46-124 struct, 1454-1735 calculation). The full
likelihood is recomputed per call; gradients come from autograd, through the
CUDA kernels' backward on the card (``ops/fused.py``, ``ops/staged.py``,
``ops/wide.py``).

Engines (``engine=``):

- ``"auto"``: the CUDA kernels for CUDA tensors, the plain engine
  (``ops/pruning.py``) for CPU tensors;
- ``"cuda"``: the CUDA kernels; raises for CPU tensors;
- ``"cuda-fused"``, ``"cuda-staged"``, ``"cuda-wide"``, ``"cuda-loop"``:
  that pair of kernels; raises for CPU tensors and for a shape it cannot
  take;
- ``"torch"``: the plain engine on any device.

``batch_engine=`` is the choice for a batch of two or more chains where it
differs (the config builder maps the JAX package's engine names by device,
state count and chains, ``config/builder.route_engine``).

``"auto"`` and ``"cuda"`` choose the kernels by the model's shape
(:func:`select_engine`): K5'/K6' (``ops/loop.py``) for a batch of chains
and for S = 4 polytomies, K3'/K4' (``ops/staged.py``) for S = 4 on a binary
tree whose levels are wide enough, K1'/K2' (``ops/fused.py``) for any other
S = 4 model, K7'/K8' (``ops/wide.py``) for any other S. ``engine_name()``
says which one a model takes. A named pair (``"cuda-fused"``,
``"cuda-staged"``, ...) runs at any S from 2 to 64.

A batch of parameter dicts (tensors ``[L, ...]``, the chains of an MCMC
run) gives ``[L]`` log-likelihoods: the batch runs through the model as a
leading axis (branch lengths ``[L, N]``, P matrices ``[L, N, C, S, S]``)
into the plain engine on the CPU and K5'/K6' on the card, for every state
count the kernels take (2 to 64: nucleotide, protein and codon models).

With a device mesh (``parallel/mesh.shard_tree_likelihood``) the engine
that :meth:`TreeLikelihood.engine_name` picks for the whole model runs once
per pattern shard, on the shard's device (:meth:`TreeLikelihood.set_mesh`).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..data.sitepattern import SitePattern
from ..ops.fused import fused_tree_log_likelihood
from ..ops.loop import STATES, loop_tree_log_likelihood
from ..ops.pruning import tree_log_likelihood, pad_patterns
from ..ops.staged import staged_tree_log_likelihood
from ..ops.wide import wide_tree_log_likelihood
from ..trees.topology import Topology
from ..trees.timetree import TimeTreeData
from ..trees.heights import (
    heights_from_ratios, heights_from_shifts, shifts_from_heights,
    ratio_log_jacobian, branch_durations, ratio_params,
)
from ..utils.profiling import span, spanned
from .parameters import ParamSpec, ParamSpace
from .clock import BranchModel
from .sitemodel import SiteModel, ConstantSiteModel
from .substitution import SubstitutionModel

KERNEL_ENGINES = ("cuda-fused", "cuda-staged", "cuda-wide", "cuda-loop")
ENGINES = ("auto", "cuda", "torch") + KERNEL_ENGINES
_ENGINE_FUNCTIONS = {"cuda-fused": fused_tree_log_likelihood,
                     "cuda-staged": staged_tree_log_likelihood,
                     "cuda-wide": wide_tree_log_likelihood,
                     "cuda-loop": loop_tree_log_likelihood,
                     "torch": tree_log_likelihood}
# the engines whose functions take a leading chain axis
_BATCH_ENGINES = ("torch", "cuda-loop")
# The staged kernels' gate, measured on an NVIDIA H100 (``python3
# chip_profile.py --gate``: balanced, caterpillar and random binary trees
# of 16-512 taxa and the fluA tree, 256-32768 patterns, C = 1 and 4).
# K1'/K2' walk the tree one node (K1') or one preorder level (K2') at a
# time, at a cost per step that grows with the categories C; K3'/K4' pay
# about as much per tree level whatever its width. So K3'/K4' win where C x
# (internal nodes / levels) is large, at every pattern count measured. With
# K4' redesigned the sweep put the gate at 4 (two runs); with K2' on the
# S = 4 reverse step of csrc/s4_backward.cuh, K1'/K2' won 18 and 17 of the
# 24 caterpillars at C = 4 (4.0) in two runs, and a gate at 5 gave the
# least summed time of both (68.3 and 72.8 ms, against 70.9 and 75.7 at 4;
# 68.8 and 72.8 at 8). With K3' walking the top of the tree in one launch
# (a caterpillar's whole tree), a gate at 4 gave the least summed time of
# two runs (73.24 and 68.69 ms, against 74.48 and 70.27 at 5).
STAGED_MIN_LEVEL_WORK = 4.0


def select_engine(engine: str, device_type: str, n_states: int,
                  max_children: int = 2, n_categories: int = 1,
                  nodes_per_level: float = 1.0,
                  batch: int | None = None) -> str:
    """The concrete engine for an ``engine=`` choice, the device type of the
    model's tensors, its state count, the most children of a node, the rate
    categories, the mean internal nodes per tree level and the number of
    chains ``batch`` (None: one parameter dict, no batch axis):
    ``"cuda-loop"`` (K5'/K6', a batch of two or more chains at any S from 2
    to 64, or S = 4 on a tree with a polytomy), ``"cuda-staged"`` (K3'/K4',
    S = 4 on a binary tree with ``n_categories * nodes_per_level >=
    STAGED_MIN_LEVEL_WORK``), ``"cuda-fused"`` (K1'/K2', any other S = 4
    model), ``"cuda-wide"`` (K7'/K8', any other S from 2 to 64) or
    ``"torch"`` (the plain engine, every batch on the CPU). That is
    ``auto``'s choice, which never picks the fused or staged pair at
    S != 4 (nor does the JAX package's). A named pair is taken at any S
    from 2 to 64: ``"cuda-fused"`` runs K1'/K2' at S != 4 in the TPU
    wrapper's packed or category-split mode (``ops/fused.needs_csplit``),
    ``"cuda-staged"`` the level-staged sweep of ``csrc/wide.cu``. A batch
    of one chain is routed as one parameter dict. A CUDA engine on a
    non-CUDA device, a state count outside 2 to 64 on the card, and a
    named pair given a batch of chains, raise."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; one of {ENGINES}")
    on_cuda = device_type == "cuda"
    if engine != "torch" and engine != "auto" and not on_cuda:
        raise ValueError(f"engine={engine!r} needs CUDA tensors; this model "
                         f"lives on {device_type}")
    if engine == "torch" or not on_cuda:
        return "torch"
    # every kernel pair takes the state counts of csrc/tiles.cuh
    if not STATES[0] <= n_states <= STATES[1]:
        raise ValueError(f"{n_states} states: the CUDA kernels take "
                         f"{STATES[0]} to {STATES[1]}")
    chains = batch is not None and batch >= 2
    if chains and engine in KERNEL_ENGINES and engine != "cuda-loop":
        raise ValueError(f"engine={engine!r} takes no batch of chains; "
                         f"'cuda-loop' does")
    if engine in KERNEL_ENGINES:
        return engine
    if chains:
        return "cuda-loop"
    if n_states != 4:
        return "cuda-wide"
    if max_children != 2:
        return "cuda-loop"
    if n_categories * nodes_per_level >= STAGED_MIN_LEVEL_WORK:
        return "cuda-staged"
    return "cuda-fused"


class TreeLikelihood(nn.Module):
    """Phylogenetic likelihood model over a fixed topology.

    Two parameterizations of branch lengths:
    - unrooted/distance mode: free branch-length vector ``{prefix}distances``
      (one per non-root node, node-id order),
    - time mode (``time_data`` given): node-height ratio parameters
      ``{prefix}ratios`` (internal postorder order) + ``{prefix}root_height``
      (or ``{prefix}shifts`` with ``height_transform="shift"``), with a clock
      model mapping durations to substitution branch lengths.

    The tip partials ``[T, S, P]`` and pattern weights ``[P]`` are registered
    buffers; pad columns (``pattern_pad_multiple``) carry all-ones tips and
    weight 0.
    """

    def __init__(self, site_pattern: SitePattern, topo: Topology,
                 subst_model: SubstitutionModel, site_model: SiteModel = None,
                 *, dtype: torch.dtype, device,
                 clock: BranchModel = None, time_data: TimeTreeData = None,
                 distances_init: np.ndarray = None,
                 include_jacobian: bool = False, tipstates: bool = False,
                 use_ambiguities: bool = True, rescale: bool | None = None,
                 pattern_pad_multiple: int = 1, prefix: str = "tree.",
                 engine: str = "auto", batch_engine: str | None = None,
                 height_transform: str = "ratio"):
        super().__init__()
        device = torch.device(device)
        if site_model is None:
            site_model = ConstantSiteModel(dtype=dtype, device=device)
        for name in (engine, batch_engine or engine):
            if name not in ENGINES:
                raise ValueError(f"unknown engine {name!r}; one of {ENGINES}")
        self.sp = site_pattern
        self.topo = topo
        self.subst = subst_model
        self.site_model = site_model
        self.clock = clock
        self.time_data = time_data
        self.include_jacobian = include_jacobian
        self.prefix = prefix
        self.engine = engine
        # the engine= choice for a batch of two or more chains (None: engine)
        self.batch_engine = batch_engine
        self.dtype = dtype
        # RATIO / RATIO_NAIVE / PROPORTION share one transform in the
        # reference; SHIFT is a distinct parameterization with |J| = 1
        # (reference: src/phyc/treetransform.h:17-22)
        ht = str(height_transform or "ratio").lower()
        if ht in ("ratio", "ratio_naive", "proportion", ""):
            self.height_transform = "ratio"
        elif ht == "shift":
            self.height_transform = "shift"
        else:
            raise ValueError(f"unknown height transform {height_transform!r}")
        if rescale is None:
            # float32 partials underflow on realistic trees; rescaling is
            # exact (the reference switches it on at -inf,
            # treelikelihood.c:1497-1520)
            rescale = torch.finfo(dtype).bits < 64
        self.rescale = rescale

        if time_data is not None and clock is None:
            raise ValueError("time mode requires a clock (branch rate) model")

        # order site-pattern rows to match tip ids
        order = [site_pattern.taxa.index(t) for t in topo.taxa]
        self._P = pad_patterns(site_pattern.pattern_count, pattern_pad_multiple)
        tp = site_pattern.tip_partials(
            tipstates=tipstates or not use_ambiguities, pad_to=self._P,
            dtype=np.float64)
        self.register_buffer("tip_partials", torch.as_tensor(
            np.ascontiguousarray(tp[order]), dtype=dtype, device=device))
        self.register_buffer("weights", torch.as_tensor(
            site_pattern.padded_weights(self._P), dtype=dtype, device=device))

        if distances_init is None:
            distances_init = np.full(topo.N - 1, 0.1)
        self.distances_init = np.asarray(distances_init, dtype=np.float64)[
            : topo.N - 1]
        # the device mesh (set_mesh) and its shards: per mesh row, a
        # (device, tips [T, S, P/n], weights [P/n]) per pattern shard
        self.mesh = None
        self._shard_rows = None

    # -- parameters --------------------------------------------------------

    def key(self, k):
        return f"{self.prefix}{k}" if self.prefix else k

    def param_specs(self):
        specs = []
        if self.time_data is not None:
            td = self.time_data
            I = self.topo.I
            if self.height_transform == "shift":
                shifts0 = shifts_from_heights(td.node_heights0, self.topo)
                specs.append(ParamSpec.vector(
                    self.key("shifts"), np.maximum(shifts0, 1e-6), lower=0.0))
            else:
                specs.append(ParamSpec.vector(
                    self.key("ratios"), td.ratios0[: I - 1],
                    lower=0.0, upper=1.0))
                specs.append(ParamSpec.scalar(
                    self.key("root_height"), td.ratios0[I - 1],
                    lower=float(td.lowers[self.topo.root])))
        else:
            specs.append(ParamSpec.vector(
                self.key("distances"), self.distances_init, lower=0.0))
        specs += self.subst.param_specs()
        specs += self.site_model.param_specs()
        if self.clock is not None:
            specs += self.clock.param_specs()
        return specs

    def param_space(self) -> ParamSpace:
        return ParamSpace(self.param_specs())

    # -- computation -------------------------------------------------------

    def node_heights(self, params) -> torch.Tensor:
        td = self.time_data
        if self.height_transform == "shift":
            return heights_from_shifts(params[self.key("shifts")], self.topo,
                                       td.tip_heights)
        ratios = ratio_params(params[self.key("ratios")],
                              params[self.key("root_height")])
        return heights_from_ratios(ratios, self.topo, td.tip_heights,
                                   td.lowers)

    def branch_lengths(self, params) -> torch.Tensor:
        """Substitution branch length per node [(L,) N] (root entry 0)."""
        if self.time_data is not None:
            h = self.node_heights(params)
            d = branch_durations(h, self.topo)
            return d * self.clock.rates(params)
        dist = params[self.key("distances")]
        return torch.cat([dist, dist.new_zeros(dist.shape[:-1] + (1,))], -1)

    def engine_name(self, batch: int | None = None,
                    topo: Topology | None = None) -> str:
        """The engine this model runs for one parameter dict (``batch``
        None) or a batch of that many, on its topology or on ``topo``:
        ``"cuda-fused"``, ``"cuda-staged"``, ``"cuda-wide"``,
        ``"cuda-loop"`` or ``"torch"`` (see :func:`select_engine`);
        ``batch_engine`` is the choice for two or more chains, if given."""
        topo = topo or self.topo
        chains = batch is not None and batch >= 2
        engine = (self.batch_engine or self.engine) if chains else self.engine
        args = (engine, self.tip_partials.device.type,
                self.tip_partials.shape[1], int(topo.child_count.max()),
                self.site_model.cat_count, topo.I / len(topo.levels))
        return (select_engine(*args) if batch is None
                else select_engine(*args, batch))

    def chain_bytes(self) -> int:
        """Device bytes that one chain of a batch adds in K5'/K6' beyond
        its inputs: the partials and their cotangents ``[I, C, S, P]`` and
        the dP scratch ``[ceil(P / 128), N, C, S, S]``."""
        S, P = self.tip_partials.shape[1:]
        C, topo = self.site_model.cat_count, self.topo
        return self.tip_partials.element_size() * (
            2 * topo.I * C * S * P + -(-P // 128) * topo.N * C * S * S)

    def set_mesh(self, mesh) -> None:
        """Shard the pattern columns over ``mesh`` (a
        ``parallel.mesh.Mesh`` whose first device holds this model; its
        pattern axis must divide the padded pattern count). The whole
        ``tip_partials`` and ``weights`` stay on the first device for every
        other path (``tips_for``, the upper partials, the analyses, the
        dynamic engine); each shard gets contiguous copies of its columns
        on its device, one per (column block, device)."""
        n = mesh.shape["patterns"]
        P = self.tip_partials.shape[-1]
        if P % n:
            raise ValueError(f"padded pattern count {P} not divisible by "
                             f"mesh axis {n}; rebuild the likelihood with "
                             f"pattern_pad_multiple={n}")
        if mesh.devices.flat[0] != self.tip_partials.device:
            raise ValueError(f"the mesh starts on {mesh.devices.flat[0]}, "
                             f"the model lives on {self.tip_partials.device}")
        step, made, rows = P // n, {}, []
        for row in mesh.rows():
            shards = []
            for j, dev in enumerate(row):
                if (j, dev) not in made:
                    cols = slice(j * step, (j + 1) * step)
                    made[j, dev] = (
                        dev,
                        self.tip_partials[..., cols].to(dev).contiguous(),
                        self.weights[cols].to(dev).contiguous())
                shards.append(made[j, dev])
            rows.append(shards)
        self.mesh, self._shard_rows = mesh, rows

    @spanned("physher.treelikelihood.forward")
    def _run_engine(self, params):
        bl = self.branch_lengths(params)                  # [(L,) N]
        batch = bl.shape[0] if bl.dim() == 2 else None
        S = self.tip_partials.shape[1]
        name = self.engine_name(batch)
        with span("physher.sitemodel.rates"):
            rates, props = self.site_model.rates_props(params)
        blc = bl[..., :, None] * rates[..., None, :]       # [(L,) N, C]
        pmats = self.subst.p_t(params, blc).to(self.dtype)  # [(L,) N, C, S, S]
        freqs = self.subst.frequencies(params).to(self.dtype)
        props = props.to(self.dtype)
        if batch is not None:
            freqs = freqs.expand(batch, S)
            props = props.expand(batch, props.shape[-1])
        fn = _ENGINE_FUNCTIONS[name]
        # one chain: the one-dict kernels, with the axis put back
        one = batch == 1 and name not in _BATCH_ENGINES
        if one:
            pmats, freqs, props, batch = pmats[0], freqs[0], props[0], None
        if self.mesh is None:
            logL, site_log = fn(self.tip_partials, pmats, self.topo, freqs,
                                props, self.weights, rescale=self.rescale)
        else:
            logL, site_log = self._run_shards(fn, batch, pmats, freqs, props)
        return (logL[None], site_log[None]) if one else (logL, site_log)

    def _run_shards(self, fn, batch, pmats, freqs, props):
        """``fn`` once per pattern shard of the mesh: a batch of chains
        that the mesh rows divide splits into contiguous groups, one a row,
        any other call runs on the first row. Returns the shards' summed
        logL (on the first device, in shard order) and their site logs
        concatenated back to ``[(L,) P]``."""
        first = self.tip_partials.device
        rows = self._shard_rows
        if batch is None or batch % len(rows):
            groups = [(rows[0], pmats, freqs, props)]
        else:
            g = batch // len(rows)
            groups = [(row, pmats[r * g:(r + 1) * g],
                       freqs[r * g:(r + 1) * g], props[r * g:(r + 1) * g])
                      for r, row in enumerate(rows)]
        logLs, sites = [], []
        for row, pm, fr, pr in groups:
            logL, parts = None, []
            for dev, tips, weights in row:
                lk, site = fn(tips, pm.to(dev), self.topo, fr.to(dev),
                              pr.to(dev), weights, rescale=self.rescale)
                lk = lk.to(first)
                logL = lk if logL is None else logL + lk
                parts.append(site.to(first))
            logLs.append(logL)
            sites.append(torch.cat(parts, -1))
        if len(groups) == 1:
            return logLs[0], sites[0]
        return torch.cat(logLs), torch.cat(sites)

    def tips_for(self, topo: Topology) -> torch.Tensor:
        """The tip partials in the tip order of ``topo``, a topology over
        the same taxa (``Topology.from_nested`` numbers them anew): the
        rows permuted on the device."""
        row = {t: i for i, t in enumerate(self.topo.taxa)}
        return self.tip_partials[torch.as_tensor(
            [row[t] for t in topo.taxa], device=self.tip_partials.device)]

    def topology_log_likelihood(self, params, topo: Topology,
                                tips: torch.Tensor,
                                bl: torch.Tensor) -> torch.Tensor:
        """The log-likelihood of this model's data, substitution and site
        models on another topology ``topo`` over the same taxa, with the
        branch lengths ``bl [N]`` (root entry unused) and ``tips`` in
        ``topo``'s tip order (:meth:`tips_for`), through the engine that
        :func:`select_engine` picks for ``topo``: on the card the CUDA
        kernels of a fixed topology, whose schedules are cached on the
        ``Topology`` object. Tree search and the tree MCMC score their
        candidates so; no model is rebuilt."""
        rates, props = self.site_model.rates_props(params)
        pmats = self.subst.p_t(params, bl[:, None] * rates[None, :]).to(
            self.dtype)
        freqs = self.subst.frequencies(params).to(self.dtype)
        return _ENGINE_FUNCTIONS[self.engine_name(topo=topo)](
            tips, pmats, topo, freqs, props.to(self.dtype), self.weights,
            rescale=self.rescale)[0]

    def log_likelihood_only(self, params) -> torch.Tensor:
        logL, _ = self._run_engine(params)
        return logL

    def log_jacobian(self, params) -> torch.Tensor:
        if self.height_transform == "shift":
            # |d heights / d shifts| = 1
            return self.weights.new_zeros(
                params[self.key("shifts")].shape[:-1])
        h = self.node_heights(params)
        return ratio_log_jacobian(h, self.topo, self.time_data.lowers)

    def log_likelihood(self, params) -> torch.Tensor:
        logL = self.log_likelihood_only(params)
        if self.include_jacobian and self.time_data is not None:
            logL = logL + self.log_jacobian(params)
        return logL

    def forward(self, params) -> torch.Tensor:
        return self.log_likelihood(params)

    def site_log_likelihoods(self, params) -> torch.Tensor:
        _, site_log = self._run_engine(params)
        return site_log[..., : self.sp.pattern_count]
