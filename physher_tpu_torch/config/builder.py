"""JSON model-graph builder: interprets reference-format physher configs.

Port of ``physher_tpu/config/builder.py`` (reference: src/physher.c:128-205
model construction, plus the per-type ``new_*_from_json`` factories). A
config is a dict of model objects (each with ``id`` and ``type``) plus a
``physher`` action list. Cross-references use the reference's syntax
(reference: src/phyc/parameters.h:384-392):

- ``&id``   — reference to a previously built object or parameter,
- ``%name`` — multi-parameter slice (e.g. ``%tree.distances``),
- ``$id``   — the parameters of a simplex.

JSON parameter ids map to ParamSpec names recorded in
``Context.param_names`` so that actions can address them. Every model is
built in the :class:`Context`'s ``dtype`` on its ``device``.

The config's ``"engine"`` names map to the port's by :func:`route_engine`:
on the card ``pallas-fused`` -> ``cuda-fused``, ``pallas-staged`` ->
``cuda-staged``, ``pallas-wide`` -> ``cuda-wide``, ``pallas-loop`` ->
``cuda-loop`` at every S from 2 to 64 (K5'/K6' for a batch of chains),
on the CPU the plain engine; ``xla`` -> ``torch``.

Pattern sharding (``"init": {"devices": n}`` or ``{"mesh": {"chains": c,
"patterns": p}}``, or ``build_config(devices=...)``) pads every
TreeLikelihood's patterns to a multiple of the pattern devices and shards
them over a :class:`~physher_tpu_torch.parallel.mesh.Mesh` (``ctx.mesh``).
"""

from __future__ import annotations

import copy
import json
import math
import os
import re

import numpy as np
import torch

from ..data.datatype import get_datatype, GeneralDataType
from ..data.distance import distance_matrix
from ..data.sitepattern import SitePattern
from ..io.seqio import read_alignment
from ..io.treeio import read_newick
from ..models.clock import (
    DiscreteClock, DistributionRelaxedClock, RelaxedClock, StrictClock)
from ..models.parameters import ParamSpec
from ..models.sitemodel import (
    ConstantSiteModel, DiscreteSiteModel, QuantileSiteModel)
from ..models.substitution import (
    GTR, HKY, JC69, K80, F81, NONSTAT, UNREST, GeneralReversible,
    SubstitutionModel,
)
from ..models.treelikelihood import TreeLikelihood
from ..trees.build import nj, upgma
from ..trees.timetree import TimeTreeData
from .treehandle import TreeHandle

# the JAX package's engine names -> the port's, on the card for one
# parameter dict (route_engine maps them by device and chains)
ENGINE_NAMES = {"auto": "auto", "pallas-fused": "cuda-fused",
                "pallas-staged": "cuda-staged", "pallas-wide": "cuda-wide",
                "pallas-loop": "cuda-loop", "xla": "torch"}


class Context:
    """Build-time registry (the reference's Hashtable, src/physher.c:140),
    with the dtype and device every model is built in."""

    def __init__(self, base_dir: str = ".", *, dtype: torch.dtype, device):
        self.base_dir = base_dir
        self.dtype = dtype
        self.device = torch.device(device)
        self.objects: dict[str, object] = {}
        # JSON parameter id -> spec name, for action resolution
        self.param_names: dict[str, str] = {}
        # composite name -> list of spec names (e.g. reparam vector aliases)
        self.slices: dict[str, list] = {}
        self.extra_specs: list[ParamSpec] = []
        self.seed = 0
        # the device mesh (build_config's devices / init.devices / init.mesh)
        self.mesh = None
        self.pattern_devices = 1

    @property
    def kw(self) -> dict:
        """``dtype`` and ``device`` keywords for the model constructors."""
        return dict(dtype=self.dtype, device=self.device)

    def resolve_target(self, ref) -> list:
        """Resolve '&id' / '%name' / '$id' to a list of spec names
        (reference: src/phyc/parameters.h:384-392)."""
        if isinstance(ref, list):
            out = []
            for r in ref:
                out.extend(self.resolve_target(r))
            return out
        if not isinstance(ref, str):
            raise ValueError(f"cannot resolve target {ref!r}")
        name = ref[1:] if ref[:1] in ("&", "$", "%") else ref
        if name in self.slices:
            return list(self.slices[name])
        if name in self.param_names:
            return [self.param_names[name]]
        return [name]

    def register(self, id_, obj):
        if id_:
            self.objects[id_] = obj

    def resolve(self, node):
        """Resolve '&id' string references."""
        if isinstance(node, str) and node.startswith("&"):
            return self.objects[node[1:]]
        return node

    def path(self, p):
        return p if os.path.isabs(p) else os.path.join(self.base_dir, p)


def loads_tolerant(text: str):
    """json.loads tolerating trailing commas before ``]``/``}``, as the
    reference's parser does (src/phyc/mjson.c:633) and its own fixtures
    need (tests/data/f81.json of the reference)."""
    # blank string literals with a non-whitespace filler so that commas and
    # brackets inside strings cannot match, then drop trailing commas from
    # the original text by offset
    no_str = re.sub(r'"(?:\\.|[^"\\])*"', lambda m: "0" * len(m.group()),
                    text)
    out, i = [], 0
    for m in re.finditer(r",(\s*[\]}])", no_str):
        out.append(text[i:m.start()])
        i = m.start() + 1
    out.append(text[i:])
    return json.loads("".join(out))


def load_json(path: str):
    """Read a reference-format JSON config file (mjson-compatible)."""
    with open(path) as fh:
        return loads_tolerant(fh.read())


def _prune(node):
    """Remove ignored and underscored entries (reference:
    src/physher.c:135-136)."""
    if isinstance(node, dict):
        return {k: _prune(v) for k, v in node.items()
                if not k.startswith("_")
                and not (isinstance(v, dict) and v.get("ignore") is True)}
    if isinstance(node, list):
        return [_prune(v) for v in node]
    return node


# -- parameters -------------------------------------------------------------


def _param_value(node, ctx: Context, default=None):
    """A scalar or vector parameter's initial value from JSON."""
    node = ctx.resolve(node)
    if isinstance(node, ParamSpec):
        v = node.init
        return float(v) if np.ndim(v) == 0 else np.asarray(v)
    if isinstance(node, (int, float)):
        return float(node)
    if isinstance(node, list):
        return np.asarray(node, dtype=np.float64)
    if isinstance(node, dict):
        v = node.get("values", node.get("value", default))
        if isinstance(v, list):
            return np.asarray(v, dtype=np.float64)
        return float(v)
    raise ValueError(f"cannot read parameter value from {node!r}")


def _bound(node, key, default):
    v = node.get(key, default) if isinstance(node, dict) else default
    if v in ("infinity", "inf"):
        return np.inf
    if v in ("-infinity", "-inf"):
        return -np.inf
    return float(v)


def build_parameter_spec(node, ctx: Context, name=None, lower=-np.inf,
                         upper=np.inf):
    """A ParamSpec from a JSON parameter node; registers its id."""
    node = ctx.resolve(node)
    pid = None
    if isinstance(node, dict):
        pid = node.get("id")
        lower = _bound(node, "lower", lower)
        upper = _bound(node, "upper", upper)
        value = _param_value(node, ctx)
        dim = node.get("dimension")
        if dim and np.ndim(value) == 0:
            value = np.full(int(dim), float(value))
    else:
        value = _param_value(node, ctx)
    name = name or pid
    if np.ndim(value) == 0:
        spec = ParamSpec.scalar(name, value, lower=lower, upper=upper)
    else:
        spec = ParamSpec.vector(name, value, lower=lower, upper=upper)
    if pid:
        ctx.param_names[pid] = name
        ctx.register(pid, spec)
    return spec


def build_simplex_spec(node, ctx: Context, name=None):
    node = ctx.resolve(node)
    if isinstance(node, ParamSpec):
        return node
    pid = node.get("id")
    name = name or pid
    if "values" in node:
        values = np.asarray(node["values"], dtype=np.float64)
    else:
        values = np.full(int(node["dimension"]), 1.0 / int(node["dimension"]))
    spec = ParamSpec.simplex(name, values)
    if pid:
        ctx.param_names[pid] = name
        ctx.register(pid, spec)
    return spec


# -- data -------------------------------------------------------------------


def build_datatype(node, ctx: Context):
    node = ctx.resolve(node)
    if node is None:
        return get_datatype("nucleotide")
    if isinstance(node, str):
        return get_datatype(node)
    if isinstance(node, dict):
        if node.get("type", "").lower() == "datatype" or "states" in node:
            dt = GeneralDataType(node["states"], node.get("ambiguities"))
            ctx.register(node.get("id"), dt)
            return dt
        raise ValueError(f"bad datatype node {node!r}")
    return node


def build_sitepattern(node, ctx: Context) -> SitePattern:
    node = ctx.resolve(node)
    if isinstance(node, SitePattern):
        return node
    dt = build_datatype(node.get("datatype"), ctx)
    aln_node = ctx.resolve(node["alignment"])
    if isinstance(aln_node, dict):
        if "file" in aln_node:
            seqs = read_alignment(ctx.path(aln_node["file"]))
        elif "sequences" in aln_node:
            seqs = aln_node["sequences"]
        else:
            raise ValueError("alignment needs 'file' or 'sequences'")
        ctx.register(aln_node.get("id"), seqs)
    else:
        seqs = aln_node
    gc = 0
    if isinstance(node.get("datatype"), dict):
        gc = int(node["datatype"].get("genetic_code", 0) or 0)
    sp = SitePattern.from_alignment(seqs, dt, genetic_code=gc)
    ctx.register(node.get("id"), sp)
    return sp


# -- substitution models ----------------------------------------------------


_NUC_RATE_ORDER = ["ac", "ag", "at", "cg", "ct", "gt"]


def build_substitution_model(node, ctx: Context) -> SubstitutionModel:
    node = ctx.resolve(node)
    if isinstance(node, SubstitutionModel):
        return node
    mid = node.get("id", "sm")
    model = str(node.get("model", "jc69")).lower()
    prefix = f"{mid}."
    kw = ctx.kw

    freqs_node = node.get("frequencies")
    freqs_init = freqs_name = None
    if freqs_node is not None:
        fspec = build_simplex_spec(freqs_node, ctx)
        freqs_init = np.asarray(fspec.init)
        freqs_name = fspec.name

    rates_node = node.get("rates")

    def rate_value(key, default):
        if isinstance(rates_node, dict) and key in rates_node:
            return _param_value(rates_node[key], ctx, default)
        return default

    if model == "jc69":
        sm = JC69(prefix, **kw)
    elif model == "k80":
        sm = K80(prefix, **kw)
    elif model == "f81":
        sm = F81(prefix, freqs_init=freqs_init, **kw)
    elif model == "hky":
        sm = HKY(prefix, kappa_init=rate_value("kappa", 1.0),
                 freqs_init=freqs_init, **kw)
    elif model == "gtr":
        if isinstance(rates_node, dict):
            rates_init = np.asarray([rate_value(k, 1.0)
                                     for k in _NUC_RATE_ORDER])
            sm = GTR(prefix, rates_init=rates_init, freqs_init=freqs_init,
                     **kw)
        elif isinstance(rates_node, str) and rates_node.startswith("$"):
            spec = ctx.objects[rates_node[1:]]
            sm = GTR(prefix, rates_init=np.asarray(spec.init),
                     freqs_init=freqs_init, rates_simplex=True, **kw)
        else:
            sm = GTR(prefix, freqs_init=freqs_init, **kw)
    elif model in ("wag", "lg", "dayhoff"):
        from ..models.protein import EmpiricalProtein

        sm = EmpiricalProtein(model, prefix, freqs_init=freqs_init, **kw)
    elif model in ("mg94", "gy94"):
        from ..models.codon import MG94, GY94

        dtn = node.get("datatype")
        gc = int(dtn.get("genetic_code", 0) if isinstance(dtn, dict) else 0)
        cls = MG94 if model == "mg94" else GY94
        sm = cls(prefix=prefix, genetic_code=gc, freqs_init=freqs_init, **kw)
    elif model == "unrest":
        sm = UNREST(prefix, **kw)
    elif model == "nonstat":
        sm = NONSTAT(prefix, **kw)
    elif set(model) <= set("012345") and len(model) == 5:
        # 5-digit rate-class code over AC,AG,AT,CG,CT, and GT its own class
        # (reference: src/phyc/substmodel.c:1431-1533, nucsubst.c)
        mapping = [int(c) for c in model] + [int(max(model)) + 1]
        sm = GeneralReversible(4, np.asarray(mapping), prefix,
                               freqs_init=freqs_init, **kw)
    else:
        raise ValueError(f"unknown substitution model {model!r}")

    # honour the JSON parameter ids
    if freqs_name is not None and hasattr(sm, "freqs_init"):
        ctx.param_names[freqs_name] = sm.key("frequencies")
    if isinstance(rates_node, dict):
        for sub in rates_node.values():
            if isinstance(sub, dict) and sub.get("id"):
                ctx.param_names[sub["id"]] = sm.key(
                    "kappa" if model == "hky" else "rates")
    ctx.register(mid, sm)
    return sm


# -- site models ------------------------------------------------------------


def build_sitemodel(node, ctx: Context):
    node = ctx.resolve(node)
    if node is None:
        return ConstantSiteModel(**ctx.kw), None
    subst = None
    if "substitutionmodel" in node:
        subst = build_substitution_model(node["substitutionmodel"], ctx)
    mid = node.get("id", "sitemodel")
    prefix = f"{mid}."
    dist_node = node.get("distribution")
    mu = "mu" in node
    mu_init = _param_value(node["mu"], ctx, 1.0) if mu else 1.0

    if dist_node is None:
        sm = ConstantSiteModel(prefix, mu=mu, mu_init=mu_init, **ctx.kw)
    else:
        if isinstance(dist_node, str):
            dist_name, cats, shape_init, quad = dist_node.lower(), 4, 0.5, \
                "median"
            invariant, props = False, None
        else:
            dist_name = str(dist_node.get("distribution", "gamma")).lower()
            cats = int(dist_node.get("categories", 4))
            quad = str(dist_node.get("quadrature", "median")).lower()
            invariant = bool(dist_node.get("invariant", False))
            props = dist_node.get("proportions")
            pnode = dist_node.get("parameters")
            shape_init = 0.5
            if isinstance(pnode, dict):
                if "alpha" in pnode or "shape" in pnode:
                    shape_init = _param_value(
                        pnode.get("alpha", pnode.get("shape")), ctx, 0.5)
                elif "id" in pnode:
                    shape_init = _param_value(pnode, ctx, 0.5)
        # sitemodel-level "rates": {"alpha": {...}} (gtr-bayesian.json style)
        if "rates" in node and isinstance(node["rates"], dict):
            rn = node["rates"]
            if "alpha" in rn or "shape" in rn:
                shape_init = _param_value(rn.get("alpha", rn.get("shape")),
                                          ctx, shape_init)
        pinv_init = 0.1
        if props is not None:
            # the pinv simplex keeps its JSON id as its name, as in the
            # JAX package
            pspec = build_simplex_spec(props, ctx)
            pinv_init = float(np.asarray(pspec.init)[0])
            invariant = True
        if dist_name == "discrete":
            sm = DiscreteSiteModel(cats, prefix, mu=mu, mu_init=mu_init,
                                   **ctx.kw)
        else:
            sm = QuantileSiteModel(cats, dist_name, invariant, quad, prefix,
                                   shape_init=shape_init,
                                   pinv_init=pinv_init, mu=mu,
                                   mu_init=mu_init, **ctx.kw)

        def reg_shape(pnode):
            if isinstance(pnode, dict):
                if "id" in pnode:
                    ctx.param_names[pnode["id"]] = sm.key("shape")
                else:
                    for sub in pnode.values():
                        if isinstance(sub, dict) and "id" in sub:
                            ctx.param_names[sub["id"]] = sm.key("shape")
        if isinstance(dist_node, dict):
            reg_shape(dist_node.get("parameters"))
        reg_shape(node.get("rates"))
    ctx.register(mid, sm)
    return sm, subst


# -- trees ------------------------------------------------------------------


def build_tree(node, ctx: Context) -> TreeHandle:
    """A TreeHandle; mirrors new_TreeModel_from_json (reference:
    src/phyc/tree.c:1183-1300)."""
    node = ctx.resolve(node)
    if isinstance(node, TreeHandle):
        return node
    time_tree = bool(node.get("time", False))
    dates = node.get("dates")
    if "newick" in node:
        topo, distances = read_newick(node["newick"])
    elif "file" in node:
        topo, distances = read_newick(ctx.path(node["file"]))
    elif "init" in node:
        init = node["init"]
        algorithm = str(init.get("algorithm", "nj")).lower()
        sp = build_sitepattern(init["sitepattern"], ctx)
        # reference quirk: an inverted strcasecmp chain builds JC69
        # distances for model "uncorrected" and uncorrected ones otherwise
        # (reference: src/phyc/distancematrix.c
        # create_DistanceMatrix_from_json); amino acids always take the
        # Kimura correction (distancematrix.c:641-646)
        model = str(init.get("model", "uncorrected")).lower()
        actual = "jc69" if model == "uncorrected" else "uncorrected"
        if sp.datatype.state_count == 20:
            actual = "kimura"
        D = distance_matrix(sp, actual)
        topo, distances = (nj if algorithm == "nj" else upgma)(sp.taxa, D)
    else:
        raise ValueError("tree node needs newick/file/init")
    td = None
    if dates is not None or time_tree:
        td = TimeTreeData.from_dated_tree(topo, distances, dates)
    tid = node.get("id", "tree")
    transform = str(node.get("transform", "ratio")).lower()
    handle = TreeHandle(topo, distances, td, prefix=f"{tid}.")
    handle.transform = transform
    ctx.register(tid, handle)
    # parameter-name aliases declared on the tree node (reference:
    # tree.c:1183-1199; e.g. "reparam": "tree.scalers")
    if td is not None:
        if transform == "shift":
            reparam = [handle.key("shifts")]
            alias_map = (("reparam", reparam), ("heights", reparam))
        else:
            reparam = [handle.key("ratios"), handle.key("root_height")]
            alias_map = (("reparam", reparam),
                         ("ratios", [handle.key("ratios")]),
                         ("root_height", [handle.key("root_height")]),
                         ("heights", reparam))
        for key, specs in alias_map:
            alias = node.get(key)
            if isinstance(alias, str):
                ctx.slices[alias] = specs
        for _, specs in alias_map:
            for s in specs:
                ctx.slices.setdefault(s, [s])
    else:
        alias = node.get("parameters")
        if isinstance(alias, str):
            ctx.slices[alias] = [handle.key("distances")]
        ctx.slices.setdefault(handle.key("distances"),
                              [handle.key("distances")])
    return handle


# -- branch (clock) models --------------------------------------------------


# the relaxed clock's JSON parameter keys -> its parameter names
_RELAXED_PARAMS = (("logmean", "logmean"), ("mean", "logmean"),
                   ("logsigma", "logsigma"), ("sigma", "logsigma"),
                   ("lambda", "lambda"), ("rate", "lambda"),
                   ("center", "center"))


def build_branchmodel(node, ctx: Context, N: int):
    node = ctx.resolve(node)
    model = str(node.get("model", "strict")).lower()
    mid = node.get("id", "bm")
    prefix = f"{mid}."
    if model == "strict":
        rate_node = node.get("rate")
        rate_init = (_param_value(rate_node, ctx, 1e-3)
                     if rate_node is not None else 1e-3)
        bm = StrictClock(N, prefix, rate_init=float(rate_init), **ctx.kw)
        if isinstance(rate_node, dict) and rate_node.get("id"):
            ctx.param_names[rate_node["id"]] = bm.key("rate")
    elif model in ("discrete", "local"):
        cmap = np.zeros(N, dtype=np.int32)
        if "map" in node:
            cmap = np.asarray(node["map"], dtype=np.int32)
        bm = DiscreteClock(N, cmap, prefix, **ctx.kw)
    elif model == "relaxed":
        # "distribution" selects the reference's discretized relaxed-clock
        # families (branchmodel.h:33); without one, free per-branch rates
        dist = node.get("distribution")
        if dist:
            pnode = node.get("parameters", {})
            kw = {}
            if isinstance(pnode, dict):
                for jk, name in _RELAXED_PARAMS:
                    if jk in pnode:
                        kw[f"{name}_init"] = float(
                            _param_value(pnode[jk], ctx))
                        sub = pnode[jk]
                        if isinstance(sub, dict) and sub.get("id"):
                            ctx.param_names[sub["id"]] = f"{prefix}{name}"
            if "categories" in node:
                kw["n_cats"] = int(node["categories"])
            if "map" in node:
                kw["assignment"] = np.asarray(node["map"], dtype=np.int32)
            bm = DistributionRelaxedClock(N, dist, prefix, **kw, **ctx.kw)
        else:
            bm = RelaxedClock(N, prefix, **ctx.kw)
    else:
        raise ValueError(f"unknown branch model {model!r}")
    ctx.register(mid, bm)
    return bm


# -- tree likelihood --------------------------------------------------------


def route_engine(name: str, device_type: str, n_states: int,
                 batch: int | None = None) -> str:
    """The port's engine for a config's ``"engine"`` value on a device type
    and state count, for one parameter dict (``batch`` None) or a batch of
    that many chains.

    The JAX package runs its ``pallas-*`` names on any device (in interpret
    mode off the TPU) and at any S, and a batch of two or more chains
    through its batched engine (``physher_tpu/inference/mcmc.py:344-357``).
    So here a ``pallas-*`` name takes the plain engine on the CPU, which
    computes what interpret mode computes, on the card K5'/K6' for a batch
    of chains, and otherwise its own pair at any S from 2 to 64:
    ``pallas-fused`` K1'/K2' (at S != 4 in the TPU wrapper's packed or
    category-split mode), ``pallas-staged`` the level-staged sweep (K3'/K4'
    at S = 4, ``csrc/wide.cu``'s level kernels at any other S); a state
    count outside 2 to 64 raises here. A ``cuda-*`` engine given to
    ``TreeLikelihood`` directly is not mapped: it raises where it cannot
    run."""
    name = str(name).lower()
    if name not in ENGINE_NAMES:
        raise ValueError(f"unknown engine {name!r}; one of "
                         f"{sorted(ENGINE_NAMES)}")
    engine = ENGINE_NAMES[name]
    if engine in ("auto", "torch"):
        return engine
    if device_type != "cuda":
        return "torch"
    if not 2 <= n_states <= 64:
        raise ValueError(f"engine {name!r}: {n_states} states; the CUDA "
                         f"kernels take 2 to 64")
    if batch is not None and batch >= 2:
        return "cuda-loop"
    return engine


def build_treelikelihood(node, ctx: Context) -> TreeLikelihood:
    node = ctx.resolve(node)
    if isinstance(node, TreeLikelihood):
        return node
    engine = node.get("engine", "auto")
    sp = build_sitepattern(node["sitepattern"], ctx)
    site_model, subst = build_sitemodel(node.get("sitemodel"), ctx)
    if subst is None:
        subst = build_substitution_model(node["substitutionmodel"], ctx)
    handle = build_tree(node["tree"], ctx)
    topo, td = handle.topo, handle.td
    clock = None
    if "branchmodel" in node:
        clock = build_branchmodel(node["branchmodel"], ctx, topo.N)
    elif td is not None:
        clock = StrictClock(topo.N, "bm.", rate_init=1e-3, **ctx.kw)
    dist0 = np.nan_to_num(np.asarray(handle.distances)[: topo.N - 1], nan=0.1)
    tid = node.get("id", "treelikelihood")
    route = (engine, ctx.device.type, sp.datatype.state_count)
    # the CUDA kernels take any pattern count: no padding by default; a
    # mesh run pads to a multiple of its pattern devices (zero weights)
    pad = int(node.get("pattern_pad_multiple", 1))
    pad = pad * ctx.pattern_devices // math.gcd(pad, ctx.pattern_devices)
    tlk = TreeLikelihood(
        sp, topo, subst, site_model, clock=clock, time_data=td,
        distances_init=dist0,
        include_jacobian=bool(node.get("include_jacobian",
                                       node.get("reparameterized", False))),
        # the reference defaults tipstates to true (treelikelihood.c:841)
        tipstates=bool(node.get("tipstates", True)),
        prefix=handle.prefix,
        pattern_pad_multiple=pad,
        engine=route_engine(*route),
        batch_engine=route_engine(*route, batch=2),
        height_transform=handle.transform, **ctx.kw)
    ctx.param_names.setdefault(handle.key("distances"),
                               handle.key("distances"))
    ctx.register(tid, tlk)
    return tlk


def build_parsimony(node, ctx: Context):
    """Parsimony model (reference: src/physher.c:190 MODEL_PARSIMONY)."""
    from ..likelihood.parsimony import Parsimony

    node = ctx.resolve(node)
    if not isinstance(node, dict):
        return node
    sp = build_sitepattern(node["sitepattern"], ctx)
    handle = build_tree(node["tree"], ctx)
    pars = Parsimony(sp, handle.topo, **ctx.kw)
    ctx.register(node.get("id"), pars)
    return pars


BUILDERS = {
    "treelikelihood": build_treelikelihood,
    "sitepattern": build_sitepattern,
    "substitutionmodel": build_substitution_model,
    "tree": build_tree,
    "parsimony": build_parsimony,
}


def build_config(cfg: dict, base_dir: str = ".", *, dtype: torch.dtype,
                 device, devices=None):
    """Build every top-level model object; returns (Context, actions).

    Multi-device runs are declared in the config's ``init`` block (the
    reference's seed block, src/physher.c:152) or by ``devices``, which
    overrides it (the CLI's ``--devices`` / ``--mesh``):

    - ``"init": {"devices": 4}``: shard site patterns over 4 devices;
    - ``"init": {"mesh": {"chains": 2, "patterns": 4}}``: a 2-D mesh, MCMC
      chains and tempered-ladder replicas on 'chains', patterns on
      'patterns';
    - ``devices``: an int, such a dict, or a
      :class:`~physher_tpu_torch.parallel.mesh.Mesh` whose devices are used
      as they are (a list may repeat a device).

    Without a Mesh, the mesh takes the first visible CUDA devices on the
    card (raising when there are fewer) and the CPU listed as often as the
    mesh has places on the CPU. Every TreeLikelihood is padded to a
    multiple of the pattern devices and sharded by
    ``parallel.mesh.shard_tree_likelihood``; the actions read
    ``ctx.mesh``."""
    from ..parallel.mesh import Mesh

    cfg = _prune(copy.deepcopy(cfg))
    ctx = Context(base_dir, dtype=dtype, device=device)
    actions = cfg.pop("physher", [])
    init = cfg.pop("init", {})
    if not isinstance(init, dict):
        init = {}
    ctx.seed = int(init.get("seed", 0))
    req = devices if devices is not None else init.get(
        "mesh", init.get("devices"))
    if req is not None:
        if isinstance(req, Mesh):
            shape = {"chains": req.shape.get("chains", 1),
                     "patterns": req.shape["patterns"]}
        elif isinstance(req, dict):
            shape = {"chains": int(req.get("chains", 1)),
                     "patterns": int(req.get("patterns", 1))}
        else:
            shape = {"chains": 1, "patterns": int(req)}
        # the tree likelihoods' pattern padding reads it
        ctx.pattern_devices = shape["patterns"]
    for key, node in cfg.items():
        if not isinstance(node, dict):
            continue
        typ = str(node.get("type", "")).lower()
        if typ in BUILDERS:
            BUILDERS[typ](node, ctx)
        elif typ == "compound":
            from .compound import build_compound

            build_compound(node, ctx)
        elif typ == "simplex":
            build_simplex_spec(node, ctx)
        elif typ == "parameter":
            build_parameter_spec(node, ctx)
        elif typ == "variational":
            from .variational import build_variational

            build_variational(node, ctx)
        elif typ == "distribution":
            from .compound import build_distribution

            build_distribution(node, ctx)
        elif typ == "coalescent":
            from .compound import build_coalescent

            build_coalescent(node, ctx)
        else:
            raise ValueError(f"unknown model type {typ!r} for {key!r}")
    if req is not None:
        _attach_mesh(ctx, shape, req if isinstance(req, Mesh) else None)
    return ctx, actions


def _attach_mesh(ctx: Context, shape: dict, mesh=None):
    """Make the ``shape`` mesh ({"chains", "patterns"}) unless ``mesh`` is
    given, and shard every TreeLikelihood's pattern columns over it (the
    reduction point: the weighted root sum, reference
    src/phyc/treelikelihood.c:1483-1486)."""
    from ..parallel.mesh import (cuda_devices, mesh_from_shape,
                                 shard_tree_likelihood)

    if mesh is None:
        total = shape["chains"] * shape["patterns"]
        if ctx.device.type == "cuda":
            devs = cuda_devices(total, f"config requests a {shape['chains']}"
                                       f"x{shape['patterns']} mesh, which")
        else:
            devs = [ctx.device] * total
        mesh = mesh_from_shape(shape, devs)
    ctx.mesh = mesh
    for obj in ctx.objects.values():
        if isinstance(obj, TreeLikelihood):
            shard_tree_likelihood(obj, mesh)
