"""What the per-layer metrics' readers share: counts of the traced window
and the pruning work the ops wrappers' counters say was done in it. Each
returns None where the window holds nothing to read."""

from __future__ import annotations

from . import trace
from .work import PEAK_FLOPS, bound, loop_work, pruning_work

# ops counters of the wrappers whose one call is one sweep of one chain
ONE_CHAIN = ("fused", "staged", "wide")


def launches_per_step(r):
    w = r.window
    if w is None or not w.steps:
        return None
    k = w.kernels()
    return len(k) / w.steps if k else None


def device_idle_pct(r):
    w = r.window
    if w is None or not w.device or w.window_s <= 0:
        return None
    busy = trace.union_seconds([(s, e) for _, s, e in w.device])
    return 100.0 * (1.0 - busy / w.window_s)


def _dims(r):
    s = r.shape
    return s["T"], s["I"], s["C"], s["S"], s["maxc"], s["P"]


def sweep_work(r, counters, kinds=ONE_CHAIN + ("loop",)):
    """(bytes, FLOPs) of every sweep in ``counters`` (the ops wrappers'
    calls), of the ``kinds`` of wrapper."""
    nbytes = flops = 0.0
    for kind in kinds:
        for backward, end in ((False, "forward"), (True, "backward")):
            calls = counters.get(f"{kind}_{end}", 0)
            if not calls:
                continue
            if kind == "loop":
                b, f = loop_work(backward, *_dims(r), r.chains, r.itemsize)
            else:
                b, f = pruning_work(backward, *_dims(r), r.itemsize)
            nbytes += calls * b
            flops += calls * f
    return nbytes, flops


def mfu_pct(r):
    """The measured window's counted pruning operations over its time at
    the peak rate (the untraced window: the profiler slows the host)."""
    if r.seconds <= 0:
        return None
    _, flops = sweep_work(r, r.counters)
    return 100.0 * flops / (r.seconds * PEAK_FLOPS) if flops else None


def roofline_pct(r, kinds, names):
    """The least time of the ``kinds`` wrappers' sweeps over the device
    time of the kernels named by ``names``."""
    w = r.window
    if w is None:
        return None
    nbytes, flops = sweep_work(r, w.counters, kinds)
    spent = trace.seconds_of(trace.matching(w.kernels(), names))
    if not flops or spent <= 0:
        return None
    return 100.0 * bound(nbytes, flops)[0] / spent


def device_ms_per_step(r, names):
    w = r.window
    if w is None or not w.steps:
        return None
    spent = trace.seconds_of(trace.matching(w.kernels(), names))
    return 1e3 * spent / w.steps if spent > 0 else None
