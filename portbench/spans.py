"""What the readers of the program's own spans share: the ``physher.``
spans among the host rows of a traced window (``span`` of
``physher_tpu_torch/utils/profiling.py``, recorded by the same profiler as
the device's rows), their union and their counts a step. Each returns None
where the window holds no program span, as with a program that has none."""

from __future__ import annotations

from . import trace

PREFIX = "physher."
SYNC = "physher.sync"


def is_sync(name: str) -> bool:
    """A span around a host-device synchronization: ``physher.sync`` or
    ``physher.sync.<what>``."""
    return name == SYNC or name.startswith(SYNC + ".")


def program_spans(r):
    """(window, its ``physher.`` spans), or None where there are none."""
    w = r.window
    if w is None or not w.steps:
        return None
    spans = [e for e in w.host if e[0].startswith(PREFIX)]
    return (w, spans) if spans else None


def host_dispatch_ms_per_step(r):
    """The host's ms a step inside the program and outside its waits on
    the device: the union of the program's spans less the union of its
    synchronizations' spans."""
    got = program_spans(r)
    if got is None:
        return None
    w, spans = got
    inside = trace.union_seconds([(s, e) for _, s, e in spans])
    waits = trace.union_seconds([(s, e) for n, s, e in spans if is_sync(n)])
    return 1e3 * (inside - waits) / w.steps


def count_per_step(r, match):
    """The program's spans a step whose name ``match`` accepts."""
    got = program_spans(r)
    if got is None:
        return None
    w, spans = got
    return sum(1 for n, _, _ in spans if match(n)) / w.steps


def host_syncs_per_step(r):
    return count_per_step(r, is_sync)
