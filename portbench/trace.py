"""Reading a ``torch.profiler`` window: the device's operations and the
host's spans as plain intervals, their union, the device's idle gaps and
the rows of the result's ``breakdown``."""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field


@dataclass
class Window:
    """One traced window. Times in microseconds on the profiler's clock.

    ``device``: (name, start, end) of every operation the device ran
    (kernels, copies, fills); ``host``: (name, start, end) of the host's
    operations and the harness's spans; ``wall``: (start, end) of the
    window; ``steps``: the estimator steps (or evaluations) it holds;
    ``counters``: the ops wrappers' calls within it."""

    device: list
    host: list
    wall: tuple
    steps: int
    counters: dict = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return (self.wall[1] - self.wall[0]) * 1e-6

    def kernels(self) -> list:
        return [e for e in self.device if not is_copy_or_fill(e[0])]


def is_copy_or_fill(name: str) -> bool:
    low = name.lower()
    return low.startswith("memcpy") or low.startswith("memset")


def union_seconds(intervals) -> float:
    """Seconds covered by the union of (start, end) intervals (us)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total * 1e-6


def idle_gaps(intervals, wall) -> list:
    """(start, end) of every stretch of ``wall`` that no interval covers."""
    gaps, t = [], wall[0]
    for s, e in sorted(intervals):
        if s > t:
            gaps.append((t, min(s, wall[1])))
        t = max(t, e)
    if t < wall[1]:
        gaps.append((t, wall[1]))
    return [g for g in gaps if g[1] > g[0]]


def matching(events, names) -> list:
    """The events whose name holds one of ``names``."""
    return [e for e in events if any(n in e[0] for n in names)]


def seconds_of(events) -> float:
    return sum(e[2] - e[1] for e in events) * 1e-6


def device_ops(window: Window, top: int = 10) -> list:
    by = defaultdict(float)
    for name, s, e in window.device:
        by[name[:120]] += (e - s) * 1e-6
    return sorted(([k, v] for k, v in by.items()), key=lambda r: -r[1])[:top]


def host_at(window: Window, t: float) -> str:
    """The innermost host span running at time ``t`` (the one that started
    last), or "host idle"."""
    best = None
    for name, s, e in window.host:
        if s <= t <= e and (best is None or s > best[1]):
            best = (name, s)
    return best[0] if best else "host idle"


def gap_rows(window: Window, top: int = 10) -> list:
    """The device's ``top`` longest idle gaps, each named by what the host
    was doing in its middle."""
    gaps = idle_gaps([(a, b) for _, a, b in window.device], window.wall)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    return [[host_at(window, 0.5 * (s + e))[:120], (e - s) * 1e-6]
            for s, e in gaps]


def from_profiler(prof, wall, steps: int, counters: dict) -> Window:
    """A :class:`Window` from a finished ``torch.profiler.profile``: device
    rows are the events on a CUDA device."""
    from torch.autograd import DeviceType

    events = list(prof.events())
    host_spans = {ev.name for ev in events
                  if getattr(ev, "device_type", None) != DeviceType.CUDA}
    device, host = [], []
    for ev in events:
        tr = ev.time_range
        rec = (ev.name, float(tr.start), float(tr.end))
        if getattr(ev, "device_type", None) != DeviceType.CUDA:
            host.append(rec)
        elif not (getattr(ev, "is_user_annotation", False)
                  or ev.name in host_spans):
            # a host span's shadow on the device's timeline is no device
            # work
            device.append(rec)
    return Window(device, host, wall, steps, counters)
