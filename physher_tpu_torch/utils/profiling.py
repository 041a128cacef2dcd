"""Tracing and timing on the card.

Port of ``physher_tpu/utils/profiling.py``. The reference has no in-library
profiling — only wall-clock totals (reference: src/physher.c:320-324) and
the benchmark harness's clock_gettime loops (examples/benchmarking.c:
17-20). Here:

- :func:`time_fn` times a callable's first call apart from its steady
  state: by CUDA events on the card (after a synchronize), by the host
  clock on the CPU;
- :func:`trace` is a ``torch.profiler`` context that writes a Chrome trace;
- :func:`trace_op_times` sums the device time of each kernel name over a
  run of calls (``torch.profiler``'s ``key_averages``);
- :func:`span` / :func:`spanned` / :func:`span_backward` mark the
  program's layers (the estimator steps, the entry points, the models, the
  ops wrappers and each host-device synchronization) in a
  ``torch.profiler`` trace, on the profiler's clock beside the card's
  kernels, and cost one flag check when no profiler records.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from dataclasses import dataclass

import torch


_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that records ``name`` as a span (``record_function``)
    while a ``torch.profiler`` records on this thread (or on the autograd
    engine's threads, which inherit its state), else one shared no-op
    context. Spans nest by their intervals (``cpu_parent``); the count of
    a name's spans in a window is the count of its calls."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name)


def spanned(name: str):
    """Decorator: each call of the function inside :func:`span` ``(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def span_backward(t: torch.Tensor, name: str) -> torch.Tensor:
    """``t``; while a profiler records, the autograd node that makes its
    gradient runs inside :func:`span` ``(name)`` (on the autograd engine's
    thread): a span around a library backward that synchronizes inside."""
    node = t.grad_fn
    if node is None or not torch.autograd._profiler_enabled():
        return t
    opened = []

    def enter(grad_outputs):
        opened.append(torch.profiler.record_function(name))
        opened[-1].__enter__()

    def leave(grad_inputs, grad_outputs):
        opened.pop().__exit__(None, None, None)
    node.register_prehook(enter)
    node.register_hook(leave)
    return t


def _activities(device_type: str) -> list:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device_type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _device_type() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed work with ``torch.profiler`` (the card's kernels
    too where there is one) and write a Chrome trace, viewable in Perfetto,
    to ``log_dir/trace.json``; yields the profiler."""
    os.makedirs(log_dir, exist_ok=True)
    acts = _activities(_device_type())
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@dataclass
class Timing:
    compile_s: float
    per_call_s: float
    calls: int

    @property
    def per_call_ms(self) -> float:
        return self.per_call_s * 1e3


def _sync(device_type: str) -> None:
    if device_type == "cuda":
        torch.cuda.synchronize()


def time_fn(fn, *args, calls: int = 20, warmup: int = 2,
            device: str | torch.device | None = None) -> Timing:
    """Steady-state timing of ``fn(*args)``: the first call (which builds
    the kernels it launches) apart from the per-call time of ``calls``
    calls after ``warmup`` more. On a CUDA ``device`` (the default where
    there is one) the calls are timed by CUDA events after a synchronize,
    on the CPU by the host clock."""
    device_type = (torch.device(device).type if device is not None
                   else _device_type())
    t0 = time.perf_counter()
    fn(*args)
    _sync(device_type)
    compile_s = time.perf_counter() - t0
    for _ in range(warmup):
        fn(*args)
    _sync(device_type)
    if device_type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn(*args)
        end.record()
        end.synchronize()
        return Timing(compile_s, start.elapsed_time(end) / 1e3 / calls, calls)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn(*args)
    return Timing(compile_s, (time.perf_counter() - t0) / calls, calls)


def trace_op_times(fn, args_seq, *, top: int = 20):
    """MEASURED device-op timing: run ``fn`` over ``args_seq`` (a sequence
    of argument tuples) under ``torch.profiler`` after one call outside it,
    and sum the device time of each kernel name (``key_averages``; the CPU
    time of each operation where there is no card).

    Returns ``(total_device_s, [(name, seconds, count), ...])`` with the
    list sorted by time, truncated to ``top``. Total is device-busy time
    across ALL calls — divide by ``len(args_seq)`` for per-call.
    """
    device_type = _device_type()
    fn(*args_seq[0])
    _sync(device_type)
    with torch.profiler.profile(activities=_activities(device_type)) as prof:
        for args in args_seq:
            fn(*args)
        _sync(device_type)
    rows = []
    for ev in prof.key_averages():
        if device_type == "cuda":
            us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
        else:
            us = ev.self_cpu_time_total
        if us > 0:
            rows.append((ev.key, us / 1e6, ev.count))
    rows.sort(key=lambda r: -r[1])
    return sum(r[1] for r in rows), rows[:top]


def detect_chip() -> str:
    """``torch.cuda.get_device_name()`` (the CUDA device's name), or
    ``"cpu"`` without one."""
    if not torch.cuda.is_available():
        return "cpu"
    return torch.cuda.get_device_name()
