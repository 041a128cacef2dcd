"""Tracing, timing, and roofline accounting on the card.

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
- :class:`Roofline` / :func:`pruning_roofline` hold a likelihood
  evaluation's operations and bytes against the card's peaks.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field

import torch


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


# -- roofline ---------------------------------------------------------------

# peak rates per chip: (float32 FLOP/s, float64 FLOP/s, device bytes/s)
CHIP_PEAKS = {
    # NVIDIA H100 SXM data sheet (at its 700 W limit): 67 TFLOP/s float32
    # and 34 TFLOP/s float64 on the CUDA cores (no tensor cores), 3.35 TB/s
    # of HBM3; the float32 rate and the bandwidth are chip_smoke.py's
    # PEAK_F32_FLOPS and PEAK_BYTES_PER_S
    "h100": (67e12, 34e12, 3.35e12),
}


@dataclass
class Roofline:
    flops: float
    bytes: float
    seconds: float
    chip: str = "h100"
    notes: dict = field(default_factory=dict)
    dtype_bytes: int = 4

    def _peaks(self) -> tuple:
        """(FLOP/s for this dtype, bytes/s) of the chip: a key of
        :data:`CHIP_PEAKS`, or a device name that contains one."""
        keys = [k for k in CHIP_PEAKS if k in self.chip.lower()]
        if not keys:
            raise ValueError(f"no peak rates for chip {self.chip!r}; one of "
                             f"{sorted(CHIP_PEAKS)}")
        f32, f64, bw = CHIP_PEAKS[keys[0]]
        return (f64 if self.dtype_bytes == 8 else f32), bw

    @property
    def intensity(self) -> float:
        """Arithmetic intensity, FLOPs/byte."""
        return self.flops / max(self.bytes, 1.0)

    @property
    def achieved_tflops(self) -> float:
        return self.flops / max(self.seconds, 1e-12) / 1e12

    @property
    def achieved_gbs(self) -> float:
        return self.bytes / max(self.seconds, 1e-12) / 1e9

    def bound_ms(self) -> float:
        """The least time the chip could take: the larger of the FLOPs over
        the peak rate and the bytes over the bandwidth."""
        peak_flops, peak_bw = self._peaks()
        return max(self.flops / peak_flops, self.bytes / peak_bw) * 1e3

    def bound(self) -> str:
        peak_flops, peak_bw = self._peaks()
        return ("compute" if self.intensity > peak_flops / peak_bw
                else "memory")

    def fraction_of_peak(self) -> float:
        peak_flops, peak_bw = self._peaks()
        if self.bound() == "compute":
            return self.achieved_tflops * 1e12 / peak_flops
        return self.achieved_gbs * 1e9 / peak_bw

    def report(self) -> str:
        frac = self.fraction_of_peak()
        # with both roofs far away the limiting-roof label misleads:
        # the kernel is really bound by per-op latency / occupancy
        bound = (self.bound() if frac >= 0.3
                 else f"{self.bound()}-roof, latency/occupancy")
        return (f"{self.flops/1e9:.2f} GFLOP, {self.bytes/1e6:.1f} MB, "
                f"{self.seconds*1e3:.3f} ms -> "
                f"{self.achieved_tflops:.2f} TFLOP/s, "
                f"{self.achieved_gbs:.1f} GB/s "
                f"({bound}-bound, "
                f"{100*frac:.1f}% of peak on "
                f"{self.chip})")


def pruning_roofline(n_nodes: int, n_cat: int, n_states: int,
                     n_patterns: int, seconds: float, *,
                     dtype_bytes: int = 4, chip: str = "h100",
                     with_gradient: bool = False) -> Roofline:
    """Roofline model of one likelihood evaluation (the JAX package's
    count).

    FLOPs: per internal node, per category: S x S x P multiply-adds per
    child (x2 children) plus the S x P product — the arithmetic the
    reference's SIMD kernels perform (treelikelihood4.c update_partials).
    Bytes: partials read/write + P-matrices, the floor of a sweep that
    keeps every node's partials in device memory (the level-batched plain
    engine).
    """
    internal = n_nodes // 2
    flops = internal * n_cat * (2 * 2 * n_states * n_states * n_patterns
                                + n_states * n_patterns)
    byts = (n_nodes * n_cat * n_states * n_patterns * 2      # partials rw
            + n_nodes * n_cat * n_states * n_states) * dtype_bytes
    if with_gradient:
        flops *= 3
        byts *= 2
    return Roofline(float(flops), float(byts), seconds, chip,
                    dtype_bytes=dtype_bytes)


def detect_chip() -> str:
    """``torch.cuda.get_device_name()`` (the CUDA device's name), or
    ``"cpu"`` without one."""
    if not torch.cuda.is_available():
        return "cpu"
    return torch.cuda.get_device_name()
