"""One run of one cell: set-up, the measured window, with ``--trace 1`` a
profiled window and the per-layer readers, then the check of what the
timed path produced against the plain reference.

:func:`run_cell` takes the device as an argument so that the tests can
drive it on the CPU at small sizes; ``run.py`` is the entry point, which
insists on the card."""

from __future__ import annotations

import gc
import math
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from pathlib import Path

import torch

from . import manifest, trace

# top-level module names no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "physher_tpu")
DTYPES = {"float32": torch.float32, "float64": torch.float64}


@dataclass
class Reading:
    """What the per-layer readers get: the traced window (None where
    nothing was traced), the cell's shapes and chains, the dtype's size,
    and of the measured (untraced) window its per-operation times, the
    ops wrappers' calls and its seconds."""

    window: trace.Window | None
    shape: dict
    chains: int
    itemsize: int
    latencies_ms: list = field(default_factory=list)
    counters: dict = field(default_factory=dict)
    seconds: float = 0.0


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def ops_counters() -> dict:
    """The ops wrappers' call counters (module globals of the program)."""
    from physher_tpu_torch.ops import fused, loop, staged, wide

    return {"fused_forward": fused.FORWARD_LAUNCHES,
            "fused_backward": fused.BACKWARD_LAUNCHES,
            "staged_forward": staged.STAGED_FORWARD_LAUNCHES,
            "staged_backward": staged.STAGED_BACKWARD_LAUNCHES,
            "loop_forward": loop.LOOP_FORWARD_LAUNCHES,
            "loop_backward": loop.LOOP_BACKWARD_LAUNCHES,
            "wide_forward": wide.WIDE_FORWARD_LAUNCHES,
            "wide_backward": wide.WIDE_BACKWARD_LAUNCHES}


def build_kernels(names) -> None:
    """Build (once per source hash) and load the cell's CUDA sources, all
    at once in threads."""
    from physher_tpu_torch.ops import fused, loop, staged, wide

    mods = {"fused": fused, "loop": loop, "staged": staged, "wide": wide}
    with ThreadPoolExecutor(max(1, len(names))) as pool:
        for f in [pool.submit(mods[n].build) for n in names]:
            f.result()


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def power_limit() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return r.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def traced_window(driver, session, n: int, device) -> trace.Window:
    """``n`` operations of the driver under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    sync(device)
    before = ops_counters()
    with profile(activities=acts) as prof:
        with record_function("portbench.window"):
            steps = driver.traced(session, n)
            sync(device)
    after = ops_counters()
    counters = {k: after[k] - before[k] for k in after}
    spans = [(e.name, e.time_range.start, e.time_range.end)
             for e in prof.events() if e.name == "portbench.window"]
    wall = (float(spans[0][1]), float(spans[0][2]))
    return trace.from_profiler(prof, wall, steps, counters)


def read_metrics(entries, reading: Reading, root: Path = manifest.HERE):
    """Each per-layer metric's reader on ``reading``; a reader that finds
    nothing to read leaves its metric out."""
    out = {}
    for m in entries:
        value = manifest.metric_reader(m["name"], root)(reading)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(bench: dict, workload: str, seed: int, seconds: float,
             traced: bool, device, t_start: float,
             root: Path = manifest.HERE, workdir: Path | None = None) -> dict:
    """One run; returns the result's fields (``correct``, ``attempted``,
    ``failed``, ``metrics``, ``device``, ``breakdown``, ``checks``)."""
    cell = manifest.cell(bench, workload, root)
    cfg, traffic = cell.config, cell.traffic
    device = torch.device(device)
    on_card = device.type == "cuda"
    model = manifest.module("models", cfg["model"])
    driver = manifest.module("drivers", traffic["driver"])
    dtype = DTYPES[traffic.get("dtype", cfg["dtype"])]
    if on_card:
        build_kernels(traffic.get("kernels", []))
    with tempfile.TemporaryDirectory() as tmp:
        case = model.make(cfg, seed, device, Path(workdir or tmp))
        if on_card:
            # the peak is the program's: set-up and window, not the data's
            # simulation
            sync(device)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        session = driver.setup(case, traffic, seed, device, dtype)
    sync(device)
    # every window starts from an emptied collector
    gc.collect()
    setup_s = time.perf_counter() - t_start
    before = ops_counters()
    win = driver.window(session, seconds)
    after = ops_counters()
    metrics = {m["name"]: {"value": win["metrics"][m["name"]],
                           "unit": m["unit"]}
               for m in cell.end_to_end if m["name"] != "setup_s"}
    metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": (torch.cuda.get_device_name(device) if on_card
                    else "cpu"),
           "count": 1,
           "power_limit": power_limit() if on_card else "none"}
    breakdown = None
    if traced:
        window = traced_window(driver, session,
                               int(traffic["traced_steps"]), device)
        reading = Reading(window, case.shape(), int(traffic.get("chains", 1)),
                          torch.empty((), dtype=dtype).element_size(),
                          win.get("latencies_ms", []),
                          {k: after[k] - before[k] for k in after},
                          win["seconds"])
        metrics = read_metrics(cell.per_layer, reading, root)
        busy = trace.union_seconds([(s, e) for _, s, e in window.device])
        dev.update(busy_s=busy, window_s=window.window_s)
        breakdown = {"device_ops": trace.device_ops(window),
                     "idle_gaps": trace.gap_rows(window)}
    dev["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                if on_card else 0)
    # what the timed path produced, then the program's state is freed
    # before the reference runs beside it on the device
    answers = driver.answers(session)
    del session
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    checks = driver.check(answers, case, cell.limits, seed, device)
    correct = bool(win["attempted"] > 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values()))
    out = {"correct": correct, "attempted": int(win["attempted"]),
           "failed": int(win["failed"]), "metrics": metrics, "device": dev,
           "shape": case.shape()}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out

