"""``BENCHMARK.json`` and the files the harness finds by the names in it:
``configs/<config>.json``, ``traffic/<traffic>.json``,
``limits/<workload>.json``, ``models/<model>.py``, ``drivers/<driver>.py``
and ``metrics/<metric>.py``, all under this folder."""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    chips: int
    end_to_end: list      # the cell's end-to-end metric entries
    per_layer: list       # the cell's per-layer metric entries


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def _reports(metric: dict, workload: str, e2e_of_cell: set) -> bool:
    """Whether a cell reports ``metric``: where the metric lists its
    workloads, the list decides; else an end-to-end metric is everyone's,
    and a per-layer one belongs to every cell that reports what it
    moves."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_of_cell


def cell(manifest: dict, workload: str, root: Path = HERE) -> Cell:
    by_name = {w["name"]: w for w in manifest["workloads"]}
    if workload not in by_name:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = by_name[workload]
    cfg = next(c for c in manifest["configs"] if c["name"] == w["config"])
    e2e = [m for m in manifest["end_to_end"]
           if _reports(m, workload, set())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in manifest["per_layer"]
                 if _reports(m, workload, names)]
    return Cell(workload, load_json(root.parent / cfg["file"]),
                load_json(root / "traffic" / f"{w['traffic']}.json"),
                load_json(root / "limits" / f"{workload}.json"),
                int(w["chips"]), e2e, per_layer)


def module(kind: str, name: str):
    """``models``, ``drivers``: a package module by name."""
    return importlib.import_module(f"portbench.{kind}.{name}")


def metric_reader(name: str, root: Path = HERE):
    """The ``read`` function of ``metrics/<name>.py`` (the name may hold
    dots, so the file is loaded by path)."""
    path = root / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
