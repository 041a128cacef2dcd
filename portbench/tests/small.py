"""The benchmark's manifest with every configuration cut to a size the CPU
runs in seconds, for the tests."""

from __future__ import annotations

import copy
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SIZES = {"gtrg4-time-1024x64k": {"taxa": 10, "sites": 200},
         "gy94-m0-32x4096": {"taxa": 8, "codons": 50}}


def manifest(tmp: Path) -> dict:
    """BENCHMARK.json whose configuration files are small copies in
    ``tmp``."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench = copy.deepcopy(bench)
    for c in bench["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        cfg.update(SIZES[c["name"]])
        path = tmp / f"{c['name']}.json"
        path.write_text(json.dumps(cfg))
        c["file"] = str(path)
    return bench
