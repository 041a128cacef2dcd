"""Nothing the harness, a driver or a metric reader imports is JAX or the
JAX package (compared by whole top-level names: the port's name begins
with the JAX package's)."""

import json
import subprocess
import sys

from portbench.tests.small import ROOT

CODE = """
import json, sys
sys.path.insert(0, {root!r})
import portbench.run, portbench.harness, portbench.plain, portbench.sim
from portbench import manifest
bench = json.load(open({bench!r}))
for w in bench["workloads"]:
    cell = manifest.cell(bench, w["name"])
    manifest.module("models", cell.config["model"])
    manifest.module("drivers", cell.traffic["driver"])
    for m in cell.per_layer:
        manifest.metric_reader(m["name"])
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_no_jax_anywhere():
    out = subprocess.run(
        [sys.executable, "-c", CODE.format(root=str(ROOT),
                                           bench=str(ROOT / "BENCHMARK.json"))],
        capture_output=True, text=True, check=True, timeout=300)
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "physher_tpu_torch" in top and "portbench" in top
    assert not top & {"jax", "jaxlib", "flax", "physher_tpu"}


def test_without_a_card_the_run_exits_non_zero():
    r = subprocess.run(
        [sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
         "gy94-mcmc", "--seed", "3000000001", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert r.returncode != 0 and r.stdout == ""
