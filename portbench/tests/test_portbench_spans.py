"""The readers of the program's spans on a hand-built window: the host's
time inside the program less its waits on the device, the synchronizations
and decompositions a step, each cell's reader found by its name, and
nothing read from a window without the program's spans."""

import json

import pytest

from portbench import harness, manifest, spans, trace
from portbench.tests.small import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NEW = {"host_dispatch_ms_per_step": "ms",
       "host_syncs_per_step": "syncs/step",
       "decomps_per_step": "calls/step"}


def _window(host, steps=2):
    """Two steps (us): each 0-1000 / 1000-2000 with a forward, a
    decomposition whose eigh waits 300 us, and, in the second, the sampler's
    own wait of 100 us; a driver span and an aten op around and inside."""
    return trace.Window([("k", 0.0, 50.0)], host, (0.0, 2000.0), steps, {})


HOST = [("mcmc.run", 0.0, 2000.0),
        ("physher.mcmc.step", 0.0, 1000.0),
        ("physher.treelikelihood.forward", 100.0, 900.0),
        ("physher.subst.eig", 200.0, 600.0),
        ("physher.sync.eigh", 250.0, 550.0),
        ("aten::linalg_eigh", 260.0, 540.0),
        ("physher.mcmc.step", 1000.0, 2000.0),
        ("physher.subst.eig", 1100.0, 1500.0),
        ("physher.sync.eigh", 1150.0, 1450.0),
        ("physher.sync.multinomial", 1600.0, 1700.0),
        # a span on the autograd engine's thread overlapping the main one's
        ("physher.subst.p_t.backward", 1650.0, 1750.0)]


def _reading(window):
    return harness.Reading(window, {}, 8, 4)


def test_host_dispatch_is_the_union_less_the_waits():
    r = _reading(_window(HOST))
    # union 2000 us, waits 300 + 300 + 100 us, over two steps
    assert spans.host_dispatch_ms_per_step(r) == pytest.approx(
        1e-3 * (2000.0 - 700.0) / 2)


def test_counts_a_step():
    r = _reading(_window(HOST))
    assert spans.host_syncs_per_step(r) == 1.5
    assert spans.count_per_step(r, lambda n: n == "physher.subst.eig") == 1.0
    assert spans.is_sync("physher.sync") and spans.is_sync("physher.sync.x")
    assert not spans.is_sync("physher.syncing")


@pytest.mark.parametrize("name", [m["name"] for m in BENCH["per_layer"]
                                  if m["name"].split(".")[0] in NEW])
def test_each_new_metric_reads_its_cells(name):
    entry = next(m for m in BENCH["per_layer"] if m["name"] == name)
    assert entry["unit"] == NEW[name.split(".")[0]]
    assert entry["source"] == "device_trace"
    for wl in entry["workloads"]:
        assert entry in manifest.cell(BENCH, wl).per_layer
    read = manifest.metric_reader(name)
    want = {"host_dispatch_ms_per_step": 0.65, "host_syncs_per_step": 1.5,
            "decomps_per_step": 1.0}[name.split(".")[0]]
    assert read(_reading(_window(HOST))) == pytest.approx(want)
    # a program without spans, and no traced window: nothing read
    bare = [e for e in HOST if not e[0].startswith("physher.")]
    assert read(_reading(_window(bare))) is None
    assert read(_reading(None)) is None
    assert read(_reading(_window(HOST, steps=0))) is None
