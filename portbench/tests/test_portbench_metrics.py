"""The metric arithmetic on synthetic windows, and the frozen work counts
against chip_smoke.py's."""

import numpy as np
import pytest

from portbench import harness, readers, trace, work


def test_union_and_gaps_of_overlapping_intervals():
    iv = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (5.5, 5.7), (8.0, 8.0)]
    assert trace.union_seconds(iv) == pytest.approx(4e-6)
    assert trace.idle_gaps(iv, (0.0, 10.0)) == [(3.0, 5.0), (6.0, 8.0),
                                                (8.0, 10.0)]


def test_idle_share_is_one_minus_the_union():
    w = trace.Window([("k", 0.0, 40.0), ("k", 20.0, 60.0),
                      ("Memcpy HtoD", 70.0, 80.0)],
                     [("vb.step", 0.0, 100.0)], (0.0, 100.0), 2, {})
    r = harness.Reading(w, {}, 1, 4)
    assert readers.device_idle_pct(r) == pytest.approx(30.0)
    # copies are device work but no kernel launch
    assert readers.launches_per_step(r) == 1.0
    # the longest gaps first, each named by the host span around it
    assert trace.gap_rows(w) == [["vb.step", pytest.approx(2e-5)],
                                 ["vb.step", pytest.approx(1e-5)]]


def test_percentiles_are_over_all_operations(monkeypatch):
    """p95 (the end-to-end tail) and p50 (its per-layer median) are taken
    over every evaluation of the window, not over chunks."""
    from portbench import manifest
    from portbench.drivers import api

    # a clock whose every reading is one second on: each evaluation of
    # the window takes 1000 ms
    ticks = iter(range(10 ** 6))
    monkeypatch.setattr(api.time, "perf_counter", lambda: float(next(ticks)))
    monkeypatch.setattr(api, "evaluate",
                        lambda s: ({}, -1.0, np.zeros(1)))

    class Session:
        done = []
    out = api.window(Session(), 100.0)
    assert out["attempted"] == len(out["latencies_ms"]) > 10
    assert out["metrics"]["api_eval_ms_p95"] == pytest.approx(1000.0)
    r = harness.Reading(None, {}, 1, 8, list(range(1, 101)))
    assert manifest.metric_reader("api_eval_ms_p50")(r) == \
        pytest.approx(50.5)
    assert np.percentile(range(1, 101), 95) == pytest.approx(95.05)


def test_rate_is_all_steps_over_all_the_window():
    from portbench.drivers import advi

    class Fake:
        pass
    calls = []

    def step(*a):
        calls.append(1)
    s = Fake()
    s.family = s.opt = s.schedule = s.generator = None
    s.vparams = {n: __import__("torch").zeros(2) for n in advi.LEAVES}
    s.grad_samples, s.check_every = 1, 2
    s.device = __import__("torch").device("cpu")
    real = advi.vb.step
    advi.vb.step = step
    try:
        out = advi.window(s, 0.05)
    finally:
        advi.vb.step = real
    assert out["attempted"] == len(calls) and out["failed"] == 0
    assert out["metrics"]["advi_steps_per_s"] == pytest.approx(
        len(calls) / out["seconds"])


SHAPE = dict(T=128, I=127, C=4, S=4, maxc=2, P=16291)


def test_roofline_and_mfu_from_the_counters():
    dims = tuple(SHAPE[k] for k in ("T", "I", "C", "S", "maxc", "P"))
    fb, ff = work.pruning_work(False, *dims, 4)
    bb, bf = work.pruning_work(True, *dims, 4)
    w = trace.Window([("void forward_level<float, 4>()", 0.0, 100.0),
                      ("void backward_sum<float, 4>()", 100.0, 400.0),
                      ("void other()", 400.0, 500.0)], [], (0.0, 1000.0), 2,
                     {"staged_forward": 2, "staged_backward": 2})
    r = harness.Reading(w, SHAPE, 1, 4, [], dict(w.counters), 1e-3)
    least = work.bound(2 * (fb + bb), 2 * (ff + bf))[0]
    from portbench.readers import roofline_pct
    got = roofline_pct(r, ("staged",), ("forward_level", "backward_sum"))
    assert got == pytest.approx(100.0 * least / 400e-6)
    assert readers.mfu_pct(r) == pytest.approx(
        100.0 * 2 * (ff + bf) / (1000e-6 * work.PEAK_FLOPS))
    # nothing traced, nothing read
    empty = harness.Reading(trace.Window([], [], (0.0, 1.0), 1, {}), SHAPE,
                            1, 4, [], {}, 1.0)
    assert roofline_pct(empty, ("staged",), ("forward_level",)) is None
    assert readers.mfu_pct(empty) is None


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("dims", [
    (128, 127, 4, 4, 2, 16291, 4), (69, 68, 4, 4, 2, 238, 8),
    (32, 31, 1, 61, 2, 4096, 4), (64, 63, 4, 20, 2, 8192, 8),
    (1024, 1023, 4, 4, 2, 65536, 4)])
def test_frozen_work_counts_match_chip_smoke(backward, dims):
    import chip_smoke

    assert work.pruning_work(backward, *dims) == \
        chip_smoke.pruning_work(backward, *dims)
    *shape, itemsize = dims
    for L in (1, 8):
        assert work.loop_work(backward, *shape, L, itemsize) == \
            chip_smoke.loop_work(backward, *shape, L, itemsize)
    nbytes, flops = work.pruning_work(backward, *dims)
    ms, by = chip_smoke.bound(nbytes, flops)
    s, by2 = work.bound(nbytes, flops)
    assert by == by2 and s * 1e3 == pytest.approx(ms, rel=1e-12)
    assert np.isfinite(s)
