"""The rest of a run without the look for a card, on the CPU at a small
size: sound, ``correct`` comes out true; with the timed path broken
underneath, false, once for each fault a cell can have (one chip: no
exchange between chips to leave out)."""

import time

import pytest
import torch

from physher_tpu_torch import api
from physher_tpu_torch.inference import mcmc as mcmc_mod
from physher_tpu_torch.models.treelikelihood import TreeLikelihood
from portbench import harness
from portbench.tests import small

WORKLOADS = ["gtrg4-advi", "gy94-mcmc", "gtrg4-api-f64", "gtrg4-mcmc"]
SEED = 2 ** 31 + 57


def run(tmp_path, workload):
    bench = small.manifest(tmp_path)
    return harness.run_cell(bench, workload, SEED, 0.3, False, "cpu",
                            time.perf_counter(), workdir=tmp_path)


class _KeepState:
    """``torch`` for the sampler, whose ``where`` always keeps the old
    state: every step returns its chains unchanged."""

    def __getattr__(self, name):
        return getattr(torch, name)

    @staticmethod
    def where(cond, new, old):
        return old


def state_unchanged(monkeypatch, workload):
    if workload == "gtrg4-advi":
        monkeypatch.setattr(torch.optim.Adam, "step",
                            lambda self, closure=None: None)
    elif workload == "gtrg4-api-f64":
        monkeypatch.setattr(api._ValueHolder, "SetParameters",
                            lambda self, parameters: None)
    else:
        monkeypatch.setattr(mcmc_mod, "torch", _KeepState())


def half_batch(monkeypatch, workload):
    """The likelihood over the first half of the patterns, doubled: the
    mean taken over the half that is left."""
    run_engine = TreeLikelihood._run_engine

    def fault(self, params):
        w = self.weights
        keep = torch.zeros_like(w)
        keep[: w.shape[0] // 2] = 2.0
        self.weights = w * keep
        try:
            return run_engine(self, params)
        finally:
            self.weights = w
    monkeypatch.setattr(TreeLikelihood, "_run_engine", fault)


def answer_altered(monkeypatch, workload):
    """The log-likelihood a thousandth off where the engine produces it."""
    run_engine = TreeLikelihood._run_engine

    def fault(self, params):
        logl, site = run_engine(self, params)
        return logl * (1.0 + 1e-3), site
    monkeypatch.setattr(TreeLikelihood, "_run_engine", fault)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_sound_run_is_correct(tmp_path, workload):
    out = run(tmp_path, workload)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("fault", [state_unchanged, half_batch,
                                   answer_altered])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_broken_timed_path_is_not_correct(tmp_path, monkeypatch, workload,
                                          fault):
    fault(monkeypatch, workload)
    out = run(tmp_path, workload)
    assert not out["correct"], out["checks"]
