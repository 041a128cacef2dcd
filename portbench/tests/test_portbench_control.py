"""The check's control: the plain reference in the program's place,
computed in the precision below the cell's (TF32 products for float32,
float32 for float64), fails at least one of the cell's numbers. On the CPU
at a small size, and on the card (``cuda``) at the same size;
``portbench/control.py`` reads it at a cell's own size."""

import pytest
import torch

from portbench import control
from portbench.manifest import cell
from portbench.tests import small

WORKLOADS = ["gtrg4-advi", "gy94-mcmc", "gtrg4-api-f64", "gtrg4-mcmc"]


def failed(tmp_path, workload, device):
    bench = small.manifest(tmp_path)
    checks = control.one(bench, workload, 2 ** 31 + 99, "control", 0.3,
                         torch.device(device))
    limits = cell(bench, workload).limits
    assert set(checks) == set(limits)
    return [k for k, c in checks.items() if not c["value"] <= c["limit"]]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_fails_a_number(tmp_path, workload):
    assert failed(tmp_path, workload, "cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_fails_a_number_on_the_card(tmp_path, workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    assert failed(tmp_path, workload, "cuda")
