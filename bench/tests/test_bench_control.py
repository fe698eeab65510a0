"""The comparison rejects the control and every fault a cell can have.

On the CPU, at a tiny size with that size's limits (data/limits/tiny.json,
from 12 CPU seeds): a sound run is correct; the control (the reference in
the program's place, computed in fp8) fails; each fault planted in the
program's timed path (bench/faults.py) makes a whole run come out not
correct, the harness's look for a card skipped. On a card, at the cells'
own sizes and limits: the control fails on three seeds."""
import json
import time

import pytest
import torch

from bench import check, faults, harness
from bench.tests import _tiny

CELLS = [w["name"] for w in json.loads((harness.ROOT / "BENCHMARK.json").read_text())["workloads"]]


def _run(seed, fault=None, trace=False):
    return harness.run_cell(_tiny.cell(), seed, 0.2, trace, "cpu", time.monotonic(), fault)


def _control_numbers(cell, seed, device):
    prog = harness.build_program(cell, seed, device)
    pool = prog.pool
    del prog
    ref = harness.reference_records(cell, seed, pool, device)
    ctl = harness.reference_records(cell, seed, pool, device, "fp8")
    return check.numbers(ctl, ref)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_sound_run_is_correct(seed):
    out = _run(seed)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks" and set(out["checks"]) == set(_tiny.cell().limits)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_fails_at_a_tiny_size(seed):
    cell = _tiny.cell()
    assert not check.verdict(_control_numbers(cell, seed, "cpu"), cell.limits)


@pytest.mark.parametrize("name", sorted(faults.FAULTS))
def test_fault_makes_the_run_incorrect(name):
    out = _run(1, faults.FAULTS[name])
    assert not out["correct"], out["checks"]


def test_traced_run_reports_per_layer_metrics_and_breakdown():
    out = _run(2, trace=True)
    assert out["correct"]
    assert out["device"]["window_s"] > 0 and "breakdown" in out
    # no device on the CPU: only the program's counter has something to read
    assert set(out["metrics"]) <= {"avg_maxvio"}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_the_cells_size(name, cuda_device):
    cell = harness.resolve(name)
    for seed in (3500000000, 3500000001, 3500000002):
        nums = _control_numbers(cell, seed, cuda_device)
        assert not check.verdict(nums, cell.limits), (seed, nums)
