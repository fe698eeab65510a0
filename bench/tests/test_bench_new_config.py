"""A configuration that BENCHMARK.json does not have, added through files
only (bench/tests/_dense.py): a dense model, whose tree is not minimind's and
which has no router layer. Set-up, the checked steps and the comparison run
on it unchanged: the program reads correct in fp32 and at the file's bf16,
the reference computed in fp8 does not, and a whole run, timed or traced,
reports its metrics."""
import time

import pytest

from bench import check, harness
from bench.metrics import step_mfu
from bench.tests import _dense


def _numbers(cell, seed, precision="fp32"):
    prog = harness.build_program(cell, seed, "cpu")
    got = harness.checked_steps(prog, cell, seed, "cpu")
    want = harness.reference_records(cell, seed, prog.pool, "cpu")
    assert got["q"] == got["load"] == want["q"] == want["load"] == []
    if precision != "fp32":  # the control: the reference in the program's place
        got = harness.reference_records(cell, seed, prog.pool, "cpu", precision)
    return check.numbers(got, want)


def test_the_port_agrees_with_the_reference_in_fp32():
    nums = _numbers(_dense.cell(compute_dtype="float32"), 1)
    assert set(nums) == {"loss_gap", "loss1_gap", "grad_gap", "update_gap"}
    assert nums["loss_gap"] < 1e-6 and nums["grad_gap"] < 1e-5 and nums["update_gap"] < 1e-5
    assert check.verdict(nums, _dense.cell().limits)


@pytest.mark.parametrize("seed", [13, 14])
def test_sound_run_is_correct_and_the_fp8_control_is_not(seed):
    cell = _dense.cell()
    assert check.verdict(_numbers(cell, seed), cell.limits)
    assert not check.verdict(_numbers(cell, seed, "fp8"), cell.limits)


@pytest.mark.parametrize("trace", [False, True])
def test_whole_run(trace):
    out = harness.run_cell(_dense.cell(), 15, 0.2, trace, "cpu", time.monotonic())
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == {"loss_gap", "grad_gap", "update_gap"}
    # on the CPU no reader has a device trace, and no layer reports MaxVio
    want = set() if trace else {"train_tokens_per_s", "step_ms_p90", "peak_mem_gib", "setup_s"}
    assert set(out["metrics"]) == want


def test_step_mfu_reads_the_configurations_count():
    cell = _dense.cell()
    rec = {"busy_s": 0.5, "window_s": 1.0, "steps": 2, "tokens_per_step": 128,
           "config": cell.config["config"], "reference": cell.reference, "mix": cell.mix}
    # per layer 64 x (4 + 2 x 2) x 16 + 4 x 16 x 64 attention, 3 x 64 x 96 MLP; the head 64 x 256
    flops = 6.0 * (2 * (64 * 8 * 16 + 4 * 16 * 64 + 3 * 64 * 96) + 64 * 256) + 6.0 * 2 * 32 * 64
    assert step_mfu.read(rec) == pytest.approx(100 * flops * 128 * 2 / 989e12, rel=1e-12)
