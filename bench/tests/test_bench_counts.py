"""bench/counts.py, and the minimind reference's FLOP count, against hand
counts at the cells' shapes."""
import json
import math

import pytest

from bench import counts, harness
from bench.reference import minimind_moe


def _cfg(name):
    return json.loads((harness.BENCH / "configs" / f"{name}.json").read_text())["config"]


def test_active_matmul_params():
    # per layer: attention 4 d^2, (k + 1 shared) x 3 d f, router d m; then the tied head d V
    assert minimind_moe.active_matmul_params(_cfg("minimind-moe-16e")) == 8 * (
        4 * 512 * 512 + 5 * 3 * 512 * 1408 + 512 * 16) + 512 * 6400 == 98_238_464
    assert minimind_moe.active_matmul_params(_cfg("minimind-moe-64e")) == 8 * (
        4 * 512 * 512 + 9 * 3 * 512 * 1408 + 512 * 64) + 512 * 6400 == 167_641_088


@pytest.mark.parametrize("name, seq, per_token", [
    ("minimind-moe-16e", 512, 6 * 98_238_464 + 6 * 8 * 512 * 512),
    ("minimind-moe-16e", 2048, 6 * 98_238_464 + 6 * 8 * 2048 * 512),
    ("minimind-moe-64e", 512, 6 * 167_641_088 + 6 * 8 * 512 * 512),
])
def test_model_flops_per_token(name, seq, per_token):
    assert minimind_moe.model_flops_per_token(_cfg(name), seq) == per_token


def test_capacity_at_the_cells():
    assert counts.capacity(16384, _cfg("minimind-moe-16e")) == 5120
    assert counts.capacity(16384, _cfg("minimind-moe-64e")) == 2560


def test_expert_ffn_bound_counts_filled_rows():
    # 2 experts, loads 10 and 3 at capacity 8: 8 + 3 rows, both experts' weights
    rows, w = 11, 2 * 4 * 6
    k1 = max(4 * rows * 4 * 6 / counts.PEAK_BF16_FLOPS, 2 * (rows * 4 + 2 * w + rows * 6) / counts.PEAK_BYTES)
    k2 = max(2 * rows * 4 * 6 / counts.PEAK_BF16_FLOPS, 2 * (rows * 4 + rows * 6 + w) / counts.PEAK_BYTES)
    assert counts.expert_ffn_bound_s([10, 3], 8, 4, 6) == pytest.approx(k1 + 9 * k2, rel=1e-12)
    # an expert with no rows adds no weights
    assert counts.expert_ffn_bound_s([10, 3, 0], 8, 4, 6) == pytest.approx(k1 + 9 * k2, rel=1e-12)


@pytest.mark.parametrize("name, m, cap", [("minimind-moe-16e", 16, 5120), ("minimind-moe-64e", 64, 2560)])
def test_expert_ffn_bound_at_the_cells(name, m, cap):
    k = _cfg(name)["routing"]["top_k"]
    even = [16384 * k // m] * m  # balanced loads fill k n rows
    rows = 16384 * k
    flops = 2 * rows * 512 * 1408 * (2 + 9)  # K1's two products and nine K2 uses
    assert counts.expert_ffn_bound_s(even, cap, 512, 1408) >= flops / counts.PEAK_BF16_FLOPS
    # operations bound both at these sizes: K1 4 R d f, each K2 use 2 R d f
    assert counts.expert_ffn_bound_s(even, cap, 512, 1408) == pytest.approx(
        flops / counts.PEAK_BF16_FLOPS, rel=1e-12)
    # a load past capacity fills only the capacity: never more rows than m C
    skewed = [16384 * k] + [0] * (m - 1)
    assert counts.expert_ffn_bound_s(skewed, cap, 512, 1408) < counts.expert_ffn_bound_s(even, cap, 512, 1408)
    assert counts.expert_ffn_bound_s([10 ** 9] * m, cap, 512, 1408) == pytest.approx(
        counts.expert_ffn_bound_s([cap] * m, cap, 512, 1408))


def test_k3_update_bound():
    # n 16384, m 16, k 4, T 4, one refining pass, 512 bins: 4 x n m x (2 x 10 + 5) fp32 compares
    ops = 4 * 16384 * 16 * (2 * math.ceil(math.log2(513)) + 5) / counts.PEAK_FP32_FLOPS
    assert counts.k3_update_bound_s(16384, 16, 4, 4) == pytest.approx(ops, rel=1e-12)
    # bytes bound it where the work is one compare pass: read s and q0, write q
    assert counts.k3_update_bound_s(16384, 16, 4, 0) == pytest.approx(4 * (16384 * 16 + 32) / counts.PEAK_BYTES)
