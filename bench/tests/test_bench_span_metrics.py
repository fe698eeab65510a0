"""The readers of the program's layer spans (models/, telemetry/trace.py): on
a record made by hand each reads its number and returns None without its
spans; on a card, the tiny cell's traced run reads all five, with the
kernels no layer span covers under 5% of the busy step."""
import time

import pytest
import torch

from bench import harness
from bench.metrics import (attention_ms_per_step, embed_head_ms_per_step, ffn_ms_per_step,
                           unspanned_ms_per_step, weight_cast_ms_per_step)
from bench.tests import _tiny

READERS = (attention_ms_per_step, ffn_ms_per_step, embed_head_ms_per_step, weight_cast_ms_per_step,
           unspanned_ms_per_step)
SPAN_S = {
    "model/embed": 0.001, "bwd/model/embed": 0.003,
    "model/attention": 0.02, "bwd/model/attention": 0.04,
    "model/ffn": 0.03, "bwd/model/ffn": 0.05,
    "model/head": 0.002, "bwd/model/head": 0.004,
    "model/loss": 0.005, "bwd/model/loss": 0.006,
    "model/weight_cast": 0.007, "bwd/model/weight_cast": 0.008,
    "train/apply": 0.03, "train/fwd_bwd": 0.16, "router/select": 0.001, "moe/dispatch": 0.002,
}


def _rec(span_s, kernel_s=0.25):
    kernels = [("gemm", kernel_s - 0.05), ("elementwise", 0.05)]
    return {"steps": 2, "window_s": 0.4, "busy_s": kernel_s + 0.01, "kernels": kernels,
            "span_s": dict(span_s)}


def test_span_readers_on_a_record():
    rec = _rec(SPAN_S)
    assert attention_ms_per_step.read(rec) == pytest.approx(30.0)
    assert ffn_ms_per_step.read(rec) == pytest.approx(40.0)
    assert embed_head_ms_per_step.read(rec) == pytest.approx(10.5)
    assert weight_cast_ms_per_step.read(rec) == pytest.approx(7.5)
    # 0.25 s of kernels less the partition, its twins and train/apply (0.191 s)
    assert unspanned_ms_per_step.read(rec) == pytest.approx(29.5)
    assert unspanned_ms_per_step.read(_rec(SPAN_S, kernel_s=0.15)) == 0.0


def test_span_readers_return_none_without_their_spans():
    parent = {k: v for k, v in SPAN_S.items() if not k.startswith(("model/", "bwd/"))}
    for reader in READERS:
        assert reader.read(_rec(parent)) is None
        assert reader.read(_rec({})) is None


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"


@pytest.mark.cuda
def test_tiny_cell_traced_on_the_card_reads_the_span_metrics(cuda_device):
    spec = dict(_tiny.SPEC, per_layer=[
        {"name": r.__name__.rsplit(".", 1)[1], "unit": "ms", "moves": "train_tokens_per_s"} for r in READERS])
    cell = harness.resolve("tiny", spec, base=_tiny.DATA)
    out = harness.run_cell(cell, 3500000003, 0.2, True, cuda_device, time.monotonic())
    assert out["correct"], out["checks"]
    got = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(got) == {m["name"] for m in spec["per_layer"]}, got
    assert all(v > 0 for k, v in got.items() if k != "unspanned_ms_per_step"), got
    busy_ms = 1e3 * out["device"]["busy_s"] / out["attempted"]
    assert got["unspanned_ms_per_step"] < 0.05 * busy_ms, (got, busy_ms)
