"""The per-layer readers on records made by hand: each reads its number, and
returns None where the trace holds nothing for it."""
import pytest
import torch

from bench import counts, harness
from bench.reference import minimind_moe
from bench.metrics import (adamw_ms_per_step, avg_maxvio, bip_admm_roofline, device_idle_share,
                           launches_per_step, moe_dispatch_ms_per_step, moe_gemm_roofline,
                           router_ms_per_step, step_mfu)

CFG = harness.resolve("train-m16e-bip-s512").config["config"]
MIX = harness.resolve("train-m16e-bip-s512").mix


def _rec(kernels=(), span_s=None, busy_s=0.5):
    loads = [torch.full((8, 16), 4096)] * 2
    return {"steps": 2, "window_s": 1.0, "busy_s": busy_s, "kernels": list(kernels),
            "span_s": span_s or {}, "loads": loads, "max_vio": [torch.tensor([0.1, 0.3]), torch.tensor([0.2])],
            "config": CFG, "reference": "bench.reference.minimind_moe", "mix": MIX,
            "tokens_per_step": 16384}


def test_readers_on_a_record():
    k1 = "void (anonymous namespace)::bf16::wgmma_gemm_kernel<true, false, true>(...)"
    k3 = "bip_dual_update_kernel(...)"
    rec = _rec([(k1, 0.02), (k3, 0.004), ("elementwise", 0.1)],
               {"train/apply": 0.03, "router/score_adjust": 0.004, "router/select": 0.001,
                "moe/dispatch": 0.002, "moe/combine": 0.001})
    assert launches_per_step.read(rec) == 1.5
    assert adamw_ms_per_step.read(rec) == pytest.approx(15.0)
    assert router_ms_per_step.read(rec) == pytest.approx(2.5)
    assert moe_dispatch_ms_per_step.read(rec) == pytest.approx(1.5)
    assert device_idle_share.read(rec) == pytest.approx(50.0)
    assert avg_maxvio.read(rec) == pytest.approx(0.25)
    layer = counts.expert_ffn_bound_s([4096] * 16, 5120, 512, 1408)
    assert moe_gemm_roofline.read(rec) == pytest.approx(100 * 2 * 8 * layer / 0.02)
    assert bip_admm_roofline.read(rec) == pytest.approx(100 * 2 * 8 * counts.k3_update_bound_s(16384, 16, 4, 4) / 0.004)
    flops = minimind_moe.model_flops_per_token(CFG, 512) * 16384 * 2
    assert step_mfu.read(rec) == pytest.approx(100 * flops / counts.PEAK_BF16_FLOPS)
    # the reading before the count moved into the reference, to the bit
    assert step_mfu.read(rec) == 1.994619291256623


def test_readers_return_none_without_their_records():
    rec = _rec(busy_s=0.0)
    for reader in (launches_per_step, adamw_ms_per_step, router_ms_per_step, moe_dispatch_ms_per_step,
                   device_idle_share, moe_gemm_roofline, bip_admm_roofline, step_mfu):
        assert reader.read(rec) is None
