"""K4's plain version and the rule that sends `attention` to it, on the CPU.

`kernels/flash_attn.flash_attention_plain` (the masked softmax over the
whole sequence, fp32 scores) is held against `models/common.attention`'s
chunked `_attend` path: both in fp32, outputs and the gradients of x and of
every weight, at S not a multiple of the query chunk, with GQA, for one row
and for a batch. The fused branch of `attention` is reached on the CPU by
forcing the rule, so its wrapper runs the plain version. Tolerance 1e-5
relative plus 1e-5 of the largest entry: the two sum the same fp32
products in different orders and chunk shapes, and a weight's gradient
sums B x S of them with cancellation. The rule itself is asked directly for each
feature that must keep the plain path. The kernel is checked against the
plain version on the card, by tests/test_torch_cuda.py.
"""
from __future__ import annotations

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.kernels import flash_attn  # noqa: E402
from repro_torch.models import common  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6


def _gqa_cfg():
    # 4 query heads over 2 kv heads, head_dim 32, query chunks of 16
    return configs.reduced_for_smoke("minimind_moe_16e", n_kv_heads=2, attn_chunk=16)


def _attn_and_grads(cfg, params, x):
    x = x.clone().requires_grad_(True)
    ps = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    y = common.attention(ps, x, cfg)
    g = torch.randn(y.shape, generator=torch.Generator().manual_seed(7))
    y.backward(g)
    return y.detach(), x.grad, {k: v.grad for k, v in ps.items()}


@pytest.mark.parametrize("batch,seq", [(1, 37), (3, 37), (2, 16)])
def test_plain_version_matches_the_chunked_path(batch, seq, monkeypatch):
    cfg = _gqa_cfg()
    assert cfg.n_heads == 2 * cfg.n_kv_heads and cfg.compute_dtype == torch.float32
    gen = torch.Generator().manual_seed(0)
    params = common.init_attention(gen, cfg)
    x = torch.randn(batch, seq, cfg.d_model, generator=gen)
    calls = []
    y0, dx0, dp0 = _attn_and_grads(cfg, params, x)
    monkeypatch.setattr(common, "uses_fused_attention", lambda *a, **k: True)
    plain = flash_attn.flash_attention_plain
    monkeypatch.setattr(flash_attn, "flash_attention_plain", lambda *a: calls.append(1) or plain(*a))
    y1, dx1, dp1 = _attn_and_grads(cfg, params, x)
    assert calls, "the fused branch did not run the plain version"
    for got, want in [(y1, y0), (dx1, dx0)] + [(dp1[k], dp0[k]) for k in dp0]:
        torch.testing.assert_close(got, want, rtol=RTOL, atol=RTOL * float(want.abs().max()))


def test_plain_log_sum_exp_and_causality():
    gen = torch.Generator().manual_seed(1)
    q = torch.randn(2, 21, 4, 8, generator=gen)
    k = torch.randn(2, 21, 1, 8, generator=gen)
    v = torch.randn(2, 21, 1, 8, generator=gen)
    o, lse = flash_attn.flash_attention_plain(q, k, v)
    assert o.shape == q.shape and lse.shape == (2, 4, 21)
    logits = torch.einsum("bqhd,bkd->bhqk", q, k[:, :, 0]) / 8**0.5
    for i in (0, 5, 20):  # row i sees keys 0..i only
        want = torch.logsumexp(logits[:, :, i, : i + 1], dim=-1)
        torch.testing.assert_close(lse[:, :, i], want, rtol=RTOL, atol=ATOL)
        w = torch.softmax(logits[:, :, i, : i + 1], dim=-1)
        torch.testing.assert_close(o[:, i], torch.einsum("bhk,bkd->bhd", w, v[:, : i + 1, 0]),
                                   rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(flash_attn.flash_attention(q, k, v), o)
    # row 0 attends to key 0 alone
    torch.testing.assert_close(o[:, 0], v[:, 0].expand(2, 4, 8))


def test_wrapper_refuses_mismatched_operands():
    q = torch.zeros(1, 8, 4, 16)
    with pytest.raises(ValueError):
        flash_attn.flash_attention(q, torch.zeros(1, 8, 3, 16), torch.zeros(1, 8, 3, 16))
    with pytest.raises(ValueError):
        flash_attn.flash_attention(q, torch.zeros(1, 7, 2, 16), torch.zeros(1, 7, 2, 16))
    with pytest.raises(ValueError):
        flash_attn.flash_attention(q, torch.zeros(1, 8, 2, 16), torch.zeros(1, 8, 2, 8))


def _rule(cfg, **kw):
    kw.setdefault("layer_kind", "global")
    return common.uses_fused_attention(cfg, kw.pop("device", "cuda"), **kw)


def test_rule_takes_the_training_attention_of_every_cell():
    for name in ("minimind_moe_16e", "minimind_moe_64e"):
        cfg = configs.get(name)
        assert cfg.compute_dtype == torch.bfloat16 and cfg.resolved_head_dim == 64
        assert _rule(cfg)


@pytest.mark.parametrize("feature", [
    "cpu", "fp32", "softcap", "local_window", "segments", "non_causal", "positions",
    "head_dim_32", "head_dim_256",
])
def test_rule_keeps_the_plain_path(feature):
    cfg = configs.get("minimind_moe_16e")
    kw = {}
    if feature == "cpu":
        kw["device"] = "cpu"
    elif feature == "fp32":
        cfg = dataclasses.replace(cfg, compute_dtype=torch.float32)
    elif feature == "softcap":
        cfg = dataclasses.replace(cfg, attn_logit_softcap=50.0)
    elif feature == "local_window":
        cfg = dataclasses.replace(cfg, window_size=128)
        kw["layer_kind"] = "local"
    elif feature == "segments":
        kw["segments"] = torch.zeros(1, 8, dtype=torch.int64)
    elif feature == "non_causal":
        kw["causal"] = False
    elif feature == "positions":
        kw["positions"] = torch.arange(8)[None, :]
    else:
        cfg = dataclasses.replace(cfg, head_dim=int(feature.rsplit("_", 1)[1]))
    assert not _rule(cfg, **kw)
    # the same call without the feature takes the kernel
    assert _rule(configs.get("minimind_moe_16e"))


def test_rule_for_the_families():
    """gemma2 (softcap, local layers) keeps the plain path on every layer;
    a global layer of a model with windows elsewhere takes the kernel; head_dim
    128 (phi4-mini, deepseek-coder) takes it, paligemma's 256 does not."""
    gemma = configs.get("gemma2_27b")
    assert not _rule(gemma) and not _rule(gemma, layer_kind="local")
    assert _rule(configs.get("phi4_mini_3_8b")) and _rule(configs.get("deepseek_coder_33b"))
    assert configs.get("paligemma_3b").resolved_head_dim == 256 and not _rule(configs.get("paligemma_3b"))
    local = dataclasses.replace(configs.get("minimind_moe_16e"), window_size=256)
    assert _rule(local, layer_kind="global") and not _rule(local, layer_kind="local")


def test_launch_counters_reset():
    flash_attn.flash_attention.launches = 3
    flash_attn.flash_attention.bwd_launches = 2
    flash_attn.reset_launch_counts()
    assert flash_attn.flash_attention.launches == 0 == flash_attn.flash_attention.bwd_launches
