"""Operations and bytes the benchmark counts, and the card's published peaks.

Everything here depends only on shapes, the routing settings and the step's
expert loads, not on any model's layout; nothing reads the program. A
model's FLOPs per token are its plain reference's (`model_flops_per_token`
in bench/reference/<reference>.py).

Peaks: NVIDIA H100 SXM data sheet, dense rates at the full 700 W limit.
Roofline bounds count each input read once and each output written once;
a grouped expert product counts the rows its experts' loads fill
(sum over experts of min(load, capacity)), not the capacity it pads to,
and the weights of experts that got at least one row.
"""
from __future__ import annotations

import math
from typing import Sequence

PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12  # without the tensor cores
PEAK_BYTES = 3.35e12     # HBM3
BF16_BYTES = 2


def capacity(n_tokens: int, cfg: dict) -> int:
    r = cfg["routing"]
    return max(math.ceil(r["top_k"] * n_tokens / r["n_experts"] * r["capacity_factor"]), 1)


def _gemm_bound_s(flops: float, elems: float) -> float:
    return max(flops / PEAK_BF16_FLOPS, elems * BF16_BYTES / PEAK_BYTES)


def expert_ffn_bound_s(loads: Sequence[int], cap: int, d: int, f: int) -> float:
    """Least time of one MoE layer's K1 and K2 calls in a training step
    (bf16): K1 (the gated input product, two weights in, h out) and the nine
    K2 uses (h @ w_down forward; in the backward the recomputed gate and up
    products, dh, dw_down, both halves of dx, dw_gate, dw_up), each at the
    filled rows R = sum(min(load, cap)) and the weights of the experts that
    got rows. Each K2 use reads or writes R x d, R x f and one weight set."""
    rows = sum(min(int(v), cap) for v in loads)
    experts = sum(int(v) > 0 for v in loads)
    weights = experts * d * f
    k1 = _gemm_bound_s(2 * 2 * rows * d * f, rows * d + 2 * weights + rows * f)
    k2 = _gemm_bound_s(2 * rows * d * f, rows * d + rows * f + weights)
    return k1 + 9 * k2


def k3_update_bound_s(n: int, m: int, k: int, n_iters: int, refine: int = 1, n_bins: int = 512) -> float:
    """Least time of the fused dual update (K3): read the (n, m) fp32 scores
    and q0 and write q once; per iteration (k + 1) compares per score for p
    and, per histogram pass, ceil(log2(n_bins + 1)) compares per score to
    place it among the bin edges (fp32, no tensor cores)."""
    t_bytes = 4 * (n * m + 2 * m) / PEAK_BYTES
    per_score = (refine + 1) * math.ceil(math.log2(n_bins + 1)) + k + 1
    return max(t_bytes, n_iters * n * m * per_score / PEAK_FP32_FLOPS)
