"""Model FLOPs of the traced steps over their wall time and the card's bf16
peak (bench/counts.py: 6 per matmul parameter a token uses, plus causal
attention; no recomputation, no capacity padding)."""
from bench import counts


def read(rec):
    if rec["busy_s"] <= 0:
        return None
    flops = counts.model_flops_per_token(rec["config"], rec["mix"]["seq_len"])
    flops *= rec["tokens_per_step"] * rec["steps"]
    return 100.0 * flops / (rec["window_s"] * counts.PEAK_BF16_FLOPS)
