"""Model FLOPs of the traced steps over their wall time and the card's bf16
peak. The FLOPs per token are the configuration's plain reference's
(`model_flops_per_token` in the module the record names; for minimind, 6 per
matmul parameter a token uses, plus causal attention; no recomputation, no
capacity padding)."""
import importlib

from bench import counts


def read(rec):
    if rec["busy_s"] <= 0:
        return None
    ref = importlib.import_module(rec["reference"])
    flops = ref.model_flops_per_token(rec["config"], rec["mix"]["seq_len"])
    flops *= rec["tokens_per_step"] * rec["steps"]
    return 100.0 * flops / (rec["window_s"] * counts.PEAK_BF16_FLOPS)
