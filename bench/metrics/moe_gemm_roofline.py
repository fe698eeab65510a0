"""The expert FFN kernels' share of their roofline: the least time of every
K1 and K2 call of the traced steps (forward and the eight backward uses,
at the rows each step's loads fill; bench/counts.py) over the device time
of the kernels (kernels/csrc/moe_gemm.cu's wgmma_gemm_kernel, K1 the gated
instantiations)."""
from bench import counts

KERNEL = "wgmma_gemm_kernel<"


def read(rec):
    t = sum(s for name, s in rec["kernels"] if KERNEL in name)
    if t <= 0:
        return None
    cfg = rec["config"]
    cap = counts.capacity(rec["tokens_per_step"], cfg)
    bound = sum(counts.expert_ffn_bound_s(layer.tolist(), cap, cfg["d_model"], cfg["moe_d_ff"])
                for step in rec["loads"] for layer in step)
    return 100.0 * bound / t
