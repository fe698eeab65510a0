"""llama4-scout-17b-a16e [moe] — 16 experts, top-1 routing, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E]. 48L, d_model=5120, 40 heads (GQA
kv=8, head_dim=128), expert d_ff=8192, vocab=202048.

The same dims as the reference config
(src/repro/configs/llama4_scout_17b_a16e.py). iRoPE layout: local
attention (window 8192) on 3 of every 4 layers, global every 4th, modeled
as sliding-window locals plus full-attention globals. A shared expert runs
beside the routed top-1 expert. BIP routing (k=1, m=16). Parameters and
Adam moments in bf16, as the reference's dtype policy.
"""
import torch

from repro_torch.configs.base import ModelConfig, RoutingSpec

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    source="[hf:meta-llama/Llama-4-Scout-17B-16E]",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    moe_d_ff=8192,
    vocab_size=202048,
    routing=RoutingSpec(
        n_experts=16, top_k=1, strategy="bip", bip_iters=4, capacity_factor=1.25
    ),
    n_shared_experts=1,
    attn_pattern=("local", "local", "local", "global"),
    window_size=8192,
    rope_theta=500000.0,
    max_seq_len=524288,
    attn_chunk=512,
    param_dtype=torch.bfloat16,
    compute_dtype=torch.bfloat16,
    adam_mu_dtype="bf16",
    adam_nu_dtype="bf16",
)
