"""arctic-480b [moe] — 128 experts top-2 + dense residual
[hf:Snowflake/snowflake-arctic-base]. 35L, d_model=7168, 56 heads (GQA kv=8,
head_dim=128), expert d_ff=4864, vocab=32000. Dense-MoE hybrid: a dense FFN
runs in parallel with the routed MoE residual on every layer.

The same dims as the reference config (src/repro/configs/arctic_480b.py).
m=128 is where the paper's BIP routing matters most (imbalance grows with
expert count, paper Fig. 2). Parameters and Adam moments in bf16, as the
reference's dtype policy.
"""
import torch

from repro_torch.configs.base import ModelConfig, RoutingSpec

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    source="[hf:Snowflake/snowflake-arctic-base]",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=4864,
    moe_d_ff=4864,
    vocab_size=32000,
    routing=RoutingSpec(
        n_experts=128, top_k=2, strategy="bip", bip_iters=4, capacity_factor=1.25
    ),
    dense_residual=True,
    rope_theta=10000.0,
    max_seq_len=32768,
    attn_chunk=512,
    param_dtype=torch.bfloat16,
    compute_dtype=torch.bfloat16,
    adam_mu_dtype="bf16",
    adam_nu_dtype="bf16",
)
