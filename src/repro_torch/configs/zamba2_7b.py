"""zamba2-7b [hybrid] — Mamba2 backbone + weight-shared attention blocks
[arXiv:2411.15242]. 81 backbone layers, d_model=3584, shared (attn+MLP)
block applied every 6th layer (32 heads, kv=32, head_dim 112), d_ff=14336,
vocab=32000, ssm_state=64, 2 SSM groups.

The same dims as the reference config (src/repro/configs/zamba2_7b.py),
with its simplification: one shared block (the release alternates two) and
no per-invocation LoRA deltas. Not MoE: no routed FFN.
"""
from repro_torch.configs.base import ModelConfig, SSMSpec

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    source="[arXiv:2411.15242]",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab_size=32000,
    shared_attn_every=6,
    ssm=SSMSpec(d_state=64, d_conv=4, expand=2, head_dim=64, n_groups=2, chunk_size=128),
    rope_theta=10000.0,
    max_seq_len=524288,
    attn_chunk=512,
)
