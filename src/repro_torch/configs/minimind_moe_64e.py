"""minimind-moe 64-expert (1.1B) — the paper's own 64-expert model
[Jingyaogong 2024; paper Table 1]. m=64, k=8, T=14, otherwise the 16e
layout (the reference config is src/repro/configs/minimind_moe_64e.py).
"""
from repro_torch.configs.base import ModelConfig, RoutingSpec

CONFIG = ModelConfig(
    name="minimind-moe-64e",
    family="moe",
    source="[minimind; paper Table 1]",
    n_layers=8,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    head_dim=64,
    d_ff=1408,
    moe_d_ff=1408,
    vocab_size=6400,
    routing=RoutingSpec(
        n_experts=64,
        top_k=8,
        strategy="bip",
        bip_iters=14,
        aux_loss_alpha=0.1,
        lossfree_lr=0.001,
        score_fn="softmax",
        capacity_factor=1.25,
    ),
    n_shared_experts=1,
    rope_theta=10000.0,
    max_seq_len=8192,
    attn_chunk=512,
)
