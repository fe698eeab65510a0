"""minimind-moe 16-expert (0.3B) — the paper's own 16-expert model
[Jingyaogong 2024, github.com/jingyaogong/minimind; paper Table 1].

The same dims as the reference config (src/repro/configs/minimind_moe_16e.py):
vocab 6400, 8 layers, d_model 512, 8 heads x 64, 16 routed experts, top-4,
softmax gate, expert d_ff 1408, one shared expert, BIP routing with T=4.
"""
from repro_torch.configs.base import ModelConfig, RoutingSpec

CONFIG = ModelConfig(
    name="minimind-moe-16e",
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
        n_experts=16,
        top_k=4,
        strategy="bip",
        bip_iters=4,
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
