"""granite-4.0-h-small [hybrid MoE] — IBM Granite 4.0-H Small, 32B-A9B
(https://huggingface.co/ibm-granite/granite-4.0-h-small/blob/main/config.json).

40 layers of period 10: five Mamba-2 layers, one attention layer, four
Mamba-2 layers (`layer_types`: attention at 5, 15, 25, 35). Every layer,
Mamba or attention, carries a MoE FFN: 72 SwiGLU experts of width 768,
top-10 with the gate a softmax over the ten chosen logits (softmax scores
renormalised over the top-k), beside one shared SwiGLU expert of width
1536. Mamba-2: 128 heads x 64 (expand 2), d_state 128, one group, conv 4
with bias, no projection bias, chunk 256. Attention: GQA 32 / 8 heads of
128, no position embedding (NoPE), scores scaled by attention_multiplier
1/128. The embedding times 12, each block's output times 0.22 before its
residual add, the logits over 16; tied embedding, RMSNorm eps 1e-5:

    h = h + 0.22 * mixer(norm1(h))
    h = h + 0.22 * (moe(norm2(h)) + shared(norm2(h)))

Routed by BIP here (the paper's method in place of Granite's auxiliary
loss), with the paper's T = 14 of its 64-expert model. A port-only entry
of the registry: the reference has no such model (`configs.get` resolves
it; ARCH_IDS stays the reference's list).
"""
from repro_torch.configs.base import ModelConfig, RoutingSpec, SSMSpec

PERIOD = ("mamba",) * 5 + ("global",) + ("mamba",) * 4

CONFIG = ModelConfig(
    name="granite-4.0-h-small",
    family="moe",
    source="https://huggingface.co/ibm-granite/granite-4.0-h-small/blob/main/config.json",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=768,
    moe_d_ff=768,
    vocab_size=100352,
    tie_embeddings=True,
    rms_norm_eps=1e-5,
    act="silu",
    attn_pattern=PERIOD,
    nope=True,
    attn_scale=0.0078125,
    embedding_multiplier=12.0,
    residual_multiplier=0.22,
    logits_scaling=16.0,
    routing=RoutingSpec(
        n_experts=72,
        top_k=10,
        strategy="bip",
        bip_iters=14,
        score_fn="softmax",
        norm_topk_prob=True,
        capacity_factor=1.25,
    ),
    n_shared_experts=1,
    shared_d_ff=1536,
    ssm=SSMSpec(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1, chunk_size=256),
    max_seq_len=131072,
    attn_chunk=512,
)
