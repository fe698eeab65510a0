"""gemma2-27b [dense] — local/global alternating attention + logit softcaps
[arXiv:2408.00118]. 46L, d_model=4608, 32 heads (GQA kv=16, head_dim=128),
d_ff=36864 (geglu), vocab=256000, sliding window 4096 on local layers,
attn softcap 50, final softcap 30, post-block norms.

The same dims as the reference config (src/repro/configs/gemma2_27b.py).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    source="[arXiv:2408.00118]",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    act="gelu",
    vocab_size=256000,
    attn_pattern=("local", "global"),
    window_size=4096,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    post_block_norms=True,
    rope_theta=10000.0,
    max_seq_len=524288,
    attn_chunk=512,
)
