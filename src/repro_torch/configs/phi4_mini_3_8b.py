"""phi4-mini-3.8b [dense] — RoPE + SwiGLU + GQA [arXiv:2412.08905].
32L, d_model=3072, 24 heads (GQA kv=8, head_dim=128), d_ff=8192,
vocab=200064, tied embeddings.

The same dims as the reference config (src/repro/configs/phi4_mini_3_8b.py).
Dense FFN: no routed layer.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b",
    family="dense",
    source="[arXiv:2412.08905]",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=200064,
    tie_embeddings=True,
    rope_theta=10000.0,
    max_seq_len=32768,
    attn_chunk=512,
)
