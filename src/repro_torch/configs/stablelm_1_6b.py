"""stablelm-1.6b [dense] — [hf:stabilityai/stablelm-2-1_6b].
24L, d_model=2048, 32 heads (MHA kv=32, head_dim=64), d_ff=5632,
vocab=100352.

The same dims as the reference config (src/repro/configs/stablelm_1_6b.py).
Dense FFN: no routed layer.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b",
    family="dense",
    source="[hf:stabilityai/stablelm-2-1_6b]",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=5632,
    vocab_size=100352,
    rope_theta=10000.0,
    max_seq_len=32768,
    attn_chunk=512,
)
