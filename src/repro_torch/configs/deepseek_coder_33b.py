"""deepseek-coder-33b [dense] — llama-arch code model [arXiv:2401.14196].
62L, d_model=7168, 56 heads (GQA kv=8, head_dim=128), d_ff=19200,
vocab=32256, rope_theta=100000.

The same dims as the reference config
(src/repro/configs/deepseek_coder_33b.py). Dense FFN: no routed layer.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b",
    family="dense",
    source="[arXiv:2401.14196]",
    n_layers=62,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=19200,
    vocab_size=32256,
    rope_theta=100000.0,
    max_seq_len=32768,
    attn_chunk=512,
)
