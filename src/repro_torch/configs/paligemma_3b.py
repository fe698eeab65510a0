"""paligemma-3b [vlm] — SigLIP vision encoder + Gemma-2B decoder
[arXiv:2407.07726]. Backbone: 18L, d_model=2048, 8 heads (GQA kv=1,
head_dim=256), d_ff=16384 (gelu), vocab=257216.

The same dims as the reference config (src/repro/configs/paligemma_3b.py).
The SigLIP frontend is a stub: the batch carries 256 patch embeddings of
dim 1152 (224px / 14px patches); the learned projector and the language
model are real.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    source="[arXiv:2407.07726]",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    act="gelu",
    vocab_size=257216,
    frontend_tokens=256,
    frontend_dim=1152,
    rope_theta=10000.0,
    max_seq_len=32768,
    attn_chunk=512,
)
