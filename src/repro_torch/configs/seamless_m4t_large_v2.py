"""seamless-m4t-large-v2 [audio] — encoder-decoder, multimodal translation
[arXiv:2308.11596]. Decoder 24L, d_model=1024, 16 heads (kv=16, head_dim=64),
d_ff=8192, vocab=256206; 24-layer encoder.

The same dims as the reference config
(src/repro/configs/seamless_m4t_large_v2.py). The conformer speech
frontend is a stub: the batch carries 4096 frame embeddings of dim 1024;
the encoder transformer, cross-attention and decoder are real. Dense FFN.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    source="[arXiv:2308.11596]",
    n_layers=24,
    n_enc_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256206,
    enc_seq_len=4096,
    frontend_dim=1024,
    rope_theta=10000.0,
    max_seq_len=32768,
    attn_chunk=512,
)
