"""mamba2-130m [ssm] — SSD / state-space duality [arXiv:2405.21060].
24L, d_model=768 (attention-free), d_inner=1536 (expand=2, head_dim=64,
24 ssm heads), ssm_state=128, vocab=50280.

The same dims as the reference config (src/repro/configs/mamba2_130m.py).
Attention-free, no router.
"""
from repro_torch.configs.base import ModelConfig, SSMSpec

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    source="[arXiv:2405.21060]",
    n_layers=24,
    d_model=768,
    n_heads=12,       # unused (attention-free); kept for config completeness
    n_kv_heads=12,
    d_ff=0,
    vocab_size=50280,
    ssm=SSMSpec(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1, chunk_size=128),
    max_seq_len=524288,
)
