"""ModelConfig: the config schema the port's models compile from.

A copy of the reference schema (src/repro/configs/base.py) with torch dtypes
in place of jnp ones. Field names, defaults and `reduced()` are the
reference's, so a config built here describes the same model there. The
fields marked port-only (NoPE, the attention scale, the multipliers, the
shared MLP's width, the experts held) have no counterpart there; at their
defaults the model is the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class RoutingSpec:
    """Routing gate settings for MoE layers.

    The router-facing fields convert 1:1 into `core.types.RouterConfig`
    through `to_router_config()`, which is also where they are validated;
    capacity_factor, moe_impl and ffn_kernel are model-level knobs of this
    spec only. `use_kernel` drives both the expert FFN's kernels (K1/K2)
    and bip's dual-update kernel (K3), as in the reference; `ffn_kernel`
    (None: follow use_kernel) sets the expert FFN's apart, so a bip run on
    the plain bisection dual can still go through K1/K2.
    """

    n_experts: int = 0
    top_k: int = 0
    strategy: str = "bip"
    bip_iters: int = 4
    aux_loss_alpha: float = 0.1
    lossfree_lr: float = 0.001
    norm_topk_prob: bool = False
    score_fn: str = "softmax"
    capacity_factor: float = 1.25   # static capacity C = ceil(k·n/m · cf)
    sync: str = "local"
    use_kernel: bool = False
    n_bisect: int = 26
    bisect_fanout: int = 32
    forecast: bool = False
    forecast_decay: float = 0.9
    forecast_margin: float = 4.0
    forecast_floor: float = 1e-3
    guard_duals: bool = False
    dual_abs_limit: float = 100.0
    phi_lr: float = 0.01
    lpr_decay: float = 0.99
    lpr_blend: float = 0.5
    moe_impl: str = "auto"
    ffn_kernel: Optional[bool] = None

    def __post_init__(self):
        if self.n_experts > 0:
            self.to_router_config()

    def to_router_config(self, data_axes: Sequence[str] = (), **overrides):
        """Convert to the router's RouterConfig (the single mapping point)."""
        from repro_torch.core.types import RouterConfig

        shared = {f.name for f in dataclasses.fields(RouterConfig)} & {
            f.name for f in dataclasses.fields(self)
        }
        kw = {name: getattr(self, name) for name in shared}
        kw["data_axes"] = tuple(data_axes)
        kw.update(overrides)
        return RouterConfig(**kw)


@dataclasses.dataclass(frozen=True)
class SSMSpec:
    """Mamba2 / SSD block settings (models/mamba2.py)."""

    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk_size: int = 128


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # identity
    name: str = "model"
    family: str = "dense"  # dense | moe | ssm | hybrid | encdec | vlm
    source: str = ""

    # trunk
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 0          # 0 -> d_model // n_heads
    d_ff: int = 1024
    vocab_size: int = 1024
    tie_embeddings: bool = True
    rms_norm_eps: float = 1e-6
    act: str = "silu"          # 'silu' (swiglu) | 'gelu' (geglu)

    # attention pattern, cycled across layers
    attn_pattern: Tuple[str, ...] = ("global",)
    window_size: int = 0
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    rope_theta: float = 10000.0
    rope_local_theta: float = 0.0
    qk_norm: bool = False
    post_block_norms: bool = False
    # port-only fields (the reference's schema has none of them); each
    # default leaves the model, and the operations it issues, as they were
    nope: bool = False              # attention without RoPE (NoPE)
    attn_scale: float = 0.0         # softmax scale of the scores; 0 -> 1/sqrt(head_dim)
    embedding_multiplier: float = 1.0   # the embedded tokens times this
    residual_multiplier: float = 1.0    # each block's output times this before its residual add
    logits_scaling: float = 1.0     # the logits divided by this

    # MoE
    routing: RoutingSpec = RoutingSpec()
    moe_d_ff: int = 0
    moe_pattern: Tuple[bool, ...] = (True,)
    dense_residual: bool = False
    n_shared_experts: int = 0
    shared_d_ff: int = 0            # port-only: the shared MLP's width; 0 -> moe_d_ff * n_shared_experts
    experts_held: int = 0           # port-only: experts 0 .. experts_held - 1 live here; 0 -> all

    # SSM / hybrid
    ssm: SSMSpec = SSMSpec()
    shared_attn_every: int = 0

    # encoder (encdec family)
    n_enc_layers: int = 0
    enc_seq_len: int = 0

    # modality frontend stub (vlm / audio)
    frontend_tokens: int = 0
    frontend_dim: int = 0

    # sequence / serving
    max_seq_len: int = 8192
    attn_chunk: int = 512

    # training memory policy
    remat: str = "none"

    # dtype policy
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16
    adam_mu_dtype: str = "fp32"
    adam_nu_dtype: str = "fp32"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.routing.n_experts > 0

    @property
    def n_experts_held(self) -> int:
        """The experts whose weights this device holds (and computes): the
        first `experts_held` of the router's n_experts, or all of them."""
        return self.experts_held or self.routing.n_experts

    def layer_kinds(self) -> Tuple[Tuple[str, str], ...]:
        """Per-layer (mixer_kind, ffn_kind) sequence (see the reference).
        Outside the ssm and hybrid families a 'mamba' entry of attn_pattern
        makes a mamba mixer that carries the layer's FFN (a port-only kind:
        granite-4.0-h's ('mamba', 'moe'))."""
        kinds = []
        for i in range(self.n_layers):
            if self.family in ("ssm", "hybrid"):
                mixer = "mamba"
                if self.shared_attn_every and (i + 1) % self.shared_attn_every == 0:
                    mixer = "mamba+shared"
                kinds.append((mixer, "none"))
            else:
                mixer = self.attn_pattern[i % len(self.attn_pattern)]
                is_moe = self.is_moe and self.moe_pattern[i % len(self.moe_pattern)]
                kinds.append((mixer, "moe" if is_moe else "dense"))
        return tuple(kinds)

    def scan_period(self) -> int:
        """Layers per group: the smallest cycle of the layer-kind pattern."""
        kinds = self.layer_kinds()
        for p in range(1, len(kinds) + 1):
            if all(kinds[i] == kinds[i % p] for i in range(len(kinds))):
                return p
        return len(kinds)

    def validate(self) -> None:
        if self.n_heads % max(self.n_kv_heads, 1) != 0:
            raise ValueError("n_heads must be a multiple of n_kv_heads")
        if self.is_moe and self.routing.top_k > self.routing.n_experts:
            raise ValueError("top_k must not exceed n_experts")
        if "local" in self.attn_pattern and self.window_size <= 0:
            raise ValueError("local attention needs window_size")
        if self.remat not in ("none", "block"):  # any other value would train without remat
            raise ValueError(f"remat must be 'none' or 'block', got {self.remat!r}")
        if not 0 <= self.experts_held <= self.routing.n_experts:
            raise ValueError(f"experts_held {self.experts_held} is not in 0..{self.routing.n_experts}")


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Smoke-test variant: same family/pattern, tiny dims (<=512 d_model,
    2 scan periods of layers, <=4 experts) — the reference's rule."""
    period = cfg.scan_period()
    small: dict = dict(
        n_layers=max(2, min(2 * period, cfg.n_layers)),
        d_model=min(cfg.d_model, 128),
        n_heads=min(cfg.n_heads, 4),
        n_kv_heads=min(cfg.n_kv_heads, 2),
        head_dim=32,
        d_ff=min(cfg.d_ff, 256),
        vocab_size=min(cfg.vocab_size, 512),
        max_seq_len=256,
        attn_chunk=64,
        window_size=min(cfg.window_size, 64) if cfg.window_size else 0,
        n_enc_layers=min(cfg.n_enc_layers, 2),
        enc_seq_len=min(cfg.enc_seq_len, 64),
        frontend_tokens=min(cfg.frontend_tokens, 16),
        frontend_dim=min(cfg.frontend_dim, 64) if cfg.frontend_dim else 0,
        moe_d_ff=min(cfg.moe_d_ff, 128) if cfg.moe_d_ff else 0,
        param_dtype=torch.float32,
        compute_dtype=torch.float32,
    )
    if cfg.is_moe:
        small["routing"] = dataclasses.replace(
            cfg.routing,
            n_experts=min(cfg.routing.n_experts, 4),
            top_k=min(cfg.routing.top_k, 2),
        )
    if cfg.family in ("ssm", "hybrid"):
        small["ssm"] = dataclasses.replace(
            cfg.ssm, d_state=min(cfg.ssm.d_state, 16), head_dim=32, chunk_size=32
        )
        if cfg.shared_attn_every:
            small["shared_attn_every"] = 2
            small["n_layers"] = 4
    if cfg.n_kv_heads == cfg.n_heads:  # keep MHA configs MHA
        small["n_kv_heads"] = small["n_heads"]
    small.update(overrides)
    out = dataclasses.replace(cfg, **small)
    out.validate()
    return out
