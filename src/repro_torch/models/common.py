"""Shared model primitives (port of src/repro/models/common.py): RMSNorm,
RoPE, GQA attention against a slot cache, gated MLPs, embeddings.

Functions take the reference's parameter layouts (wq (d,h,hd), wo (h,hd,d),
w_gate (d,f), ...) as plain dicts of tensors. Attention is plain torch, as
the reference's is plain jnp: fully masked rows are zeroed after the
softmax, which scaled_dot_product_attention would turn into NaN.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

Tensor = torch.Tensor
Params = Dict[str, Tensor]

NEG_INF = -2.0e38  # large-negative fill that survives bf16 casts


def _randn(gen: torch.Generator, shape, scale: float, dtype) -> Tensor:
    """Seeded normal init on the generator's device, scaled, in `dtype`."""
    return (torch.randn(shape, generator=gen, device=gen.device) * scale).to(dtype)


# ------------------------------------------------------------------ norms


def init_rmsnorm(d: int, dtype, device) -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(params: Params, x: Tensor, eps: float = 1e-6) -> Tensor:
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * params["scale"].float()
    return out.to(dt)


# ------------------------------------------------------------------- rope


def rope_freqs(head_dim: int, theta: float, device=None) -> Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """x: (..., S, H, D); positions broadcastable to (..., S). Rotates the
    split halves (x1, x2) = x[..., :D/2], x[..., D/2:], as the reference."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)
    ang = positions[..., None].float() * freqs  # (..., S, D/2)
    sin, cos = torch.sin(ang)[..., None, :], torch.cos(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -------------------------------------------------------------- attention


def init_attention(gen: torch.Generator, cfg: ModelConfig) -> Params:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    scale = 1.0 / math.sqrt(d)
    p = {
        "wq": _randn(gen, (d, h, hd), scale, cfg.param_dtype),
        "wk": _randn(gen, (d, kv, hd), scale, cfg.param_dtype),
        "wv": _randn(gen, (d, kv, hd), scale, cfg.param_dtype),
        "wo": _randn(gen, (h, hd, d), scale / math.sqrt(2 * cfg.n_layers), cfg.param_dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = init_rmsnorm(hd, cfg.param_dtype, gen.device)
        p["k_norm"] = init_rmsnorm(hd, cfg.param_dtype, gen.device)
    return p


def _attn_weights(q: Tensor, k: Tensor, mask: Tensor, softcap: float) -> Tensor:
    """q (B,Sq,H,D), k (B,Sk,KV,D), mask (B,1|H,Sq,Sk) -> (B,H,Sq,Sk) fp32."""
    groups = q.shape[2] // k.shape[2]
    kq = torch.repeat_interleave(k, groups, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, kq).float()
    logits = logits / math.sqrt(q.shape[-1])
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    logits = torch.where(mask, logits, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    # fully-masked rows (padded chunk columns): zero them out
    return torch.where(mask.any(dim=-1, keepdim=True), w, 0.0)


def _attend(q, k, v, mask, softcap: float, compute_dtype) -> Tensor:
    w = _attn_weights(q, k, mask, softcap)
    groups = q.shape[2] // v.shape[2]
    vq = torch.repeat_interleave(v, groups, dim=2)
    return torch.einsum("bhqk,bkhd->bqhd", w.to(compute_dtype), vq)


def attention_chunk(
    params: Params,
    x: Tensor,  # (B, C, d)
    cache: Dict[str, Tensor],
    cfg: ModelConfig,
    *,
    layer_kind: str = "global",
    lengths: Optional[Tensor] = None,  # (B,) tokens valid per row (0..C)
) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Cached attention advancing each row by `lengths[i]` tokens at once.

    Row i's first lengths[i] columns are real tokens starting at absolute
    position cache['pos'][i]; the rest is padding. The valid columns' K/V
    are written INTO the cache tensors in place (padded columns, and any
    position past the cache, are not written — the reference drops them
    with an out-of-bounds scatter). Global layers attend against the
    updated cache; ring (sliding-window) layers attend against the
    pre-update ring concatenated with the in-chunk keys. Padded output
    columns are garbage and must be masked by the caller. Returns
    (out, {'k', 'v' (the same tensors), 'pos' advanced by lengths}).
    """
    b, c, _ = x.shape
    dev = x.device
    cd = cfg.compute_dtype
    theta = cfg.rope_theta
    window = 0
    if layer_kind == "local":
        window = cfg.window_size
        if cfg.rope_local_theta:
            theta = cfg.rope_local_theta
    if lengths is None:
        lengths = torch.full((b,), c, dtype=torch.int64, device=dev)

    pos0 = cache["pos"]  # (B,)
    cols = torch.arange(c, device=dev)
    q_pos = pos0[:, None] + cols[None, :]  # (B, C)
    valid = cols[None, :] < lengths[:, None]  # (B, C)

    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(cd))
    k_new = torch.einsum("bsd,dhk->bshk", x, params["wk"].to(cd))
    v_new = torch.einsum("bsd,dhk->bshk", x, params["wv"].to(cd))
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q, cfg.rms_norm_eps)
        k_new = rmsnorm(params["k_norm"], k_new, cfg.rms_norm_eps)
    q = apply_rope(q, q_pos, theta)
    k_new = apply_rope(k_new, q_pos, theta)

    k_cache, v_cache = cache["k"], cache["v"]
    cap = k_cache.shape[1]
    idx = torch.arange(cap, device=dev)[None, :]  # (1, cap)
    if window > 0:
        if c > cap:
            raise ValueError(f"chunk {c} must fit the ring buffer (window {cap})")
        # ring layers attend against the PRE-update ring plus the in-chunk
        # keys (a bulk write would clobber keys still inside earlier
        # in-chunk queries' windows): build the operands before writing
        prev = pos0 - 1
        k_pos = prev[:, None] - torch.remainder(prev[:, None] - idx, cap)  # (B, cap)
        ring_ok = (
            (k_pos >= 0)[:, None, :]
            & (k_pos[:, None, :] <= q_pos[..., None])
            & (k_pos[:, None, :] > q_pos[..., None] - window)
        )
        chunk_ok = (
            (q_pos[:, None, :] <= q_pos[..., None])
            & (q_pos[:, None, :] > q_pos[..., None] - window)
            & valid[:, None, :]
        )
        mask = torch.cat([ring_ok, chunk_ok], dim=-1) & valid[..., None]
        k_att = torch.cat([k_cache.to(cd), k_new], dim=1)
        v_att = torch.cat([v_cache.to(cd), v_new], dim=1)
        write_idx = torch.remainder(q_pos, cap)
    else:
        write_idx = q_pos

    write = valid & (write_idx < cap)
    rows, wcols = torch.nonzero(write, as_tuple=True)
    k_cache[rows, write_idx[rows, wcols]] = k_new[rows, wcols].to(k_cache.dtype)
    v_cache[rows, write_idx[rows, wcols]] = v_new[rows, wcols].to(v_cache.dtype)

    if window == 0:
        mask = (idx[:, None, :] <= q_pos[..., None]) & valid[..., None]  # (B, C, cap)
        k_att, v_att = k_cache.to(cd), v_cache.to(cd)
    mask = mask[:, None]  # (B, 1, C, cap[+C])

    y = _attend(q, k_att, v_att, mask, cfg.attn_logit_softcap, cd)
    out = torch.einsum("bshk,hkd->bsd", y, params["wo"].to(cd))
    return out, {"k": k_cache, "v": v_cache, "pos": pos0 + lengths}


def init_attention_cache(
    cfg: ModelConfig, batch: int, seq_len: int, layer_kind: str, dtype, device
) -> Dict[str, Tensor]:
    cap = min(cfg.window_size, seq_len) if layer_kind == "local" else seq_len
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    return {
        "k": torch.zeros((batch, cap, kv, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, cap, kv, hd), dtype=dtype, device=device),
        "pos": torch.zeros((batch,), dtype=torch.int64, device=device),
    }


# -------------------------------------------------------------------- mlp


def init_mlp(gen: torch.Generator, cfg: ModelConfig, d_ff: Optional[int] = None) -> Params:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    return {
        "w_gate": _randn(gen, (d, f), s_in, cfg.param_dtype),
        "w_up": _randn(gen, (d, f), s_in, cfg.param_dtype),
        "w_down": _randn(gen, (f, d), s_out / math.sqrt(2 * cfg.n_layers), cfg.param_dtype),
    }


def _act(cfg: ModelConfig):
    if cfg.act == "silu":
        return F.silu
    return lambda t: F.gelu(t, approximate="tanh")  # jax.nn.gelu's default


def mlp(params: Params, x: Tensor, cfg: ModelConfig) -> Tensor:
    cd = cfg.compute_dtype
    g = torch.einsum("...d,df->...f", x, params["w_gate"].to(cd))
    u = torch.einsum("...d,df->...f", x, params["w_up"].to(cd))
    return torch.einsum("...f,fd->...d", _act(cfg)(g) * u, params["w_down"].to(cd))


# ------------------------------------------------------------- embeddings


def init_embedding(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Tied token embeddings (the port's models all tie them)."""
    return {
        "tok": _randn(gen, (cfg.vocab_size, cfg.d_model), 1.0 / math.sqrt(cfg.d_model),
                      cfg.param_dtype)
    }


def embed(params: Params, tokens: Tensor, cfg: ModelConfig) -> Tensor:
    return params["tok"].to(cfg.compute_dtype)[tokens]


def unembed(params: Params, x: Tensor, cfg: ModelConfig) -> Tensor:
    logits = torch.einsum("...d,vd->...v", x, params["tok"].to(cfg.compute_dtype)).float()
    if cfg.final_logit_softcap > 0:
        c = cfg.final_logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits
