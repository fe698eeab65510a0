"""Decoder stack assembly (port of src/repro/models/stack.py).

The reference stacks each layer-kind position of the period along a leading
group axis for lax.scan; the port keeps one parameter dict per layer, in
layer order (`params['layers'][i]`), and loops over them. Layer i is
position i % period of group i // period in the reference's layout
(`convert.py` maps one onto the other).

Block structure (pre-norm residual):
    x += [post_norm](attn(pre_norm(x)))
    x += [post_norm](ffn(ffn_norm(x)))     ffn in {dense, moe (+ shared mlp)}

`apply_layer` / `apply_stack` run the training forward over whole
sequences; MoE layers thread their router state and return their metrics,
which `apply_stack` stacks into '<key>_per_layer' columns in layer order.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.types import init_router_state
from repro_torch.models import common, moe

Params = Dict[str, Any]


def _group_layout(cfg: ModelConfig) -> Tuple[int, int, int]:
    period = cfg.scan_period()
    return period, cfg.n_layers // period, cfg.n_layers % period


def check_supported(cfg: ModelConfig) -> None:
    """Raise for the layer kinds and families the port does not run yet."""
    for mixer, _ in cfg.layer_kinds():
        if mixer not in ("global", "local"):
            raise NotImplementedError(f"{mixer!r} layers are not ported yet")
    if cfg.n_enc_layers:
        raise NotImplementedError("cross-attention (encdec) is not ported yet")
    if cfg.frontend_dim:
        raise NotImplementedError("modality frontends (vlm) are not ported yet")
    if cfg.dense_residual:
        raise NotImplementedError("dense_residual MoE layers are not ported yet")
    if not cfg.tie_embeddings:
        raise NotImplementedError("untied embeddings are not ported yet")


def init_layer(gen: torch.Generator, cfg: ModelConfig, mixer_kind: str, ffn_kind: str) -> Params:
    """One attention layer's parameters (dense or MoE FFN), the reference's
    shapes and init scales, drawn from `gen` (kinds per check_supported)."""
    dev = gen.device
    p: Params = {
        "pre_norm": common.init_rmsnorm(cfg.d_model, cfg.param_dtype, dev),
        "attn": common.init_attention(gen, cfg),
    }
    if cfg.post_block_norms:
        p["post_attn_norm"] = common.init_rmsnorm(cfg.d_model, cfg.param_dtype, dev)
    p["ffn_norm"] = common.init_rmsnorm(cfg.d_model, cfg.param_dtype, dev)
    if ffn_kind == "dense":
        p["mlp"] = common.init_mlp(gen, cfg)
        if cfg.post_block_norms:
            p["post_ffn_norm"] = common.init_rmsnorm(cfg.d_model, cfg.param_dtype, dev)
    elif ffn_kind == "moe":
        p["moe"] = moe.init_moe(gen, cfg)
        if cfg.n_shared_experts:
            p["shared_mlp"] = common.init_mlp(
                gen, cfg, d_ff=(cfg.moe_d_ff or cfg.d_ff) * cfg.n_shared_experts
            )
    else:
        raise NotImplementedError(f"ffn kind {ffn_kind!r} is not ported yet")
    return p


def init_stack(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Per-layer parameters in layer order: {'layers': [layer_params, ...]}."""
    return {"layers": [init_layer(gen, cfg, mk, fk) for mk, fk in cfg.layer_kinds()]}


def init_stack_router_states(cfg: ModelConfig, device="cpu") -> List[Optional[Dict]]:
    """Router state per layer in layer order (None for non-MoE layers)."""
    rcfg = moe.router_config(cfg) if cfg.is_moe else None
    return [
        init_router_state(rcfg, device) if ffn_kind == "moe" else None
        for _, ffn_kind in cfg.layer_kinds()
    ]


def _maybe_post(p: Params, name: str, y, cfg: ModelConfig):
    if cfg.post_block_norms and name in p:
        return common.rmsnorm(p[name], y, cfg.rms_norm_eps)
    return y


def apply_layer(
    p: Params,
    x: torch.Tensor,  # (B, S, d)
    cfg: ModelConfig,
    mixer_kind: str,
    ffn_kind: str,
    router_state: Optional[Dict[str, torch.Tensor]],
    *,
    positions: Optional[torch.Tensor] = None,
    segments: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]], torch.Tensor, Dict]:
    """One layer over whole sequences. Returns (x, new_router_state,
    aux_loss, metrics); MoE layers report 'max_vio', 'load' and the router's
    'dropped_frac_cap1' and 'q_abs_max' (and, with the bip forecaster,
    'forecast_err' / 'forecast_hit'), as the reference's local path."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    mets: Dict[str, torch.Tensor] = {}
    b, s, d = x.shape
    h = common.attention(
        p["attn"], common.rmsnorm(p["pre_norm"], x, cfg.rms_norm_eps), cfg,
        layer_kind=mixer_kind, positions=positions, segments=segments,
    )
    x = x + _maybe_post(p, "post_attn_norm", h, cfg)
    if ffn_kind == "dense":
        h = common.mlp(p["mlp"], common.rmsnorm(p["ffn_norm"], x, cfg.rms_norm_eps), cfg)
        x = x + _maybe_post(p, "post_ffn_norm", h, cfg)
    elif ffn_kind == "moe":
        xin = common.rmsnorm(p["ffn_norm"], x, cfg.rms_norm_eps)
        y, router_state, aux_moe, moe_mets = moe.moe_ffn_local(
            p["moe"], xin.reshape(b * s, d), router_state, cfg
        )
        h = y.reshape(b, s, d)
        if cfg.n_shared_experts and "shared_mlp" in p:
            h = h + common.mlp(p["shared_mlp"], xin, cfg)
        x = x + h
        aux = aux + aux_moe
        mets = {"max_vio": moe_mets["max_vio"], "load": moe_mets["load"]}
        for k in ("dropped_frac_cap1", "q_abs_max", "forecast_err", "forecast_hit"):
            if k in moe_mets:
                mets[k] = moe_mets[k]
    return x, router_state, aux, mets


def apply_stack(
    params: Params,
    x: torch.Tensor,
    router_states: List[Optional[Dict]],
    cfg: ModelConfig,
    *,
    positions: Optional[torch.Tensor] = None,
    segments: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, List[Optional[Dict]], torch.Tensor, Dict[str, torch.Tensor]]:
    """Run every layer in order. Returns (x, new_router_states, aux_total,
    metrics) with metrics['<key>_per_layer'] stacked over the MoE layers in
    layer order (e.g. 'max_vio_per_layer' (n_moe,), 'load_per_layer'
    (n_moe, m) int64)."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    new_states: List[Optional[Dict]] = []
    per_layer: Dict[str, list] = {}
    for (mixer, ffn), p, st in zip(cfg.layer_kinds(), params["layers"], router_states):
        x, st, aux, mets = apply_layer(
            p, x, cfg, mixer, ffn, st, positions=positions, segments=segments
        )
        new_states.append(st)
        aux_total = aux_total + aux
        for k, v in mets.items():
            per_layer.setdefault(k, []).append(v)
    metrics = {f"{k}_per_layer": torch.stack(v) for k, v in per_layer.items()}
    if "max_vio_per_layer" not in metrics:
        metrics["max_vio_per_layer"] = torch.zeros((0,), dtype=torch.float32, device=x.device)
    return x, new_states, aux_total, metrics
