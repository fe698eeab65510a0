"""Decoder stack assembly (port of src/repro/models/stack.py).

The reference stacks each layer-kind position of the period along a leading
group axis for lax.scan; the port keeps one parameter dict per layer, in
layer order (`params['layers'][i]`), and loops over them. Layer i is
position i % period of group i // period in the reference's layout
(`convert.py` maps one onto the other).

Block structure (pre-norm residual):
    attention layers:  x += [post_norm](attn(pre_norm(x)))
                       x += cross(cross_norm(x), enc_out)        (encdec decoder)
                       x += [post_norm](ffn(ffn_norm(x)))
                       ffn in {dense, moe (+ dense residual mlp) (+ shared mlp)}
    mamba layers:      x += mamba(pre_norm(x))
                       x += ffn(ffn_norm(x))    (where the layer kind has one:
                                                 granite-4.0-h's ('mamba', 'moe'))
    'mamba+shared' then applies the weight-SHARED (attn + mlp) block
    (zamba2), whose one set of weights is params['shared'].
Each block's output is scaled by cfg.residual_multiplier before its add
(granite's 0.22; at 1 no product is issued).

`apply_layer` / `apply_stack` run the training forward over whole
sequences; MoE layers thread their router state and return their metrics,
which `apply_stack` stacks into '<key>_per_layer' columns in layer order.
A layer's mixer and FFN run as the layer spans 'model/attention' (or
'model/mamba') and 'model/ffn' (telemetry/trace.py), each ending with its
residual add.

`cfg.remat == "block"` recomputes activations in the backward pass, as the
reference's `jax.checkpoint` of each scanned period: every whole period of
layers runs under `torch.utils.checkpoint` (non-reentrant), the tail
remainder layers outside it. A period's router states and metrics leave
it as return values (nothing in the block writes in place), so the
recomputation changes neither; it does launch the period's kernels once
more (K1, K2's forward use and K3 per MoE layer).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.types import init_router_state
from repro_torch.distributed.collectives import MeshCtx
from repro_torch.models import common, mamba2, moe
from repro_torch.telemetry.trace import layer_span

Params = Dict[str, Any]


def _group_layout(cfg: ModelConfig) -> Tuple[int, int, int]:
    period = cfg.scan_period()
    return period, cfg.n_layers // period, cfg.n_layers % period


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a layer kind the port does not know (every kind the
    reference's configs produce is ported)."""
    for mixer, ffn in cfg.layer_kinds():
        if mixer not in ("global", "local", "mamba", "mamba+shared"):
            raise NotImplementedError(f"mixer kind {mixer!r} is unknown")
        if ffn not in ("dense", "moe", "none"):
            raise NotImplementedError(f"ffn kind {ffn!r} is unknown")


def init_layer(gen: torch.Generator, cfg: ModelConfig, mixer_kind: str, ffn_kind: str) -> Params:
    """One layer's parameters, the reference's shapes and init scales,
    drawn from `gen`."""
    dev, pd = gen.device, cfg.param_dtype
    p: Params = {"pre_norm": common.init_rmsnorm(cfg.d_model, pd, dev)}
    if mixer_kind in ("global", "local"):
        p["attn"] = common.init_attention(gen, cfg)
        if cfg.post_block_norms:
            p["post_attn_norm"] = common.init_rmsnorm(cfg.d_model, pd, dev)
        if cfg.n_enc_layers:  # decoder of an encdec model: cross attention
            p["cross_norm"] = common.init_rmsnorm(cfg.d_model, pd, dev)
            p["cross"] = common.init_attention(gen, cfg)
    else:  # mamba, mamba+shared
        p["mamba"] = mamba2.init_mamba(gen, cfg)
    if ffn_kind == "dense":
        p["ffn_norm"] = common.init_rmsnorm(cfg.d_model, pd, dev)
        p["mlp"] = common.init_mlp(gen, cfg)
        if cfg.post_block_norms:
            p["post_ffn_norm"] = common.init_rmsnorm(cfg.d_model, pd, dev)
    elif ffn_kind == "moe":
        p["ffn_norm"] = common.init_rmsnorm(cfg.d_model, pd, dev)
        p["moe"] = moe.init_moe(gen, cfg)
        if cfg.dense_residual:
            p["mlp"] = common.init_mlp(gen, cfg)
        if cfg.n_shared_experts:
            p["shared_mlp"] = common.init_mlp(gen, cfg, d_ff=shared_width(cfg))
    return p


def shared_width(cfg: ModelConfig) -> int:
    """The shared MLP's width: cfg.shared_d_ff where set, else one expert's
    width per shared expert."""
    return cfg.shared_d_ff or (cfg.moe_d_ff or cfg.d_ff) * cfg.n_shared_experts


def init_shared_block(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """zamba2: one (attn + mlp) block whose weights are shared across uses."""
    dev = gen.device
    return {
        "pre_norm": common.init_rmsnorm(cfg.d_model, cfg.param_dtype, dev),
        "attn": common.init_attention(gen, cfg),
        "ffn_norm": common.init_rmsnorm(cfg.d_model, cfg.param_dtype, dev),
        "mlp": common.init_mlp(gen, cfg),
    }


def init_stack(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Per-layer parameters in layer order: {'layers': [layer_params, ...]}
    (+ 'shared', the zamba2 block, when a layer kind uses it)."""
    kinds = cfg.layer_kinds()
    p: Params = {"layers": [init_layer(gen, cfg, mk, fk) for mk, fk in kinds]}
    if any(mk.endswith("+shared") for mk, _ in kinds):
        p["shared"] = init_shared_block(gen, cfg)
    return p


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


def cross_attention(p: Params, x: torch.Tensor, enc_out: torch.Tensor, cfg: ModelConfig):
    """Decoder queries against the encoder output (no mask, no RoPE), one
    (chunk, S_enc) score block per query chunk of cfg.attn_chunk."""
    cd = cfg.compute_dtype
    s = x.shape[1]
    wq, wk, wv, wo = common.cast_weights(cd, p["wq"], p["wk"], p["wv"], p["wo"])
    q = torch.einsum("bsd,dhk->bshk", x, wq)
    k = torch.einsum("bsd,dhk->bshk", enc_out, wk)
    v = torch.einsum("bsd,dhk->bshk", enc_out, wv)
    chunk = min(cfg.attn_chunk, s)
    mask = torch.ones((1, 1, 1, enc_out.shape[1]), dtype=torch.bool, device=x.device)
    ys = [common._attend(q[:, c0:c0 + chunk], k, v, mask, 0.0, cd) for c0 in range(0, s, chunk)]
    return torch.einsum("bshk,hkd->bsd", torch.cat(ys, dim=1), wo)


# The layer regions (telemetry.trace.layer_span): each takes the residual
# stream and the leaves it reads, and ends with its residual add, so the
# regions cover the layer's forward and backward whole.
_ATTN_KEYS = ("pre_norm", "attn", "post_attn_norm")
_MAMBA_KEYS = ("pre_norm", "mamba")
_DENSE_KEYS = ("ffn_norm", "mlp", "post_ffn_norm")
_MOE_KEYS = ("ffn_norm", "moe", "mlp", "shared_mlp")


def leaves_of(p: Params, keys: Tuple[str, ...]) -> Params:
    """The entries of `p` under `keys` that it has: what a region reads."""
    return {k: p[k] for k in keys if k in p}


def residual_add(x, h, cfg: ModelConfig):
    """x + h scaled by cfg.residual_multiplier (no product where it is 1)."""
    m = cfg.residual_multiplier
    return x + h if m == 1 else x + h * m


def _attention_block(p: Params, x, cfg: ModelConfig, layer_kind: str, positions, segments):
    """x + [post_norm](attention(pre_norm(x)))."""
    h = common.attention(
        p["attn"], common.rmsnorm(p["pre_norm"], x, cfg.rms_norm_eps), cfg,
        layer_kind=layer_kind, positions=positions, segments=segments,
    )
    return residual_add(x, _maybe_post(p, "post_attn_norm", h, cfg), cfg)


def _mamba_block(p: Params, x, cfg: ModelConfig):
    h = mamba2.mamba_block(p["mamba"], common.rmsnorm(p["pre_norm"], x, cfg.rms_norm_eps), cfg)
    return residual_add(x, h, cfg)


def _dense_block(p: Params, x, cfg: ModelConfig):
    """x + [post_norm](mlp(ffn_norm(x)))."""
    h = common.mlp(p["mlp"], common.rmsnorm(p["ffn_norm"], x, cfg.rms_norm_eps), cfg)
    return residual_add(x, _maybe_post(p, "post_ffn_norm", h, cfg), cfg)


def _moe_block(p: Params, x, router_state, cfg: ModelConfig, mesh_ctx):
    """x + the routed experts and the residual MLPs over ffn_norm(x):
    (x, new router state, aux loss, metrics)."""
    b, s, d = x.shape
    xin = common.rmsnorm(p["ffn_norm"], x, cfg.rms_norm_eps)
    y, router_state, aux_moe, moe_mets = moe.moe_ffn(
        p["moe"], xin.reshape(b * s, d), router_state, cfg, mesh_ctx,
    )
    h = y.reshape(b, s, d) + _residual_mlps(p, xin, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device) + aux_moe
    mets = {"max_vio": moe_mets["max_vio"], "load": moe_mets["load"]}
    for k in ("dropped_frac_cap1", "q_abs_max", "forecast_err", "forecast_hit"):
        if k in moe_mets:
            mets[k] = moe_mets[k]
    return residual_add(x, h, cfg), router_state, aux, mets


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
    enc_out: Optional[torch.Tensor] = None,
    shared_params: Optional[Params] = None,
    mesh_ctx: Optional[MeshCtx] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]], torch.Tensor, Dict]:
    """One layer over whole sequences. Returns (x, new_router_state,
    aux_loss, metrics); MoE layers report 'max_vio', 'load' and the router's
    'dropped_frac_cap1' and 'q_abs_max' (and, with the bip forecaster,
    'forecast_err' / 'forecast_hit'), as the reference's local path; on a
    mesh (`mesh_ctx`, the MoE FFN through moe.moe_ffn's expert-parallel
    paths) the first three. The mixer and the FFN (and zamba2's shared
    block) run as the layer spans 'model/attention' or 'model/mamba' and
    'model/ffn'; cross attention runs outside them."""
    aux: Optional[torch.Tensor] = None
    mets: Dict[str, torch.Tensor] = {}
    if mixer_kind in ("global", "local"):
        x = layer_span("model/attention", _attention_block, leaves_of(p, _ATTN_KEYS), x, cfg,
                       mixer_kind, positions, segments)
        if enc_out is not None and "cross" in p:
            x = x + cross_attention(
                p["cross"], common.rmsnorm(p["cross_norm"], x, cfg.rms_norm_eps), enc_out, cfg
            )
    else:  # mamba, mamba+shared
        x = layer_span("model/mamba", _mamba_block, leaves_of(p, _MAMBA_KEYS), x, cfg)

    if ffn_kind == "dense":
        x = layer_span("model/ffn", _dense_block, leaves_of(p, _DENSE_KEYS), x, cfg)
    elif ffn_kind == "moe":
        x, router_state, aux, mets = layer_span(
            "model/ffn", _moe_block, leaves_of(p, _MOE_KEYS), x, router_state, cfg, mesh_ctx)

    if mixer_kind.endswith("+shared") and shared_params is not None:
        sp = shared_params
        x = layer_span("model/attention", _attention_block, leaves_of(sp, _ATTN_KEYS), x, cfg,
                       "global", positions, segments)
        x = layer_span("model/ffn", _dense_block, leaves_of(sp, _DENSE_KEYS), x, cfg)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, router_state, aux, mets


def _residual_mlps(p: Params, xin: torch.Tensor, cfg: ModelConfig):
    """What runs beside the routed experts of a MoE layer: arctic's dense
    residual FFN and the shared experts (0 when the layer has neither)."""
    h = 0
    if cfg.dense_residual and "mlp" in p:
        h = h + common.mlp(p["mlp"], xin, cfg)
    if cfg.n_shared_experts and "shared_mlp" in p:
        h = h + common.mlp(p["shared_mlp"], xin, cfg)
    return h


def apply_stack(
    params: Params,
    x: torch.Tensor,
    router_states: List[Optional[Dict]],
    cfg: ModelConfig,
    *,
    positions: Optional[torch.Tensor] = None,
    segments: Optional[torch.Tensor] = None,
    enc_out: Optional[torch.Tensor] = None,
    mesh_ctx: Optional[MeshCtx] = None,
) -> Tuple[torch.Tensor, List[Optional[Dict]], torch.Tensor, Dict[str, torch.Tensor]]:
    """Run every layer in order. Returns (x, new_router_states, aux_total,
    metrics) with metrics['<key>_per_layer'] stacked over the MoE layers in
    layer order (e.g. 'max_vio_per_layer' (n_moe,), 'load_per_layer'
    (n_moe, m) int64). Under cfg.remat == "block" each whole period of
    layers is one checkpointed block (see the module doc)."""
    kinds = cfg.layer_kinds()
    shared = params.get("shared")

    def run(lo: int, hi: int, x: torch.Tensor, states: List[Optional[Dict]]):
        """Layers lo..hi-1 in order: (x, their new states, auxes, metrics)."""
        out_states, auxes, mets_list = [], [], []
        for (mixer, ffn), p, st in zip(kinds[lo:hi], params["layers"][lo:hi], states):
            x, st, aux, mets = apply_layer(
                p, x, cfg, mixer, ffn, st, positions=positions, segments=segments,
                enc_out=enc_out, shared_params=shared, mesh_ctx=mesh_ctx,
            )
            out_states.append(st)
            auxes.append(aux)
            mets_list.append(mets)
        return x, out_states, auxes, mets_list

    remat = cfg.remat == "block"
    period, n_groups, _ = _group_layout(cfg)
    # whole periods first (one checkpointed block each under remat), then
    # the tail remainder layers one by one, as the reference's scan + tail
    spans = [(g * period, (g + 1) * period) for g in range(n_groups)]
    spans += [(i, i + 1) for i in range(n_groups * period, len(kinds))]
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    new_states: List[Optional[Dict]] = []
    per_layer: Dict[str, list] = {}
    for g, (lo, hi) in enumerate(spans):
        states = list(router_states[lo:hi])
        if remat and g < n_groups:
            x, states, auxes, mets_list = checkpoint(run, lo, hi, x, states, use_reentrant=False)
        else:
            x, states, auxes, mets_list = run(lo, hi, x, states)
        new_states.extend(states)
        for aux, mets in zip(auxes, mets_list):
            aux_total = aux_total + aux
            for k, v in mets.items():
                per_layer.setdefault(k, []).append(v)
    metrics = {f"{k}_per_layer": torch.stack(v) for k, v in per_layer.items()}
    if "max_vio_per_layer" not in metrics:
        metrics["max_vio_per_layer"] = torch.zeros((0,), dtype=torch.float32, device=x.device)
    return x, new_states, aux_total, metrics
