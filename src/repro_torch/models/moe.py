"""Mixture-of-Experts FFN with BIP-balanced routing, single device (port of
src/repro/models/moe.py: expert_capacity, init_moe, _expert_ffn,
moe_ffn_local; the expert-parallel paths are not ported yet).

Capacity: C = ceil(k·n/m · capacity_factor); tokens beyond capacity are
dropped (contribute zero), standard MoE practice.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import make_dispatch_plan, route
from repro_torch.core.types import RouterConfig
from repro_torch.models.common import _act, _randn

Tensor = torch.Tensor
Params = Dict[str, Tensor]


def router_config(cfg: ModelConfig) -> RouterConfig:
    """RouterConfig for this model — one conversion point (RoutingSpec shim)."""
    return cfg.routing.to_router_config()


def expert_capacity(n_tokens: int, cfg: ModelConfig) -> int:
    r = cfg.routing
    return max(int(math.ceil(r.top_k * n_tokens / r.n_experts * r.capacity_factor)), 1)


def init_moe(gen: torch.Generator, cfg: ModelConfig) -> Params:
    d = cfg.d_model
    f = cfg.moe_d_ff or cfg.d_ff
    m = cfg.routing.n_experts
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    return {
        "w_router": _randn(gen, (d, m), s_in, torch.float32),
        "w_gate": _randn(gen, (m, d, f), s_in, cfg.param_dtype),
        "w_up": _randn(gen, (m, d, f), s_in, cfg.param_dtype),
        "w_down": _randn(gen, (m, f, d), s_out / math.sqrt(2 * cfg.n_layers), cfg.param_dtype),
    }


def _expert_ffn(w_gate, w_up, w_down, xb, cfg: ModelConfig) -> Tensor:
    """Expert FFN over the packed (e, c, d) buffer. With routing.use_kernel
    (and SwiGLU) it runs the CUDA kernel pair; the fp32 expert weights are
    cast to the compute dtype on every call, as the reference does."""
    dt = cfg.compute_dtype
    if cfg.routing.use_kernel and cfg.act == "silu":
        from repro_torch.kernels import ops as kernel_ops

        return kernel_ops.expert_ffn(
            xb.to(dt), w_gate.to(dt), w_up.to(dt), w_down.to(dt)
        )
    g = torch.einsum("ecd,edf->ecf", xb, w_gate.to(dt))
    u = torch.einsum("ecd,edf->ecf", xb, w_up.to(dt))
    return torch.einsum("ecf,efd->ecd", _act(cfg)(g) * u, w_down.to(dt))


def moe_ffn_local(
    params: Params,
    x: Tensor,  # (n, d) flattened tokens
    router_state: Dict[str, Tensor],
    cfg: ModelConfig,
    token_mask: Optional[Tensor] = None,  # (n,) bool
) -> Tuple[Tensor, Dict[str, Tensor], Tensor, Dict[str, Tensor]]:
    """Single-device MoE FFN. Returns (y, new_router_state, aux_loss, metrics).

    With a token mask the balance metrics count the real tokens only: the
    load is the dispatch plan's segment counts (masked rows excluded).
    """
    n, d = x.shape
    m = cfg.routing.n_experts
    cap = expert_capacity(n, cfg)
    rcfg = router_config(cfg)

    logits = torch.einsum("nd,dm->nm", x.float(), params["w_router"])
    out = route(logits, router_state, rcfg, token_mask=token_mask)
    plan = make_dispatch_plan(out.expert_index, m, cap, token_mask)
    buf = plan.pack(x)  # (m, cap, d)
    y = _expert_ffn(params["w_gate"], params["w_up"], params["w_down"], buf, cfg)
    y_tok = plan.combine(y, out.combine_weights)

    mets = out.metrics
    if token_mask is not None:
        load = plan.counts
        mean_load = torch.clamp_min(token_mask.sum() * cfg.routing.top_k / m, 1e-9)
        mets = dict(mets)
        mets.update(load=load, max_vio=load.max() / mean_load - 1.0)
    return y_tok, out.state, out.aux_loss, mets


__all__ = ["expert_capacity", "init_moe", "moe_ffn_local", "router_config"]
