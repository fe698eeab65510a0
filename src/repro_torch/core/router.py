"""Top-k router over the balancer registry, plus the sort-based dispatch plan
(port of src/repro/core/router.py).

`route(logits, state, cfg)` drives the hook protocol in the reference's
order (score -> guard -> score_adjust -> select -> aux_loss -> update_state
-> metrics) and returns a RouterOutput with the new state. The dispatch plan
is the megablocks-style one: one stable argsort of the (n·k,) expert
assignments gives every expert's queue; pack and combine are gathers.
Capacity queues are token-ordered (earlier tokens win), slot-major within a
token, and masked rows never occupy capacity. Index tensors are int64,
torch's index type; their values equal the reference's int32 ones.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.core import balancers, ref_bip
from repro_torch.core.types import RouterConfig, RouterOutput, init_router_state

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class DispatchPlan:
    """Ragged routing plan for one routed batch.

    order    (n·k,) stable argsort of expert assignments (masked -> sentinel m)
    offsets  (m+1,) segment start of each expert's queue in sorted order
    pos      (n, k) position of each (token, slot) in its expert's queue
    keep     (n, k) slot survives capacity (and token_mask)
    """

    expert_index: Tensor  # (n, k)
    order: Tensor
    offsets: Tensor
    pos: Tensor
    keep: Tensor
    capacity: int
    top_k: int

    @property
    def counts(self) -> Tensor:
        """Per-expert assigned load (m,), pre-capacity, masked rows excluded."""
        return self.offsets[1:] - self.offsets[:-1]

    def pack(self, x: Tensor) -> Tensor:
        """Gather tokens (n, d) into the (m, capacity, d) expert buffers."""
        nk = self.order.shape[0]
        m = self.offsets.shape[0] - 1
        cap = self.capacity
        slots = torch.arange(m * cap, device=x.device)
        se = slots // cap
        src_sorted = self.offsets[se] + slots % cap
        valid = src_sorted < self.offsets[se + 1]
        src_tok = self.order[torch.clamp_max(src_sorted, nk - 1)] // self.top_k
        buf = x[src_tok] * valid[:, None].to(x.dtype)
        return buf.reshape(m, cap, x.shape[-1])

    def combine(self, y: Tensor, weights: Tensor) -> Tensor:
        """Gather expert outputs (m, capacity, d) back per (token, slot),
        weight them, and sum over the k slots."""
        m, cap, d = y.shape
        n, k = self.expert_index.shape
        ok = self.keep.reshape(-1)
        slot = (self.expert_index * cap + self.pos).reshape(-1)
        g = y.reshape(m * cap, d)[torch.where(ok, slot, 0)]
        w = weights.reshape(-1, 1).to(y.dtype)
        contrib = torch.where(ok[:, None], g * w, torch.zeros((), dtype=y.dtype, device=y.device))
        return contrib.reshape(n, k, d).sum(dim=1)


def make_dispatch_plan(
    expert_index: Tensor,  # (n, k)
    n_experts: int,
    capacity: int,
    token_mask: Optional[Tensor] = None,  # (n,) bool; False never dispatches
) -> DispatchPlan:
    """Build the sort-based plan; masked tokens are re-keyed to the sentinel
    expert m, so the stable sort pushes them past every real segment."""
    n, k = expert_index.shape
    nk = n * k
    dev = expert_index.device
    flat = expert_index.reshape(-1).long()
    if token_mask is not None:
        flat = torch.where(token_mask.repeat_interleave(k), flat, n_experts)
    order = torch.argsort(flat, stable=True)
    sorted_e = flat[order]
    offsets = torch.searchsorted(sorted_e, torch.arange(n_experts + 1, device=dev))
    # rank within the expert's segment == position in its capacity queue
    pos_sorted = torch.arange(nk, device=dev) - offsets[sorted_e]
    pos = torch.empty_like(pos_sorted).scatter_(0, order, pos_sorted).reshape(n, k)
    keep = pos < capacity
    if token_mask is not None:
        keep = keep & token_mask[:, None]
    return DispatchPlan(
        expert_index=expert_index.long(),
        order=order,
        offsets=offsets,
        pos=pos,
        keep=keep,
        capacity=capacity,
        top_k=k,
    )


def compute_scores(logits: Tensor, cfg: RouterConfig) -> Tensor:
    """Gating function G. Paper / minimind: softmax over experts."""
    logits = logits.to(cfg.router_dtype)
    if cfg.score_fn == "softmax":
        return torch.softmax(logits, dim=-1)
    return torch.sigmoid(logits)


def route(
    logits: Tensor,
    state: Dict[str, Tensor],
    cfg: RouterConfig,
    *,
    local_shards: int = 1,
    token_mask: Optional[Tensor] = None,
) -> RouterOutput:
    """Route a flattened batch of tokens.

    logits: (n, m) router logits. state: {'q': (m,)} plus method leaves.
    token_mask: optional (n,) bool — serving padding rows are False; they
      still get selections but are excluded from every state update.
    """
    n, m = logits.shape
    if m != cfg.n_experts:
        raise ValueError(f"logits have {m} experts, config {cfg.n_experts}")
    bal = balancers.get_balancer(cfg.strategy)
    bal.check_config(cfg)
    if token_mask is not None and not bal.serving_ok:
        raise NotImplementedError(
            f"strategy {cfg.strategy!r} is training-only (batch-dependent selection)"
        )
    s = compute_scores(logits, cfg)
    new_state = dict(state)

    if cfg.guard_duals:
        # dual-health watchdog: any non-finite/runaway entry in the guarded
        # keys resets them all to zeros; healthy carries pass bitwise
        gkeys = bal.guard_keys(state)
        stacked = torch.cat([state[k] for k in gkeys])
        _, healthy = ref_bip.sanitize_duals(stacked, cfg.dual_abs_limit)
        for k in gkeys:
            new_state[k] = torch.where(healthy, state[k], torch.zeros_like(state[k]))
        state = dict(new_state)

    global_axes = tuple(cfg.data_axes) if cfg.sync == "global" else ()
    adjusted = bal.score_adjust(
        s, state, cfg,
        token_mask=token_mask, axis_names=global_axes, local_shards=local_shards,
    )
    if len(adjusted) == 3:
        corrected, pre_updates, hook_telemetry = adjusted
    else:
        corrected, pre_updates = adjusted
        hook_telemetry = {}
    new_state.update(pre_updates)
    w, idx = bal.select(s, corrected, cfg)
    aux = bal.aux_loss(s, idx, cfg, token_mask)
    new_state.update(
        bal.update_state(s, idx, state, cfg, token_mask=token_mask, axis_names=global_axes)
    )
    metrics = dict(balancers.router_metrics(bal, s, w, idx, cfg))
    metrics.update(hook_telemetry)
    metrics["q_abs_max"] = new_state["q"].abs().max()
    return RouterOutput(
        combine_weights=w,
        expert_index=idx,
        state={k: v.detach() for k, v in new_state.items()},
        aux_loss=aux,
        metrics=metrics,
    )


__all__ = [
    "DispatchPlan",
    "compute_scores",
    "init_router_state",
    "make_dispatch_plan",
    "route",
    "RouterConfig",
    "RouterOutput",
]
