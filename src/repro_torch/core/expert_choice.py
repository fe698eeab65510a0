"""Expert-Choice routing [Zhou et al. 2022] (port of
src/repro/core/expert_choice.py).

Each EXPERT takes its top-C tokens (C = max(⌊k·n/m⌋, 1)) instead of each
token its top-k experts. Balance is perfect by construction, but tokens
may receive fewer than k experts (coverage instead of capacity drops), the
routed score mass falls below the LP optimum when popular tokens crowd out
others, and the selection of one token depends on later tokens of the
batch, so it is training-only.

Tie rule, as lax.top_k: among equal scores the lower index goes first (a
stable descending sort; torch.topk promises no order among ties).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

Tensor = torch.Tensor


def _top(x: Tensor, c: int) -> Tensor:
    """Indices of the c largest entries along the last axis, ties to the
    lower index."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :c]


def expert_choice_route(s: Tensor, top_k: int) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Each expert takes its top-C tokens. Returns (gates (n, m): the score
    on every selected (token, expert) pair and 0 elsewhere, metrics with the
    load and coverage statistics)."""
    n, m = s.shape
    c = max((n * top_k) // m, 1)
    idx = _top(s.T, c)  # (m, C) token indices per expert
    mask = torch.zeros((m, n), dtype=s.dtype, device=s.device).scatter_(1, idx, 1.0).T
    gates = mask * s
    per_token = mask.sum(dim=1)  # experts per token
    mets = {
        "load": mask.sum(dim=0),  # == C per expert (perfect)
        "max_vio": torch.zeros((), device=s.device),  # by construction
        "coverage_full": (per_token >= top_k).float().mean(),
        "coverage_zero": (per_token == 0).float().mean(),
        "mean_experts_per_token": per_token.mean(),
        "objective": gates.sum(),
    }
    return gates, mets


def expert_choice_select(
    s: Tensor, top_k: int, *, norm_topk_prob: bool = False
) -> Tuple[Tensor, Tensor]:
    """Expert-choice assignment in the router's (n, k) token-slot interface:
    each token keeps its k highest-gate assignments as (combine_weights,
    expert_index) rows. Slots beyond a token's assignments carry the
    SENTINEL index m with weight 0; the dispatch plan sorts the sentinel
    past every real segment and never keeps it, so uncovered slots take no
    capacity and no load."""
    m = s.shape[-1]
    gates, _ = expert_choice_route(s, top_k)
    idx = _top(gates, top_k)
    w = torch.gather(gates, -1, idx)
    selected = w > 0.0
    idx = torch.where(selected, idx, m)
    w = torch.where(selected, w, torch.zeros((), dtype=w.dtype, device=w.device))
    if norm_topk_prob:
        w = w / torch.clamp_min(w.sum(dim=-1, keepdim=True), 1e-9)
    return w, idx


__all__ = ["expert_choice_route", "expert_choice_select"]
