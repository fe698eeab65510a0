"""Shared types for the routing core: the gate's static config and output."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    """Static configuration of one routing gate (fields as in the reference,
    src/repro/core/types.py, which documents each). `strategy` resolves
    through the port's balancer registry (core/balancers.py)."""

    n_experts: int
    top_k: int
    strategy: str = "bip"
    bip_iters: int = 4
    bip_warm_start: bool = True
    aux_loss_alpha: float = 0.1
    lossfree_lr: float = 0.001
    norm_topk_prob: bool = False
    score_fn: str = "softmax"
    router_dtype: Any = torch.float32
    use_kernel: bool = False
    sync: str = "local"
    data_axes: tuple = ()
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

    def __post_init__(self):
        from repro_torch.core import balancers  # lazy: balancers imports this

        balancers.get_balancer(self.strategy)
        if not (0 < self.top_k <= self.n_experts):
            raise ValueError("need 0 < top_k <= n_experts")
        if self.score_fn not in ("softmax", "sigmoid"):
            raise ValueError(f"unknown score_fn {self.score_fn!r}")
        if self.sync not in ("local", "global"):
            raise ValueError(f"unknown sync mode {self.sync!r}")
        if self.n_bisect < 1:
            raise ValueError(f"n_bisect must be >= 1, got {self.n_bisect}")
        if self.bisect_fanout < 1:
            raise ValueError(f"bisect_fanout must be >= 1, got {self.bisect_fanout}")
        if not (0.0 <= self.forecast_decay < 1.0):
            raise ValueError(f"forecast_decay must be in [0, 1), got {self.forecast_decay}")
        if self.forecast_margin <= 0.0 or self.forecast_floor <= 0.0:
            raise ValueError("forecast_margin and forecast_floor must be > 0")
        if self.dual_abs_limit <= 0.0:
            raise ValueError(f"dual_abs_limit must be > 0, got {self.dual_abs_limit}")
        if self.phi_lr <= 0.0:
            raise ValueError(f"phi_lr must be > 0, got {self.phi_lr}")
        if not (0.0 <= self.lpr_decay < 1.0):
            raise ValueError(f"lpr_decay must be in [0, 1), got {self.lpr_decay}")
        if not (0.0 <= self.lpr_blend <= 1.0):
            raise ValueError(f"lpr_blend must be in [0, 1], got {self.lpr_blend}")


def init_router_state(cfg: RouterConfig, device="cpu") -> Dict[str, Tensor]:
    """Per-gate carried state from the registered balancer's `init_state`:
    every method carries the (m,) 'q' slot."""
    from repro_torch.core import balancers  # lazy: balancers imports this

    return balancers.get_balancer(cfg.strategy).init_state(cfg, device)


@dataclasses.dataclass
class RouterOutput:
    """Result of routing one flattened batch of n tokens.

    combine_weights: (n, k) gate values of the selected experts.
    expert_index:    (n, k) int64 selected expert ids.
    state:           updated router state.
    aux_loss:        scalar auxiliary loss (0 for the ported strategies).
    metrics:         dict with 'load' (m,), 'max_vio', 'q_abs_max', ...
    """

    combine_weights: Tensor
    expert_index: Tensor
    state: Dict[str, Tensor]
    aux_loss: Tensor
    metrics: Dict[str, Tensor]
