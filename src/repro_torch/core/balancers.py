"""Balancer registry — the routing strategy surface (port of
src/repro/core/balancers.py).

`route()` (core/router.py) resolves `cfg.strategy` here and calls the hook
protocol: init_state / check_config / guard_keys / score_adjust / select /
aux_loss / update_state / finalize_metrics. The port registers the
strategies the serving path needs: 'topk' (no balancing) and 'bip' (the
paper). The other reference methods (aux_loss, lossfree, phi, lpr,
expert_choice) are not ported yet and fail validation by name.
"""
from __future__ import annotations

import warnings
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import ref_bip
from repro_torch.core.metrics import balance_metrics
from repro_torch.core.types import RouterConfig

Tensor = torch.Tensor
State = Dict[str, Tensor]

_REGISTRY: Dict[str, "Balancer"] = {}

_warned: set = set()

# what the unmasked use_kernel branches need and where it stands
_ADMM_KERNEL_TODO = (
    "the BIP ADMM dual-update kernel (K3, src/repro/kernels/bip_admm.py) is not "
    "ported yet (ROADMAP.md, queue 2, K3); the port runs use_kernel=True only "
    "on masked (serving) calls, whose dual update is the plain threshold "
    "bisection"
)


def _warn_once(key: str, msg: str) -> None:
    """Emit a config-degradation warning once per process."""
    if key not in _warned:
        _warned.add(key)
        warnings.warn(msg, stacklevel=4)


def register_balancer(name: str):
    """Class decorator: instantiate and register a Balancer under `name`."""

    def deco(cls):
        cls.name = name
        _REGISTRY[name] = cls()
        return cls

    return deco


def registered_balancers() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def get_balancer(name: str) -> "Balancer":
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown routing strategy {name!r}; registered: "
            f"{', '.join(registered_balancers())}"
        ) from None


def topk_select(s: Tensor, corrected: Tensor, cfg: RouterConfig) -> Tuple[Tensor, Tensor]:
    """Top-k on `corrected` scores, gate values gathered from raw `s`.

    Tie rule: equal scores go to the LOWER expert index first, the order
    lax.top_k gives. A stable descending sort keeps equal values in index
    order; torch.topk promises no order among ties on CUDA, so it is not
    used for the selection.
    """
    idx = torch.sort(corrected, dim=-1, descending=True, stable=True).indices
    idx = idx[..., : cfg.top_k]
    w = torch.gather(s, -1, idx)
    if cfg.norm_topk_prob:
        w = w / torch.clamp_min(w.sum(dim=-1, keepdim=True), 1e-9)
    return w, idx


class Balancer:
    """Base strategy: plain token-choice top-k, no balancing, no state use."""

    name: str = ""
    STATE_KEYS: Tuple[str, ...] = ("q",)
    serving_ok: bool = True
    uses_kernel: bool = False

    def init_state(self, cfg: RouterConfig, device="cpu") -> State:
        return {"q": torch.zeros((cfg.n_experts,), dtype=cfg.router_dtype, device=device)}

    def guard_keys(self, state: State) -> Tuple[str, ...]:
        return tuple(k for k in self.STATE_KEYS if k in state)

    def check_config(self, cfg: RouterConfig) -> None:
        if cfg.use_kernel and not self.uses_kernel:
            _warn_once(
                f"kernel-unused-{self.name}",
                f"use_kernel=True only accelerates the 'bip' ADMM dual "
                f"update; strategy {self.name!r} runs the reference path "
                f"and the flag is ignored.",
            )
        if cfg.forecast and self.name != "bip":
            _warn_once(
                f"forecast-unused-{self.name}",
                f"RouterConfig.forecast drives the bip dual forecaster; "
                f"strategy {self.name!r} carries no forecaster state and "
                f"the flag is ignored.",
            )

    def score_adjust(self, s, state, cfg, *, token_mask=None, axis_names=(),
                     local_shards=1):
        return s, {}

    def select(self, s, corrected, cfg):
        return topk_select(s, corrected, cfg)

    def aux_loss(self, s, idx, cfg, token_mask=None):
        return torch.zeros((), dtype=cfg.router_dtype, device=s.device)

    def update_state(self, s, idx, state, cfg, *, token_mask=None, axis_names=()):
        return {}

    def finalize_metrics(self, base, s, w, idx, cfg):
        return base


@register_balancer("topk")
class TopKBalancer(Balancer):
    """Vanilla softmax top-k — no balancing; the collapse-prone baseline."""


@register_balancer("bip")
class BIPBalancer(Balancer):
    """BIP-Based Balancing (the paper): per-gate ADMM dual update of q.

    The dual price q is SUBTRACTED from scores for selection. Masked calls
    (serving) run the plain threshold bisection over the real rows; unmasked
    calls run the exact sort-based update, or — with use_kernel — would run
    the ADMM kernel, which is not ported yet and raises.
    """

    STATE_KEYS = ("q", "q_ema", "q_err")
    uses_kernel = True

    def init_state(self, cfg, device="cpu"):
        state = super().init_state(cfg, device)
        if cfg.forecast:
            state["q_ema"] = torch.zeros_like(state["q"])
            state["q_err"] = torch.zeros_like(state["q"])
        return state

    def check_config(self, cfg):
        if cfg.forecast and (cfg.sync != "global" or cfg.use_kernel):
            _warn_once(
                "forecast-inactive",
                "RouterConfig.forecast only drives the reference sync='global' "
                "bisection path; with sync='local' or use_kernel=True the "
                "forecaster state is carried but never consulted.",
            )

    def guard_keys(self, state):
        return ("q",) + tuple(k for k in ("q_ema", "q_err") if k in state)

    def _solve(self, s, q0, cfg):
        if cfg.use_kernel:
            raise NotImplementedError(_ADMM_KERNEL_TODO)
        q, _ = ref_bip.bip_dual_update(s, q0, top_k=cfg.top_k, n_iters=cfg.bip_iters)
        return q

    def score_adjust(self, s, state, cfg, *, token_mask=None, axis_names=(),
                     local_shards=1):
        if axis_names:
            raise NotImplementedError("multi-device dual sync is not ported yet")
        q0 = state["q"]
        updates: State = {}
        if cfg.sync == "global" and cfg.use_kernel and token_mask is None:
            raise NotImplementedError(_ADMM_KERNEL_TODO)
        if cfg.sync == "global" or token_mask is not None:
            if cfg.use_kernel:  # only reachable with a token mask
                _warn_once(
                    "kernel-masked",
                    "use_kernel=True has no masked (serving-padding) form; "
                    "running the reference masked dual update.",
                )
            if cfg.forecast and not cfg.use_kernel and "q_ema" in state:
                raise NotImplementedError(
                    "the bip dual forecaster (RouterConfig.forecast) is not ported yet"
                )
            # scores are softmax/sigmoid outputs, so [0, 1] is a static bracket
            q, _ = ref_bip.bip_dual_update_global(
                s.detach(), q0,
                top_k=cfg.top_k, n_iters=cfg.bip_iters,
                token_mask=token_mask,
                n_bisect=cfg.n_bisect, fanout=cfg.bisect_fanout,
                score_bounds=(0.0, 1.0),
            )
        elif local_shards > 1 and cfg.sync == "local":
            raise NotImplementedError("local_shards > 1 is not ported yet")
        else:
            q = self._solve(s.detach(), q0, cfg)
        corrected = s - q[None, :]
        updates["q"] = q
        if not cfg.bip_warm_start:
            updates["q"] = torch.zeros_like(q0)
        return corrected, updates, {}


def router_metrics(bal: Balancer, s, w, idx, cfg: RouterConfig) -> Dict[str, Tensor]:
    """Balance metrics + the balancer's method-specific columns."""
    base = balance_metrics(idx, cfg.n_experts, cfg.top_k)
    return bal.finalize_metrics(base, s, w, idx, cfg)


__all__ = [
    "Balancer",
    "get_balancer",
    "register_balancer",
    "registered_balancers",
    "router_metrics",
    "topk_select",
]
