"""Balancer registry — the routing strategy surface (port of
src/repro/core/balancers.py).

`route()` (core/router.py) resolves `cfg.strategy` here and calls the hook
protocol: init_state / check_config / guard_keys / score_adjust / select /
aux_loss / update_state / finalize_metrics. The port registers every
method of the reference: the paper's four (topk, aux_loss, lossfree, bip),
expert_choice (training-only) here, and phi (core/phi.py) and lpr
(core/lpr.py), which self-register when this module is imported.
Expert-choice leaves a token's spare slots at the sentinel index m with
weight 0: every one-hot here drops it (`one_hot`), and the dispatch plan
never keeps it.

Each hook receives `axis_names`: the mesh's data axes under sync='global'
(router.route passes cfg.data_axes), else (). Reductions over the batch
(the selection histogram, lpr's cluster sums, the bip dual's counts) are
psum'd over them (distributed.collectives, under the caller's axis_env),
so a sharded batch updates the carried state as the whole batch would.
"""
from __future__ import annotations

import warnings
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import ref_bip
from repro_torch.core.metrics import balance_metrics
from repro_torch.core.types import RouterConfig
from repro_torch.distributed import collectives
from repro_torch.kernels import ops as kernel_ops

Tensor = torch.Tensor
State = Dict[str, Tensor]

_REGISTRY: Dict[str, "Balancer"] = {}

_warned: set = set()


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


def one_hot(idx: Tensor, m: int, dtype) -> Tensor:
    """(..., m) one-hot rows of `idx`; the sentinel index m (expert-choice's
    uncovered slots) gives a zero row, as jax.nn.one_hot does for an index
    out of range (F.one_hot raises on it)."""
    return torch.nn.functional.one_hot(idx.long(), m + 1)[..., :m].to(dtype)


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
    """Base strategy: plain token-choice top-k, no balancing, no state use.

    STATE_KEYS      the state keys the dual watchdog covers, in order
    local_avg_keys  state keys the expert-parallel paths pmean over the
                    data shards under sync='local' (the warm-start average)
    serving_ok      supports masked serving rows (causal under decode)
    uses_kernel     consumes cfg.use_kernel (bip's K3 only)
    """

    name: str = ""
    STATE_KEYS: Tuple[str, ...] = ("q",)
    local_avg_keys: Tuple[str, ...] = ("q",)
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


@register_balancer("aux_loss")
class AuxLossBalancer(Balancer):
    """Loss-Controlled (GShard/Switch): L_balance = alpha * sum_j f_j P_j.

    f_j = m/(k n) sum_i delta_ij (token fraction, no gradient),
    P_j = 1/n sum_i s_ij         (mean gate score, carries the gradient).
    With token_mask, both means run over the real rows only.
    """

    def aux_loss(self, s, idx, cfg, token_mask=None):
        n, m = s.shape
        onehot = one_hot(idx, m, s.dtype)  # (n, k, m)
        if token_mask is not None:
            w = token_mask.to(s.dtype)
            n_eff = torch.clamp_min(w.sum(), 1.0)
            f = (onehot * w[:, None, None]).sum(dim=(0, 1)).detach() * (m / (cfg.top_k * n_eff))
            p_mean = (s * w[:, None]).sum(dim=0) / n_eff
        else:
            f = onehot.sum(dim=(0, 1)).detach() * (m / (cfg.top_k * n))
            p_mean = s.mean(dim=0)
        return cfg.aux_loss_alpha * torch.sum(f * p_mean)


def selection_load(idx: Tensor, m: int, dtype, token_mask: Optional[Tensor] = None,
                   axis_names: tuple = ()) -> Tensor:
    """Per-expert selection histogram (m,), masked rows excluded, psum'd
    over `axis_names` so sync='global' methods see the global batch;
    integer valued, so exact in any summation order."""
    onehot = one_hot(idx, m, dtype)
    if token_mask is not None:
        onehot = onehot * token_mask.to(dtype)[:, None, None]
    return collectives.psum(onehot.sum(dim=(0, 1)).detach(), axis_names)


@register_balancer("lossfree")
class LossFreeBalancer(Balancer):
    """Loss-Free (Wang et al. 2024): per-batch sign update of a bias b.

    The carried 'q' plays the role of b, ADDED to the scores for selection;
    gate values stay the raw scores, so b gets no gradient.
    """

    def score_adjust(self, s, state, cfg, *, token_mask=None, axis_names=(),
                     local_shards=1):
        return s + state["q"][None, :], {}

    def update_state(self, s, idx, state, cfg, *, token_mask=None, axis_names=()):
        load = selection_load(idx, s.shape[-1], cfg.router_dtype, token_mask, axis_names)
        err = load.mean() - load
        return {"q": state["q"] + cfg.lossfree_lr * torch.sign(err)}


@register_balancer("bip")
class BIPBalancer(Balancer):
    """BIP-Based Balancing (the paper): per-gate ADMM dual update of q.

    The dual price q is SUBTRACTED from scores for selection. Masked calls
    (serving) run the plain threshold bisection over the real rows; unmasked
    calls run the exact sort-based update, or with use_kernel the ADMM
    kernel's histogram dual (kernels/ops.py, K3), under either sync mode.
    Under sync='global' on a mesh (axis_names) the kernel dual runs in its
    collective form and the bisection psums its counts.
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
        """The unmasked dual update: the K3 kernel's dual or the exact one."""
        if cfg.use_kernel:
            return kernel_ops.bip_dual_update(s, q0, top_k=cfg.top_k, n_iters=cfg.bip_iters)
        q, _ = ref_bip.bip_dual_update(s, q0, top_k=cfg.top_k, n_iters=cfg.bip_iters)
        return q

    def score_adjust(self, s, state, cfg, *, token_mask=None, axis_names=(),
                     local_shards=1):
        n, m = s.shape
        q0 = state["q"]
        updates: State = {}
        # dual-health telemetry route() folds into the metrics: values the
        # solve already produced
        tel: State = {}
        if cfg.sync == "global" and cfg.use_kernel and token_mask is None:
            # the kernel dual; with axis_names its collective form (the
            # histogram counts psum'd between passes), without them the
            # single-device kernel
            q = kernel_ops.bip_dual_update(s.detach(), q0, top_k=cfg.top_k, n_iters=cfg.bip_iters,
                                           axis_names=axis_names)
            corrected = s - q[None, :]
        elif cfg.sync == "global" or token_mask is not None:
            if cfg.use_kernel:  # only reachable with a token mask
                _warn_once(
                    "kernel-masked",
                    "use_kernel=True has no masked (serving-padding) form; "
                    "running the reference masked dual update.",
                )
            # load forecaster: predict the pre-clamp order statistic t from
            # its EMA and bracket it by the EMA'd error; the bisection checks
            # the bracket in round 0 and ignores it where it is stale
            use_forecast = cfg.forecast and not cfg.use_kernel and "q_ema" in state
            window = None
            if use_forecast:
                half = cfg.forecast_margin * state["q_err"] + cfg.forecast_floor
                window = (state["q_ema"] - half, state["q_ema"] + half)
            # scores are softmax/sigmoid outputs, so [0, 1] is a static bracket
            q, _, t = ref_bip.bip_dual_update_global(
                s.detach(), q0,
                top_k=cfg.top_k, n_iters=cfg.bip_iters,
                token_mask=token_mask, axis_names=axis_names,
                n_bisect=cfg.n_bisect, fanout=cfg.bisect_fanout,
                score_bounds=(0.0, 1.0), window=window, with_stats=True,
            )
            if use_forecast:
                d = cfg.forecast_decay
                err = torch.abs(t - state["q_ema"])
                updates["q_ema"] = d * state["q_ema"] + (1.0 - d) * t
                updates["q_err"] = d * state["q_err"] + (1.0 - d) * err
                # forecast quality: mean |t - prediction| and the share of
                # experts whose statistic landed inside the bracket
                lo, hi = window
                tel["forecast_err"] = torch.mean(err)
                tel["forecast_hit"] = torch.mean(((t >= lo) & (t <= hi)).float())
            corrected = s - q[None, :]
        elif local_shards > 1 and cfg.sync == "local":
            # per-token-group duals (the reference's vmap over groups): one
            # solve per group, K3 once per group on the card
            s_grp = s.detach().reshape(local_shards, n // local_shards, m)
            q_grp = torch.stack([self._solve(sg, q0, cfg) for sg in s_grp])  # (S, m)
            corrected = (s.reshape(local_shards, -1, m) - q_grp[:, None, :]).reshape(n, m)
            q = q_grp.mean(dim=0)  # replicated warm start
        else:
            q = self._solve(s.detach(), q0, cfg)
            corrected = s - q[None, :]
        updates["q"] = q
        if not cfg.bip_warm_start:
            updates["q"] = torch.zeros_like(q0)
        return corrected, updates, tel


@register_balancer("expert_choice")
class ExpertChoiceBalancer(Balancer):
    """Expert-Choice (Zhou et al. 2022): each EXPERT takes its top-C tokens.

    Balance is perfect by construction (C = floor(k·n/m) per expert), but
    tokens may receive fewer than k experts: their spare slots carry the
    sentinel index m with weight 0, so they take no capacity and no load.
    TRAINING ONLY: an expert's top-C over the batch makes one token's
    selection depend on later tokens, so masked serving raises (route()
    checks `serving_ok`).
    """

    serving_ok = False

    def check_config(self, cfg):
        super().check_config(cfg)
        if cfg.sync == "global":
            _warn_once(
                "expert-choice-sync",
                "expert_choice selects each expert's top-C over the "
                "device-local token shard; sync='global' does not globalize "
                "the selection (no cross-shard top-C).",
            )

    def select(self, s, corrected, cfg):
        from repro_torch.core.expert_choice import expert_choice_select  # lazy: as the reference

        return expert_choice_select(s, cfg.top_k, norm_topk_prob=cfg.norm_topk_prob)

    def finalize_metrics(self, base, s, w, idx, cfg):
        # coverage columns: the share of tokens that got all k experts / none
        per_token = (idx < s.shape[-1]).sum(dim=-1)
        base = dict(base)
        base["coverage_full"] = (per_token >= cfg.top_k).float().mean()
        base["coverage_zero"] = (per_token == 0).float().mean()
        return base


def router_metrics(bal: Balancer, s, w, idx, cfg: RouterConfig) -> Dict[str, Tensor]:
    """Balance metrics + the balancer's method-specific columns."""
    base = balance_metrics(idx, cfg.n_experts, cfg.top_k)
    return bal.finalize_metrics(base, s, w, idx, cfg)


# the φ-Balancing and Latent-Prototype-Routing modules self-register on
# import; importing them here populates the full registry
from repro_torch.core import lpr as _lpr  # noqa: E402,F401  (self-registering)
from repro_torch.core import phi as _phi  # noqa: E402,F401  (self-registering)

__all__ = [
    "Balancer",
    "get_balancer",
    "one_hot",
    "register_balancer",
    "registered_balancers",
    "router_metrics",
    "selection_load",
    "topk_select",
]
