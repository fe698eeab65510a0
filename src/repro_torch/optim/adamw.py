"""AdamW with a per-config state dtype policy and global-norm clipping
(port of src/repro/optim/adamw.py).

State mirrors the params tree: {'step': int, 'mu': tree, 'nu': tree}. The
update math runs in fp32 whatever the stored dtypes. Weight decay applies
to the leaves the reference decays: those whose counterpart in the
reference's stacked layout is a matrix (ndim >= 2). The port keeps one
dict per layer, so a per-layer (d,) norm scale is (G, d) there and is
decayed (`convert.decay_mask`).

Unlike the reference, which returns new trees, `adamw_update` updates the
params and moments IN PLACE under torch.no_grad() (one copy of the state
lives on the device) and returns the same trees; `step` is a host integer.
With `guard` (the guarded train step), a step that is not ok leaves the
params and moments bit-identical.

The norm and the update run in `kernels/adamw_step.py`: on CUDA leaves K5,
one multi-tensor kernel pair over every leaf at once; on CPU leaves its
plain version, the same fp32 math leaf by leaf in slices.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.kernels import adamw_step
from repro_torch.kernels.adamw_step import global_norm

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    mu_dtype: Any = torch.float32
    nu_dtype: Any = torch.float32


def _dtype(name: str):
    return torch.bfloat16 if name == "bf16" else torch.float32


def from_model_config(cfg, **overrides) -> AdamWConfig:
    return AdamWConfig(
        mu_dtype=_dtype(cfg.adam_mu_dtype),
        nu_dtype=_dtype(cfg.adam_nu_dtype),
        **overrides,
    )


def tree_leaves(tree) -> List[Tensor]:
    """Tensor leaves of a dict/list tree in a fixed order: dict keys sorted,
    as jax.tree.leaves, so a tree restored from a checkpoint (whose dicts
    come back in sorted order) sums its global norm in the same order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [] if tree is None else [tree]


def tree_paths(tree, prefix: str = "") -> List[Tuple[str, Tensor]]:
    """(path, leaf) pairs in the order of `tree_leaves`; a path names dict
    keys with dots and list positions in brackets ('stack.layers[0].attn.wq')."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_paths(tree[k], f"{prefix}.{k}" if prefix else k)]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in tree_paths(v, f"{prefix}[{i}]")]
    return [] if tree is None else [(prefix, tree)]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return None if tree is None else fn(tree)


def adamw_init(params, cfg: AdamWConfig) -> Dict[str, Any]:
    return {
        "step": 0,
        "mu": tree_map(lambda p: torch.zeros_like(p, dtype=cfg.mu_dtype), params),
        "nu": tree_map(lambda p: torch.zeros_like(p, dtype=cfg.nu_dtype), params),
    }


@torch.no_grad()
def adamw_update(
    grads: List[Tensor],
    opt_state: Dict[str, Any],
    params,
    lr: float,
    cfg: AdamWConfig,
    decay: Dict[str, bool],
    guard: Optional[Tensor] = None,
    grad_norm: Optional[Tensor] = None,
) -> Tuple[Any, Dict[str, Any], Dict[str, Any]]:
    """One AdamW step, in place. `grads` are in the order of
    tree_leaves(params). Returns (params, opt_state, info) with info
    {'grad_norm': device scalar, 'lr': lr}.

    `decay` maps each leaf's path (`tree_paths`) to whether weight decay
    applies to it (`convert.decay_mask` builds it for the model's params).

    `guard` (a device bool scalar) makes the step conditional without a
    host sync: ok = guard & isfinite(grad_norm), where ok is false every
    param and moment keeps its bits, info gains 'step_ok' (ok) and
    `step` is NOT advanced: the caller advances it once it has read ok.

    `grad_norm` replaces the norm of `grads` where they are blocks of
    leaves sharded over a mesh (the caller reduces it over the ranks)."""
    step = opt_state["step"] + 1
    p_paths = tree_paths(params)
    # a gradient autograd hands back transposed (the tied embedding's) is
    # read from a contiguous copy, as the plain update's reshape reads it
    grads = [g if g.is_contiguous() else g.contiguous() for g in grads]
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    ok = None if guard is None else guard & torch.isfinite(gnorm)
    adamw_step.adamw_step(
        [p for _, p in p_paths], grads, tree_leaves(opt_state["mu"]), tree_leaves(opt_state["nu"]),
        [decay[path] for path, _ in p_paths],  # matrices of the reference's layout
        lr=lr, b1=cfg.b1, b2=cfg.b2, eps=cfg.eps, weight_decay=cfg.weight_decay, clip_norm=cfg.clip_norm,
        step=step, gnorm=gnorm, ok=ok)
    if ok is None:
        opt_state["step"] = step
        return params, opt_state, {"grad_norm": gnorm, "lr": lr}
    return params, opt_state, {"grad_norm": gnorm, "lr": lr, "step_ok": ok}
