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
With `guard` (the guarded train step), every write selects the old value
where the step is not ok, so a skipped step leaves the state bit-identical.
A leaf is updated in slices of _SLICE elements, which bounds the update's
temporaries without changing a bit of its result (the math is elementwise).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

Tensor = torch.Tensor
# elements per slice of a leaf's update (256 MB of fp32): a 1e9-element
# embedding would otherwise hold ~6 fp32 temporaries of 4 GB at once
_SLICE = 1 << 26


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


def global_norm(leaves: List[Tensor]) -> Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves))


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
    host sync: ok = guard & isfinite(grad_norm), every param and moment
    write is torch.where(ok, new, old), info gains 'step_ok' (ok) and
    `step` is NOT advanced: the caller advances it once it has read ok.

    `grad_norm` replaces the norm of `grads` where they are blocks of
    leaves sharded over a mesh (the caller reduces it over the ranks)."""
    step = opt_state["step"] + 1
    p_paths = tree_paths(params)
    mu_leaves, nu_leaves = tree_leaves(opt_state["mu"]), tree_leaves(opt_state["nu"])
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    ok = None if guard is None else guard & torch.isfinite(gnorm)
    keep = (lambda new, old: new) if ok is None else (lambda new, old: torch.where(ok, new, old))  # noqa: E731
    scale = None
    if cfg.clip_norm > 0:
        scale = torch.clamp(cfg.clip_norm / torch.clamp_min(gnorm, 1e-9), max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    c1 = 1.0 - torch.tensor(b1, dtype=torch.float32) ** float(step)
    c2 = 1.0 - torch.tensor(b2, dtype=torch.float32) ** float(step)
    c1, c2 = float(c1), float(c2)  # host scalars: fp32 values, no device sync
    for g, mu, nu, (path, p) in zip(grads, mu_leaves, nu_leaves, p_paths):
        wd = cfg.weight_decay if decay[path] else 0.0  # matrices of the reference's layout
        # slice by slice: the same elementwise math, with the fp32
        # temporaries of one slice live at a time, not of a whole leaf
        for gs, ps, mus, nus in zip(g.reshape(-1).split(_SLICE), p.view(-1).split(_SLICE),
                                    mu.view(-1).split(_SLICE), nu.view(-1).split(_SLICE)):
            if scale is not None:
                gs = gs * scale.to(gs.dtype)
            g32 = gs.float()
            mu_n = b1 * mus.float() + (1 - b1) * g32
            nu_n = b2 * nus.float() + (1 - b2) * g32 * g32
            delta = (mu_n / c1) / (torch.sqrt(nu_n / c2) + cfg.eps)
            if wd > 0:
                delta = delta + wd * ps.float()
            ps.copy_(keep(ps.float() - lr * delta, ps))
            mus.copy_(keep(mu_n, mus))
            nus.copy_(keep(nu_n, nus))
    if ok is None:
        opt_state["step"] = step
        return params, opt_state, {"grad_norm": gnorm, "lr": lr}
    return params, opt_state, {"grad_norm": gnorm, "lr": lr, "step_ok": ok}
