"""Carry parameters, optimizer and router states across between the
reference package's layout and the port's, both ways.

The reference keeps each layer-kind position j of the period stacked along
a leading group axis (`params['stack']['blocks'][j]`, n_groups long, +1 for
a remainder position); the port keeps one dict per layer in layer order.
Layer i is group i // period of position i % period. The encdec encoder's
layers are one stack over n_enc_layers there (`params['encoder']['layers']`)
and a list here; the zamba2 shared block (`params['stack']['shared']`),
`frontend_proj` and the untied head `embed.unembed` are one leaf set in both.

    params_from_numpy(tree, cfg, device)        reference params -> port params
    router_states_from_numpy(states, cfg, dev)  reference states -> port states
    train_state_from_numpy(params, opt_state, router_states, cfg, device)
                                                reference TrainState leaves -> port TrainState
    load_npz_params(path, cfg, device)          reference npz checkpoint -> port params
    load_npz_tree(path)                         the npz as a tree of CPU tensors
    stack_blocks(layers, cfg)                   inverse of unstack_blocks
    decay_mask(params)                          leaf path -> decayed by AdamW, as in the
                                                reference's stacked layout
    params_to_tree(params, cfg)                 port params -> the reference's tree
    train_state_to_tree(state, cfg)             port TrainState -> the reference's
                                                {'params', 'opt_state', 'router_states'}

Inputs are numpy arrays (e.g. from jax.device_get) or torch tensors; bf16
leaves arrive as ml_dtypes bfloat16 arrays or as uint16 bit patterns.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.stack import _group_layout


def _to_tensor(a, device="cpu") -> torch.Tensor:
    if isinstance(a, torch.Tensor):  # a copy: `a` may be a slice of a group stack
        return a.to(device, copy=True)
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":  # ml_dtypes: reinterpret the 16 bits
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(arr).copy()).to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    if tree is None:
        return None
    return fn(tree)


def unstack_blocks(blocks: List[Any], cfg: ModelConfig) -> List[Any]:
    """Reference per-position stacks -> one subtree per layer, layer order."""
    period, _, _ = _group_layout(cfg)
    if len(blocks) != period:
        raise ValueError(f"expected {period} block stacks, got {len(blocks)}")
    out = []
    for i in range(cfg.n_layers):
        j, g = i % period, i // period
        out.append(_map(blocks[j], lambda a, g=g: a[g]))
    return out


def _zip_map(trees: List[Any], fn):
    """Map `fn` over the leaves of same-structured trees, leaf tuples in."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _zip_map([t[k] for t in trees], fn) for k in first}
    if isinstance(first, (list, tuple)):
        return [_zip_map([t[i] for t in trees], fn) for i in range(len(first))]
    if first is None:
        return None
    return fn(trees)


def stack_blocks(layers: List[Any], cfg: ModelConfig) -> List[Any]:
    """One subtree per layer (layer order) -> the reference's per-position
    stacks: position j stacks layers j, j + period, ... along a new leading
    group axis (a remainder position holds one more group). The stacks are
    new tensors on the layers' device."""
    period, _, _ = _group_layout(cfg)
    if len(layers) != cfg.n_layers:
        raise ValueError(f"expected {cfg.n_layers} layers, got {len(layers)}")
    return [
        _zip_map(layers[j::period], lambda xs: torch.stack([x.detach() for x in xs]))
        for j in range(period)
    ]


# leaves under these carry a leading layer axis in the reference's layout
_STACKED = ("stack.layers[", "encoder.layers[")
_TOP_KEYS = {"embed", "stack", "final_norm", "encoder", "frontend_proj"}


def decay_mask(params) -> Dict[str, bool]:
    """AdamW's weight-decay mask, keyed by leaf path (`optim.adamw.tree_paths`).

    The reference decays a leaf when it has ndim >= 2 in ITS layout, where
    every leaf of the decoder's per-layer blocks and of the encoder's layers
    carries a leading layer axis (`stack_blocks`; the encoder is stacked
    over n_enc_layers): a per-layer (d,) norm scale is (G, d) there and is
    decayed. Leaves outside them count as they are: the embedding and the
    zamba2 shared block's matrices are decayed, `final_norm`, the encoder's
    final norm and the shared block's norm scales are not."""
    from repro_torch.optim.adamw import tree_paths  # lazy: optim imports nothing of the models

    return {
        path: leaf.dim() + (1 if path.startswith(_STACKED) else 0) >= 2
        for path, leaf in tree_paths(params)
    }


def _check_keys(tree) -> None:
    unknown = set(tree) - _TOP_KEYS
    if unknown:
        raise NotImplementedError(f"params with entries {sorted(unknown)} are not ported")


def params_to_tree(params, cfg: ModelConfig):
    """The port's params (or a tree shaped like them: the Adam moments) ->
    the reference's params tree, every leaf a new tensor on its device:
    decoder layers into per-position group stacks, encoder layers stacked
    along a leading layer axis, the shared block as it is."""
    _check_keys(params)
    clone = lambda t: t.detach().clone()  # noqa: E731
    tree = {
        "embed": _map(params["embed"], clone),
        "stack": {"blocks": stack_blocks(params["stack"]["layers"], cfg)},
        "final_norm": _map(params["final_norm"], clone),
    }
    if "shared" in params["stack"]:
        tree["stack"]["shared"] = _map(params["stack"]["shared"], clone)
    if "encoder" in params:
        enc = params["encoder"]
        tree["encoder"] = {
            "layers": _zip_map(enc["layers"], lambda xs: torch.stack([x.detach() for x in xs])),
            "final_norm": _map(enc["final_norm"], clone),
        }
    if "frontend_proj" in params:
        tree["frontend_proj"] = clone(params["frontend_proj"])
    return tree


@torch.no_grad()
def train_state_to_tree(state, cfg: ModelConfig):
    """A port TrainState -> the tree the reference's CheckpointManager
    saves: {'params', 'opt_state': {'step' (0-d int32), 'mu', 'nu'},
    'router_states'} in the reference's stacked layout. Every tensor leaf is
    a new tensor on the state's device, so the tree is a snapshot the next
    in-place step cannot touch."""
    opt = state.opt_state
    return {
        "params": params_to_tree(state.params, cfg),
        "opt_state": {
            "step": torch.tensor(int(opt["step"]), dtype=torch.int32),
            "mu": params_to_tree(opt["mu"], cfg),
            "nu": params_to_tree(opt["nu"], cfg),
        },
        "router_states": stack_blocks(state.router_states, cfg),
    }


def params_from_numpy(tree, cfg: ModelConfig, device="cpu"):
    """The reference's params pytree -> the port's params on `device`."""
    _check_keys(tree)
    conv = lambda a: _to_tensor(a, device)  # noqa: E731
    out = {
        "embed": _map(tree["embed"], conv),
        "stack": {"layers": _map(unstack_blocks(tree["stack"]["blocks"], cfg), conv)},
        "final_norm": _map(tree["final_norm"], conv),
    }
    if "shared" in tree["stack"]:
        out["stack"]["shared"] = _map(tree["stack"]["shared"], conv)
    if "encoder" in tree:
        enc = tree["encoder"]
        out["encoder"] = {
            "layers": [_map(enc["layers"], lambda a, i=i: conv(a[i])) for i in range(cfg.n_enc_layers)],
            "final_norm": _map(enc["final_norm"], conv),
        }
    if "frontend_proj" in tree:
        out["frontend_proj"] = conv(tree["frontend_proj"])
    return out


def router_states_from_numpy(states, cfg: ModelConfig, device="cpu"):
    """The reference's router-state stacks (one per period position, None for
    non-MoE positions) -> the port's per-layer list."""
    return _map(unstack_blocks(list(states), cfg), lambda a: _to_tensor(a, device))


def train_state_from_numpy(params, opt_state, router_states, cfg: ModelConfig, device="cpu"):
    """The reference's TrainState (params, AdamW state {'step', 'mu', 'nu'},
    router states) -> the port's TrainState on `device`. The Adam moments
    mirror the params tree and are unstacked the same way; the step counter
    becomes a host integer, as the port's AdamW keeps it."""
    from repro_torch.training.loop import TrainState  # lazy: training imports models

    opt = {
        "step": int(np.asarray(opt_state["step"])),
        "mu": params_from_numpy(opt_state["mu"], cfg, device),
        "nu": params_from_numpy(opt_state["nu"], cfg, device),
    }
    return TrainState(
        params=params_from_numpy(params, cfg, device),
        opt_state=opt,
        router_states=router_states_from_numpy(router_states, cfg, device),
    )


def load_npz_tree(path: str):
    """Read an npz written by either package's `save_pytree` as a tree of
    CPU tensors (dicts/lists/tuples; None leaves as None)."""
    from repro_torch.checkpoint.store import load_pytree  # lazy: import cycle

    return load_pytree(path)


def load_npz_params(path: str, cfg: ModelConfig, device="cpu"):
    """The port's params from a reference npz (a bare params tree or a
    TrainState-like tree with a 'params' entry)."""
    tree = load_npz_tree(path)
    if isinstance(tree, dict) and "params" in tree:
        tree = tree["params"]
    return params_from_numpy(tree, cfg, device)


__all__ = [
    "decay_mask",
    "load_npz_params",
    "load_npz_tree",
    "params_from_numpy",
    "params_to_tree",
    "router_states_from_numpy",
    "stack_blocks",
    "train_state_from_numpy",
    "train_state_to_tree",
    "unstack_blocks",
]
