"""Carry parameters and router states across from the reference package.

The reference keeps each layer-kind position j of the period stacked along
a leading group axis (`params['stack']['blocks'][j]`, n_groups long, +1 for
a remainder position); the port keeps one dict per layer in layer order.
Layer i is group i // period of position i % period.

    params_from_numpy(tree, cfg, device)        reference params -> port params
    router_states_from_numpy(states, cfg, dev)  reference states -> port states
    load_npz_params(path, cfg, device)          reference npz checkpoint -> port params
    load_npz_tree(path)                         the npz as a tree of CPU tensors

Inputs are numpy arrays (e.g. from jax.device_get) or torch tensors; bf16
leaves arrive as ml_dtypes bfloat16 arrays or as uint16 bit patterns.
"""
from __future__ import annotations

import json
from typing import Any, List

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.stack import _group_layout

_SEP = "|"  # path separator of the reference npz format


def _to_tensor(a, device="cpu") -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device)
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


def params_from_numpy(tree, cfg: ModelConfig, device="cpu"):
    """The reference's params pytree -> the port's params on `device`."""
    layers = unstack_blocks(tree["stack"]["blocks"], cfg)
    if "shared" in tree["stack"]:
        raise NotImplementedError("the zamba2 shared block is not ported yet")
    conv = lambda a: _to_tensor(a, device)  # noqa: E731
    return {
        "embed": _map(tree["embed"], conv),
        "stack": {"layers": _map(layers, conv)},
        "final_norm": _map(tree["final_norm"], conv),
    }


def router_states_from_numpy(states, cfg: ModelConfig, device="cpu"):
    """The reference's router-state stacks (one per period position, None for
    non-MoE positions) -> the port's per-layer list."""
    return _map(unstack_blocks(list(states), cfg), lambda a: _to_tensor(a, device))


def load_npz_tree(path: str):
    """Read an npz written by the reference's `save_pytree`: leaves under
    `a{i}`, their 'd:'/'l:'/'t:' paths joined by '|' and dtypes in the
    `__meta__` JSON, bf16 stored as uint16. Returns dicts/lists of CPU
    tensors (tuples come back as lists, None leaves as None)."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode("utf-8"))
        items = []
        for name, info in meta.items():
            if info["dtype"] == "NoneType":
                items.append((info["path"], None))
                continue
            arr = z[name]
            if info["dtype"] == "bfloat16":
                t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
            else:
                t = torch.from_numpy(np.ascontiguousarray(arr).copy())
            items.append((info["path"], t))
    root: Any = None
    for path, leaf in items:
        parts = [seg.split(":", 1) for seg in path.split(_SEP)]
        if root is None:
            root = {} if parts[0][0] == "d" else []
        node = root
        for depth, (tag, key) in enumerate(parts):
            k = key if tag == "d" else int(key)
            last = depth == len(parts) - 1
            if isinstance(node, list):
                while len(node) <= k:
                    node.append(None)
            if last:
                node[k] = leaf
                break
            nxt_tag = parts[depth + 1][0]
            if isinstance(node, dict):
                node = node.setdefault(k, {} if nxt_tag == "d" else [])
            else:
                if node[k] is None:
                    node[k] = {} if nxt_tag == "d" else []
                node = node[k]
    return root


def load_npz_params(path: str, cfg: ModelConfig, device="cpu"):
    """The port's params from a reference npz (a bare params tree or a
    TrainState-like tree with a 'params' entry)."""
    tree = load_npz_tree(path)
    if isinstance(tree, dict) and "params" in tree:
        tree = tree["params"]
    return params_from_numpy(tree, cfg, device)


__all__ = [
    "load_npz_params",
    "load_npz_tree",
    "params_from_numpy",
    "router_states_from_numpy",
    "unstack_blocks",
]
