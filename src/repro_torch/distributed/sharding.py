"""Sharding rules: the mesh layout of every tensor (port of
src/repro/distributed/sharding.py).

Layout, mesh axes ('pod',) 'data', 'model', as the reference's:

* batch: rows over (pod, data) when they divide, else replicated.
* tensor parallelism over 'model': attention heads, FFN hidden, the MoE
  expert dim, the mamba inner dim, the vocab (embed/unembed).
* FSDP over 'data': a parameter of 2^16 elements or more (in the
  reference's stacked layout) also shards its largest other axis over the
  data axes; 'model' folds into that axis when the tensor-parallel rule
  found no home for it and the data shard alone stays >= 128 MiB.
* expert weights: experts over 'model', the expert hidden f over the data
  axes (the layout ep2d/ep2ds use as stored).
* optimizer moments: their parameter's spec; router states replicated.
* decode caches: batch over the data axes when it divides; kv heads (or
  head_dim, or the cache length) over 'model'.

A spec is a tuple with one entry per dimension: None, an axis name, or a
tuple of axis names: the reference's PartitionSpec as plain data. The rules
read only the mesh's axis names and sizes (`collectives.mesh_shape`), so
any object with a `shape` dict serves for them; `shard_tree` and
`unshard_tree` need the DeviceMesh of a running process group.

The reference stacks each layer-kind position of the period along a
leading group axis and decides a leaf's spec from that stacked shape; the
port keeps one leaf per layer, so a layer's leaf gets the spec of its
group stack without the leading (never sharded) axis. The same holds for
the encoder's layers and for the per-layer decode caches.

    make_mesh_ctx(mesh)                   -> models.stack.MeshCtx
    param_specs(params, cfg, mesh)        -> spec tree like params
    batch_specs(cfg, mesh, batch_size)    -> {'tokens': ..., 'labels': ..., ...}
    batch_layout(cfg, mesh, batch)        -> batch_specs of `batch`'s own keys
    router_state_specs(router_states)     -> () per leaf
    train_state_specs(state, cfg, mesh)   -> TrainState of specs
    cache_specs(cache, cfg, mesh, batch_size)
    shard_tree(tree, specs, mesh)         -> this rank's blocks (new tensors)
    unshard_tree(tree, specs, mesh)       -> whole tensors from every rank's blocks
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives
from repro_torch.distributed.collectives import MeshCtx

Spec = Tuple


def make_mesh_ctx(mesh) -> MeshCtx:
    if mesh is None:
        return MeshCtx()
    names = tuple(collectives.mesh_shape(mesh))
    data_axes = tuple(a for a in names if a in ("pod", "data"))
    return MeshCtx(mesh=mesh, data_axes=data_axes, model_axis="model")


def _data_axes(shape: Dict[str, int]) -> Tuple[str, ...]:
    return tuple(a for a in shape if a in ("pod", "data"))


def _axis_size(shape: Dict[str, int], axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        return shape[axes]
    return math.prod(shape[a] for a in axes)


# --------------------------------------------------------------- params


_MODEL_AXIS_BY_NAME = {
    # tensor-parallel axis index per parameter name (after the stack dim)
    "wq": 1,       # (d, H, hd) -> heads
    "wk": 1,
    "wv": 1,
    "wo": 0,       # (H, hd, d) -> heads
    "w_gate": -1,  # (d, f) / (m, d, f): last axis = hidden f
    "w_up": -1,
    "w_down": -2,  # (f, d) / (m, f, d): f
    "in_proj": 1,  # mamba (d, d_in_proj)
    "out_proj": 0, # mamba (d_inner, d)
    "conv_w": 1,   # (K, conv_dim)
    "conv_b": 0,
    "norm_scale": 0,  # (d_inner,)
    "tok": 0,      # (V, d) -> vocab
    "unembed": 1,  # (d, V)
}
_MOE_EXPERT_PARAMS = {"w_gate", "w_up", "w_down"}
_REPLICATED = {"scale", "A_log", "D", "dt_bias", "w_router", "frontend_proj"}


def _param_spec(path: Tuple[str, ...], shape: Tuple[int, ...], mshape: Dict[str, int],
                data_axes: Tuple[str, ...], stacked: bool) -> Spec:
    """The reference's rule, on the reference's (stacked) shape."""
    name = path[-1]
    spec = [None] * len(shape)
    ndim_offset = 1 if stacked else 0  # the leading stack axis stays unsharded
    msize = mshape["model"]

    moe_ctx = "moe" in path
    if name in _REPLICATED and not (moe_ctx and name == "w_router"):
        pass  # fully replicated (tiny)
    elif name == "frontend_proj" or name == "w_router":
        pass
    elif moe_ctx and name in _MOE_EXPERT_PARAMS:
        # (stack, m, d, f) expert weights: experts over 'model', the expert
        # hidden f over the data axes (the ep2d at-rest layout)
        e_ax = ndim_offset
        if shape[e_ax] % msize == 0:
            spec[e_ax] = "model"
        f_ax = len(shape) - 1 if name in ("w_gate", "w_up") else len(shape) - 2
        dsize = _axis_size(mshape, data_axes)
        if data_axes and shape[f_ax] % dsize == 0 and shape[f_ax] >= dsize:
            spec[f_ax] = data_axes if len(data_axes) > 1 else data_axes[0]
    elif name in _MODEL_AXIS_BY_NAME:
        raw = _MODEL_AXIS_BY_NAME[name]
        ax = raw + ndim_offset if raw >= 0 else len(shape) + raw
        if 0 <= ax < len(shape) and shape[ax] % msize == 0:
            spec[ax] = "model"

    # FSDP: shard the largest remaining axis over the data axes, folding
    # 'model' in when tensor parallelism found no home for it and the data
    # shard alone would stay big (>= 128 MiB)
    data_used = any(
        sp is not None and (sp in data_axes or (isinstance(sp, tuple) and any(a in data_axes for a in sp)))
        for sp in spec
    )
    numel = math.prod(shape)
    if data_axes and not data_used and numel >= 1 << 16:
        dsize = _axis_size(mshape, data_axes)
        model_used = any(sp == "model" for sp in spec)
        big_after_data = (numel * 4 / dsize) >= (1 << 27)
        fold_model = (not model_used) and big_after_data
        fsdp_axes = tuple(data_axes) + (("model",) if fold_model else ())
        fsize = _axis_size(mshape, fsdp_axes)
        candidates = [(shape[i], i) for i in range(ndim_offset, len(shape))
                      if spec[i] is None and shape[i] % fsize == 0 and shape[i] >= fsize]
        if not candidates and fold_model:
            fsdp_axes = tuple(data_axes)
            fsize = _axis_size(mshape, fsdp_axes)
            candidates = [(shape[i], i) for i in range(ndim_offset, len(shape))
                          if spec[i] is None and shape[i] % fsize == 0 and shape[i] >= fsize]
        if candidates:
            _, i = max(candidates)
            spec[i] = fsdp_axes if len(fsdp_axes) > 1 else fsdp_axes[0]
    return tuple(spec)


def _walk(tree, fn, keys: tuple = ()):
    """fn(keys, leaf) over a dict/list tree; keys are dict keys and list
    positions from the root."""
    if isinstance(tree, dict):
        return {k: _walk(v, fn, keys + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_walk(v, fn, keys + (i,)) for i, v in enumerate(tree)]
    return None if tree is None else fn(keys, tree)


def _stack_depth(keys: tuple, cfg: ModelConfig) -> Optional[int]:
    """Length of the reference's group stack that holds this leaf, or None
    when the reference keeps it unstacked."""
    if keys[:2] == ("stack", "layers"):
        period = cfg.scan_period()
        return len(range(keys[2] % period, cfg.n_layers, period))
    if keys[:2] == ("encoder", "layers"):
        return cfg.n_enc_layers
    return None


def param_specs(params: Any, cfg: ModelConfig, mesh) -> Any:
    """Spec tree matching the port's params tree (leaves need only .shape)."""
    mshape = collectives.mesh_shape(mesh)
    data_axes = _data_axes(mshape)

    def leaf(keys, p):
        names = tuple(k for k in keys if isinstance(k, str))
        depth = _stack_depth(keys, cfg)
        shape = tuple(p.shape)
        if depth is None:
            return _param_spec(names, shape, mshape, data_axes, False)
        return _param_spec(names, (depth,) + shape, mshape, data_axes, True)[1:]

    return _walk(params, leaf)


# ------------------------------------------------------- everything else


def batch_specs(cfg: ModelConfig, mesh, batch_size: int) -> Dict[str, Spec]:
    mshape = collectives.mesh_shape(mesh)
    data_axes = _data_axes(mshape)
    dsize = _axis_size(mshape, data_axes)
    bspec = data_axes if len(data_axes) > 1 else (data_axes[0] if data_axes else None)
    if batch_size % dsize != 0 or batch_size < dsize:
        bspec = None  # tiny batches stay replicated
    out = {"tokens": (bspec, None), "labels": (bspec, None), "segments": (bspec, None)}
    if cfg.family == "vlm":
        out["patches"] = (bspec, None, None)
    if cfg.family == "encdec":
        out["frames"] = (bspec, None, None)
    return out


def router_state_specs(router_states: Any) -> Any:
    return _walk(router_states, lambda keys, leaf: ())


def batch_layout(cfg: ModelConfig, mesh, batch: Dict[str, Any]) -> Dict[str, Spec]:
    """batch_specs for the entries of `batch`, sized by its row count."""
    specs = batch_specs(cfg, mesh, next(iter(batch.values())).shape[0])
    return {k: specs[k] for k in batch}


def train_state_specs(state, cfg: ModelConfig, mesh):
    """Specs for TrainState(params, opt_state {step, mu, nu}, router_states),
    as a TrainState of the same class as `state`."""
    pspec = param_specs(state.params, cfg, mesh)
    return dataclasses.replace(
        state,
        params=pspec,
        opt_state={"step": (), "mu": pspec, "nu": pspec},
        router_states=router_state_specs(state.router_states),
    )


def cache_specs(cache: Any, cfg: ModelConfig, mesh, batch_size: int) -> Any:
    """Decode-cache specs for the port's per-layer cache ({'layers': [...]},
    leaves (B, ...)): the reference's rule on the (G, B, ...) group stack,
    without its leading axis."""
    mshape = collectives.mesh_shape(mesh)
    data_axes = _data_axes(mshape)
    dsize = _axis_size(mshape, data_axes)
    msize = mshape["model"]
    bspec = data_axes if len(data_axes) > 1 else (data_axes[0] if data_axes else None)
    batch_ok = batch_size % dsize == 0 and batch_size >= dsize

    def leaf_spec(keys, leaf):
        name = keys[-1]
        shape = (1,) + tuple(leaf.shape)  # (G, B, ...): the group axis is never sharded
        spec = [None] * len(shape)
        if len(shape) >= 2 and batch_ok:
            spec[1] = bspec
        if name in ("k", "v", "sk", "sv", "ck", "cv"):
            # (G, B, C, KV, hd): kv heads over model, else head_dim; the
            # length only when the batch cannot carry the data axes
            if shape[3] % msize == 0:
                spec[3] = "model"
            elif len(shape) > 4 and shape[4] % msize == 0:
                spec[4] = "model"
            if not batch_ok and shape[2] % dsize == 0:
                spec[2] = bspec
        elif name == "ssm":
            # (G, B, H, N, P): heads over model if divisible, else state N
            if shape[2] % msize == 0:
                spec[2] = "model"
            elif shape[3] % msize == 0:
                spec[3] = "model"
        elif name == "conv":
            # (G, B, K-1, conv_dim)
            if shape[3] % msize == 0:
                spec[3] = "model"
        return tuple(spec[1:])

    return _walk(cache, leaf_spec)


# ------------------------------------------------------------- placement


def _zip(tree, specs, fn):
    """fn(leaf, spec) over a tree and its spec tree (the tree's structure
    leads: a spec is a tuple, as a list position would be)."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: _zip(getattr(tree, f.name), getattr(specs, f.name), fn)
                                            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: _zip(v, specs[k], fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_zip(v, s, fn) for v, s in zip(tree, specs)]
    if tree is None or not isinstance(tree, torch.Tensor):
        return tree
    return fn(tree, specs)


def _check(x: torch.Tensor, spec: Spec) -> None:
    """A spec may be shorter than the tensor's rank (the trailing
    dimensions are then whole, as with a PartitionSpec), not longer."""
    if len(spec) > x.dim():
        raise ValueError(f"spec {spec} for a tensor of shape {tuple(x.shape)}")


def shard_tree(tree, specs, mesh):
    """This rank's block of every tensor (the counterpart of
    jax.device_put(x, NamedSharding(mesh, spec))): each dimension with
    axes is cut by this rank's coordinate over them. The blocks are new
    contiguous tensors; other leaves (a host step counter) pass through."""
    mshape = collectives.mesh_shape(mesh)

    def cut(x, spec):
        _check(x, spec)
        for dim, entry in enumerate(spec):
            if entry is None:
                continue
            n = _axis_size(mshape, entry)
            if x.shape[dim] % n:
                raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not split {n} ways ({entry})")
            blk = x.shape[dim] // n
            x = x.narrow(dim, collectives.axis_index(entry, mesh) * blk, blk)
        return x.detach().clone(memory_format=torch.contiguous_format)

    return _zip(tree, specs, cut)


@torch.no_grad()
def unshard_tree(tree, specs, mesh):
    """The whole tensors from every rank's blocks (a collective: every rank
    of the mesh calls it, with its own blocks)."""

    def whole(x, spec):
        _check(x, spec)
        for dim, entry in enumerate(spec):
            if entry is not None:
                x = collectives._all_gather(x.contiguous(), collectives.group(entry, mesh), dim)
        return x

    return _zip(tree, specs, whole)


__all__ = [
    "batch_layout",
    "batch_specs",
    "cache_specs",
    "make_mesh_ctx",
    "param_specs",
    "router_state_specs",
    "shard_tree",
    "train_state_specs",
    "unshard_tree",
]
