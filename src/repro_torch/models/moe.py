"""Mixture-of-Experts FFN with BIP-balanced routing and expert parallelism
(port of src/repro/models/moe.py).

* `moe_ffn_local`: one device, the semantic reference of the mesh paths.
* `moe_ffn_ep`, `moe_ffn_ep2d`, `moe_ffn_ep2ds`: the bodies of the
  reference's shard_map blocks, run by every rank of a (data, model) mesh
  on its local shards with the collectives written out
  (distributed.collectives). Tokens arrive split over the data axes and
  the same on every rank of the model axis; experts are split over
  'model'. `ep` routes the rank's tokens and gathers each expert's hidden
  f over data at use; `ep2d` all-gathers the tokens over data and uses the
  weights as stored (f split over data); `ep2ds` packs the rank's tokens
  first and all-gathers only the (m_loc, cap, d) buffers. Each combines by
  a psum over 'model' (and, for the 2-D paths, a reduce-scatter over data).
* `moe_ffn` picks one by cfg.routing.moe_impl ('auto' -> ep2ds, as the
  reference) when the MeshCtx has a model axis, else the local path.

Capacity: C = ceil(k·n/m · capacity_factor); tokens beyond capacity are
dropped (contribute zero), standard MoE practice. Each path takes n from
its own token count: ep and ep2ds the rank's, ep2d the whole batch's.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import get_balancer, make_dispatch_plan, route
from repro_torch.core.types import RouterConfig
from repro_torch.distributed import collectives as C
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models.common import _act, _randn, cast_weights
from repro_torch.telemetry.trace import named_span

Tensor = torch.Tensor
Params = Dict[str, Tensor]


def router_config(cfg: ModelConfig, data_axes: Tuple[str, ...] = ()) -> RouterConfig:
    """RouterConfig for this model — one conversion point (RoutingSpec shim)."""
    return cfg.routing.to_router_config(data_axes=data_axes)


def _state_specs(router_state):
    """Replicated spec for every router-state leaf: the reference's
    P(None) tree, built from the live state so new keys need no spec."""
    return {k: (None,) for k in router_state}


# Above this many tokens per invocation the reference finds gathering
# activations (ep2d) dearer than gathering weight shards (ep); carried over
# as the reference has it ('auto' picks ep2ds at every size).
EP2D_TOKEN_THRESHOLD = 32768


def expert_capacity(n_tokens: int, cfg: ModelConfig) -> int:
    r = cfg.routing
    return max(int(math.ceil(r.top_k * n_tokens / r.n_experts * r.capacity_factor)), 1)


def init_moe(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """The router over all n_experts; the weights of the experts held here
    (cfg.n_experts_held, all of them unless the config says fewer)."""
    d = cfg.d_model
    f = cfg.moe_d_ff or cfg.d_ff
    m, held = cfg.routing.n_experts, cfg.n_experts_held
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    return {
        "w_router": _randn(gen, (d, m), s_in, torch.float32),
        "w_gate": _randn(gen, (held, d, f), s_in, cfg.param_dtype),
        "w_up": _randn(gen, (held, d, f), s_in, cfg.param_dtype),
        "w_down": _randn(gen, (held, f, d), s_out / math.sqrt(2 * cfg.n_layers), cfg.param_dtype),
    }


def _expert_ffn(w_gate, w_up, w_down, xb, cfg: ModelConfig) -> Tensor:
    """Expert FFN over the packed (e, c, d) buffer. With routing.use_kernel
    (or routing.ffn_kernel, where set) and SwiGLU it runs the CUDA kernel
    pair; the fp32 expert weights are cast to the compute dtype on every
    call, as the reference does."""
    dt = cfg.compute_dtype
    r = cfg.routing
    if (r.use_kernel if r.ffn_kernel is None else r.ffn_kernel) and cfg.act == "silu":
        return kernel_ops.expert_ffn(xb.to(dt), *cast_weights(dt, w_gate, w_up, w_down))
    w_gate, w_up, w_down = cast_weights(dt, w_gate, w_up, w_down)
    g = torch.einsum("ecd,edf->ecf", xb, w_gate)
    u = torch.einsum("ecd,edf->ecf", xb, w_up)
    return torch.einsum("ecf,efd->ecd", _act(cfg)(g) * u, w_down)


def moe_ffn_local(
    params: Params,
    x: Tensor,  # (n, d) flattened tokens
    router_state: Dict[str, Tensor],
    cfg: ModelConfig,
    token_mask: Optional[Tensor] = None,  # (n,) bool
    expert_offset: int = 0,
) -> Tuple[Tensor, Dict[str, Tensor], Tensor, Dict[str, Tensor]]:
    """Single-device MoE FFN. Returns (y, new_router_state, aux_loss, metrics).

    The router scores all n_experts; the expert weights in `params` are
    those of experts expert_offset .. expert_offset + E - 1 (E their
    leading axis: all of them, or the share cfg.experts_held of one device
    of an expert-parallel deployment, which runs here without its
    exchange). Only those are packed and computed, and y is their part of
    the layer's output; the capacity is the whole layer's.

    With a token mask the balance metrics count the real tokens only: the
    load is the dispatch plan's segment counts (masked rows excluded).
    """
    n, d = x.shape
    m = cfg.routing.n_experts
    held = params["w_gate"].shape[0]
    cap = expert_capacity(n, cfg)
    rcfg = router_config(cfg)

    logits = torch.einsum("nd,dm->nm", x.float(), params["w_router"])
    out = route(logits, router_state, rcfg, token_mask=token_mask)
    with named_span("moe/dispatch"):
        plan = make_dispatch_plan(out.expert_index, m, cap, token_mask)
        buf = plan.pack(x, expert_offset=expert_offset, n_local=held)  # (held, cap, d)
    with named_span("moe/gemm"):
        y = _expert_ffn(params["w_gate"], params["w_up"], params["w_down"], buf, cfg)
    with named_span("moe/combine"):
        y_tok = plan.combine(y, out.combine_weights, expert_offset=expert_offset)

    mets = out.metrics
    if token_mask is not None:
        load = plan.counts
        mean_load = torch.clamp_min(token_mask.sum() * cfg.routing.top_k / m, 1e-9)
        mets = dict(mets)
        mets.update(load=load, max_vio=load.max() / mean_load - 1.0)
    return y_tok, out.state, out.aux_loss, mets


def moe_ffn(params, x, router_state, cfg, mesh_ctx=None, token_mask=None):
    """The configured implementation: an expert-parallel path when the
    MeshCtx has a model axis (moe_impl 'auto' -> ep2ds), else the local one.
    On a mesh, `x` and `token_mask` are this rank's rows of the data-split
    batch (mesh_ctx.tokens_sharded) or the whole replicated batch."""
    if mesh_ctx is not None and mesh_ctx.use_ep:
        if cfg.n_experts_held != cfg.routing.n_experts:
            raise ValueError("experts_held is one device's share of a layer; on a mesh the "
                             "expert-parallel paths split the experts themselves")
        impl_name = cfg.routing.moe_impl
        if impl_name == "auto":
            impl_name = "ep2ds"
        impl = {"ep2d": moe_ffn_ep2d, "ep2ds": moe_ffn_ep2ds, "ep": moe_ffn_ep}[impl_name]
        return impl(params, x, router_state, cfg, mesh_ctx.mesh, data_axes=mesh_ctx.data_axes,
                    model_axis=mesh_ctx.model_axis, token_mask=token_mask,
                    tokens_sharded=mesh_ctx.tokens_sharded)
    return moe_ffn_local(params, x, router_state, cfg, token_mask=token_mask)


# ------------------------------------------------------ expert parallel
#
# Every path below is one rank's share of the reference's shard_map block.
# params: 'w_router' whole; 'w_gate'/'w_up' (m_loc, d, f_blk) and 'w_down'
# (m_loc, f_blk, d) this rank's blocks as distributed.param_specs lays them
# out: experts over the model axis, f over the data axes where it splits
# (f_blk = f / n_data), else whole. Gradients follow shard_map's transposes
# (see distributed.collectives): the rank's tokens feed its own experts
# through pvary over 'model' (their cotangent is summed over the expert
# owners), the combine weights likewise, and the psum over 'model' that
# completes y passes its cotangent through unchanged.


def _data_size(mesh, data_axes) -> int:
    return C.axis_size(data_axes, mesh) if data_axes else 1


def _f_split_at_rest(f: int, n_data: int) -> bool:
    """param_specs splits an expert's f over the data axes when it divides."""
    return n_data > 1 and f % n_data == 0 and f >= n_data


def _expert_weights(params, data_axes, *, split_at_rest: bool, keep_split: bool, varying: bool):
    """The expert weights as a path uses them: the stored blocks when the
    path keeps f split, else whole f, gathered over data from a split block
    (backward: reduce-scatter when the tokens differ over data, the block
    when they do not) or, from a replicated block, used as it is (pvary:
    its gradient summed over data when the tokens differ there)."""
    out = []
    for name, f_dim in (("w_gate", 2), ("w_up", 2), ("w_down", 1)):
        w = params[name]
        if keep_split:
            out.append(w)
        elif split_at_rest:
            out.append(C.all_gather(w, data_axes, axis=f_dim, invariant=not varying))
        elif varying:
            out.append(C.pvary(w, data_axes))
        else:
            out.append(w)
    return out


def _rows(t: Optional[Tensor], data_axes):
    """This rank's rows of a replicated batch (no gradient for a mask)."""
    return None if t is None else C.shard_rows(t, data_axes)


def _router_weight(params, data_axes, tokens_sharded: bool) -> Tensor:
    """The router weight as a path that routes the rank's rows uses it.
    Where those rows are the rank's cut of a batch replicated over data,
    the work varies over data only inside this layer, so the weight is
    pvary'd there (its gradient summed over the data ranks, shard_map's
    transpose); a data-split batch's sum happens where the model gathers
    the leaf (Model._params_at_use)."""
    w = params["w_router"]
    return C.pvary(w, data_axes) if data_axes and not tokens_sharded else w


def _mets(load, mean_load, dropped):
    return {"load": load, "max_vio": load.max() / mean_load - 1.0, "dropped_frac_cap1": dropped}


def moe_ffn_ep(params, x, router_state, cfg, mesh, *, data_axes, model_axis, token_mask=None,
               tokens_sharded=True):
    """Expert-parallel path: each rank routes its own tokens (capacity from
    its own count), packs the slots of the experts it owns, runs them with
    f gathered over data, and the outputs meet in a psum over 'model'. A
    batch too small to split over data is routed whole on every rank."""
    m, k = cfg.routing.n_experts, cfg.routing.top_k
    f = cfg.moe_d_ff or cfg.d_ff
    rest_axes = tuple(data_axes)
    n_rest = _data_size(mesh, rest_axes)
    n_in = x.shape[0]
    n_global = n_in * n_rest if tokens_sharded else n_in
    with C.axis_env(mesh):
        if n_global % n_rest != 0 or n_global < n_rest:
            data_axes = ()  # tiny token counts: replicated over the data axes
        n_data = _data_size(mesh, data_axes)
        ep = C.axis_size(model_axis)
        if m % ep:
            raise ValueError(f"{m} experts do not split over {ep} model ranks")
        m_loc = m // ep
        n_loc = n_global // n_data
        cap = expert_capacity(n_loc, cfg)
        rcfg = router_config(cfg, data_axes=data_axes if cfg.routing.sync == "global" else ())
        if data_axes and not tokens_sharded:
            x_loc, mask_loc = C.shard_rows(x, data_axes), _rows(token_mask, data_axes)
        else:
            x_loc, mask_loc = x, token_mask
        w_gate, w_up, w_down = _expert_weights(
            params, rest_axes, split_at_rest=_f_split_at_rest(f, n_rest), keep_split=False,
            varying=bool(data_axes))
        offset = C.axis_index(model_axis) * m_loc

        logits = torch.einsum("nd,dm->nm", x_loc.float(), _router_weight(params, data_axes, tokens_sharded))
        out = route(logits, router_state, rcfg, token_mask=mask_loc)
        plan = make_dispatch_plan(out.expert_index, m, cap, mask_loc)
        buf = plan.pack(C.pvary(x_loc, model_axis), expert_offset=offset, n_local=m_loc)
        y = _expert_ffn(w_gate, w_up, w_down, buf, cfg)
        y_tok = plan.combine(y, C.pvary(out.combine_weights, model_axis), expert_offset=offset)
        y_tok = C.psum(y_tok, model_axis)

        # sync='global': the duals converged identically on every shard;
        # 'local': the carried leaves of the balancer are averaged
        new_state = out.state
        if data_axes and cfg.routing.sync != "global":
            new_state = dict(out.state)
            for key in get_balancer(cfg.routing.strategy).local_avg_keys:
                new_state[key] = C.pmean(out.state[key], data_axes)
        load = plan.counts if mask_loc is not None else out.metrics["load"]
        n_real = None if mask_loc is None else mask_loc.sum(dtype=torch.int64)
        dropped, aux = out.metrics["dropped_frac_cap1"], out.aux_loss
        if data_axes:
            load = C.psum(load, data_axes)
            dropped = C.pmean(dropped, data_axes)
            aux = C.pmean(aux, data_axes)
            if n_real is not None:
                n_real = C.psum(n_real, data_axes)
        mean_load = (n_global * k) / m if n_real is None else torch.clamp_min(n_real * k / m, 1e-9)
        if data_axes and not tokens_sharded:
            y_tok = C.all_gather(y_tok, data_axes, invariant=True)
        return y_tok, new_state, aux, _mets(load, mean_load, dropped)


def moe_ffn_ep2d(params, x, router_state, cfg, mesh, *, data_axes, model_axis, token_mask=None,
                 tokens_sharded=True):
    """2-D expert parallelism: the tokens are all-gathered over data, every
    rank routes the whole batch (capacity from the global count; the duals
    are global under either sync mode) and runs its (m_loc, f_loc) weight
    block on every token; the combine is a psum over 'model' and a
    reduce-scatter over data, or a slice when f is not split."""
    m, k = cfg.routing.n_experts, cfg.routing.top_k
    f = cfg.moe_d_ff or cfg.d_ff
    n_data = _data_size(mesh, data_axes)
    n_in = x.shape[0]
    n_global = n_in * n_data if tokens_sharded else n_in
    token_sharded = n_data > 1 and n_global % n_data == 0 and n_global >= n_data
    with C.axis_env(mesh):
        ep = C.axis_size(model_axis)
        if m % ep:
            raise ValueError(f"{m} experts do not split over {ep} model ranks")
        m_loc = m // ep
        f_shards = n_data if (token_sharded and f % n_data == 0) else 1
        cap = expert_capacity(n_global, cfg)
        # no data axes: routing sees the gathered batch, so the duals are
        # the whole batch's under either sync mode
        rcfg = router_config(cfg)
        if token_sharded:
            x_loc = x if tokens_sharded else C.shard_rows(x, data_axes)
            mask_loc = token_mask if tokens_sharded else _rows(token_mask, data_axes)
            x_all = C.all_gather(x_loc, data_axes)
            mask_all = None if mask_loc is None else C.all_gather(mask_loc, data_axes)
        else:
            x_all, mask_all = x, token_mask
        w_gate, w_up, w_down = _expert_weights(
            params, data_axes, split_at_rest=_f_split_at_rest(f, n_data), keep_split=f_shards > 1,
            varying=token_sharded)
        offset = C.axis_index(model_axis) * m_loc

        logits = torch.einsum("nd,dm->nm", x_all.float(), params["w_router"])
        out = route(logits, router_state, rcfg, token_mask=mask_all)
        plan = make_dispatch_plan(out.expert_index, m, cap, mask_all)
        buf = plan.pack(C.pvary(x_all, model_axis), expert_offset=offset, n_local=m_loc)
        y = _expert_ffn(w_gate, w_up, w_down, buf, cfg)  # partial over f when f is split
        y_tok = plan.combine(y, C.pvary(out.combine_weights, model_axis), expert_offset=offset)
        y_tok = C.psum(y_tok, model_axis)
        if token_sharded:
            if f_shards > 1:
                y_tok = C.psum_scatter(y_tok, data_axes)
            else:
                n_loc = n_global // n_data
                y_tok = y_tok.narrow(0, C.axis_index(data_axes) * n_loc, n_loc)
            if not tokens_sharded:
                y_tok = C.all_gather(y_tok, data_axes, invariant=True)

        # every data rank routed the same gathered batch, so the state, the
        # loads and the drop share are already equal across them (the
        # reference's pmeans and psum // n re-establish that for its type
        # checker; here they would only round). aux is averaged all the
        # same: its gradient must count the batch once, not once per rank
        load = plan.counts if mask_all is not None else out.metrics["load"]
        aux = C.pmean(out.aux_loss, data_axes) if token_sharded else out.aux_loss
        if mask_all is not None:
            mean_load = torch.clamp_min(mask_all.sum(dtype=torch.int64) * k / m, 1e-9)
        else:
            mean_load = (n_global * k) / m
        return y_tok, out.state, aux, _mets(load, mean_load, out.metrics["dropped_frac_cap1"])


def moe_ffn_ep2ds(params, x, router_state, cfg, mesh, *, data_axes, model_axis, token_mask=None,
                  tokens_sharded=True):
    """Selective 2-D expert parallelism: each rank routes and packs its own
    tokens (capacity from its own count), and only the (m_loc, cap, d)
    buffers are all-gathered over data along the capacity axis; the expert
    outputs come back by one reduce-scatter over data (which also sums the
    f partials) and a psum over 'model'. Falls back to ep2d where the
    tokens do not split over data."""
    m, k = cfg.routing.n_experts, cfg.routing.top_k
    f = cfg.moe_d_ff or cfg.d_ff
    n_data = _data_size(mesh, data_axes)
    n_in = x.shape[0]
    n_global = n_in * n_data if tokens_sharded else n_in
    if not (n_data > 1 and n_global % n_data == 0 and n_global >= n_data):
        return moe_ffn_ep2d(params, x, router_state, cfg, mesh, data_axes=data_axes,
                            model_axis=model_axis, token_mask=token_mask, tokens_sharded=tokens_sharded)
    with C.axis_env(mesh):
        ep = C.axis_size(model_axis)
        if m % ep:
            raise ValueError(f"{m} experts do not split over {ep} model ranks")
        m_loc = m // ep
        n_loc = n_global // n_data
        cap = expert_capacity(n_loc, cfg)
        f_sharded = f % n_data == 0
        # sync='global': route() runs the psum'd dual update over the data
        # axes, so each rank routes its shard against the whole batch's duals
        rcfg = router_config(cfg, data_axes=data_axes if cfg.routing.sync == "global" else ())
        if tokens_sharded:
            x_loc, mask_loc = x, token_mask
        else:
            x_loc, mask_loc = C.shard_rows(x, data_axes), _rows(token_mask, data_axes)
        w_gate, w_up, w_down = _expert_weights(
            params, data_axes, split_at_rest=_f_split_at_rest(f, n_data), keep_split=f_sharded,
            varying=True)
        offset = C.axis_index(model_axis) * m_loc

        logits = torch.einsum("nd,dm->nm", x_loc.float(), _router_weight(params, data_axes, tokens_sharded))
        out = route(logits, router_state, rcfg, token_mask=mask_loc)
        plan = make_dispatch_plan(out.expert_index, m, cap, mask_loc)
        buf = plan.pack(C.pvary(x_loc, model_axis), expert_offset=offset, n_local=m_loc)
        # only dispatched tokens cross the data axis: (m_loc, n_data * cap, d)
        buf_all = C.all_gather(buf, data_axes, axis=1)
        y = _expert_ffn(w_gate, w_up, w_down, buf_all, cfg)
        if f_sharded:  # sum the f partials and hand every rank its own slots
            y = C.psum_scatter(y, data_axes, scatter_dimension=1)
        else:  # y is complete: this rank's slice of the gathered axis
            y = y.narrow(1, C.axis_index(data_axes) * cap, cap)
        y_tok = plan.combine(y, C.pvary(out.combine_weights, model_axis), expert_offset=offset)
        y_tok = C.psum(y_tok, model_axis)

        if cfg.routing.sync == "global":
            new_state = out.state
        else:
            new_state = dict(out.state)
            for key in get_balancer(cfg.routing.strategy).local_avg_keys:
                new_state[key] = C.pmean(out.state[key], data_axes)
        if mask_loc is not None:
            load = C.psum(plan.counts, data_axes)
            n_real = C.psum(mask_loc.sum(dtype=torch.int64), data_axes)
            mean_load = torch.clamp_min(n_real * k / m, 1e-9)
        else:
            load = C.psum(out.metrics["load"], data_axes)
            mean_load = (n_global * k) / m
        dropped = C.pmean(out.metrics["dropped_frac_cap1"], data_axes)
        aux = C.pmean(out.aux_loss, data_axes)
        if not tokens_sharded:
            y_tok = C.all_gather(y_tok, data_axes, invariant=True)
        return y_tok, new_state, aux, _mets(load, mean_load, dropped)


__all__ = [
    "EP2D_TOKEN_THRESHOLD",
    "expert_capacity",
    "init_moe",
    "moe_ffn",
    "moe_ffn_ep",
    "moe_ffn_ep2d",
    "moe_ffn_ep2ds",
    "moe_ffn_local",
    "router_config",
]
