"""Top-level model (port of src/repro/models/model.py): embeddings, the
decoder stack, an encoder for the encdec family, a projected patch prefix
for the vlm family, and the head (tied or untied), for training over whole
sequences and for serving chunk by chunk against a cache.

    Model(cfg, device)                          device defaults to "cuda"
    init(seed)                               -> params
    init_router_states()                     -> per-layer router states
    forward(params, batch, states)           -> (logits, states, aux, mets)
    loss_fn(params, batch, states)           -> (loss, (states, mets))
    init_cache(params, batch, seq_len)       -> {'layers': [...]} with the
                                                encoder's cross K/V (per request)
    init_slot_cache(params, n_slots, max_len)-> {'layers': [...]} (token families)
    reset_slot(cache, slot)                  -> cache (zeroed in place)
    prefill_chunk(params, tokens, cache, states, lengths)
                                             -> (logits, cache, states, mets)
    decode_step(params, tokens, cache, states) -> (logits, cache, states)

Batch keys by family: all 'tokens' (B, S) int64 (training also 'labels');
vlm 'patches' (B, frontend_tokens, frontend_dim), the SigLIP stub's output;
encdec 'frames' (B, enc_seq_len, frontend_dim), the speech stub's output.

Parameters, router states and caches are per layer, in layer order (the
reference scans stacked groups). A layer's cache holds 'k', 'v', 'pos'
(attention; + 'ck', 'cv' for cross attention), or 'ssm', 'conv' (mamba;
+ 'sk', 'sv', 'spos' for the zamba2 shared block's own K/V at that
depth). The cache is updated in place: each step writes its rows into the
slot tensors instead of copying the cache. As in the reference, serving
embeds tokens only (the vlm patch prefix reaches `forward` alone) and the
slot cache refuses encdec. `prefill_chunk(..., positions=, segments=,
write_slots=, cache_rows=)` takes the packed multi-request layout
(common._attention_chunk_packed) on attention-only stacks.

On a device mesh (`build_model(cfg, mesh_ctx)`, mesh_ctx from
distributed.make_mesh_ctx) the model is one rank's share of an SPMD
program: `params` are this rank's blocks as distributed.param_specs lays
them out (build_model puts that spec tree on the MeshCtx), the batch is
its rows of the global batch (or the whole batch when it does not split
over the data axes: MeshCtx.tokens_sharded False), and
every leaf but the expert weights is all-gathered at use
(collectives.gather_leaf, ZeRO-3: the gradient comes back as this rank's
block, summed over the data ranks). The dense layers then run on every
rank of the model axis alike (no tensor parallelism yet) and the MoE
layers through moe.moe_ffn's expert-parallel paths. The loss is the mean
over the global batch.

Serving on a mesh (init_slot_cache, reset_slot, prefill_chunk; the
engine's mesh=) holds the slot cache as distributed.cache_specs lays it
out: the slots over the data ranks when they divide, else the cache length
(one long request) when it divides, else replicated; KV heads over the
model ranks when they divide, else head_dim, else replicated; the SSM
state's heads, else its state N, and the conv state's channels over the
model ranks where they divide. `_layer_block` reads a rank's block of every
layer from those specs: per cache axis its (first, count) and the mesh
axes it is split over. The expert weights are cut as in training and every
other weight is whole on every rank (`serving_param_specs`: nothing is
gathered at a step). Every rank takes the step's tokens, positions and
cache rows whole (the reference's replicated serving operands): norms,
projections and the dense MLP run on all rows, and the MoE layers through
moe.moe_ffn's expert-parallel paths with the serving token mask (the
replicated-batch case, MeshCtx.tokens_sharded False). Attention runs on
the rows that read the rank's slots, the query heads of its KV heads, its
cache columns and its head_dim slice (common.KVBlock): scores of a split
head_dim are psum'd before the softmax, the columns of a split length are
combined by their row max and sums, and a column is written only by the
rank that holds it. The mamba layers run their SSD on the rank's rows and
SSM heads or N (mamba2.mamba_chunk). What a rank does not compute is zero,
so one psum over the mesh axes that split rows, heads, head_dim or N gives
every rank the whole output, and the output projection follows on all
rows. A replicated axis is reduced over by nothing.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch.overrides import TorchFunctionMode
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives, sharding
from repro_torch.models import common, mamba2, moe, stack
from repro_torch.models.stack import MeshCtx, leaves_of
from repro_torch.telemetry.trace import layer_span

Tensor = torch.Tensor
Params = Dict[str, Any]


def _merge_load(load_total, vio_max, ld, m_load):
    """Fold one MoE layer's dispatch counts into the running (total load,
    worst per-layer MaxVio) pair."""
    if ld is None:
        return load_total, vio_max
    mean = torch.clamp_min(ld.sum() / m_load, 1e-9)
    return load_total + ld, torch.maximum(vio_max, ld.max() / mean - 1.0)


# ------------------------------------------------------------- encoder


def _enc_cfg(cfg: ModelConfig) -> ModelConfig:
    return dataclasses.replace(cfg, n_layers=cfg.n_enc_layers, attn_pattern=("global",))


def _init_encoder(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Bidirectional transformer encoder (encdec family). Its layers are
    the decoder's attention + dense layers, cross-attention leaves included
    (unused, as in the reference's layout)."""
    enc_cfg = _enc_cfg(cfg)
    return {
        "layers": [stack.init_layer(gen, enc_cfg, "global", "dense") for _ in range(cfg.n_enc_layers)],
        "final_norm": common.init_rmsnorm(cfg.d_model, cfg.param_dtype, gen.device),
    }


def _apply_encoder(params: Params, x: Tensor, cfg: ModelConfig) -> Tensor:
    """Non-causal self-attention over frame embeddings, then the final norm.
    Under cfg.remat == "block" each layer is one checkpointed block, as the
    reference's jax.checkpoint of its scanned encoder layer."""
    enc_cfg = _enc_cfg(cfg)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]

    def layer(x: Tensor, lp: Params) -> Tensor:
        x = x + common.attention(lp["attn"], common.rmsnorm(lp["pre_norm"], x, cfg.rms_norm_eps),
                                 enc_cfg, positions=positions, causal=False)
        return x + common.mlp(lp["mlp"], common.rmsnorm(lp["ffn_norm"], x, cfg.rms_norm_eps), enc_cfg)

    for lp in params["layers"]:
        x = checkpoint(layer, x, lp, use_reentrant=False) if cfg.remat == "block" else layer(x, lp)
    return common.rmsnorm(params["final_norm"], x, cfg.rms_norm_eps)


class _OnMeta(TorchFunctionMode):
    """Every tensor factory with a device makes a meta tensor (shape and
    dtype, no storage) and draws nothing."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if "device" in kwargs:
            kwargs["device"] = "meta"
            kwargs.pop("generator", None)
        return func(*args, **kwargs)


def abstract_params(cfg: ModelConfig) -> Params:
    """The params tree of `cfg` as meta tensors: every leaf's shape and
    dtype with no storage (the counterpart of jax.eval_shape(model.init)),
    for the sharding rules at any size."""
    with _OnMeta():
        return Model(cfg, device="cpu").init(0)


_EXPERT_LEAVES = ("w_gate", "w_up", "w_down")
# the leaves the layer spans 'model/embed' and 'model/head' read
_EMBED_KEYS = ("embed", "frontend_proj")
_HEAD_KEYS = ("final_norm", "embed")


def _is_expert_leaf(keys: Tuple[str, ...]) -> bool:
    return "moe" in keys and keys[-1] in _EXPERT_LEAVES


def _map_keyed(tree, specs, fn, keys: Tuple[str, ...] = ()):
    """fn(leaf, spec, dict keys from the root) over a params tree and its
    spec tree."""
    if isinstance(tree, dict):
        return {k: _map_keyed(v, specs[k], fn, keys + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_keyed(v, sp, fn, keys) for v, sp in zip(tree, specs)]
    return fn(tree, specs, keys)


class Model:
    def __init__(self, cfg: ModelConfig, device="cuda", mesh_ctx: Optional[MeshCtx] = None):
        cfg.validate()
        stack.check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh_ctx = mesh_ctx if mesh_ctx is not None else MeshCtx()
        if self.mesh_ctx.mesh is not None and self.mesh_ctx.param_specs is None:
            raise ValueError("a model on a mesh needs its params' layout: build it with "
                             "build_model(cfg, make_mesh_ctx(mesh))")

    # ------------------------------------------------------------- mesh

    def _params_at_use(self, params: Params) -> Params:
        """Every leaf but the expert weights gathered whole from this rank's
        block; its gradient is summed over the data ranks when the batch is
        split over them (the work differs there) and taken as the rank's
        block over the model axis (the dense work is the same there)."""
        mc = self.mesh_ctx
        varying = tuple(mc.data_axes) if mc.tokens_sharded else ()

        def use(leaf, spec, keys):
            if _is_expert_leaf(keys):
                return leaf  # moe.moe_ffn's paths take the stored blocks
            return collectives.gather_leaf(leaf, spec, mc.mesh, varying)

        return _map_keyed(params, mc.param_specs, use)

    def serving_param_specs(self) -> Params:
        """The params' layout for serving on the mesh: the expert leaves cut
        as distributed.param_specs cuts them (moe.moe_ffn's paths take the
        blocks), every other leaf whole on every rank. Serving weights do
        not change, so the dense leaves are held whole once instead of
        gathered at every step."""
        return _map_keyed(self.mesh_ctx.param_specs, self.mesh_ctx.param_specs,
                          lambda spec, _, keys: spec if _is_expert_leaf(keys) else ())

    # ------------------------------------------------------------- init

    def init(self, seed: int = 0) -> Params:
        """Seeded random parameters with the reference's shapes and scales.
        (Not the reference's numbers: jax.random and torch.Generator draw
        different streams; `convert.params_from_numpy` carries those over.)"""
        cfg = self.cfg
        gen = torch.Generator(device=self.device).manual_seed(seed)
        p: Params = {
            "embed": common.init_embedding(gen, cfg),
            "stack": stack.init_stack(gen, cfg),
            "final_norm": common.init_rmsnorm(cfg.d_model, cfg.param_dtype, self.device),
        }
        if cfg.n_enc_layers:
            p["encoder"] = _init_encoder(gen, cfg)
        if cfg.frontend_dim:
            p["frontend_proj"] = common._randn(
                gen, (cfg.frontend_dim, cfg.d_model), 1.0 / math.sqrt(cfg.frontend_dim),
                cfg.param_dtype,
            )
        return p

    def init_router_states(self) -> list:
        return stack.init_stack_router_states(self.cfg, self.device)

    # -------------------------------------------------------- embedding

    def _embed_inputs(self, params: Params, batch: Dict[str, Tensor]) -> Tuple[Tensor, int]:
        """Token embeddings, behind the projected patches for vlm. Returns
        (x, number of prefix positions)."""
        cfg = self.cfg
        x = common.embed(params["embed"], batch["tokens"], cfg)
        if cfg.family != "vlm":
            return x, 0
        cd = cfg.compute_dtype
        proj = torch.einsum("bsf,fd->bsd", batch["patches"].to(cd),
                            common.cast_weight(params["frontend_proj"], cd))
        return torch.cat([proj, x], dim=1), cfg.frontend_tokens

    def _encode(self, params: Params, batch: Dict[str, Tensor]) -> Optional[Tensor]:
        """The encoder's output over the projected frames (encdec), or None."""
        cfg = self.cfg
        if not cfg.n_enc_layers:
            return None
        cd = cfg.compute_dtype
        proj = torch.einsum("bsf,fd->bsd", batch["frames"].to(cd), params["frontend_proj"].to(cd))
        return _apply_encoder(params["encoder"], proj, cfg)

    # ---------------------------------------------------------- training

    def forward(
        self, params: Params, batch: Dict[str, Tensor], router_states: list
    ) -> Tuple[Tensor, list, Tensor, Dict[str, Tensor]]:
        """Whole-sequence forward of batch['tokens'] (B, S) int64. Returns
        (logits (B, S, vocab) fp32, new router states, aux loss, metrics)
        with the stack's '<key>_per_layer' columns; the vlm prefix positions
        are dropped before the head. A packed real-text batch carries
        batch['segments'] (B, S) document ids: attention then stays within
        each document (routing does not: expert capacity is contested across
        the whole batch, as in the reference). Prefix models ignore
        segments; ssm/hybrid models refuse them (ValueError): the mamba
        recurrence would carry state across a document boundary.

        On a mesh, `params` and `batch` are this rank's (see the module
        doc). The embedding and the head run as the layer spans
        'model/embed' and 'model/head' (telemetry/trace.py)."""
        cfg = self.cfg
        if self.mesh_ctx.mesh is not None:
            params = self._params_at_use(params)
        x, n_prefix = layer_span("model/embed", self._embed_inputs, leaves_of(params, _EMBED_KEYS),
                                 batch)
        enc_out = self._encode(params, batch)
        segments = batch.get("segments") if n_prefix == 0 else None
        if segments is not None and cfg.family in ("ssm", "hybrid"):
            raise ValueError(
                "segment-masked packing (pack_nocross) is attention-only; "
                f"{cfg.family} architectures leak document state through the "
                "mamba recurrence: use pack_mode='pack' or 'pad'"
            )
        # positions None: the row index, which attention builds itself and
        # which lets it take the fused kernel without reading a tensor
        x, new_states, aux, mets = stack.apply_stack(
            params["stack"], x, router_states, cfg, positions=None,
            segments=segments, enc_out=enc_out, mesh_ctx=self.mesh_ctx,
        )
        logits = layer_span("model/head", self._head, leaves_of(params, _HEAD_KEYS), x, n_prefix)
        return logits, new_states, aux, mets

    def _head(self, params: Params, x: Tensor, n_prefix: int) -> Tensor:
        """The final norm and the unembedding, past the vlm prefix."""
        x = common.rmsnorm(params["final_norm"], x, self.cfg.rms_norm_eps)
        if n_prefix:
            x = x[:, n_prefix:]
        return common.unembed(params["embed"], x, self.cfg)

    def _loss(self, logits: Tensor, labels: Tensor, aux: Tensor):
        """(loss, ce, perplexity) of the logits against the labels, the aux
        loss added."""
        valid = labels >= 0
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, torch.clamp_min(labels, 0)[..., None])[..., 0]
        nll = torch.where(valid, nll, torch.zeros_like(nll))
        mc = self.mesh_ctx
        if mc.mesh is not None and mc.tokens_sharded and mc.data_axes:
            with collectives.axis_env(mc.mesh):
                n_valid = collectives.psum(valid.sum(), mc.data_axes)
                ce = collectives.psum(torch.sum(nll) / torch.clamp_min(n_valid, 1).float(), mc.data_axes)
        else:
            ce = torch.sum(nll) / torch.clamp_min(valid.sum(), 1).float()
        return ce + aux, ce, torch.exp(ce)

    def loss_fn(self, params: Params, batch: Dict[str, Tensor], router_states: list):
        """Masked next-token cross entropy (labels < 0 are ignored) plus the
        balancers' aux loss. Returns (loss, (new router states, metrics))
        with metrics gaining 'ce_loss', 'aux_loss' and 'perplexity'. On a
        mesh with the batch split over data, each rank adds its rows' sum
        over the global count of valid labels, and the psum of those is the
        loss every rank returns (its cotangent reaches each rank's rows
        unchanged)."""
        logits, new_states, aux, mets = self.forward(params, batch, router_states)
        loss, ce, ppl = layer_span("model/loss", self._loss, logits, batch["labels"], aux)
        mets = dict(mets)
        mets.update(ce_loss=ce, aux_loss=aux, perplexity=ppl)
        return loss, (new_states, mets)

    # ---------------------------------------------------------- serving

    def init_cache(self, params: Params, batch: Dict[str, Tensor], seq_len: int) -> Params:
        """Decode caches for one batch of requests; the cross-attention K/V
        are computed here, once, from the encoder's output over
        batch['frames'] (encdec). Serves any family."""
        with torch.no_grad():
            return self._build_cache(params, batch["tokens"].shape[0], seq_len,
                                     self._encode(params, batch))

    def init_slot_cache(self, params: Params, n_slots: int, max_seq_len: int) -> Params:
        """Slot-pool cache for the continuous-batching engine: one cache row
        per batch slot, recycled across requests via `reset_slot`. Token
        families only: encdec needs per-request encoder K/V (ValueError).
        On a mesh: this rank's block (distributed.cache_specs, kept on
        `slot_specs`), whose place `_layer_block` reads once here for the
        steps that serve it."""
        if self.cfg.n_enc_layers:
            raise ValueError("slot cache: encdec is not supported (its cross K/V are per "
                             "request); serve it through serving.greedy_generate")
        cache = self._build_cache(params, n_slots, max_seq_len, None)
        mesh = self.mesh_ctx.mesh
        if mesh is not None:
            self.slot_specs = sharding.cache_specs(cache, self.cfg, mesh, n_slots)
            self._slot_blocks = [self._layer_block(c, sp)
                                 for c, sp in zip(cache["layers"], self.slot_specs["layers"])]
            cache = sharding.shard_tree(cache, self.slot_specs, mesh)
        return cache

    def _build_cache(self, params: Params, bsz: int, seq_len: int, enc_out) -> Params:
        cfg, dev = self.cfg, self.device
        cd = cfg.compute_dtype
        layers = []
        for (mixer, _), lp in zip(cfg.layer_kinds(), params["stack"]["layers"]):
            if mixer in ("global", "local"):
                c = common.init_attention_cache(cfg, bsz, seq_len, mixer, cd, dev)
                if enc_out is not None:  # per layer: each layer has its own weights
                    c["ck"] = torch.einsum("bsd,dhk->bshk", enc_out, lp["cross"]["wk"].to(cd))
                    c["cv"] = torch.einsum("bsd,dhk->bshk", enc_out, lp["cross"]["wv"].to(cd))
            else:
                c = mamba2.init_mamba_cache(cfg, bsz, cd, dev)
                if mixer.endswith("+shared"):
                    sc = common.init_attention_cache(cfg, bsz, seq_len, "global", cd, dev)
                    c.update(sk=sc["k"], sv=sc["v"], spos=sc["pos"])
            layers.append(c)
        return {"layers": layers}

    def reset_slot(self, cache: Params, slot: int) -> Params:
        """Zero one slot's row of every cache leaf (K/V, positions, SSM and
        conv state, the shared block's K/V), in place. The slot is axis 0 of
        each per-layer leaf; on a mesh every rank whose block holds the
        slot's row zeroes it (one data rank when the slots split, every
        rank when they do not)."""
        if self.mesh_ctx.mesh is not None:
            lo, n, _ = self._slot_blocks[0]["rows"]
            slot -= lo
            if not 0 <= slot < n:
                return cache
        for layer in cache["layers"]:
            for leaf in layer.values():
                leaf[slot] = 0
        return cache

    # ------------------------------------------------ serving on a mesh

    def _dim_block(self, entry, whole: int) -> Tuple[int, int, Tuple[str, ...]]:
        """(first, count, mesh axes) of this rank's block of one cache
        dimension of size `whole` laid out by spec `entry`; (0, whole, ())
        when it is not split."""
        mesh = self.mesh_ctx.mesh
        axes = collectives.spec_axes(entry)
        if not axes:
            return 0, whole, ()
        n = whole // collectives.axis_size(axes, mesh)
        return collectives.axis_index(axes, mesh) * n, n, axes

    def _mesh_axes(self, axes) -> Tuple[str, ...]:
        """`axes` without repeats, in the mesh's order (a psum's group)."""
        return tuple(a for a in collectives.mesh_shape(self.mesh_ctx.mesh) if a in axes)

    def _kv_block(self, k: Tensor, spec, rows) -> Dict[str, Any]:
        """A (B, C, KV, hd) K/V leaf's block: its KV heads and their query
        heads as (first, count), its columns and head_dim slice
        (common.KVBlock) and the axes its outputs are psum'd over."""
        kv0, n_kv, kv_axes = self._dim_block(spec[2], k.shape[2])
        c0, n_c, len_axes = self._dim_block(spec[1], k.shape[1])
        hd0, n_hd, hd_axes = self._dim_block(spec[3], k.shape[3])
        group = self.cfg.n_heads // self.cfg.n_kv_heads
        return {"kv": (kv0, n_kv), "q": (kv0 * group, n_kv * group),
                "block": common.KVBlock(cap=k.shape[1], col0=c0, n_cols=n_c, head_dim=k.shape[3], hd0=hd0,
                                        n_hd=n_hd, len_axes=len_axes, hd_axes=hd_axes, chunk_keys=c0 == 0),
                "psum": self._mesh_axes(rows[2] + kv_axes + hd_axes)}

    def _layer_block(self, c: Params, spec: Params) -> Dict[str, Any]:
        """This rank's block of one layer's whole cache `c` under `spec`:
        'rows' (its slots), 'attn' / 'shared' (its K/V, `_kv_block`),
        'mamba' (its rows, SSM heads, state N and conv channels as
        mamba2.mamba_chunk takes them)."""
        rows = self._dim_block(next(iter(spec.values()))[0], next(iter(c.values())).shape[0])
        blk = {"rows": rows}
        if "k" in c:
            blk["attn"] = self._kv_block(c["k"], spec["k"], rows)
        if "sk" in c:
            blk["shared"] = self._kv_block(c["sk"], spec["sk"], rows)
        if "ssm" in c:
            heads = self._dim_block(spec["ssm"][1], c["ssm"].shape[1])
            state = self._dim_block(spec["ssm"][2], c["ssm"].shape[2])
            blk["mamba"] = {"rows": rows, "heads": heads, "state": state,
                            "conv": self._dim_block(spec["conv"][2], c["conv"].shape[2]),
                            "psum": self._mesh_axes(rows[2] + heads[2] + state[2])}
        return blk

    def _local_packed(self, cache, rows_blk, positions, segments, write_slots, cache_rows):
        """The packed operands of the rows this rank's attention touches:
        the rows that read a slot of its block (`own`) and the rows with a
        column writing into one, with slots renumbered into the block
        (others -1: not written here) and writes kept to its columns."""
        lo, n, _ = rows_blk
        if cache_rows is None:
            cache_rows = torch.arange(segments.shape[0], device=segments.device)
        own = (cache_rows >= lo) & (cache_rows < lo + n)
        here = (write_slots >= lo) & (write_slots < lo + n)
        rows = torch.nonzero(own | here.any(dim=1), as_tuple=True)[0]
        kv_blocks = {}
        for (mixer, _), blk in zip(self.cfg.layer_kinds(), self._slot_blocks):
            kv_blocks.setdefault(mixer, blk["attn"]["block"])
        ops = self._packed_operands(cache, positions[rows], segments[rows],
                                    torch.where(here, write_slots - lo, -1)[rows],
                                    torch.where(own, cache_rows - lo, 0)[rows], kv_blocks)
        ops.update(rows=rows, own=own[rows])
        return ops

    def _attention_on_mesh(self, p, xn, kv, layer_kind, lengths, rows_blk, ablk, loc):
        """Chunk attention of this rank's block (see the module doc):
        `rows_blk` its slots, `ablk` its heads and KVBlock, `loc` the
        step's local packed operands or None; psum'd whole over the axes
        that split something, then the output projection."""
        cfg, mc = self.cfg, self.mesh_ctx
        cd = cfg.compute_dtype
        b, c, _ = xn.shape
        (kv0, n_kv), (q0, n_q), kvb = ablk["kv"], ablk["q"], ablk["block"]
        heads = dict(p, wq=p["wq"][:, q0:q0 + n_q], wk=p["wk"][:, kv0:kv0 + n_kv],
                     wv=p["wv"][:, kv0:kv0 + n_kv])
        with collectives.axis_env(mc.mesh):
            if loc is None:
                lo, n, _ = rows_blk
                rows = slice(lo, lo + n)
                y, new_kv = common.attention_chunk(heads, xn[rows], kv, cfg, layer_kind=layer_kind,
                                                   lengths=None if lengths is None else lengths[rows],
                                                   project=False, block=kvb)
            else:
                rows = loc["rows"]
                ops = {k: v for k, v in loc.items() if k not in ("rows", "own")}
                y, new_kv = common._attention_chunk_packed(
                    heads, xn[rows], kv, cfg, layer_kind=layer_kind, project=False, block=kvb,
                    **dict(ops, writes=ops["writes"][layer_kind]))
                y = torch.where(loc["own"][:, None, None, None], y,
                                torch.zeros((), dtype=y.dtype, device=y.device))
            whole = y.new_zeros((b, c, cfg.n_heads, cfg.resolved_head_dim))
            whole[rows, :, q0:q0 + n_q, kvb.hd0:kvb.hd0 + kvb.n_hd] = y
            whole = collectives.psum(whole, ablk["psum"])
        return torch.einsum("bshk,hkd->bsd", whole, p["wo"].to(cd)), new_kv

    def _apply_layer_chunk(self, p, x, cfg, mixer_kind, ffn_kind, cache, router_state, lengths,
                           shared, packed=None, blk=None):
        """One layer over a (B, C) token chunk against its cache. `packed`
        (from `_packed_operands`) switches attention to the packed layout;
        column validity then comes from segments >= 0. `blk` (on a mesh,
        the layer's `_layer_block` with the step's local packed operands
        under 'packed') sends attention through `_attention_on_mesh`, the
        mamba mixer through its block and the MoE layer through the
        expert-parallel paths. Returns (x, new_cache, new_router_state,
        load) with load the per-expert dispatch counts of this layer's real
        tokens, or None."""
        valid = None
        if packed is not None:
            valid = packed["segments"] >= 0
        elif lengths is not None:
            valid = torch.arange(x.shape[1], device=x.device)[None, :] < lengths[:, None]
        new_cache = dict(cache)
        if mixer_kind in ("global", "local"):
            xn = common.rmsnorm(p["pre_norm"], x, cfg.rms_norm_eps)
            kv = {"k": cache["k"], "v": cache["v"], "pos": cache["pos"]}
            if blk is not None:
                h, attn_cache = self._attention_on_mesh(p["attn"], xn, kv, mixer_kind, lengths, blk["rows"],
                                                        blk["attn"], blk["packed"])
            elif packed is None:
                h, attn_cache = common.attention_chunk(
                    p["attn"], xn, kv, cfg, layer_kind=mixer_kind, lengths=lengths
                )
            else:
                h, attn_cache = common._attention_chunk_packed(
                    p["attn"], xn, kv, cfg, layer_kind=mixer_kind,
                    **dict(packed, writes=packed["writes"][mixer_kind]),
                )
            new_cache.update(attn_cache)
            x = x + stack._maybe_post(p, "post_attn_norm", h, cfg)
            if "ck" in cache:
                x = x + self._cross_chunk(p, x, cache, valid)
        else:
            mblk = None if blk is None else blk["mamba"]
            with collectives.axis_env(self.mesh_ctx.mesh) if mblk else contextlib.nullcontext():
                h, mcache = mamba2.mamba_chunk(
                    p["mamba"], common.rmsnorm(p["pre_norm"], x, cfg.rms_norm_eps),
                    {"ssm": cache["ssm"], "conv": cache["conv"]}, cfg, lengths=lengths, block=mblk,
                )
            new_cache.update(mcache)
            x = x + h

        load = None
        if ffn_kind == "dense":
            h = common.mlp(p["mlp"], common.rmsnorm(p["ffn_norm"], x, cfg.rms_norm_eps), cfg)
            x = x + stack._maybe_post(p, "post_ffn_norm", h, cfg)
        elif ffn_kind == "moe":
            xin = common.rmsnorm(p["ffn_norm"], x, cfg.rms_norm_eps)
            b, s, d = xin.shape
            if valid is None:
                flat = xin.reshape(b * s, d)
                token_mask = None
            else:
                # zero padded rows so they router-score as neutral uniform
                flat = (xin * valid[..., None].to(xin.dtype)).reshape(b * s, d)
                token_mask = valid.reshape(b * s)
            if blk is None:
                y, router_state, _aux, moe_mets = moe.moe_ffn_local(
                    p["moe"], flat, router_state, cfg, token_mask=token_mask)
            else:  # every rank holds the whole chunk: the replicated-batch EP case
                y, router_state, _aux, moe_mets = moe.moe_ffn(
                    p["moe"], flat, router_state, cfg,
                    dataclasses.replace(self.mesh_ctx, tokens_sharded=False), token_mask=token_mask)
            load = moe_mets["load"]
            x = x + (y.reshape(b, s, d) + stack._residual_mlps(p, xin, cfg))

        if mixer_kind.endswith("+shared"):
            xn = common.rmsnorm(shared["pre_norm"], x, cfg.rms_norm_eps)
            kv = {"k": cache["sk"], "v": cache["sv"], "pos": cache["spos"]}
            if blk is None:
                h, sc = common.attention_chunk(shared["attn"], xn, kv, cfg, layer_kind="global", lengths=lengths)
            else:
                h, sc = self._attention_on_mesh(shared["attn"], xn, kv, "global", lengths, blk["rows"],
                                                blk["shared"], None)
            new_cache.update(sk=sc["k"], sv=sc["v"], spos=sc["pos"])
            x = x + h
            x = x + common.mlp(shared["mlp"], common.rmsnorm(shared["ffn_norm"], x, cfg.rms_norm_eps), cfg)
        return x, new_cache, router_state, load

    def _cross_chunk(self, p, x, cache, valid):
        """Cross attention of a chunk's queries against the cached encoder
        K/V; padded query columns are masked (their output is zero)."""
        cfg = self.cfg
        cd = cfg.compute_dtype
        xq = common.rmsnorm(p["cross_norm"], x, cfg.rms_norm_eps)
        q = torch.einsum("bsd,dhk->bshk", xq, p["cross"]["wq"].to(cd))
        b, c, se = x.shape[0], x.shape[1], cache["ck"].shape[1]
        if valid is None:
            mask = torch.ones((1, 1, c, se), dtype=torch.bool, device=x.device)
        else:
            mask = valid[:, None, :, None].expand(b, 1, c, se)
        y = common._attend(q, cache["ck"], cache["cv"], mask, 0.0, cd)
        return torch.einsum("bshk,hkd->bsd", y, p["cross"]["wo"].to(cd))

    def prefill_chunk(
        self,
        params: Params,
        tokens: Tensor,  # (B, C) int64
        cache: Params,
        router_states: list,
        lengths: Optional[Tensor] = None,  # (B,) valid counts; None = all C
        *,
        positions: Optional[Tensor] = None,  # (B, C) packed layout: absolute positions
        segments: Optional[Tensor] = None,  # (B, C); -1 = padding
        write_slots: Optional[Tensor] = None,  # (B, C) cache row each column writes
        cache_rows: Optional[Tensor] = None,  # (B,) cache row each row reads
    ) -> Tuple[Tensor, Params, list, Dict[str, Tensor]]:
        """Advance every slot by up to C tokens in one step: prefilling slots
        carry their next <=C prompt tokens, decoding slots 1 sampled token,
        idle slots 0. Returns (logits (B, C, vocab) fp32, cache, router
        states, metrics) with metrics['moe_load'] the per-expert dispatch
        counts of real tokens summed over MoE layers and metrics['max_vio']
        the worst per-layer violation. Padded logit columns are garbage.

        Passing `segments` switches attention to the PACKED layout
        (common._attention_chunk_packed): rows and cache slots decouple and
        every column carries (position, segment, write slot); `lengths` is
        ignored. Attention-only stacks only (ValueError otherwise): SSM and
        conv state advance strictly left to right per row and cannot host
        interleaved streams.

        On a mesh (see the module doc) `params` are laid out by
        `serving_param_specs` (the expert leaves this rank's blocks, the
        rest whole), `cache` is this rank's block, every other operand is
        whole, and the logits, metrics and router states come back whole on
        every rank."""
        cfg = self.cfg
        if segments is not None:
            bad = {k for k, _ in cfg.layer_kinds() if k.replace("+shared", "") not in ("global", "local")}
            if bad:
                raise ValueError(f"packed prefill: attention-only stacks required, got {sorted(bad)}")
        blocks = [None] * cfg.n_layers
        if self.mesh_ctx.mesh is not None:
            loc = None
            if segments is not None:
                loc = self._local_packed(cache, self._slot_blocks[0]["rows"], positions, segments, write_slots,
                                         cache_rows)
            blocks = [dict(b, packed=loc) for b in self._slot_blocks]
        packed = None
        if segments is not None:
            if self.mesh_ctx.mesh is None:
                packed = self._packed_operands(cache, positions, segments, write_slots, cache_rows)
            else:  # the whole grid's columns, for the MoE layers' token mask
                packed = {"segments": segments}
        x = common.embed(params["embed"], tokens, cfg)
        shared = params["stack"].get("shared")
        m_load = cfg.routing.n_experts if cfg.is_moe else 1
        load_total = torch.zeros((m_load,), dtype=torch.int64, device=tokens.device)
        vio_max = torch.zeros((), dtype=torch.float32, device=tokens.device)
        new_layers, new_states = [], []
        for (mixer, ffn), p, c, st, blk in zip(
            cfg.layer_kinds(), params["stack"]["layers"], cache["layers"], router_states, blocks
        ):
            x, nc, st, ld = self._apply_layer_chunk(p, x, cfg, mixer, ffn, c, st, lengths, shared, packed,
                                                    blk)
            new_layers.append(nc)
            new_states.append(st)
            load_total, vio_max = _merge_load(load_total, vio_max, ld, m_load)
        x = common.rmsnorm(params["final_norm"], x, cfg.rms_norm_eps)
        logits = common.unembed(params["embed"], x, cfg)
        mets = {"moe_load": load_total, "max_vio": vio_max}
        return logits, {"layers": new_layers}, new_states, mets

    def _packed_operands(self, cache, positions, segments, write_slots, cache_rows, kv_blocks=None):
        """The packed operands of one step, with what every layer shares
        computed once: the write set of each layer kind (global caches and
        rings differ in length; on a mesh, the columns of the kind's
        KVBlock in `kv_blocks`) and each cache row's advance."""
        layers = cache["layers"]
        n_rows = layers[0]["k"].shape[0]
        if cache_rows is None:
            cache_rows = torch.arange(segments.shape[0], device=segments.device)
        writes = {}
        for (mixer, _), c in zip(self.cfg.layer_kinds(), layers):
            if mixer not in writes:
                kvb = None if kv_blocks is None else kv_blocks[mixer]
                writes[mixer] = common.packed_writes(
                    positions, segments, write_slots, n_rows, c["k"].shape[1] if kvb is None else kvb.cap,
                    ring=mixer == "local", block=kvb,
                )
        return {"positions": positions, "segments": segments, "write_slots": write_slots,
                "cache_rows": cache_rows, "writes": writes,
                "counts": common.packed_counts(segments, write_slots, n_rows)}

    def decode_step(self, params, tokens, cache, router_states):
        """One token for every sequence in the batch (prefill_chunk, C=1)."""
        logits, cache, states, _ = self.prefill_chunk(params, tokens, cache, router_states)
        return logits, cache, states



def build_model(cfg: ModelConfig, mesh_ctx: MeshCtx = MeshCtx(), device="cuda") -> Model:
    """The model of `cfg`, laid out by `mesh_ctx` (MeshCtx(): one device).
    On a mesh, the spec tree of the params (distributed.param_specs) is
    worked out here, once, and carried on the model's MeshCtx."""
    if mesh_ctx.mesh is not None and mesh_ctx.param_specs is None:
        specs = sharding.param_specs(abstract_params(cfg), cfg, mesh_ctx.mesh)
        mesh_ctx = dataclasses.replace(mesh_ctx, param_specs=specs)
    return Model(cfg, device=device, mesh_ctx=mesh_ctx)
