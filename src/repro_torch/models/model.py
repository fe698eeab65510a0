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
over the global batch. Serving (init_slot_cache, prefill_chunk) stays on
one device.
"""
from __future__ import annotations

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
from repro_torch.models.stack import MeshCtx

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
            if "moe" in keys and keys[-1] in _EXPERT_LEAVES:
                return leaf  # moe.moe_ffn's paths take the stored blocks
            return collectives.gather_leaf(leaf, spec, mc.mesh, varying)

        def walk(tree, specs, keys):
            if isinstance(tree, dict):
                return {k: walk(v, specs[k], keys + (k,)) for k, v in tree.items()}
            if isinstance(tree, list):
                return [walk(v, sp, keys) for v, sp in zip(tree, specs)]
            return use(tree, specs, keys)

        return walk(params, mc.param_specs, ())

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
        proj = torch.einsum("bsf,fd->bsd", batch["patches"].to(cd), params["frontend_proj"].to(cd))
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
        doc)."""
        cfg = self.cfg
        if self.mesh_ctx.mesh is not None:
            params = self._params_at_use(params)
        x, n_prefix = self._embed_inputs(params, batch)
        enc_out = self._encode(params, batch)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        segments = batch.get("segments") if n_prefix == 0 else None
        if segments is not None and cfg.family in ("ssm", "hybrid"):
            raise ValueError(
                "segment-masked packing (pack_nocross) is attention-only; "
                f"{cfg.family} architectures leak document state through the "
                "mamba recurrence: use pack_mode='pack' or 'pad'"
            )
        x, new_states, aux, mets = stack.apply_stack(
            params["stack"], x, router_states, cfg, positions=positions,
            segments=segments, enc_out=enc_out, mesh_ctx=self.mesh_ctx,
        )
        x = common.rmsnorm(params["final_norm"], x, cfg.rms_norm_eps)
        if n_prefix:
            x = x[:, n_prefix:]
        logits = common.unembed(params["embed"], x, cfg)
        return logits, new_states, aux, mets

    def loss_fn(self, params: Params, batch: Dict[str, Tensor], router_states: list):
        """Masked next-token cross entropy (labels < 0 are ignored) plus the
        balancers' aux loss. Returns (loss, (new router states, metrics))
        with metrics gaining 'ce_loss', 'aux_loss' and 'perplexity'. On a
        mesh with the batch split over data, each rank adds its rows' sum
        over the global count of valid labels, and the psum of those is the
        loss every rank returns (its cotangent reaches each rank's rows
        unchanged)."""
        logits, new_states, aux, mets = self.forward(params, batch, router_states)
        labels = batch["labels"]
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
        loss = ce + aux
        mets = dict(mets)
        mets.update(ce_loss=ce, aux_loss=aux, perplexity=torch.exp(ce))
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
        families only: encdec needs per-request encoder K/V (ValueError)."""
        if self.cfg.n_enc_layers:
            raise ValueError("slot cache: encdec is not supported (its cross K/V are per "
                             "request); serve it through serving.greedy_generate")
        return self._build_cache(params, n_slots, max_seq_len, None)

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

    @staticmethod
    def reset_slot(cache: Params, slot: int) -> Params:
        """Zero one slot's row of every cache leaf (K/V, positions, SSM and
        conv state, the shared block's K/V), in place. The slot is axis 0 of
        each per-layer leaf."""
        for layer in cache["layers"]:
            for leaf in layer.values():
                leaf[slot] = 0
        return cache

    def _apply_layer_chunk(self, p, x, cfg, mixer_kind, ffn_kind, cache, router_state, lengths,
                           shared, packed=None):
        """One layer over a (B, C) token chunk against its cache. `packed`
        (from `_packed_operands`) switches attention to the packed layout;
        column validity then comes from segments >= 0. Returns (x,
        new_cache, new_router_state, load) with load the per-expert dispatch
        counts of this layer's real tokens, or None."""
        valid = None
        if packed is not None:
            valid = packed["segments"] >= 0
        elif lengths is not None:
            valid = torch.arange(x.shape[1], device=x.device)[None, :] < lengths[:, None]
        new_cache = dict(cache)
        if mixer_kind in ("global", "local"):
            xn = common.rmsnorm(p["pre_norm"], x, cfg.rms_norm_eps)
            kv = {"k": cache["k"], "v": cache["v"], "pos": cache["pos"]}
            if packed is None:
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
            h, mcache = mamba2.mamba_chunk(
                p["mamba"], common.rmsnorm(p["pre_norm"], x, cfg.rms_norm_eps),
                {"ssm": cache["ssm"], "conv": cache["conv"]}, cfg, lengths=lengths,
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
            y, router_state, _aux, moe_mets = moe.moe_ffn_local(
                p["moe"], flat, router_state, cfg, token_mask=token_mask
            )
            load = moe_mets["load"]
            x = x + (y.reshape(b, s, d) + stack._residual_mlps(p, xin, cfg))

        if mixer_kind.endswith("+shared"):
            h, sc = common.attention_chunk(
                shared["attn"], common.rmsnorm(shared["pre_norm"], x, cfg.rms_norm_eps),
                {"k": cache["sk"], "v": cache["sv"], "pos": cache["spos"]}, cfg,
                layer_kind="global", lengths=lengths,
            )
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
        interleaved streams."""
        cfg = self.cfg
        if self.mesh_ctx.mesh is not None:
            raise NotImplementedError(
                "serving on a mesh (the engine's mesh=) is the next slice of the port; "
                "a mesh model trains only")
        packed = None
        if segments is not None:
            bad = {k for k, _ in cfg.layer_kinds() if k.replace("+shared", "") not in ("global", "local")}
            if bad:
                raise ValueError(f"packed prefill: attention-only stacks required, got {sorted(bad)}")
            packed = self._packed_operands(cache, positions, segments, write_slots, cache_rows)
        x = common.embed(params["embed"], tokens, cfg)
        shared = params["stack"].get("shared")
        m_load = cfg.routing.n_experts if cfg.is_moe else 1
        load_total = torch.zeros((m_load,), dtype=torch.int64, device=tokens.device)
        vio_max = torch.zeros((), dtype=torch.float32, device=tokens.device)
        new_layers, new_states = [], []
        for (mixer, ffn), p, c, st in zip(
            cfg.layer_kinds(), params["stack"]["layers"], cache["layers"], router_states
        ):
            x, nc, st, ld = self._apply_layer_chunk(p, x, cfg, mixer, ffn, c, st, lengths, shared, packed)
            new_layers.append(nc)
            new_states.append(st)
            load_total, vio_max = _merge_load(load_total, vio_max, ld, m_load)
        x = common.rmsnorm(params["final_norm"], x, cfg.rms_norm_eps)
        logits = common.unembed(params["embed"], x, cfg)
        mets = {"moe_load": load_total, "max_vio": vio_max}
        return logits, {"layers": new_layers}, new_states, mets

    def _packed_operands(self, cache, positions, segments, write_slots, cache_rows):
        """The packed operands of one step, with what every layer shares
        computed once: the write set of each layer kind (global caches and
        rings differ in length) and each cache row's advance."""
        layers = cache["layers"]
        n_rows = layers[0]["k"].shape[0]
        if cache_rows is None:
            cache_rows = torch.arange(segments.shape[0], device=segments.device)
        writes = {}
        for (mixer, _), c in zip(self.cfg.layer_kinds(), layers):
            if mixer not in writes:
                writes[mixer] = common.packed_writes(
                    positions, segments, write_slots, n_rows, c["k"].shape[1], ring=mixer == "local"
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
