"""Top-level model (port of src/repro/models/model.py): embeddings +
attention/MoE stack + tied head, for training over whole sequences and for
serving chunk by chunk against a slot cache.

    Model(cfg, device)                          device defaults to "cuda"
    init(seed)                               -> params
    init_router_states()                     -> per-layer router states
    forward(params, batch, states)           -> (logits, states, aux, mets)
    loss_fn(params, batch, states)           -> (loss, (states, mets))
    init_slot_cache(params, n_slots, max_len)-> {'layers': [{'k','v','pos'}]}
    reset_slot(cache, slot)                  -> cache (zeroed in place)
    prefill_chunk(params, tokens, cache, states, lengths)
                                             -> (logits, cache, states, mets)
    decode_step(params, tokens, cache, states) -> (logits, cache, states)

Parameters, router states and caches are per layer, in layer order (the
reference scans stacked groups). The cache is updated in place: each step
writes its K/V rows into the slot tensors instead of copying the cache.
Attention-only decoder families run; cross-attention, mamba layers, the
zamba2 shared block and the packed multi-request prefill (`segments=` of
`prefill_chunk`) raise NotImplementedError; packed training batches
(`segments` in the batch of `forward`) run.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import common, moe, stack

Tensor = torch.Tensor
Params = Dict[str, Any]


def _merge_load(load_total, vio_max, ld, m_load):
    """Fold one MoE layer's dispatch counts into the running (total load,
    worst per-layer MaxVio) pair."""
    if ld is None:
        return load_total, vio_max
    mean = torch.clamp_min(ld.sum() / m_load, 1e-9)
    return load_total + ld, torch.maximum(vio_max, ld.max() / mean - 1.0)


class Model:
    def __init__(self, cfg: ModelConfig, device="cuda"):
        cfg.validate()
        stack.check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)

    # ------------------------------------------------------------- init

    def init(self, seed: int = 0) -> Params:
        """Seeded random parameters with the reference's shapes and scales.
        (Not the reference's numbers: jax.random and torch.Generator draw
        different streams; `convert.params_from_numpy` carries those over.)"""
        cfg = self.cfg
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return {
            "embed": common.init_embedding(gen, cfg),
            "stack": stack.init_stack(gen, cfg),
            "final_norm": common.init_rmsnorm(cfg.d_model, cfg.param_dtype, self.device),
        }

    def init_router_states(self) -> list:
        return stack.init_stack_router_states(self.cfg, self.device)

    # ---------------------------------------------------------- training

    def forward(
        self, params: Params, batch: Dict[str, Tensor], router_states: list
    ) -> Tuple[Tensor, list, Tensor, Dict[str, Tensor]]:
        """Whole-sequence forward of batch['tokens'] (B, S) int64. Returns
        (logits (B, S, vocab) fp32, new router states, aux loss, metrics)
        with the stack's '<key>_per_layer' columns. A packed real-text batch
        carries batch['segments'] (B, S) document ids: attention then stays
        within each document (routing does not: expert capacity is contested
        across the whole batch, as in the reference)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        x = common.embed(params["embed"], tokens, cfg)
        positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
        x, new_states, aux, mets = stack.apply_stack(
            params["stack"], x, router_states, cfg, positions=positions,
            segments=batch.get("segments"),
        )
        x = common.rmsnorm(params["final_norm"], x, cfg.rms_norm_eps)
        logits = common.unembed(params["embed"], x, cfg)
        return logits, new_states, aux, mets

    def loss_fn(self, params: Params, batch: Dict[str, Tensor], router_states: list):
        """Masked next-token cross entropy (labels < 0 are ignored) plus the
        balancers' aux loss. Returns (loss, (new router states, metrics))
        with metrics gaining 'ce_loss', 'aux_loss' and 'perplexity'."""
        logits, new_states, aux, mets = self.forward(params, batch, router_states)
        labels = batch["labels"]
        valid = labels >= 0
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, torch.clamp_min(labels, 0)[..., None])[..., 0]
        nll = torch.where(valid, nll, torch.zeros_like(nll))
        ce = torch.sum(nll) / torch.clamp_min(valid.sum(), 1).float()
        loss = ce + aux
        mets = dict(mets)
        mets.update(ce_loss=ce, aux_loss=aux, perplexity=torch.exp(ce))
        return loss, (new_states, mets)

    # ---------------------------------------------------------- serving

    def init_slot_cache(self, params: Params, n_slots: int, max_seq_len: int) -> Params:
        """Slot-pool cache for the continuous-batching engine: one cache row
        per batch slot, recycled across requests via `reset_slot`."""
        cfg = self.cfg
        return {
            "layers": [
                common.init_attention_cache(
                    cfg, n_slots, max_seq_len, mixer, cfg.compute_dtype, self.device
                )
                for mixer, _ in cfg.layer_kinds()
            ]
        }

    @staticmethod
    def reset_slot(cache: Params, slot: int) -> Params:
        """Zero one slot's row of every cache leaf (K/V and positions), in
        place. The slot is axis 0 of each per-layer leaf."""
        for layer in cache["layers"]:
            for leaf in layer.values():
                leaf[slot] = 0
        return cache

    def _apply_layer_chunk(self, p, x, cfg, mixer_kind, ffn_kind, cache, router_state, lengths):
        """One layer over a (B, C) token chunk against the slot cache.
        Returns (x, new_cache, new_router_state, load) with load the
        per-expert dispatch counts of this layer's real tokens, or None."""
        valid = None
        if lengths is not None:
            valid = torch.arange(x.shape[1], device=x.device)[None, :] < lengths[:, None]
        h, new_cache = common.attention_chunk(
            p["attn"],
            common.rmsnorm(p["pre_norm"], x, cfg.rms_norm_eps),
            cache,
            cfg,
            layer_kind=mixer_kind,
            lengths=lengths,
        )
        x = x + stack._maybe_post(p, "post_attn_norm", h, cfg)

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
            h = y.reshape(b, s, d)
            if cfg.n_shared_experts and "shared_mlp" in p:
                h = h + common.mlp(p["shared_mlp"], xin, cfg)
            x = x + h
        return x, new_cache, router_state, load

    def prefill_chunk(
        self,
        params: Params,
        tokens: Tensor,  # (B, C) int64
        cache: Params,
        router_states: list,
        lengths: Optional[Tensor] = None,  # (B,) valid counts; None = all C
        *,
        segments: Optional[Tensor] = None,
        **packed,
    ) -> Tuple[Tensor, Params, list, Dict[str, Tensor]]:
        """Advance every slot by up to C tokens in one step: prefilling slots
        carry their next <=C prompt tokens, decoding slots 1 sampled token,
        idle slots 0. Returns (logits (B, C, vocab) fp32, cache, router
        states, metrics) with metrics['moe_load'] the per-expert dispatch
        counts of real tokens summed over MoE layers and metrics['max_vio']
        the worst per-layer violation. Padded logit columns are garbage."""
        if segments is not None or packed:
            raise NotImplementedError("packed multi-request prefill is not ported yet")
        cfg = self.cfg
        x = common.embed(params["embed"], tokens, cfg)
        m_load = cfg.routing.n_experts if cfg.is_moe else 1
        load_total = torch.zeros((m_load,), dtype=torch.int64, device=tokens.device)
        vio_max = torch.zeros((), dtype=torch.float32, device=tokens.device)
        new_layers, new_states = [], []
        for (mixer, ffn), p, c, st in zip(
            cfg.layer_kinds(), params["stack"]["layers"], cache["layers"], router_states
        ):
            x, nc, st, ld = self._apply_layer_chunk(p, x, cfg, mixer, ffn, c, st, lengths)
            new_layers.append(nc)
            new_states.append(st)
            load_total, vio_max = _merge_load(load_total, vio_max, ld, m_load)
        x = common.rmsnorm(params["final_norm"], x, cfg.rms_norm_eps)
        logits = common.unembed(params["embed"], x, cfg)
        mets = {"moe_load": load_total, "max_vio": vio_max}
        return logits, {"layers": new_layers}, new_states, mets

    def decode_step(self, params, tokens, cache, router_states):
        """One token for every sequence in the batch (prefill_chunk, C=1)."""
        logits, cache, states, _ = self.prefill_chunk(params, tokens, cache, router_states)
        return logits, cache, states

