"""Latent Prototype Routing (arxiv 2506.21328): prototype-assignment gating
(port of src/repro/core/lpr.py).

Expert j owns a prototype p_j in the gate-score simplex; selection runs on
the blend of the raw score and the (squared-distance) affinity to p_j, the
per-token constant ‖s_i‖² dropped:

    corrected_ij = (1 − λ) · s_ij + λ · (2 s_i·p_j − ‖p_j‖²),   λ = lpr_blend,

and the prototypes follow their tokens by a gradient-free EMA k-means step:

    p_j ← d · p_j + (1 − d) · mean{ s_i : j ∈ topk(i) },   d = lpr_decay,

empty clusters carried unchanged, masked serving rows excluded from both
sums.

State: the 'q' slot (carried, unused: checkpoints stay strategy-portable)
plus 'proto', an (m, m) leaf starting at the identity. 'proto' is the
port's first 2-D router-state leaf; the layout converters and the npz
checkpoints carry it like any other leaf. The dual watchdog covers 'q'
only: a poisoned prototype matrix would need a reset to the identity, not
to zeros, so 'proto' stays outside guard_keys.
"""
from __future__ import annotations

import torch

from repro_torch.core.balancers import Balancer, one_hot, register_balancer
from repro_torch.distributed import collectives


@register_balancer("lpr")
class LPRBalancer(Balancer):
    """Prototype-assignment gate with an EMA k-means prototype update."""

    # the expert-parallel paths under sync='local' average both carried
    # leaves over the data shards, so 'proto' stays replicated too
    local_avg_keys = ("q", "proto")

    def init_state(self, cfg, device="cpu"):
        state = super().init_state(cfg, device)
        state["proto"] = torch.eye(cfg.n_experts, dtype=cfg.router_dtype, device=device)
        return state

    def score_adjust(self, s, state, cfg, *, token_mask=None, axis_names=(),
                     local_shards=1):
        proto = state["proto"]  # (m, m): row j = prototype of expert j
        affinity = 2.0 * (s @ proto.T) - torch.sum(proto * proto, dim=-1)[None, :]
        lam = cfg.lpr_blend
        return (1.0 - lam) * s + lam * affinity, {}

    def update_state(self, s, idx, state, cfg, *, token_mask=None, axis_names=()):
        onehot = one_hot(idx, s.shape[-1], cfg.router_dtype)  # (n, k, m)
        if token_mask is not None:
            onehot = onehot * token_mask.to(cfg.router_dtype)[:, None, None]
        assign = onehot.sum(dim=1)  # (n, m)
        counts = assign.sum(dim=0)  # (m,)
        sums = assign.T @ s.detach()  # (m, m): sum of s_i over cluster j
        counts = collectives.psum(counts, axis_names)
        sums = collectives.psum(sums, axis_names)
        proto = state["proto"]
        mean = sums / torch.clamp_min(counts, 1.0)[:, None]
        target = torch.where((counts > 0.0)[:, None], mean, proto)
        d = cfg.lpr_decay
        return {"proto": d * proto + (1.0 - d) * target}
