"""φ-Balancing (arxiv 2605.15403): a gradient-free multiplicative gate
correction (port of src/repro/core/phi.py).

The carried log-correction φ_j shrinks over-loaded experts' scores by
exp(-φ_j), and each batch integrates the relative load error:

    corrected_ij = s_ij · exp(-φ_j)
    φ_j        += φ_lr · (Load_j / mean_load − 1)
    φ          −= mean(φ)                       (recentring)

Recentring keeps φ bounded without changing a selection (top-k is
invariant to a positive uniform scaling). Gate values stay the raw scores,
so φ receives no gradient. φ lives in the shared 'q' slot ((m,), like the
BIP dual), so checkpoints, layer stacking and the dual watchdog apply
unchanged; masked serving rows are excluded from the histogram.
"""
from __future__ import annotations

import torch

from repro_torch.core.balancers import Balancer, register_balancer, selection_load


@register_balancer("phi")
class PhiBalancer(Balancer):
    """Multiplicative gate correction with an integrating load-error update."""

    def score_adjust(self, s, state, cfg, *, token_mask=None, axis_names=(),
                     local_shards=1):
        return s * torch.exp(-state["q"])[None, :], {}

    def update_state(self, s, idx, state, cfg, *, token_mask=None, axis_names=()):
        load = selection_load(idx, s.shape[-1], cfg.router_dtype, token_mask, axis_names)
        # masked serving chunks can be entirely padding -> zero mean load
        mean_load = torch.clamp_min(load.mean(), 1e-9)
        phi = state["q"] + cfg.phi_lr * (load / mean_load - 1.0)
        return {"q": phi - phi.mean()}
