"""Plain-torch oracles of the kernels' whole functions (ports of
src/repro/kernels/ref.py; the per-kernel plain versions live beside their
kernels in moe_gemm.py and bip_admm.py)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.ref_bip import bip_dual_update as bip_dual_update_exact
from repro_torch.core.ref_bip import kth_largest


def bip_iteration_ref(s, q, *, top_k):
    """p_i = max(0, (k+1)-th largest of s_i - q), the exact order statistic."""
    return torch.clamp_min(kth_largest(s - q[None, :], top_k, dim=-1), 0.0)


def bip_dual_update_ref(s, q0, *, top_k, n_iters):
    """The exact (sort-based) T-iteration dual update; returns q."""
    q, _p = bip_dual_update_exact(s, q0, top_k=top_k, n_iters=n_iters)
    return q


def histogram_counts_ref(s, p, *, n_bins, lo=-1.0, hi=1.0):
    """Per-expert counts of (s_ij - p_i) > edge_b for fixed scalar bounds."""
    shifted = s.float() - p[:, None]
    edges = lo + (hi - lo) * torch.arange(n_bins, dtype=torch.float32, device=s.device) / n_bins
    return (shifted[:, :, None] > edges[None, None, :]).sum(dim=0).float()  # (m, n_bins)


def expert_ffn_ref(x, w_gate, w_up, w_down):
    """Grouped expert FFN oracle: y = (silu(x wg) * (x wu)) wd, all in fp32,
    cast to x's dtype at the end."""
    x32 = x.float()
    g = torch.bmm(x32, w_gate.float())
    u = torch.bmm(x32, w_up.float())
    return torch.bmm(F.silu(g) * u, w_down.float()).to(x.dtype)
