"""Load-balance measurements from the paper (Section 4.1).

MaxVio_batch = max_j Load_j / mean_load - 1, where Load_j is the number of
tokens matched to expert j in the batch and mean_load = k*n/m.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

Tensor = torch.Tensor


def expert_load(expert_index: Tensor, n_experts: int) -> Tensor:
    """Tokens matched per expert: (..., k) ids -> (m,) int64 counts.
    Out-of-range ids (a sentinel m) are dropped, as the reference drops them."""
    flat = expert_index.reshape(-1).long()
    flat = torch.where((flat >= 0) & (flat < n_experts), flat, n_experts)
    counts = torch.zeros(n_experts + 1, dtype=torch.int64, device=flat.device)
    return counts.scatter_add_(0, flat, torch.ones_like(flat))[:n_experts]


def max_violation(load: Tensor, n_tokens: int, top_k: int) -> Tensor:
    """MaxVio for one batch given the per-expert load vector."""
    mean_load = (n_tokens * top_k) / load.shape[0]
    return load.max() / mean_load - 1.0


def balance_metrics(expert_index: Tensor, n_experts: int, top_k: int) -> Dict[str, Tensor]:
    n = int(np.prod(expert_index.shape[:-1]))
    load = expert_load(expert_index, n_experts)
    mean_load = (n * top_k) / n_experts
    frac = load / torch.clamp_min(load.sum(), 1).float()
    entropy = -torch.sum(frac * torch.log(frac + 1e-9))
    return {
        "load": load,
        "max_vio": load.max() / mean_load - 1.0,
        "min_load_frac": load.min() / mean_load,
        "load_entropy": entropy / np.log(n_experts),  # 1.0 == perfectly uniform
        "dropped_frac_cap1": torch.sum(torch.clamp_min(load - mean_load, 0.0))
        / torch.clamp_min(load.sum(), 1).float(),
    }
