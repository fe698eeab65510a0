"""Plain-torch oracle of the whole expert FFN (the per-kernel plain versions
live beside their kernels in moe_gemm.py)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def expert_ffn_ref(x, w_gate, w_up, w_down):
    """Grouped expert FFN oracle: y = (silu(x wg) * (x wu)) wd, all in fp32,
    cast to x's dtype at the end."""
    x32 = x.float()
    g = torch.bmm(x32, w_gate.float())
    u = torch.bmm(x32, w_up.float())
    return torch.bmm(F.silu(g) * u, w_down.float()).to(x.dtype)
