"""Public wrappers around the port's kernels (model-path entry points)."""
from __future__ import annotations

from repro_torch.kernels import moe_gemm


def expert_ffn(x, w_gate, w_up, w_down):
    """Grouped expert FFN, forward only: y = (silu(x wg) * (x wu)) wd.

    x (E,C,D), w_gate/w_up (E,D,F), w_down (E,F,D), all of one dtype. The
    hidden h stays in x's dtype between the two kernels, as in the
    reference pair; C, D and F are taken as they are (no padding).
    """
    h = moe_gemm.grouped_gated_ffn_in(x, w_gate, w_up)
    return moe_gemm.grouped_matmul(h, w_down)

