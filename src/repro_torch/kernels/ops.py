"""Public wrappers around the port's kernels (model-path entry points).

    bip_dual_update(s, q0, top_k, n_iters)   T ADMM dual iterations: one K3
                                             launch (bip_admm.py); with
                                             axis_names its collective form
    expert_ffn(x, w_gate, w_up, w_down)      the grouped SwiGLU FFN on K1/K2,
                                             differentiable: its backward is
                                             eight K2 launches over views
"""
from __future__ import annotations

import torch

from repro_torch.kernels import moe_gemm
from repro_torch.kernels.bip_admm import bip_dual_update  # noqa: F401  (re-exported)

Tensor = torch.Tensor


class _ExpertFFN(torch.autograd.Function):
    """y = (silu(x wg) * (x wu)) wd with the reference's custom VJP
    (src/repro/kernels/ops.py, _expert_ffn_vjp): the forward is K1 then K2
    and keeps only its inputs; the backward recomputes the gate and up
    pre-activations and writes every dgrad and wgrad as a K2 launch over
    transposed views (strided, no copies). The SwiGLU derivative is plain
    elementwise torch, as it is plain jnp in the reference."""

    @staticmethod
    def forward(ctx, x, w_gate, w_up, w_down):
        ctx.save_for_backward(x, w_gate, w_up, w_down)
        h = moe_gemm.grouped_gated_ffn_in(x, w_gate, w_up)
        return moe_gemm.grouped_matmul(h, w_down)

    @staticmethod
    def backward(ctx, dy):
        x, wg, wu, wd = ctx.saved_tensors
        mm = moe_gemm.grouped_matmul
        t = lambda a: a.transpose(-1, -2)  # noqa: E731
        dy = dy.to(x.dtype).contiguous()  # an expanded grad (stride 0) is refused
        g = mm(x, wg)
        u = mm(x, wu)
        gf, uf = g.float(), u.float()
        sg = torch.sigmoid(gf)
        silu = gf * sg
        h = (silu * uf).to(x.dtype)
        dh = mm(dy, t(wd))
        dwd = mm(t(h), dy)
        dhf = dh.float()
        dg = (dhf * uf * (sg * (1.0 + gf * (1.0 - sg)))).to(x.dtype)
        du = (dhf * silu).to(x.dtype)
        dx = mm(dg, t(wg)) + mm(du, t(wu))
        dwg = mm(t(x), dg)
        dwu = mm(t(x), du)
        return dx, dwg, dwu, dwd


def expert_ffn(x, w_gate, w_up, w_down):
    """Grouped expert FFN y = (silu(x wg) * (x wu)) wd, differentiable.

    x (E,C,D), w_gate/w_up (E,D,F), w_down (E,F,D), all of one dtype. The
    hidden h stays in x's dtype between the two kernels, as in the
    reference pair; C, D and F are taken as they are (no padding). Eight K2
    launches per backward: the two recomputed pre-activations, dh, dw_down,
    the two halves of dx, dw_gate and dw_up.
    """
    return _ExpertFFN.apply(x, w_gate, w_up, w_down)
