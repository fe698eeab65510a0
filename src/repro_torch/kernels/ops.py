"""Public wrappers around the port's kernels (model-path entry points).

    bip_dual_update(s, q0, top_k, n_iters)   T ADMM dual iterations on K3
    expert_ffn(x, w_gate, w_up, w_down)      the grouped SwiGLU FFN on K1/K2,
                                             differentiable: its backward is
                                             eight K2 launches over views
"""
from __future__ import annotations

import torch

from repro_torch.core.ref_bip import expert_kth_index
from repro_torch.kernels import bip_admm, moe_gemm

Tensor = torch.Tensor


def bip_dual_update(
    s: Tensor,
    q0: Tensor,
    *,
    top_k: int,
    n_iters: int,
    n_bins: int = 512,
    refine: int = 1,
) -> Tensor:
    """T fused ADMM iterations on the (n, m) score matrix. Returns q (m,).

    A port of the reference's single-device form (src/repro/kernels/ops.py,
    bip_dual_update without axis_names). Each iteration runs one coarse
    histogram pass over [-1, 1] plus `refine` passes over the located bin
    (per-expert bounds), every pass one launch of the K3 kernel; the bin
    location and the interpolation are plain torch, on the device, with no
    host sync. Capacity slack (rank past the column) returns zeros.
    """
    n, m = s.shape
    rank = expert_kth_index(n, top_k, m)
    if rank < 0:  # capacity slack: the constraint never binds
        return torch.zeros_like(q0)
    q = q0.float()
    for _ in range(n_iters):
        lo = torch.full((m,), bip_admm.LO, dtype=torch.float32, device=s.device)
        hi = torch.full((m,), bip_admm.HI, dtype=torch.float32, device=s.device)
        for _pass in range(refine + 1):
            _p, cnt = bip_admm.bip_admm_iteration(
                s, q, top_k=top_k, n_bins=n_bins, lo=lo, hi=hi
            )
            cur_lo, cur_hi = lo, hi  # the bounds this cnt was computed over
            bin_lo, bin_hi, found = bip_admm.locate_bin(cnt, rank, n_bins, lo, hi)
            lo = torch.where(found, bin_lo, lo)
            hi = torch.where(found, bin_hi, hi)
        q = bip_admm.q_from_histogram(cnt, rank, n_bins, lo=cur_lo, hi=cur_hi)
    return q


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
