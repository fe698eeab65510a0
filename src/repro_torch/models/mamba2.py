"""Mamba2 / SSD (state-space duality) block [arXiv:2405.21060] (port of
src/repro/models/mamba2.py; plain torch there as plain jnp in the
reference, which runs no Pallas kernel here).

The selective state-space recurrence per head h with state size N, head
dim P:

    S_t = exp(dt_t·A_h) · S_{t-1} + B_t ⊗ (dt_t·x_t)      S in R^{N x P}
    y_t = C_t · S_t + D_h · x_t

with A_h < 0 a learned scalar per head, B_t, C_t in R^N shared across the
heads of a group, dt_t > 0 per head via softplus.

`ssd_chunked` is the chunked SSD algorithm: within a chunk of Q steps the
output is a masked quadratic form; across chunks a loop carries the
(H, N, P) state. `ssd_reference` is the step-by-step recurrence, the
oracle. `mamba_chunk` advances a cached state by a (B, C) chunk with
per-row valid lengths (C = 1 is decode).

Block layout (the Mamba2 reference): in_proj -> [z | x | B | C | dt], short
depthwise causal conv over (x, B, C), SSD core, gated RMSNorm, out_proj.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives
from repro_torch.models.common import _randn, cast_weight, cast_weights
from repro_torch.telemetry.trace import layer_span

Tensor = torch.Tensor
Params = Dict[str, Tensor]


def dims(cfg: ModelConfig) -> Dict[str, int]:
    d_inner = cfg.ssm.expand * cfg.d_model
    return {
        "d_inner": d_inner,
        "n_heads": d_inner // cfg.ssm.head_dim,
        "head_dim": cfg.ssm.head_dim,
        "d_state": cfg.ssm.d_state,
        "n_groups": cfg.ssm.n_groups,
        "d_conv": cfg.ssm.d_conv,
        "conv_dim": d_inner + 2 * cfg.ssm.n_groups * cfg.ssm.d_state,
    }


def init_mamba(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """The reference's shapes, dtypes and init scales (A_log, D and dt_bias
    are fp32 whatever the param dtype)."""
    dm = dims(cfg)
    d, pd, dev = cfg.d_model, cfg.param_dtype, gen.device
    di, nh = dm["d_inner"], dm["n_heads"]
    d_in_proj = 2 * di + 2 * dm["n_groups"] * dm["d_state"] + nh
    return {
        "in_proj": _randn(gen, (d, d_in_proj), 1.0 / math.sqrt(d), pd),
        "conv_w": _randn(gen, (dm["d_conv"], dm["conv_dim"]), 0.5, pd),
        "conv_b": torch.zeros((dm["conv_dim"],), dtype=pd, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, device=dev)),
        "D": torch.ones((nh,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((nh,), dtype=torch.float32, device=dev),
        "norm_scale": torch.ones((di,), dtype=pd, device=dev),
        "out_proj": _randn(gen, (di, d), 1.0 / math.sqrt(di) / math.sqrt(2 * cfg.n_layers), pd),
    }


def _split_proj(zxbcdt: Tensor, dm: Dict[str, int]):
    """in_proj's output -> (z, the conv input [x | B | C], dt)."""
    di, ns, ng = dm["d_inner"], dm["d_state"], dm["n_groups"]
    return (
        zxbcdt[..., :di],
        zxbcdt[..., di : di + dm["conv_dim"]],
        zxbcdt[..., 2 * di + 2 * ng * ns :],
    )


def _causal_conv(x: Tensor, w: Tensor, b: Tensor) -> Tensor:
    """Depthwise causal conv. x: (B, S, C), w: (K, C)."""
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    return sum(xp[:, i : i + x.shape[1], :] * w[i] for i in range(k)) + b


def _gated_norm(y: Tensor, z: Tensor, scale: Tensor, eps: float) -> Tensor:
    y = y * F.silu(z.float()).to(y.dtype)
    y32 = y.float()
    var = torch.mean(y32 * y32, dim=-1, keepdim=True)
    return (y32 * torch.rsqrt(var + eps) * scale.float()).to(y.dtype)


def _softplus(x: Tensor) -> Tensor:
    """log(1 + e^x) as jax.nn.softplus computes it (logaddexp(x, 0));
    F.softplus returns x itself above its threshold of 20."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


# ---------------------------------------------------------------- SSD core


def ssd_reference(x, dt, a_log, b, c, d_skip, init_state=None) -> Tuple[Tensor, Tensor]:
    """The step-by-step recurrence, the oracle for ssd_chunked.

    x: (B,S,H,P)  dt: (B,S,H)  a_log: (H,)  b,c: (B,S,G,N)  d_skip: (H,)
    Returns (y (B,S,H,P) in x's dtype, final state (B,H,N,P) fp32). The
    B/C groups broadcast to the heads as jnp.repeat does: group g serves
    heads g*rep .. g*rep + rep - 1 (repeat_interleave, not a tiling).
    """
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    rep = h // g
    a = -torch.exp(a_log.float())
    state = (init_state.float() if init_state is not None
             else torch.zeros((bsz, h, n, p), dtype=torch.float32, device=x.device))
    bs = torch.repeat_interleave(b, rep, dim=2).float()
    cs = torch.repeat_interleave(c, rep, dim=2).float()
    x32, dt32 = x.float(), dt.float()
    ys = []
    for t in range(s):
        dtt = dt32[:, t]  # (B, H)
        decay = torch.exp(dtt * a[None, :])[..., None, None]
        state = state * decay + bs[:, t, :, :, None] * (dtt[..., None] * x32[:, t])[..., None, :]
        ys.append(torch.einsum("bhn,bhnp->bhp", cs[:, t], state))
    y = torch.stack(ys, dim=1) + x32 * d_skip[None, None, :, None]
    return y.to(x.dtype), state


def ssd_chunked(
    x: Tensor,
    dt: Tensor,
    a_log: Tensor,
    b: Tensor,
    c: Tensor,
    d_skip: Tensor,
    chunk: int,
    init_state: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """Chunked SSD. Same contract as ssd_reference, O(S·Q) not O(S²).

    The sequence is padded to a multiple of `chunk` with dt = 0 (an
    identity step). The intra-chunk decay matrix is masked in the LOG
    domain (-1e30 before exp): the anti-causal entries are positive and
    their exp can overflow, and a mask after exp would put inf * 0 into
    the backward pass.
    """
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    rep = h // g
    if s % chunk:
        pad = chunk - s % chunk
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))  # dt = 0 -> identity step
        b = F.pad(b, (0, 0, 0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, 0, 0, pad))
    sp = x.shape[1]
    nc = sp // chunk
    a = -torch.exp(a_log.float())

    la = dt.float() * a[None, None, :]  # (B,S,H) log-decay
    xdt = x.float() * dt.float()[..., None]

    xc = xdt.reshape(bsz, nc, chunk, h, p)
    lac = la.reshape(bsz, nc, chunk, h)
    bc = torch.repeat_interleave(b, rep, dim=2).float().reshape(bsz, nc, chunk, h, n)
    cc = torch.repeat_interleave(c, rep, dim=2).float().reshape(bsz, nc, chunk, h, n)

    csum = torch.cumsum(lac, dim=2)  # (B,nc,Q,H)
    total = csum[:, :, -1]  # (B,nc,H)

    # intra-chunk quadratic part (no carry)
    dmat = csum[:, :, :, None, :] - csum[:, :, None, :, :]  # (B,nc,t,u,H)
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    dmat = torch.where(causal[None, None, :, :, None], dmat, -1e30)
    dexp = torch.exp(dmat)
    cb = torch.einsum("bcthn,bcuhn->bctuh", cc, bc)
    y_intra = torch.einsum("bctuh,bcuhp->bcthp", cb * dexp, xc)

    # per-chunk state increment: sum_u exp(total - cs_u) B_u ⊗ xdt_u
    w_u = torch.exp(total[:, :, None, :] - csum)  # (B,nc,Q,H)
    incr = torch.einsum("bcuhn,bcuhp->bchnp", bc * w_u[..., None], xc)

    st = (init_state.float() if init_state is not None
          else torch.zeros((bsz, h, n, p), dtype=torch.float32, device=x.device))
    y_inter = []
    for ci in range(nc):  # carry the state across chunks, emit the inter-chunk output
        y_inter.append(torch.exp(csum[:, ci])[..., None]
                       * torch.einsum("bthn,bhnp->bthp", cc[:, ci], st))
        st = torch.exp(total[:, ci])[..., None, None] * st + incr[:, ci]
    y = (y_intra + torch.stack(y_inter, dim=1)).reshape(bsz, sp, h, p)[:, :s]
    y = y + x.float()[:, :s] * d_skip[None, None, :, None]
    return y.to(x.dtype), st


def ssd_quadratic_bytes(cfg: ModelConfig, batch: int, seq: int) -> int:
    """Bytes of ONE (B, nc, Q, Q, H) fp32 tensor of `ssd_chunked` for a
    mamba layer of `cfg` over (batch, seq): dmat, dexp, cb and cb * dexp
    each have this size. The forward holds the four at its peak; autograd
    keeps three of them per layer for the backward (dexp, exp's output;
    cb and cb * dexp, the operands of a product), unless the layer is
    rematerialised."""
    dm = dims(cfg)
    q = cfg.ssm.chunk_size
    return 4 * batch * -(-seq // q) * q * q * dm["n_heads"]


# ------------------------------------------------------------- full block


def _ssd_inputs(xbc: Tensor, dt: Tensor, params: Params, dm: Dict[str, int]):
    """Split the conv output into (x, B, C) by head/group and make dt > 0."""
    bsz, s = xbc.shape[:2]
    di, ns, ng = dm["d_inner"], dm["d_state"], dm["n_groups"]
    xs = xbc[..., :di].reshape(bsz, s, dm["n_heads"], dm["head_dim"])
    bs = xbc[..., di : di + ng * ns].reshape(bsz, s, ng, ns)
    cs = xbc[..., di + ng * ns :].reshape(bsz, s, ng, ns)
    return xs, bs, cs, _softplus(dt.float() + params["dt_bias"])


def mamba_block(params: Params, xres: Tensor, cfg: ModelConfig) -> Tensor:
    """Full-sequence mamba2 mixer. xres: (B, S, d) (already normed). The
    SSD core runs as the layer span 'mamba/ssd' (its backward under
    'bwd/mamba/ssd'; telemetry/trace.py)."""
    dm = dims(cfg)
    cd = cfg.compute_dtype
    zxbcdt = torch.einsum("bsd,de->bse", xres, cast_weight(params["in_proj"], cd))
    z, xbc, dt = _split_proj(zxbcdt, dm)
    xbc = F.silu(_causal_conv(xbc, *cast_weights(cd, params["conv_w"], params["conv_b"])))
    xs, bs, cs, dt = _ssd_inputs(xbc, dt, params, dm)
    y, _ = layer_span("mamba/ssd", ssd_chunked, xs, dt, params["A_log"], bs, cs, params["D"],
                      cfg.ssm.chunk_size)
    bsz, s = xres.shape[:2]
    y = _gated_norm(y.reshape(bsz, s, dm["d_inner"]), z, params["norm_scale"], cfg.rms_norm_eps)
    return torch.einsum("bse,ed->bsd", y, cast_weight(params["out_proj"], cd))


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype, device) -> Dict[str, Tensor]:
    dm = dims(cfg)
    return {
        "ssm": torch.zeros((batch, dm["n_heads"], dm["d_state"], dm["head_dim"]),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, dm["d_conv"] - 1, dm["conv_dim"]), dtype=dtype, device=device),
    }


def mamba_chunk(
    params: Params,
    xres: Tensor,  # (B, C, d) (already normed)
    cache: Dict[str, Tensor],
    cfg: ModelConfig,
    *,
    lengths: Optional[Tensor] = None,  # (B,) tokens valid per row (0..C)
    block: Optional[Dict[str, tuple]] = None,
) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Advance the recurrent state by `lengths[i]` tokens per row at once.

    The conv history and SSM state come from the cache, the chunk runs
    through ssd_chunked with `init_state`, and padding is neutralized by
    forcing dt -> 0 there (decay exp(0) = 1, increment dt·x = 0: the state
    is frozen through padded steps). The new conv cache gathers the last
    d_conv - 1 VALID inputs per row (lengths == 0 keeps the old cache).
    The cache tensors are overwritten in place; returns (out, the cache's
    {'ssm', 'conv'}).

    `block` (on a mesh, inside collectives.axis_env): the cache is one
    rank's block, {'rows', 'heads', 'state', 'conv'} each (first, count,
    mesh axes) of the slots, the SSM heads, the state N and the conv
    channels it holds, and 'psum' the axes that split rows, heads or N;
    xres and lengths are the whole grid's. in_proj runs
    on every row; the rank gathers its rows' conv state whole over the
    channel axes (the channels [x | B | C] do not line up with heads), runs
    the conv and the SSD on its rows, heads and N (the skip D·x on the
    first rank of the N axes: y is linear in N), and one psum over the axes
    that split rows, heads or N gives every rank the whole y (zeros where
    it holds nothing) before the gated norm and out_proj. It writes its
    own block of the new state."""
    dm = dims(cfg)
    cd = cfg.compute_dtype
    bsz, c, _ = xres.shape
    dev = xres.device
    if lengths is None:
        lengths = torch.full((bsz,), c, dtype=torch.int64, device=dev)
    valid = torch.arange(c, device=dev)[None, :] < lengths[:, None]  # (B, C)

    zxbcdt = torch.einsum("bsd,de->bse", xres, params["in_proj"].to(cd))
    z, xbc_new, dt = _split_proj(zxbcdt, dm)
    conv_state = cache["conv"]
    if block is not None:
        r0, nr, _ = block["rows"]
        rows = slice(r0, r0 + nr)
        xbc_new, dt, lengths, valid = xbc_new[rows], dt[rows], lengths[rows], valid[rows]
        conv_state = collectives.all_gather(conv_state, block["conv"][2], axis=2)
    n_rows = xbc_new.shape[0]

    kw = dm["d_conv"]
    # (B, kw-1+C, conv_dim): entry (kw-1)+t is the input at chunk offset t
    hist = torch.cat([conv_state, xbc_new.to(conv_state.dtype)], dim=1)
    w = params["conv_w"].to(cd)
    conv_out = sum(hist[:, i : i + c, :].to(cd) * w[i] for i in range(kw)) + params["conv_b"].to(cd)
    xbc = F.silu(conv_out)
    # the last kw-1 valid inputs: hist indices lengths .. lengths+kw-2
    gather_idx = lengths[:, None] + torch.arange(kw - 1, device=dev)[None, :]
    new_conv = hist[torch.arange(n_rows, device=dev)[:, None], gather_idx]

    xs, bs, cs, dt = _ssd_inputs(xbc, dt, params, dm)
    dt = torch.where(valid[..., None], dt, 0.0)  # freeze the state through padding
    a_log, d_skip = params["A_log"], params["D"]
    if block is not None:
        (h0, nh, _), (n0, nn, _), (c0, ncc, _) = block["heads"], block["state"], block["conv"]
        rep = dm["n_heads"] // dm["n_groups"]  # B, C per head (ssd_chunked's repeat), then cut
        bs, cs = (torch.repeat_interleave(t, rep, dim=2)[:, :, h0:h0 + nh, n0:n0 + nn] for t in (bs, cs))
        xs, dt = xs[:, :, h0:h0 + nh], dt[..., h0:h0 + nh]
        a_log, d_skip = a_log[h0:h0 + nh], d_skip[h0:h0 + nh] * float(n0 == 0)
        new_conv = new_conv[..., c0:c0 + ncc]
    y, st = ssd_chunked(xs, dt, a_log, bs, cs, d_skip,
                        chunk=min(cfg.ssm.chunk_size, c), init_state=cache["ssm"])
    if block is not None:
        whole = y.new_zeros((bsz, c, dm["n_heads"], dm["head_dim"]))
        whole[rows, :, h0:h0 + nh] = y
        y = collectives.psum(whole, block["psum"])
    y = _gated_norm(y.reshape(bsz, c, dm["d_inner"]), z, params["norm_scale"], cfg.rms_norm_eps)
    out = torch.einsum("bse,ed->bsd", y, params["out_proj"].to(cd))
    cache["ssm"].copy_(st)
    cache["conv"].copy_(new_conv)
    return out, {"ssm": cache["ssm"], "conv": cache["conv"]}


__all__ = [
    "dims",
    "init_mamba",
    "init_mamba_cache",
    "mamba_block",
    "mamba_chunk",
    "ssd_chunked",
    "ssd_quadratic_bytes",
    "ssd_reference",
]
