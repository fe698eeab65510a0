"""Shared model primitives (port of src/repro/models/common.py): RMSNorm,
RoPE, GQA attention (chunked training attention and attention against a
slot cache), gated MLPs, embeddings.

Functions take the reference's parameter layouts (wq (d,h,hd), wo (h,hd,d),
w_gate (d,f), ...) as plain dicts of tensors. Attention is plain torch, as
the reference's is plain jnp (fully masked rows are zeroed after the
softmax), except where `uses_fused_attention` holds: causal, unsegmented,
global attention over the row indices in bf16 on the card runs K4, the
fused kernel of kernels/flash_attn.py.

The two cached attentions (`attention_chunk`, `_attention_chunk_packed`)
also run on one rank's block of a cache on a device mesh (`KVBlock`): its
columns of the cache length and its slice of head_dim, each reduced over
the mesh axes it is split over (see `_attend_block`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.router import gather_rows
from repro_torch.distributed import collectives
from repro_torch.kernels import flash_attn
from repro_torch.telemetry.trace import cast_span

Tensor = torch.Tensor
Params = Dict[str, Tensor]

NEG_INF = -2.0e38  # large-negative fill that survives bf16 casts


# leaves of more elements are drawn in blocks along their leading axis
SLICE_NUMEL = 1 << 28
_BLOCK_NUMEL = 1 << 26


def _randn(gen: torch.Generator, shape, scale: float, dtype) -> Tensor:
    """Seeded normal init on the generator's device, scaled, in `dtype`.

    A leaf of at most SLICE_NUMEL elements is drawn whole in fp32, then
    scaled and cast. A larger one (arctic's (128, 7168, 4864) expert
    weights, a 257k-row embedding) is written block by block along its
    leading axis into a `dtype` tensor, so no fp32 copy of the whole leaf
    is ever held; it is as seeded, but not the numbers a whole draw gives.
    """
    shape = tuple(shape)
    numel = math.prod(shape)
    if numel <= SLICE_NUMEL:
        return (torch.randn(shape, generator=gen, device=gen.device) * scale).to(dtype)
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    rows = max(1, _BLOCK_NUMEL // (numel // shape[0]))
    for r0 in range(0, shape[0], rows):
        blk = out[r0 : r0 + rows]
        blk.copy_(torch.randn(blk.shape, generator=gen, device=gen.device).mul_(scale))
    return out


def cast_weights(dtype, *ws: Tensor) -> Tuple[Tensor, ...]:
    """The weights of one use site in the compute dtype (`w.to(dtype)` each),
    under the layer span 'model/weight_cast' while a profiler collects. A
    site casts together the weights one block uses (attention's four, an
    MLP's three), so a traced step records one span a block, not a weight."""
    return cast_span("model/weight_cast", dtype, *ws)


def cast_weight(w: Tensor, dtype) -> Tensor:
    """One weight in the compute dtype at its use (`cast_weights`)."""
    return cast_weights(dtype, w)[0]


# ------------------------------------------------------------------ norms


def init_rmsnorm(d: int, dtype, device) -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(params: Params, x: Tensor, eps: float = 1e-6) -> Tensor:
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * params["scale"].float()
    return out.to(dt)


# ------------------------------------------------------------------- rope


def rope_freqs(head_dim: int, theta: float, device=None) -> Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """x: (..., S, H, D); positions broadcastable to (..., S). Rotates the
    split halves (x1, x2) = x[..., :D/2], x[..., D/2:], as the reference."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)
    ang = positions[..., None].float() * freqs  # (..., S, D/2)
    sin, cos = torch.sin(ang)[..., None, :], torch.cos(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -------------------------------------------------------------- attention


def init_attention(gen: torch.Generator, cfg: ModelConfig) -> Params:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    scale = 1.0 / math.sqrt(d)
    p = {
        "wq": _randn(gen, (d, h, hd), scale, cfg.param_dtype),
        "wk": _randn(gen, (d, kv, hd), scale, cfg.param_dtype),
        "wv": _randn(gen, (d, kv, hd), scale, cfg.param_dtype),
        "wo": _randn(gen, (h, hd, d), scale / math.sqrt(2 * cfg.n_layers), cfg.param_dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = init_rmsnorm(hd, cfg.param_dtype, gen.device)
        p["k_norm"] = init_rmsnorm(hd, cfg.param_dtype, gen.device)
    return p


def _attn_weights(q: Tensor, k: Tensor, mask: Tensor, softcap: float) -> Tensor:
    """q (B,Sq,H,D), k (B,Sk,KV,D), mask (B,1|H,Sq,Sk) -> (B,H,Sq,Sk) fp32."""
    groups = q.shape[2] // k.shape[2]
    kq = torch.repeat_interleave(k, groups, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, kq).float()
    logits = logits / math.sqrt(q.shape[-1])
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    logits = torch.where(mask, logits, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    # fully-masked rows (padded chunk columns): zero them out
    return torch.where(mask.any(dim=-1, keepdim=True), w, 0.0)


def _attend(q, k, v, mask, softcap: float, compute_dtype) -> Tensor:
    w = _attn_weights(q, k, mask, softcap)
    groups = q.shape[2] // v.shape[2]
    vq = torch.repeat_interleave(v, groups, dim=2)
    return torch.einsum("bhqk,bkhd->bqhd", w.to(compute_dtype), vq)


@dataclasses.dataclass(frozen=True)
class KVBlock:
    """One rank's block of a layer's K/V cache on a device mesh, along the
    two axes attention reduces over: cache columns col0 .. col0 + n_cols
    of the whole length `cap` and head_dim entries hd0 .. hd0 + n_hd of
    `head_dim`, each with the mesh axes it is split over (() when the rank
    holds it whole). `chunk_keys`: whether this rank attends a ring
    layer's in-chunk keys, which must count once over the length axes
    (their first rank)."""

    cap: int
    col0: int
    n_cols: int
    head_dim: int
    hd0: int
    n_hd: int
    len_axes: Tuple[str, ...] = ()
    hd_axes: Tuple[str, ...] = ()
    chunk_keys: bool = True

    def cut_hd(self, *ts: Tensor):
        return tuple(t[..., self.hd0:self.hd0 + self.n_hd] for t in ts)


def _attend_block(q, k, v, mask, softcap: float, compute_dtype, block: Optional[KVBlock]) -> Tensor:
    """`_attend` on a rank's block (inside collectives.axis_env): q, k, v
    hold the block's head_dim slice and k, v its columns; returns the
    output's head_dim slice. Scores of a split head_dim are psum'd whole
    before the softmax. Over a split length the row max is pmax'd first,
    so each rank's exponentials need no rescaling: one psum each of their
    sums l and the exp-weighted values o (fp32), then o / l. A block whose
    columns are all masked adds exact zeros; a row masked on every rank is
    zero, as `_attn_weights` makes it."""
    if block is None or not (block.len_axes or block.hd_axes):
        return _attend(q, k, v, mask, softcap, compute_dtype)
    groups = q.shape[2] // k.shape[2]
    logits = torch.einsum("bqhd,bkhd->bhqk", q, torch.repeat_interleave(k, groups, dim=2)).float()
    logits = collectives.psum(logits, block.hd_axes) / math.sqrt(block.head_dim)
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    logits = torch.where(mask, logits, NEG_INF)
    vq = torch.repeat_interleave(v, groups, dim=2)
    if not block.len_axes:
        w = torch.where(mask.any(dim=-1, keepdim=True), torch.softmax(logits, dim=-1), 0.0)
        return torch.einsum("bhqk,bkhd->bqhd", w.to(compute_dtype), vq)
    m = collectives.pmax(logits.amax(dim=-1, keepdim=True), block.len_axes)
    p = torch.where(mask, torch.exp(logits - m), 0.0)
    l = collectives.psum(p.sum(dim=-1), block.len_axes).transpose(1, 2)[..., None]  # (B, Q, H, 1)
    o = collectives.psum(torch.einsum("bhqk,bkhd->bqhd", p.to(compute_dtype), vq).float(), block.len_axes)
    return torch.where(l > 0, o / torch.clamp_min(l, 1e-30), 0.0).to(compute_dtype)


def causal_window_mask(q_pos: Tensor, k_pos: Tensor, window: int) -> Tensor:
    """(..., Sq, Sk) bool. window=0 -> plain causal; else sliding window."""
    diff = q_pos[..., :, None] - k_pos[..., None, :]
    mask = diff >= 0
    if window > 0:
        mask = mask & (diff < window)
    return mask


def uses_fused_attention(
    cfg: ModelConfig,
    device,
    *,
    layer_kind: str = "global",
    positions: Optional[Tensor] = None,
    segments: Optional[Tensor] = None,
    causal: bool = True,
) -> bool:
    """Whether `attention` on `device` runs K4 (kernels/flash_attn.py): on
    the card, bf16 compute, causal, no segments, no logit softcap, a global
    layer (no window), positions left None (so they are the row index,
    known without reading a tensor) and a head_dim the kernel takes. Any
    other call keeps the plain chunked path."""
    window = cfg.window_size if layer_kind == "local" else 0
    return (
        torch.device(device).type == "cuda"
        and cfg.compute_dtype == torch.bfloat16
        and causal
        and segments is None
        and cfg.attn_logit_softcap == 0
        and window == 0
        and positions is None
        and cfg.resolved_head_dim in flash_attn.HEAD_DIMS
    )


def attention(
    params: Params,
    x: Tensor,  # (B, S, d)
    cfg: ModelConfig,
    *,
    layer_kind: str = "global",
    positions: Optional[Tensor] = None,  # (1|B, S)
    segments: Optional[Tensor] = None,
    causal: bool = True,
) -> Tensor:
    """Training / prefill attention over whole sequences, single device.

    The reference's layout (common.attention): queries in chunks of
    cfg.attn_chunk (the query axis padded to a chunk multiple with position
    -1), each chunk against all keys with a causal (or sliding-window) mask,
    plain einsums and a masked fp32 softmax, so only one (B, H, chunk, S)
    score block is formed per chunk.

    `segments` (B, S) document ids restrict attention to seg_q == seg_k
    (packed multi-document rows, data/packing.py 'pack_nocross'); padded
    query rows take segment -2, which no key carries, and their fully
    masked rows are zeroed by the softmax, not NaN.

    `positions` None means the row index (the same `arange` is built for
    RoPE); where `uses_fused_attention` holds, the scores are one K4 call
    on q, k and v as they lie instead of the chunk loop.
    """
    s = x.shape[1]
    cd = cfg.compute_dtype
    fused = uses_fused_attention(cfg, x.device, layer_kind=layer_kind, positions=positions,
                                 segments=segments, causal=causal)
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    theta = cfg.rope_theta
    window = 0
    if layer_kind == "local":
        window = cfg.window_size
        if cfg.rope_local_theta:
            theta = cfg.rope_local_theta

    wq, wk, wv, wo = cast_weights(cd, params["wq"], params["wk"], params["wv"], params["wo"])
    q = torch.einsum("bsd,dhk->bshk", x, wq)
    k = torch.einsum("bsd,dhk->bshk", x, wk)
    v = torch.einsum("bsd,dhk->bshk", x, wv)
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q, cfg.rms_norm_eps)
        k = rmsnorm(params["k_norm"], k, cfg.rms_norm_eps)
    q = apply_rope(q, positions, theta)
    k = apply_rope(k, positions, theta)
    if fused:
        return torch.einsum("bshk,hkd->bsd", flash_attn.flash_attention(q, k, v), wo)

    y = attend_chunked(q, k, v, positions, segments, causal=causal, window=window,
                       softcap=cfg.attn_logit_softcap, chunk=min(cfg.attn_chunk, s), compute_dtype=cd)
    return torch.einsum("bshk,hkd->bsd", y, wo)


def attend_chunked(q, k, v, positions, segments, *, causal: bool, window: int, softcap: float,
                   chunk: int, compute_dtype) -> Tensor:
    """The plain path of `attention` after RoPE: q (B,S,H,D) in chunks of
    `chunk` queries (the query axis padded to a chunk multiple with
    position -1) against all of k, v (B,S,KV,D), masked by `positions`
    (1|B, S), `window` and `segments` -> (B,S,H,D)."""
    b, s = q.shape[:2]
    pad = (-s) % chunk
    qpos = positions.expand(b, s)
    segq = None if segments is None else segments.expand(b, s)
    if pad:  # pad the query axis up to a chunk multiple
        q = F.pad(q, (0, 0, 0, 0, 0, pad))
        qpos = F.pad(qpos, (0, pad), value=-1)
        if segq is not None:  # padded query rows get a segment no key carries
            segq = F.pad(segq, (0, pad), value=-2)
    ys = []
    for c0 in range(0, q.shape[1], chunk):
        qi, pi = q[:, c0:c0 + chunk], qpos[:, c0:c0 + chunk]
        if causal:
            mask = causal_window_mask(pi, positions, window)[:, None]  # (B, 1, c, S)
        else:
            mask = (pi >= 0)[:, None, :, None] & torch.ones(
                (1, 1, 1, s), dtype=torch.bool, device=q.device
            )
        if segq is not None:
            si = segq[:, c0:c0 + chunk]
            mask = mask & (si[:, :, None] == segments[:, None, :])[:, None]
        ys.append(_attend(qi, k, v, mask, softcap, compute_dtype))
    return torch.cat(ys, dim=1)[:, :s]


def attention_chunk(
    params: Params,
    x: Tensor,  # (B, C, d)
    cache: Dict[str, Tensor],
    cfg: ModelConfig,
    *,
    layer_kind: str = "global",
    lengths: Optional[Tensor] = None,  # (B,) tokens valid per row (0..C)
    project: bool = True,
    block: Optional[KVBlock] = None,
) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Cached attention advancing each row by `lengths[i]` tokens at once.

    Row i's first lengths[i] columns are real tokens starting at absolute
    position cache['pos'][i]; the rest is padding. The valid columns' K/V
    are written INTO the cache tensors in place (padded columns, and any
    position past the cache, are not written — the reference drops them
    with an out-of-bounds scatter). Global layers attend against the
    updated cache; ring (sliding-window) layers attend against the
    pre-update ring concatenated with the in-chunk keys. Padded output
    columns are garbage and must be masked by the caller. Returns
    (out, {'k', 'v' (the same tensors), 'pos' advanced by lengths});
    `project=False` returns the heads' outputs (B, C, H, hd) before the
    output projection instead of out.

    `block` (on a mesh, inside collectives.axis_env): the cache holds the
    rank's columns and head_dim slice. q and k are rotated whole and then
    cut (RoPE pairs entries i and i + hd/2), a column is written only by
    the rank holding it, and the result is the output's head_dim slice
    (`project` must be False).
    """
    b, c, _ = x.shape
    dev = x.device
    cd = cfg.compute_dtype
    theta = cfg.rope_theta
    window = 0
    if layer_kind == "local":
        window = cfg.window_size
        if cfg.rope_local_theta:
            theta = cfg.rope_local_theta
    if lengths is None:
        lengths = torch.full((b,), c, dtype=torch.int64, device=dev)

    pos0 = cache["pos"]  # (B,)
    cols = torch.arange(c, device=dev)
    q_pos = pos0[:, None] + cols[None, :]  # (B, C)
    valid = cols[None, :] < lengths[:, None]  # (B, C)

    q, k_new, v_new = _project_qkv(params, x, cfg, q_pos, theta, block)
    k_cache, v_cache = cache["k"], cache["v"]
    cap, col0 = (k_cache.shape[1], 0) if block is None else (block.cap, block.col0)
    idx = col0 + torch.arange(k_cache.shape[1], device=dev)[None, :]  # (1, columns held)
    if window > 0:
        if c > cap:
            raise ValueError(f"chunk {c} must fit the ring buffer (window {cap})")
        # ring layers attend against the PRE-update ring plus the in-chunk
        # keys (a bulk write would clobber keys still inside earlier
        # in-chunk queries' windows): build the operands before writing
        prev = pos0 - 1
        k_pos = prev[:, None] - torch.remainder(prev[:, None] - idx, cap)  # (B, cap)
        ring_ok = (
            (k_pos >= 0)[:, None, :]
            & (k_pos[:, None, :] <= q_pos[..., None])
            & (k_pos[:, None, :] > q_pos[..., None] - window)
        )
        chunk_ok = (
            (q_pos[:, None, :] <= q_pos[..., None])
            & (q_pos[:, None, :] > q_pos[..., None] - window)
            & valid[:, None, :]
            & (block is None or block.chunk_keys)
        )
        mask = torch.cat([ring_ok, chunk_ok], dim=-1) & valid[..., None]
        k_att = torch.cat([k_cache.to(cd), k_new], dim=1)
        v_att = torch.cat([v_cache.to(cd), v_new], dim=1)
        write_idx = torch.remainder(q_pos, cap)
    else:
        write_idx = q_pos

    write = valid & (write_idx >= col0) & (write_idx < col0 + k_cache.shape[1]) & (write_idx < cap)
    rows, wcols = torch.nonzero(write, as_tuple=True)
    k_cache[rows, write_idx[rows, wcols] - col0] = k_new[rows, wcols].to(k_cache.dtype)
    v_cache[rows, write_idx[rows, wcols] - col0] = v_new[rows, wcols].to(v_cache.dtype)

    if window == 0:
        mask = (idx[:, None, :] <= q_pos[..., None]) & valid[..., None]  # (B, C, cap)
        k_att, v_att = k_cache.to(cd), v_cache.to(cd)
    mask = mask[:, None]  # (B, 1, C, cap[+C])

    y = _attend_block(q, k_att, v_att, mask, cfg.attn_logit_softcap, cd, block)
    out = torch.einsum("bshk,hkd->bsd", y, params["wo"].to(cd)) if project else y
    return out, {"k": k_cache, "v": v_cache, "pos": pos0 + lengths}


def _project_qkv(params: Params, x: Tensor, cfg: ModelConfig, q_pos: Tensor, theta: float,
                 block: Optional[KVBlock] = None):
    """q, k, v of a chunk's columns at positions q_pos: projected, normed
    (qk_norm) and rotated over the whole head_dim, then cut to `block`'s
    head_dim slice."""
    cd = cfg.compute_dtype
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(cd))
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"].to(cd))
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"].to(cd))
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q, cfg.rms_norm_eps)
        k = rmsnorm(params["k_norm"], k, cfg.rms_norm_eps)
    q, k = apply_rope(q, q_pos, theta), apply_rope(k, q_pos, theta)
    return (q, k, v) if block is None else block.cut_hd(q, k, v)


def _packed_kept(segments: Tensor, write_slots: Tensor, n_rows: int) -> Tensor:
    """(B, C) bool: the real columns of a packed chunk that name a cache row."""
    return (segments >= 0) & (write_slots >= 0) & (write_slots < n_rows)


def packed_writes(
    positions: Tensor, segments: Tensor, write_slots: Tensor, n_rows: int, cap: int, ring: bool,
    block: Optional[KVBlock] = None,
) -> Tuple[Tuple[Tensor, Tensor], Tuple[Tensor, Tensor]]:
    """Where a packed chunk's K/V land in one kind of layer cache:
    ((grid rows, grid cols), (cache rows, cache positions)) of every column
    written. Padding and write_slots < 0 are never written; a global cache
    drops a position past its end (the reference's out-of-bounds scatter),
    a ring wraps it. The set is the same for every layer of a kind, so the
    model builds it once per step: one host sync (the nonzero), not one per
    layer. Written once each, so index_put_ stays deterministic. On a
    mesh (`block`; `cap` is then the whole length) only the columns of the
    rank's block are kept, numbered within it."""
    keep = _packed_kept(segments, write_slots, n_rows)
    if ring:
        dst_pos = torch.remainder(positions, cap)
    else:
        dst_pos = positions
        keep = keep & (positions < cap)
    if block is not None:
        keep = keep & (dst_pos >= block.col0) & (dst_pos < block.col0 + block.n_cols)
        dst_pos = dst_pos - block.col0
    rows, cols = torch.nonzero(keep, as_tuple=True)
    return (rows, cols), (write_slots[rows, cols], dst_pos[rows, cols])


def packed_counts(segments: Tensor, write_slots: Tensor, n_rows: int) -> Tensor:
    """(n_rows,) tokens each cache row advances by in a packed chunk: its
    kept columns, counted on the WRITE row (a spread row advances the
    stream it continues), past-the-end positions included, as the
    reference counts them."""
    keep = _packed_kept(segments, write_slots, n_rows)
    rows = torch.arange(n_rows, device=segments.device)
    return ((write_slots[..., None] == rows) & keep[..., None]).sum(dim=(0, 1))


def _attention_chunk_packed(
    params: Params,
    x: Tensor,  # (B, C, d)
    cache: Dict[str, Tensor],
    cfg: ModelConfig,
    *,
    layer_kind: str,
    positions: Tensor,  # (B, C) absolute position of every column
    segments: Tensor,  # (B, C); -1 = padding
    write_slots: Tensor,  # (B, C) cache row each column writes; -1 drops
    cache_rows: Optional[Tensor],  # (B,) cache row each ROW reads
    writes=None,  # packed_writes(...) for this cache, when the caller has it
    counts: Optional[Tensor] = None,  # packed_counts(...), likewise
    project: bool = True,
    block: Optional[KVBlock] = None,
) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Packed multi-request chunk (the reference's function of this name):
    rows and cache slots decouple, and every column carries (position,
    segment, cache row it writes).

    Segment 0 is the row's RESIDENT stream, the continuation of cache row
    `cache_rows[b]`, attending through the cache as the dense path does.
    Segments >= 1 are FRESH prompts sharing a row: each attends only its own
    in-chunk keys (same row, same segment, causal by position), and still
    writes its K/V into its own slot's row so the next step continues it as
    a resident. Segment -1 is padding: never written, never attended,
    output garbage for the caller to mask.

    Global layers write first, then gather `k[cache_rows]`: a spread row
    (a second row continuing one stream) sees the keys every other row of
    its stream wrote this chunk. Ring layers gather the PRE-update ring and
    attend it beside the in-chunk keys, as the dense path; the engine
    spreads only on all-global stacks. The cache tensors are written in
    place; 'pos' advances by `packed_counts`. `project=False` returns the
    heads' outputs (B, C, H, hd) before the output projection. `block` as
    in `attention_chunk` (`writes` must then be the block's).
    """
    b, c, _ = x.shape
    dev = x.device
    cd = cfg.compute_dtype
    k_cache, v_cache = cache["k"], cache["v"]
    n_rows = k_cache.shape[0]
    cap, col0 = (k_cache.shape[1], 0) if block is None else (block.cap, block.col0)
    theta = cfg.rope_theta
    window = 0
    if layer_kind == "local":
        window = cfg.window_size
        if cfg.rope_local_theta:
            theta = cfg.rope_local_theta
        if c > cap:
            raise ValueError(f"chunk {c} must fit the ring buffer (window {cap})")
    if cache_rows is None:
        cache_rows = torch.arange(b, device=dev)
    if writes is None:
        writes = packed_writes(positions, segments, write_slots, n_rows, cap, ring=window > 0, block=block)
    if counts is None:
        counts = packed_counts(segments, write_slots, n_rows)
    valid = segments >= 0
    q_pos = positions

    q, k_new, v_new = _project_qkv(params, x, cfg, q_pos, theta, block)
    (src_rows, src_cols), (dst_rows, dst_pos) = writes

    def write():
        k_cache[dst_rows, dst_pos] = k_new[src_rows, src_cols].to(k_cache.dtype)
        v_cache[dst_rows, dst_pos] = v_new[src_rows, src_cols].to(v_cache.dtype)

    resident = segments == 0
    same_seg = segments[:, None, :] == segments[:, :, None]  # (B, C, C)
    causal = q_pos[:, None, :] <= q_pos[..., None]  # key column <= query column
    idx = col0 + torch.arange(k_cache.shape[1], device=dev)[None, :]  # (1, columns held)
    pos0 = cache["pos"]
    if window > 0:
        prev = pos0[cache_rows] - 1  # latest position already in the read row's ring
        k_pos = prev[:, None] - torch.remainder(prev[:, None] - idx, cap)  # (B, cap)
        cache_ok = (
            (k_pos >= 0)[:, None, :]
            & (k_pos[:, None, :] <= q_pos[..., None])
            & (k_pos[:, None, :] > q_pos[..., None] - window)
            & resident[..., None]
        )
        chunk_ok = (same_seg & causal & (q_pos[:, None, :] > q_pos[..., None] - window) & valid[:, None, :]
                    & (block is None or block.chunk_keys))
        k_att = torch.cat([k_cache[cache_rows].to(cd), k_new], dim=1)  # gathered before the write
        v_att = torch.cat([v_cache[cache_rows].to(cd), v_new], dim=1)
        write()
    else:
        write()
        cache_ok = (idx[:, None, :] <= q_pos[..., None]) & resident[..., None]
        fresh = segments >= 1
        chunk_ok = same_seg & causal & valid[:, None, :] & fresh[..., None] & (block is None or block.chunk_keys)
        k_att = torch.cat([k_cache[cache_rows].to(cd), k_new], dim=1)  # gathered after the write
        v_att = torch.cat([v_cache[cache_rows].to(cd), v_new], dim=1)
    mask = (torch.cat([cache_ok, chunk_ok], dim=-1) & valid[..., None])[:, None]  # (B, 1, C, cap+C)

    y = _attend_block(q, k_att, v_att, mask, cfg.attn_logit_softcap, cd, block)
    out = torch.einsum("bshk,hkd->bsd", y, params["wo"].to(cd)) if project else y
    return out, {"k": k_cache, "v": v_cache, "pos": pos0 + counts}


def init_attention_cache(
    cfg: ModelConfig, batch: int, seq_len: int, layer_kind: str, dtype, device
) -> Dict[str, Tensor]:
    cap = min(cfg.window_size, seq_len) if layer_kind == "local" else seq_len
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    return {
        "k": torch.zeros((batch, cap, kv, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, cap, kv, hd), dtype=dtype, device=device),
        "pos": torch.zeros((batch,), dtype=torch.int64, device=device),
    }


# -------------------------------------------------------------------- mlp


def init_mlp(gen: torch.Generator, cfg: ModelConfig, d_ff: Optional[int] = None) -> Params:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    return {
        "w_gate": _randn(gen, (d, f), s_in, cfg.param_dtype),
        "w_up": _randn(gen, (d, f), s_in, cfg.param_dtype),
        "w_down": _randn(gen, (f, d), s_out / math.sqrt(2 * cfg.n_layers), cfg.param_dtype),
    }


def _act(cfg: ModelConfig):
    if cfg.act == "silu":
        return F.silu
    return lambda t: F.gelu(t, approximate="tanh")  # jax.nn.gelu's default


def mlp(params: Params, x: Tensor, cfg: ModelConfig) -> Tensor:
    cd = cfg.compute_dtype
    w_gate, w_up, w_down = cast_weights(cd, params["w_gate"], params["w_up"], params["w_down"])
    g = torch.einsum("...d,df->...f", x, w_gate)
    u = torch.einsum("...d,df->...f", x, w_up)
    return torch.einsum("...f,fd->...d", _act(cfg)(g) * u, w_down)


# ------------------------------------------------------------- embeddings


def init_embedding(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Token embeddings 'tok' (vocab, d); untied models also get the head
    'unembed' (d, vocab), as the reference lays them out."""
    scale = 1.0 / math.sqrt(cfg.d_model)
    p = {"tok": _randn(gen, (cfg.vocab_size, cfg.d_model), scale, cfg.param_dtype)}
    if not cfg.tie_embeddings:
        p["unembed"] = _randn(gen, (cfg.d_model, cfg.vocab_size), scale, cfg.param_dtype)
    return p


def embed(params: Params, tokens: Tensor, cfg: ModelConfig) -> Tensor:
    return gather_rows(cast_weight(params["tok"], cfg.compute_dtype), tokens)


def unembed(params: Params, x: Tensor, cfg: ModelConfig) -> Tensor:
    if cfg.tie_embeddings:
        logits = torch.einsum("...d,vd->...v", x, cast_weight(params["tok"], cfg.compute_dtype))
    else:
        logits = torch.einsum("...d,dv->...v", x, cast_weight(params["unembed"], cfg.compute_dtype))
    logits = logits.float()
    if cfg.final_logit_softcap > 0:
        c = cfg.final_logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits
