"""K4: fused causal attention, a hand-written CUDA kernel and its plain version.

    o = softmax(q k^T / sqrt(hd), causal) v

q (B, S, H, hd), k and v (B, S, KV, hd) with H a multiple of KV (GQA: query
head h reads kv head h // (H // KV)); o (B, S, H, hd) in q's dtype. The
queries are the row indices 0..S-1 and so are the keys: no positions, no
segments, no window, no softcap (models/common.py `uses_fused_attention`
says when the model's attention takes this path).

On a CUDA tensor `flash_attention` launches the kernels of
`csrc/flash_attn.cu` (compiled with nvcc for sm_90a at first use, loaded
through ctypes; see nvcc.py) or raises on what they do not take: another
dtype than bf16, a head_dim outside HEAD_DIMS, a last axis that is not
unit-stride, another stride or a base address off the 16-byte grain of the
kernels' copies. It never falls back. Its gradient is a
`torch.autograd.Function` whose backward is kernels too (a pre-pass for
rowsum(dO * O), then dK/dV over key tiles, then dQ over query tiles, no
atomics); it saves q, k, v, o and the fp32 log-sum-exp, no (S, S) tensor.
On a CPU tensor it runs `flash_attention_plain`, the masked softmax over
the whole sequence with fp32 scores, differentiated by autograd.

Launches are counted in plain integers: `flash_attention.launches` (the
forward kernel) and `flash_attention.bwd_launches` (one per backward: the
three kernels of one gradient); `reset_launch_counts()` zeroes them.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import nvcc

HEAD_DIMS = (64, 128)  # head dims the kernels take (one tile shape, per-hd operand staging)
TILE = 64  # query and key rows of a tile; lse rows are padded to a multiple
_GRAIN = 16  # bytes: cp.async's copy unit, so every stride and the base
# the C entry points' own codes (csrc/flash_attn.cu)
_RC = {-1: "unsupported head_dim", -2: "unsupported shape"}

_lib: Optional[ctypes.CDLL] = None


def build() -> ctypes.CDLL:
    """Compile csrc/flash_attn.cu (once per source content) and load it."""
    global _lib
    if _lib is not None:
        return _lib
    lib = nvcc.build_library("flash_attn.cu")
    p, i64, i32, f32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
    operand = [p, i64, i64, i64]  # pointer, batch, sequence and head strides
    lib.flash_attn_fwd.argtypes = [i32] + operand * 4 + [p] + [i32] * 4 + [f32, p]
    lib.flash_attn_fwd.restype = i32
    lib.flash_attn_bwd.argtypes = [i32] + operand * 5 + [p, p] + operand * 3 + [i32] * 4 + [f32, p]
    lib.flash_attn_bwd.restype = i32
    lib.flash_attn_smem_bytes.argtypes = [i32, i32]
    lib.flash_attn_smem_bytes.restype = i32
    _lib = lib
    return lib


# ------------------------------------------------------------- plain version


def flash_attention_plain(q, k, v) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse): the causal softmax over the whole sequence with fp32 scores
    scaled by 1/sqrt(hd), the weights rounded to q's dtype before the PV
    einsum (as models/common.py `_attend` rounds them), and the fp32
    log-sum-exp of each row (B, H, S)."""
    s, groups = q.shape[1], q.shape[2] // k.shape[2]
    kq = torch.repeat_interleave(k, groups, dim=2)
    vq = torch.repeat_interleave(v, groups, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kq.float()) / math.sqrt(q.shape[-1])
    causal = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    logits = logits.masked_fill(~causal, float("-inf"))
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w.to(q.dtype), vq), torch.logsumexp(logits, dim=-1)


# ------------------------------------------------------------------ wrapper


def _check(q, k, v) -> None:
    name = "flash_attention"
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{name}: q, k, v must be 4-d (B, S, heads, head_dim)")
    b, s, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[1] != s or k.shape[3] != d:
        raise ValueError(f"{name}: k {tuple(k.shape)} and v {tuple(v.shape)} do not match q {tuple(q.shape)}")
    if k.shape[2] == 0 or h % k.shape[2]:
        raise ValueError(f"{name}: {h} query heads are not a multiple of {k.shape[2]} kv heads")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"{name}: q on {q.device}, k on {k.device}, v on {v.device}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {q.device}")


def _on_grain(t) -> bool:
    """Unit stride on head_dim, the other strides and the base address on
    the 16-byte grain of the kernels' copies."""
    grain = _GRAIN // t.element_size()
    return t.stride(-1) == 1 and not any(st % grain for st in t.stride()[:3]) and not t.data_ptr() % _GRAIN


def _check_cuda(*ts) -> None:
    """What the kernels read: bf16, a head_dim of HEAD_DIMS, `_on_grain`."""
    name = "flash_attention"
    for t in ts:
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: dtype {t.dtype} not supported on CUDA (bfloat16)")
        if t.shape[-1] not in HEAD_DIMS:
            raise ValueError(f"{name}: head_dim {t.shape[-1]} not supported (one of {HEAD_DIMS})")
        if not _on_grain(t):
            raise ValueError(
                f"{name}: strides {t.stride()} (or the base address) cannot be read: head_dim needs "
                f"unit stride, every other stride and the base a multiple of {_GRAIN} bytes"
            )


def _launch_args(t):
    return (t.data_ptr(), *t.stride()[:3])


def _forward(q, k, v):
    """The forward kernel on checked CUDA tensors: (o, lse) with lse (B, H,
    S rounded up to TILE) fp32, its first S columns the rows' log-sum-exp
    (which the tests and chip_smoke.py read here)."""
    b, s, h, d = q.shape
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((b, h, -(-s // TILE) * TILE), dtype=torch.float32, device=q.device)
    lib = build()
    with torch.cuda.device(q.device):
        rc = lib.flash_attn_fwd(
            d, *_launch_args(q), *_launch_args(k), *_launch_args(v), *_launch_args(o), lse.data_ptr(),
            b, s, h, k.shape[2], 1.0 / math.sqrt(d), torch.cuda.current_stream(q.device).cuda_stream,
        )
    nvcc.raise_on(rc, "flash_attention", _RC)
    flash_attention.launches += 1
    return o, lse


def _backward(q, k, v, o, lse, do):
    b, s, h, d = q.shape
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    delta = torch.empty_like(lse)
    lib = build()
    with torch.cuda.device(q.device):
        rc = lib.flash_attn_bwd(
            d, *_launch_args(q), *_launch_args(k), *_launch_args(v), *_launch_args(o), *_launch_args(do),
            lse.data_ptr(), delta.data_ptr(), *_launch_args(dq), *_launch_args(dk), *_launch_args(dv),
            b, s, h, k.shape[2], 1.0 / math.sqrt(d), torch.cuda.current_stream(q.device).cuda_stream,
        )
    nvcc.raise_on(rc, "flash_attention backward", _RC)
    flash_attention.bwd_launches += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v):
        o, lse = _forward(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.to(q.dtype)
        if not _on_grain(do):  # an expanded or permuted gradient: read a copy
            do = do.contiguous()
        return _backward(q, k, v, o, lse, do)


def flash_attention(q, k, v):
    """Causal attention of q (B, S, H, hd) over k, v (B, S, KV, hd) -> o
    (B, S, H, hd) in q's dtype, differentiable. CUDA: the K4 kernels (bf16
    only); CPU: `flash_attention_plain`."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v)[0]
    _check_cuda(q, k, v)
    return _FlashAttention.apply(q, k, v)


flash_attention.launches = 0
flash_attention.bwd_launches = 0


def reset_launch_counts() -> None:
    flash_attention.launches = 0
    flash_attention.bwd_launches = 0


__all__ = [
    "HEAD_DIMS",
    "build",
    "flash_attention",
    "flash_attention_plain",
    "reset_launch_counts",
]
