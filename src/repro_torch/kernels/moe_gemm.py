"""Grouped expert-FFN GEMMs: hand-written CUDA kernels and their plain versions.

After dispatch, expert inputs sit in a dense (E, C, D) buffer (C = capacity).
The FFN is two grouped GEMMs with a gated activation between:

    h = silu(x @ w_gate) * (x @ w_up)        kernel: grouped_gated_ffn_in
    y = h @ w_down                           kernel: grouped_matmul

On a CUDA tensor each wrapper launches its kernel from `csrc/moe_gemm.cu`
(compiled with nvcc for sm_90a at first use, loaded through ctypes; see
nvcc.py) or raises; on a CPU tensor it runs the plain PyTorch version in
this module. Both accumulate in fp32 and return the input's dtype (fp32 or
bf16), and every shape is taken as is: no padding of C, D or F.

Operands may be strided views (the expert-FFN backward passes transposed
weights and activations): their strides go to the kernel as they are, with
no copy. A zero stride on an axis longer than one (an expanded operand) is
refused, and so are gate and up weights whose strides differ, because the
gated kernel takes one stride triple for both. The bf16 kernel reads each
operand through a TMA tensor map along whichever of its last two axes has
unit stride (`tma_layout`); a bf16 CUDA operand that TMA cannot describe
(a base address not 16-byte aligned, no unit stride among its last two
axes, or another stride that is not a multiple of 16 bytes) raises
ValueError.

Each wrapper counts its launches in a plain integer attribute
(`grouped_gated_ffn_in.launches`, `grouped_matmul.launches`), so a run can
show that it went through the kernels; `reset_launch_counts()` zeroes them.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import nvcc

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the C entry points' own codes (csrc/moe_gemm.cu)
_RC = {-1: "unsupported dtype", -2: "an operand TMA cannot describe",
       -3: "the driver offers no cuTensorMapEncodeTiled",
       -4: "cuTensorMapEncodeTiled refused a tensor map"}
_TMA_BYTES = 16  # TMA's granule: base address and every non-unit stride

_lib: Optional[ctypes.CDLL] = None


def build() -> ctypes.CDLL:
    """Compile csrc/moe_gemm.cu (once per source content) and load it."""
    global _lib
    if _lib is not None:
        return _lib
    lib = nvcc.build_library("moe_gemm.cu")
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    gemm_args = [i32, p, i64, i64, i64]  # dtype, A and its strides
    lib.moe_gemm_gated_ffn_in.argtypes = (
        gemm_args + [p, p, i64, i64, i64] + [p, i64, i64, i64] + [i32] * 4 + [p]
    )
    lib.moe_gemm_gated_ffn_in.restype = i32
    lib.moe_gemm_matmul.argtypes = (
        gemm_args + [p, i64, i64, i64] + [p, i64, i64, i64] + [i32] * 4 + [p]
    )
    lib.moe_gemm_matmul.restype = i32
    lib.moe_gemm_bf16_smem_bytes.argtypes = [i32]
    lib.moe_gemm_bf16_smem_bytes.restype = i32
    _lib = lib
    return lib


# ------------------------------------------------------------- plain versions


def grouped_gated_ffn_in_plain(x, w_gate, w_up):
    """h[e] = silu(x[e] w_gate[e]) * (x[e] w_up[e]); fp32 math, x's dtype out."""
    x32 = x.float()
    g = torch.bmm(x32, w_gate.float())
    u = torch.bmm(x32, w_up.float())
    return (F.silu(g) * u).to(x.dtype)


def grouped_matmul_plain(h, w):
    """y[e] = h[e] w[e]; fp32 math, h's dtype out."""
    return torch.bmm(h.float(), w.float()).to(h.dtype)


# ------------------------------------------------------------------ wrappers


def _check(name, a, bs, a_dims, b_dims):
    """Dtype, rank, shape, device and stride checks shared by both
    wrappers. `a_dims`/`b_dims` name the axes, e.g. ('E','C','D')."""
    if a.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: dtype {a.dtype} not supported (float32, bfloat16)")
    sizes = {}
    for t, dims, what in [(a, a_dims, "input")] + [(b, b_dims, "weight") for b in bs]:
        if t.dtype != a.dtype:
            raise TypeError(f"{name}: {what} dtype {t.dtype} != {a.dtype}")
        if t.dim() != 3:
            raise ValueError(f"{name}: {what} must be 3-d {dims}, got {tuple(t.shape)}")
        if t.device != a.device:
            raise ValueError(f"{name}: {what} on {t.device}, input on {a.device}")
        if any(st <= 0 and sz > 1 for st, sz in zip(t.stride(), t.shape)):
            raise ValueError(f"{name}: {what} has a zero stride {t.stride()} (expanded)")
        for dim, size in zip(dims, t.shape):
            if sizes.setdefault(dim, size) != size:
                raise ValueError(
                    f"{name}: axis {dim} is {size} here but {sizes[dim]} elsewhere"
                )
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {a.device}")
    return sizes


def _tma_operand(name, what, t, k_axis):
    """How the bf16 kernel reads one 3-d operand: ('K', strides) when its
    reduction axis `k_axis` (1 or 2) has unit stride, ('MN', strides) when
    its other matrix axis has. An axis of size 1 addresses nothing, so it
    may count as the unit-stride one, and is otherwise given a stride TMA
    accepts; the strides returned are the ones to pass. Raises ValueError
    for an operand TMA cannot describe."""
    granule = _TMA_BYTES // t.element_size()
    if t.data_ptr() % _TMA_BYTES:
        raise ValueError(
            f"{name}: {what} starts at an address that is not {_TMA_BYTES}-byte "
            "aligned; the TMA loads need one"
        )
    size, stride = tuple(t.shape), t.stride()
    for inner, major in ((k_axis, "K"), (3 - k_axis, "MN")):
        if size[inner] > 1 and stride[inner] != 1:
            continue
        mid = 3 - inner
        st = [stride[0], 0, 0]
        st[inner] = 1
        st[mid] = stride[mid] if size[mid] > 1 else -(-size[inner] // granule) * granule
        if size[0] == 1:
            st[0] = -(-st[mid] * size[mid] // granule) * granule
        if st[mid] % granule == 0 and st[0] % granule == 0:
            return major, tuple(st)
    raise ValueError(
        f"{name}: {what} of shape {size} and strides {stride} cannot be read by "
        "TMA: one of its last two axes needs unit stride and every other "
        f"stride a multiple of {_TMA_BYTES} bytes ({granule} elements)"
    )


def tma_layout(a, b, name="grouped_matmul"):
    """The layout pair in which the bf16 kernel reads the product
    A (E,M,K) @ B (E,K,N): ('K' or 'MN' for A, the same for B), 'K' when
    the operand's reduction axis has unit stride (K-major) and 'MN' when
    its M or N axis has; then the strides to pass for A and for B. Pure
    Python over shapes, strides and addresses; raises ValueError for an
    operand TMA cannot describe."""
    a_major, sa = _tma_operand(name, "A", a, k_axis=2)
    b_major, sb = _tma_operand(name, "B", b, k_axis=1)
    return (a_major, b_major), sa, sb


def grouped_gated_ffn_in(x, w_gate, w_up):
    """x (E,C,D), w_gate/w_up (E,D,F) -> h (E,C,F) in x's dtype."""
    name = "grouped_gated_ffn_in"
    s = _check(name, x, (w_gate, w_up), "ECD", "EDF")
    if w_gate.stride() != w_up.stride():
        raise ValueError(
            f"{name}: w_gate strides {w_gate.stride()} differ from "
            f"w_up strides {w_up.stride()}"
        )
    if x.device.type == "cpu":
        return grouped_gated_ffn_in_plain(x, w_gate, w_up)
    e, c, d, f = s["E"], s["C"], s["D"], s["F"]
    if 0 in (e, c, d, f):  # nothing to launch: silu(0) * 0 where D == 0
        return torch.zeros((e, c, f), dtype=x.dtype, device=x.device)
    sx, sw = x.stride(), w_gate.stride()
    if x.dtype == torch.bfloat16:
        _, sx, sw = tma_layout(x, w_gate, name)
        _tma_operand(name, "w_up", w_up, k_axis=1)  # its strides are w_gate's
    h = torch.empty((e, c, f), dtype=x.dtype, device=x.device)
    lib = build()
    with torch.cuda.device(x.device):
        rc = lib.moe_gemm_gated_ffn_in(
            _DTYPE_CODE[x.dtype], x.data_ptr(), *sx,
            w_gate.data_ptr(), w_up.data_ptr(), *sw,
            h.data_ptr(), *h.stride(), e, c, f, d,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    nvcc.raise_on(rc, name, _RC)
    grouped_gated_ffn_in.launches += 1
    return h


def grouped_matmul(h, w):
    """h (E,C,F), w (E,F,D) -> y (E,C,D) in h's dtype."""
    name = "grouped_matmul"
    s = _check(name, h, (w,), "ECF", "EFD")
    if h.device.type == "cpu":
        return grouped_matmul_plain(h, w)
    e, c, f, d = s["E"], s["C"], s["F"], s["D"]
    if 0 in (e, c, f, d):  # nothing to launch: an empty sum where F == 0
        return torch.zeros((e, c, d), dtype=h.dtype, device=h.device)
    sh, sw = h.stride(), w.stride()
    if h.dtype == torch.bfloat16:
        _, sh, sw = tma_layout(h, w, name)
    y = torch.empty((e, c, d), dtype=h.dtype, device=h.device)
    lib = build()
    with torch.cuda.device(h.device):
        rc = lib.moe_gemm_matmul(
            _DTYPE_CODE[h.dtype], h.data_ptr(), *sh,
            w.data_ptr(), *sw,
            y.data_ptr(), *y.stride(), e, c, d, f,
            torch.cuda.current_stream(h.device).cuda_stream,
        )
    nvcc.raise_on(rc, name, _RC)
    grouped_matmul.launches += 1
    return y


grouped_gated_ffn_in.launches = 0
grouped_matmul.launches = 0


def reset_launch_counts() -> None:
    grouped_gated_ffn_in.launches = 0
    grouped_matmul.launches = 0


__all__ = [
    "build",
    "grouped_gated_ffn_in",
    "grouped_gated_ffn_in_plain",
    "grouped_matmul",
    "grouped_matmul_plain",
    "reset_launch_counts",
    "tma_layout",
]
