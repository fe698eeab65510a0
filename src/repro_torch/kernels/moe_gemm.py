"""Grouped expert-FFN GEMMs: hand-written CUDA kernels and their plain versions.

After dispatch, expert inputs sit in a dense (E, C, D) buffer (C = capacity).
The FFN is two grouped GEMMs with a gated activation between:

    h = silu(x @ w_gate) * (x @ w_up)        kernel: grouped_gated_ffn_in
    y = h @ w_down                           kernel: grouped_matmul

On a CUDA tensor each wrapper launches its kernel from `csrc/moe_gemm.cu`
(compiled with nvcc for sm_90a at first use, loaded through ctypes) or
raises; on a CPU tensor it runs the plain PyTorch version in this module.
Both accumulate in fp32 and return the input's dtype (fp32 or bf16), and
every shape is taken as is: no padding of C, D or F.

Each wrapper counts its launches in a plain integer attribute
(`grouped_gated_ffn_in.launches`, `grouped_matmul.launches`), so a run can
show that it went through the kernels; `reset_launch_counts()` zeroes them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import torch
import torch.nn.functional as F

_SRC = Path(__file__).resolve().parent / "csrc" / "moe_gemm.cu"
# build products stay inside the package's own (git-ignored) directory
_BUILD_DIR = Path(__file__).resolve().parent / "_build"
_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def build() -> ctypes.CDLL:
    """Compile csrc/moe_gemm.cu (once per source content) and load it."""
    global _lib
    if _lib is not None:
        return _lib
    src = _SRC.read_bytes()
    tag = hashlib.sha1(src + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:12]
    so = _BUILD_DIR / f"libmoe_gemm-{tag}.so"
    if not so.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(_SRC)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({res.returncode}):\n{res.stdout}\n{res.stderr}"
            )
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
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
    """Dtype, rank, shape, device and contiguity checks shared by both
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
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
        for dim, size in zip(dims, t.shape):
            if sizes.setdefault(dim, size) != size:
                raise ValueError(
                    f"{name}: axis {dim} is {size} here but {sizes[dim]} elsewhere"
                )
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {a.device}")
    return sizes


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed (CUDA error {rc})")


def grouped_gated_ffn_in(x, w_gate, w_up):
    """x (E,C,D), w_gate/w_up (E,D,F) -> h (E,C,F) in x's dtype."""
    s = _check("grouped_gated_ffn_in", x, (w_gate, w_up), "ECD", "EDF")
    if x.device.type == "cpu":
        return grouped_gated_ffn_in_plain(x, w_gate, w_up)
    e, c, d, f = s["E"], s["C"], s["D"], s["F"]
    h = torch.empty((e, c, f), dtype=x.dtype, device=x.device)
    lib = build()
    with torch.cuda.device(x.device):
        rc = lib.moe_gemm_gated_ffn_in(
            _DTYPE_CODE[x.dtype], x.data_ptr(), *x.stride(),
            w_gate.data_ptr(), w_up.data_ptr(), *w_gate.stride(),
            h.data_ptr(), *h.stride(), e, c, f, d,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _raise_on(rc, "grouped_gated_ffn_in")
    grouped_gated_ffn_in.launches += 1
    return h


def grouped_matmul(h, w):
    """h (E,C,F), w (E,F,D) -> y (E,C,D) in h's dtype."""
    s = _check("grouped_matmul", h, (w,), "ECF", "EFD")
    if h.device.type == "cpu":
        return grouped_matmul_plain(h, w)
    e, c, f, d = s["E"], s["C"], s["F"], s["D"]
    y = torch.empty((e, c, d), dtype=h.dtype, device=h.device)
    lib = build()
    with torch.cuda.device(h.device):
        rc = lib.moe_gemm_matmul(
            _DTYPE_CODE[h.dtype], h.data_ptr(), *h.stride(),
            w.data_ptr(), *w.stride(),
            y.data_ptr(), *y.stride(), e, c, d, f,
            torch.cuda.current_stream(h.device).cuda_stream,
        )
    _raise_on(rc, "grouped_matmul")
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
]
