"""One BIP-ADMM dual iteration: a hand-written CUDA kernel and its plain version.

For scores s (n, m) in [0, 1], expert prices q (m,) and per-expert
histogram bounds [lo_j, hi_j) it returns
    p_i        = max(0, (k+1)-th largest of s_i - q)                  (n,)
    counts[j,b] = #{ i : s_ij - p_i > edge_jb },
    edge_jb    = lo_j + (hi_j - lo_j) * b / n_bins                    (m, n_bins)
the two halves of one ADMM iteration of the reference's Pallas kernel
(src/repro/kernels/bip_admm.py). Both are exact: p is an order statistic
(ties change which lane is taken, not the value) and the counts are
integers held in fp32. So the kernel and the plain version agree bit for
bit given the same edges, and the wrapper computes the edges once in torch,
with the plain version's own formula (`histogram_edges`), for both.

On a CUDA tensor `bip_admm_iteration` launches the kernel of
`csrc/bip_admm.cu` (built with nvcc at first use; see nvcc.py) or raises;
on a CPU tensor it runs `bip_admm_iteration_plain`. The kernel writes an
(m, n_bins + 1) int32 histogram of how many edges lie below each shifted
score; the counts are its suffix sums. It counts its launches in
`bip_admm_iteration.launches` (`reset_launch_counts()` zeroes it).

`locate_bin` and `q_from_histogram` turn the counts into the column order
statistic q_j (plain torch, as the reference's are plain jnp).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import nvcc

Tensor = torch.Tensor

LO, HI = -1.0, 1.0  # score domain: scores in [0, 1], minus p in [0, 1]
PAD_VALUE = -2.0    # the (k+1)-th largest of a row with fewer than k+1 lanes

_lib: Optional[ctypes.CDLL] = None


def build() -> ctypes.CDLL:
    """Compile csrc/bip_admm.cu (once per source content) and load it."""
    global _lib
    if _lib is not None:
        return _lib
    lib = nvcc.build_library("bip_admm.cu")
    p, i32 = ctypes.c_void_p, ctypes.c_int
    lib.bip_admm_iteration.argtypes = [p] * 5 + [i32] * 4 + [p]
    lib.bip_admm_iteration.restype = i32
    _lib = lib
    return lib


def histogram_edges(lo: Tensor, hi: Tensor, n_bins: int) -> Tensor:
    """(m, n_bins) edges lo_j + (hi_j - lo_j) * b / n_bins, fp32, as the
    reference kernel forms them (a product, then a sum: no fused rounding)."""
    frac = torch.arange(n_bins, dtype=torch.float32, device=lo.device) / n_bins
    return lo[:, None] + (hi - lo)[:, None] * frac[None, :]


# ------------------------------------------------------------- plain version


def bip_admm_iteration_plain(s, q, lo, hi, *, top_k: int, n_bins: int) -> Tuple[Tensor, Tensor]:
    """p (n,) and counts (m, n_bins) fp32, by torch.topk and a broadcast
    compare of every shifted score against every edge."""
    s = s.float()
    n, m = s.shape
    x = s - q.float()[None, :]
    if top_k + 1 > m:
        kth = torch.full((n,), PAD_VALUE, dtype=torch.float32, device=s.device)
    else:
        kth = torch.topk(x, top_k + 1, dim=1).values[:, top_k]
    p = torch.clamp_min(kth, 0.0)
    shifted = s - p[:, None]
    edges = histogram_edges(lo.float(), hi.float(), n_bins)
    counts = (shifted[:, :, None] > edges[None, :, :]).sum(dim=0).float()
    return p, counts


# ------------------------------------------------------------------ wrapper


def _bounds(lo, hi, m, device):
    if lo is None:
        lo = torch.full((m,), LO, dtype=torch.float32, device=device)
    if hi is None:
        hi = torch.full((m,), HI, dtype=torch.float32, device=device)
    return lo.float(), hi.float()


def bip_admm_iteration(
    s: Tensor,
    q: Tensor,
    *,
    top_k: int,
    n_bins: int = 512,
    lo: Optional[Tensor] = None,
    hi: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """One fused ADMM iteration. Returns (p (n,), counts (m, n_bins) fp32).

    s (n, m) fp32 or bf16 (read as fp32); q, lo, hi (m,), with lo <= hi
    (default [-1, 1) for every expert)."""
    if s.dim() != 2:
        raise ValueError(f"bip_admm_iteration: scores must be (n, m), got {tuple(s.shape)}")
    if s.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"bip_admm_iteration: dtype {s.dtype} not supported (float32, bfloat16)")
    n, m = s.shape
    if n == 0 or n_bins < 1 or not 0 <= top_k <= m:
        raise ValueError(f"bip_admm_iteration: need n > 0, n_bins >= 1, 0 <= top_k <= m "
                         f"(n={n}, m={m}, top_k={top_k}, n_bins={n_bins})")
    lo, hi = _bounds(lo, hi, m, s.device)
    for name, t in (("q", q), ("lo", lo), ("hi", hi)):
        if t.shape != (m,):
            raise ValueError(f"bip_admm_iteration: {name} must be ({m},), got {tuple(t.shape)}")
        if t.device != s.device:
            raise ValueError(f"bip_admm_iteration: {name} on {t.device}, scores on {s.device}")
    if s.device.type == "cpu":
        return bip_admm_iteration_plain(s, q, lo, hi, top_k=top_k, n_bins=n_bins)
    if s.device.type != "cuda":
        raise ValueError(f"bip_admm_iteration: unsupported device {s.device}")
    s32 = s.float().contiguous()
    q32 = q.float().contiguous()
    edges = histogram_edges(lo, hi, n_bins).contiguous()
    p = torch.empty((n,), dtype=torch.float32, device=s.device)
    hist = torch.zeros((m, n_bins + 1), dtype=torch.int32, device=s.device)
    lib = build()
    with torch.cuda.device(s.device):
        rc = lib.bip_admm_iteration(
            s32.data_ptr(), q32.data_ptr(), edges.data_ptr(), p.data_ptr(),
            hist.data_ptr(), n, m, top_k, n_bins,
            torch.cuda.current_stream(s.device).cuda_stream,
        )
    nvcc.raise_on(rc, "bip_admm_iteration")
    bip_admm_iteration.launches += 1
    # counts[j, b] = sum of hist[j, c] over c > b
    counts = hist[:, 1:].flip(1).cumsum(1).flip(1).float()
    return p, counts


bip_admm_iteration.launches = 0


def reset_launch_counts() -> None:
    bip_admm_iteration.launches = 0


# ------------------------------------------- order statistic from the counts


def locate_bin(cnt: Tensor, rank: int, n_bins: int, lo: Tensor, hi: Tensor):
    """Bin holding the (rank+1)-th largest value. Returns (bin_lo, bin_hi,
    found): the value lies in (edge_b*, edge_b* + width] with b* the last
    edge whose count exceeds rank."""
    width = (hi - lo) / n_bins
    b_star = (cnt > rank).sum(dim=1) - 1
    b_clip = torch.clamp(b_star, 0, n_bins - 1).float()
    bin_lo = lo + b_clip * width
    bin_hi = bin_lo + width
    return bin_lo, bin_hi, b_star >= 0


def q_from_histogram(cnt: Tensor, rank: int, n_bins: int, lo=None, hi=None) -> Tensor:
    """q_j = max(0, order statistic), linearly interpolated in its bin."""
    lo, hi = _bounds(lo, hi, cnt.shape[0], cnt.device)
    width = (hi - lo) / n_bins
    bin_lo, _, found = locate_bin(cnt, rank, n_bins, lo, hi)
    b_clip = torch.clamp((cnt > rank).sum(dim=1) - 1, 0, n_bins - 1)
    c_lo = cnt.gather(1, b_clip[:, None])[:, 0]
    c_next = cnt.gather(1, torch.clamp(b_clip + 1, 0, n_bins - 1)[:, None])[:, 0]
    c_hi = torch.where(b_clip + 1 < n_bins, c_next, torch.zeros_like(c_next))
    frac = (c_lo - rank) / torch.clamp_min(c_lo - c_hi, 1.0)
    v = bin_lo + torch.clamp(frac, 0.0, 1.0) * width
    return torch.where(found, torch.clamp_min(v, 0.0), torch.zeros_like(v))


__all__ = [
    "HI",
    "LO",
    "PAD_VALUE",
    "bip_admm_iteration",
    "bip_admm_iteration_plain",
    "build",
    "histogram_edges",
    "locate_bin",
    "q_from_histogram",
    "reset_launch_counts",
]
