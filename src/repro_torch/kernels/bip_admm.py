"""The BIP-ADMM dual update: one hand-written CUDA kernel and its plain version.

For scores s (n, m) in [0, 1] and expert prices q (m,), one ADMM iteration
of the reference's Pallas kernel (src/repro/kernels/bip_admm.py) is
    p_i         = max(0, (k+1)-th largest of s_i - q)                (n,)
    counts[j,b] = #{ i : s_ij - p_i > edge_jb },
    edge_jb     = lo_j + (hi_j - lo_j) * b / n_bins                  (m, n_bins)
and the dual update (src/repro/kernels/ops.py, bip_dual_update, single-device
form) runs T such iterations, each with `refine` + 1 histogram passes that
narrow [lo_j, hi_j) to the bin of the column's (rank+1)-th largest value
(`locate_bin`) and end in q_j interpolated in that bin (`q_from_histogram`).

On a CUDA tensor, `bip_dual_update` is ONE launch of `csrc/bip_admm.cu`
(built with nvcc at first use; see nvcc.py): one thread-block cluster runs
all T iterations, its histograms in distributed shared memory, and returns
q with nothing left for torch to do. `bip_admm_iteration`, the counterpart
of the Pallas function with its (p, counts) contract, is one launch of the
same kernel in its single-pass mode. On a CPU tensor both run their plain
versions (`bip_dual_update_plain`, `bip_admm_iteration_plain`); on a CUDA
tensor they launch or raise. The kernel is bit-equal to the plain versions:
p is an order statistic, counts are integers, and every edge, bound and q
is formed in the plain version's order of fp32 operations. Each wrapper
counts its launches (`bip_dual_update.launches`,
`bip_admm_iteration.launches`; `reset_launch_counts()` zeroes both).

The collective form (`bip_dual_update(..., axis_names=)`, sync='global' on a
mesh; the reference's `kernels/ops.py` with axis_names): `s` is this rank's
token shard, and the fused launch, which keeps every pass's histograms
inside one cluster, cannot add other ranks' counts. So it is the plain
loop over the single-pass mode: per pass one `bip_admm_iteration` launch,
then the (m, n_bins) counts psum'd over the data axes, then `locate_bin`;
per iteration q from `q_from_histogram` on the summed counts, with the rank
floor(n_glob k / m) from the psum'd token count and q = 0 where that rank
is past n_glob. The summed counts are exact integers in fp32 (below 2^24),
so every rank locates the order statistic the whole batch gives.

`launch_plan` is the kernel's launch plan in pure Python (rows per CTA and
per thread, experts per owner, shared bytes); it raises ValueError on what
the kernel refuses.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch.distributed import collectives
from repro_torch.kernels import nvcc

Tensor = torch.Tensor

LO, HI = -1.0, 1.0  # score domain: scores in [0, 1], minus p in [0, 1]
PAD_VALUE = -2.0    # the (k+1)-th largest of a row with fewer than k+1 lanes

THREADS = 512           # per CTA (csrc/bip_admm.cu)
CLUSTER = 16            # CTAs of the one cluster, where the card can place 16
PORTABLE_CLUSTER = 8    # else the portable size
MAX_SMEM = 227 * 1024   # shared memory one block may use on an H100
MAX_BINS = 4096
# the C entry point's own codes
_RC = {-1: "the plan's shared bytes disagree with the kernel's layout",
       -2: "shared memory over 227 KB"}

_lib: Optional[ctypes.CDLL] = None


def build() -> ctypes.CDLL:
    """Compile csrc/bip_admm.cu (once per source content) and load it."""
    global _lib
    if _lib is not None:
        return _lib
    lib = nvcc.build_library("bip_admm.cu")
    p, i32 = ctypes.c_void_p, ctypes.c_int
    lib.bip_admm_dual.argtypes = [p] * 7 + [i32] * 14 + [p]
    lib.bip_admm_dual.restype = i32
    lib.bip_admm_max_active_clusters.argtypes = [i32, i32, i32, ctypes.POINTER(i32)]
    lib.bip_admm_max_active_clusters.restype = i32
    lib.bip_admm_threads.restype = i32
    if lib.bip_admm_threads() != THREADS:
        raise RuntimeError("csrc/bip_admm.cu and bip_admm.py disagree on the threads per CTA")
    _lib = lib
    return lib


# ---------------------------------------------------------------- launch plan


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    cluster: int            # CTAs in the cluster (the grid is one cluster)
    threads: int            # per CTA
    rows_per_cta: int       # ceil(n / cluster); the last CTA's share may be short
    rows_per_thread: int
    resident_rows: int      # of a CTA's rows, those whose scores stay in shared memory
    s_stride: int           # words between two experts' columns of resident scores (odd)
    experts_per_owner: int  # histograms each CTA owns
    smem_bytes: int


@functools.lru_cache(maxsize=None)
def launch_plan(n: int, m: int, n_bins: int = 512, cluster: int = CLUSTER) -> LaunchPlan:
    """How the kernel lays out n rows and m experts over one cluster.

    Shared memory per CTA: four per-expert edge terms, q, lo and hi (7m
    words), the owned histograms (experts_per_owner * (n_bins + 1) int32),
    p of the CTA's rows, and as many rows' scores as fit in the rest of the
    227 KB, column by column with an odd stride. Raises ValueError for
    what the kernel refuses: n < 1, m < 1, n_bins not a power of two in
    2..4096, a cluster other than 8 or 16, or a CTA whose per-expert terms,
    histograms and p alone overflow its shared memory."""
    if n < 1:
        raise ValueError(f"bip_admm: need n >= 1 rows, got {n}")
    if m < 1:
        raise ValueError(f"bip_admm: need m >= 1 experts, got {m}")
    if n_bins < 2 or n_bins > MAX_BINS or n_bins & (n_bins - 1):
        raise ValueError(f"bip_admm: n_bins={n_bins} must be a power of two in 2..{MAX_BINS} "
                         f"(b / n_bins is then exact on every device)")
    if cluster not in (PORTABLE_CLUSTER, CLUSTER):
        raise ValueError(f"bip_admm: cluster of {cluster} CTAs (8 or 16)")
    rows_per_cta = -(-n // cluster)
    epo = -(-m // cluster)
    fixed = 7 * m + epo * (n_bins + 1) + rows_per_cta
    room = MAX_SMEM // 4 - fixed
    if room < 0:
        raise ValueError(f"bip_admm: n={n}, m={m}, n_bins={n_bins} need {4 * fixed} B of shared "
                         f"memory per CTA before any score, over {MAX_SMEM} B")
    resident = min(rows_per_cta, room // m)
    if resident and resident % 2 == 0 and resident + 1 > room // m:
        resident -= 1  # keep the odd stride inside the room
    stride = resident | 1 if resident else 0
    return LaunchPlan(
        cluster=cluster, threads=THREADS, rows_per_cta=rows_per_cta,
        rows_per_thread=-(-rows_per_cta // THREADS), resident_rows=resident, s_stride=stride,
        experts_per_owner=epo, smem_bytes=4 * (fixed + m * stride),
    )


_placeable: Dict[Tuple[int, int, int], bool] = {}


def device_plan(n: int, m: int, n_bins: int, device: torch.device) -> LaunchPlan:
    """The plan for a cluster of 16 where the device can place one (the
    occupancy query, once per shape), else of 8; raises if neither fits."""
    lib = build()
    index = device.index if device.index is not None else torch.cuda.current_device()
    for cluster in (CLUSTER, PORTABLE_CLUSTER):
        plan = launch_plan(n, m, n_bins, cluster)
        key = (index, cluster, plan.smem_bytes)
        if key not in _placeable:
            count = ctypes.c_int(0)
            rc = lib.bip_admm_max_active_clusters(cluster, plan.smem_bytes, index,
                                                  ctypes.byref(count))
            nvcc.raise_on(rc, "bip_admm_max_active_clusters", _RC)
            _placeable[key] = count.value >= 1
        if _placeable[key]:
            return plan
    raise RuntimeError(f"bip_admm: the device cannot place a cluster of {CLUSTER} or "
                       f"{PORTABLE_CLUSTER} CTAs with {plan.smem_bytes} B of shared memory each")


# ------------------------------------------------------------ plain versions


def expert_kth_index(n: int, k: int, m: int) -> int:
    """0-based index of the (nk/m + 1)-th largest of n values, or -1 when it
    falls past the end (capacity slack: q_j must be 0). Defined here, and
    re-exported by core.ref_bip, so that the kernels import nothing of the
    routing core that calls them."""
    idx = (n * k) // m
    return -1 if idx >= n else idx


def histogram_edges(lo: Tensor, hi: Tensor, n_bins: int) -> Tensor:
    """(m, n_bins) edges lo_j + (hi_j - lo_j) * b / n_bins, fp32, as the
    reference kernel forms them (a product, then a sum: no fused rounding)."""
    frac = torch.arange(n_bins, dtype=torch.float32, device=lo.device) / n_bins
    return lo[:, None] + (hi - lo)[:, None] * frac[None, :]


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


def bip_dual_update_plain(
    s: Tensor, q0: Tensor, *, top_k: int, n_iters: int, n_bins: int = 512, refine: int = 1
) -> Tensor:
    """T ADMM iterations in plain torch, the reference's loop step for step:
    per iteration one coarse pass over [-1, 1) and `refine` passes over the
    located bin, then q from the last pass's counts over the bounds that
    pass was counted on. Capacity slack (rank past the column) gives zeros."""
    n, m = s.shape
    rank = expert_kth_index(n, top_k, m)
    if rank < 0:  # capacity slack: the constraint never binds
        return torch.zeros_like(q0)
    q = q0.float()
    for _ in range(n_iters):
        lo, hi = _bounds(None, None, m, s.device)
        for _pass in range(refine + 1):
            _p, cnt = bip_admm_iteration_plain(s, q, lo, hi, top_k=top_k, n_bins=n_bins)
            cur_lo, cur_hi = lo, hi  # the bounds this cnt was computed over
            bin_lo, bin_hi, found = locate_bin(cnt, rank, n_bins, lo, hi)
            lo = torch.where(found, bin_lo, lo)
            hi = torch.where(found, bin_hi, hi)
        q = q_from_histogram(cnt, rank, n_bins, lo=cur_lo, hi=cur_hi)
    return q


# ------------------------------------------------------------------ wrappers


def _bounds(lo, hi, m, device):
    if lo is None:
        lo = torch.full((m,), LO, dtype=torch.float32, device=device)
    if hi is None:
        hi = torch.full((m,), HI, dtype=torch.float32, device=device)
    return lo.float(), hi.float()


def _check(name: str, s: Tensor, top_k: int, **vectors) -> None:
    if s.dim() != 2:
        raise ValueError(f"{name}: scores must be (n, m), got {tuple(s.shape)}")
    if s.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: dtype {s.dtype} not supported (float32, bfloat16)")
    n, m = s.shape
    if n == 0 or not 0 <= top_k <= m:
        raise ValueError(f"{name}: need n > 0 and 0 <= top_k <= m (n={n}, m={m}, top_k={top_k})")
    for vname, t in vectors.items():
        if t.shape != (m,):
            raise ValueError(f"{name}: {vname} must be ({m},), got {tuple(t.shape)}")
        if t.device != s.device:
            raise ValueError(f"{name}: {vname} on {t.device}, scores on {s.device}")
    if s.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {s.device}")


def _launch(s, q, lo, hi, *, top_k, rank, n_iters, refine, n_bins,
            q_out=None, p_out=None, counts_out=None) -> None:
    """One launch of the kernel on s's device and current stream."""
    n, m = s.shape
    plan = device_plan(n, m, n_bins, s.device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    rc = build().bip_admm_dual(  # the C entry point sets (and restores) the device
        s.data_ptr(), q.data_ptr(), ptr(lo), ptr(hi), ptr(q_out), ptr(p_out), ptr(counts_out),
        n, m, top_k, rank, n_iters, refine, n_bins, plan.cluster, plan.rows_per_cta,
        plan.resident_rows, plan.s_stride, plan.experts_per_owner, plan.smem_bytes,
        s.device.index if s.device.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(s.device).cuda_stream,
    )
    nvcc.raise_on(rc, "bip_admm", _RC)


def bip_dual_update(
    s: Tensor,
    q0: Tensor,
    *,
    top_k: int,
    n_iters: int,
    n_bins: int = 512,
    refine: int = 1,
    axis_names: tuple = (),
) -> Tensor:
    """T ADMM iterations on the (n, m) score matrix. Returns q (m,) fp32.

    A port of the reference's src/repro/kernels/ops.py, bip_dual_update:
    per iteration one coarse histogram pass over [-1, 1) and `refine`
    passes over the located bin. Without axis_names, on a CUDA tensor the
    whole update is one kernel launch (no host sync); on a CPU tensor it is
    `bip_dual_update_plain`. Capacity slack (rank past the column) returns
    zeros without a launch. With axis_names it is the collective form (see
    the module doc): (refine + 1) * n_iters single-pass launches and as
    many count psums."""
    _check("bip_dual_update", s, top_k, q0=q0)
    if axis_names:
        return _dual_update_collective(s, q0, top_k=top_k, n_iters=n_iters, n_bins=n_bins,
                                       refine=refine, axis_names=tuple(axis_names))
    n, m = s.shape
    if s.device.type == "cpu":
        return bip_dual_update_plain(s, q0, top_k=top_k, n_iters=n_iters, n_bins=n_bins,
                                     refine=refine)
    if n_iters < 0 or refine < 0:
        raise ValueError(f"bip_dual_update: n_iters={n_iters}, refine={refine} must be >= 0")
    rank = expert_kth_index(n, top_k, m)
    if rank < 0:  # capacity slack: the constraint never binds
        return torch.zeros_like(q0)
    if n_iters == 0:
        return q0.float()
    q = torch.empty((m,), dtype=torch.float32, device=s.device)
    _launch(s.float().contiguous(), q0.float().contiguous(), None, None, top_k=top_k, rank=rank,
            n_iters=n_iters, refine=refine, n_bins=n_bins, q_out=q)
    bip_dual_update.launches += 1
    return q


def _dual_update_collective(s, q0, *, top_k, n_iters, n_bins, refine, axis_names) -> Tensor:
    """The collective form: the single-pass loop with the counts psum'd."""
    n, m = s.shape
    if n_iters < 0 or refine < 0:
        raise ValueError(f"bip_dual_update: n_iters={n_iters}, refine={refine} must be >= 0")
    n_glob = collectives.psum(torch.tensor(n, dtype=torch.int64, device=s.device), axis_names)
    rank = (n_glob * top_k) // m  # the tensor counterpart of expert_kth_index
    s32 = s.float().contiguous()
    q = q0.float()
    for _ in range(n_iters):
        lo, hi = _bounds(None, None, m, s.device)
        for _pass in range(refine + 1):
            _p, cnt = bip_admm_iteration(s32, q, top_k=top_k, n_bins=n_bins, lo=lo, hi=hi)
            cnt = collectives.psum(cnt, axis_names)
            cur_lo, cur_hi = lo, hi  # the bounds this cnt was computed over
            bin_lo, bin_hi, found = locate_bin(cnt, rank, n_bins, lo, hi)
            lo = torch.where(found, bin_lo, lo)
            hi = torch.where(found, bin_hi, hi)
        q = q_from_histogram(cnt, rank, n_bins, lo=cur_lo, hi=cur_hi)
        q = torch.where(rank >= n_glob, torch.zeros_like(q), q)  # capacity slack
    return q


def bip_admm_iteration(
    s: Tensor,
    q: Tensor,
    *,
    top_k: int,
    n_bins: int = 512,
    lo: Optional[Tensor] = None,
    hi: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """One ADMM iteration. Returns (p (n,), counts (m, n_bins) fp32).

    s (n, m) fp32 or bf16 (read as fp32); q, lo, hi (m,), with lo <= hi
    (default [-1, 1) for every expert). On a CUDA tensor: the fused kernel's
    single-pass mode, one launch."""
    m = s.shape[-1]
    lo, hi = _bounds(lo, hi, m, s.device)
    _check("bip_admm_iteration", s, top_k, q=q, lo=lo, hi=hi)
    if s.device.type == "cpu":
        return bip_admm_iteration_plain(s, q, lo, hi, top_k=top_k, n_bins=n_bins)
    n = s.shape[0]
    p = torch.empty((n,), dtype=torch.float32, device=s.device)
    counts = torch.empty((m, n_bins), dtype=torch.float32, device=s.device)
    _launch(s.float().contiguous(), q.float().contiguous(), lo.contiguous(), hi.contiguous(),
            top_k=top_k, rank=0, n_iters=1, refine=0, n_bins=n_bins, p_out=p, counts_out=counts)
    bip_admm_iteration.launches += 1
    return p, counts


bip_dual_update.launches = 0
bip_admm_iteration.launches = 0


def reset_launch_counts() -> None:
    bip_dual_update.launches = 0
    bip_admm_iteration.launches = 0


__all__ = [
    "HI",
    "LO",
    "PAD_VALUE",
    "LaunchPlan",
    "bip_admm_iteration",
    "bip_admm_iteration_plain",
    "bip_dual_update",
    "bip_dual_update_plain",
    "build",
    "device_plan",
    "histogram_edges",
    "launch_plan",
    "locate_bin",
    "q_from_histogram",
    "reset_launch_counts",
]
