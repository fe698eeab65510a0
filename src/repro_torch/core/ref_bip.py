"""Plain-torch BIP-Based Balancing duals (Algorithm 1), the port of
src/repro/core/ref_bip.py.

Algorithm 1 (inner loop, per gate invocation), for scores s in R^{n x m}:

    for t = 1..T:
        p_i = max(0, (k+1)-th largest of s_i - q)      # row-wise
        q_j = max(0, (nk/m+1)-th largest of s_:j - p)  # column-wise

Two forms of the column order statistic: the exact sort-based one
(`bip_dual_update`) and the threshold bisection (`kth_largest_threshold`,
used by `bip_dual_update_global`), which the serving path runs because it
handles a token mask with a data-dependent capacity index. The bisection
keeps the reference's numerics step for step — midpoint ladders built from
exact (a+b)*0.5 chains, exact small-integer counts, bounds gathered from the
ladder rather than recomputed — so on identical fp32 scores both packages
land on bit-identical duals.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

Tensor = torch.Tensor


def expert_kth_index(n: int, k: int, m: int) -> int:
    """0-based index of the (nk/m + 1)-th largest of n values, or -1 when it
    falls past the end (capacity slack: q_j must be 0)."""
    idx = (n * k) // m
    return -1 if idx >= n else idx


def kth_largest(x: Tensor, kth: int, dim: int = -1) -> Tensor:
    """Value of the (kth+1)-th largest element along `dim` (0-based kth)."""
    return torch.topk(x, kth + 1, dim=dim).values.select(dim, kth)


def bip_dual_update(
    s: Tensor, q0: Tensor, *, top_k: int, n_iters: int
) -> Tuple[Tensor, Tensor]:
    """T iterations of the exact (sort-based) ADMM dual update. Returns (q, p).

    s: (n, m) routing scores; q0: (m,) warm-start expert prices.
    """
    n, m = s.shape
    cap_idx = expert_kth_index(n, top_k, m)
    q = q0.to(s.dtype)
    p = torch.zeros((n,), dtype=s.dtype, device=s.device)
    for _ in range(n_iters):
        if top_k >= m:  # every expert selected: the token constraint is slack
            p = torch.zeros((n,), dtype=s.dtype, device=s.device)
        else:
            p = torch.clamp_min(kth_largest(s - q[None, :], top_k, dim=-1), 0.0)
        if cap_idx < 0:
            q = torch.zeros_like(q)
        else:
            q = torch.clamp_min(kth_largest(s - p[:, None], cap_idx, dim=0), 0.0)
    return q, p


def bisect_ladder_depth(fanout: int) -> int:
    """Midpoint-ladder depth r for a per-round probe budget: `fanout` rounds
    up to the next 2^r - 1 interior points."""
    if fanout < 1:
        raise ValueError(f"fanout must be >= 1, got {fanout}")
    return max(1, math.ceil(math.log2(fanout + 1.0)))


def bisect_rounds(n_bisect: int, fanout: int) -> int:
    """Worst-case fused-bisection rounds for `n_bisect` bits of resolution."""
    if n_bisect < 1:
        raise ValueError(f"n_bisect must be >= 1, got {n_bisect}")
    return max(1, math.ceil(n_bisect / bisect_ladder_depth(fanout)))


def kth_largest_threshold(
    x: Tensor,
    kth,
    *,
    dim: int = -1,
    n_bisect: int = 26,
    lo: Optional[Tensor] = None,
    hi: Optional[Tensor] = None,
    fanout: int = 1,
) -> Tensor:
    """(kth+1)-th largest along `dim` by fused multi-threshold bisection.

    Finds the largest threshold t with #{x > t} <= kth. Each round probes the
    bracket's depth-r midpoint ladder (2^r - 1 interior thresholds) with one
    bucketized count (searchsorted + histogram + reverse cumsum, exact
    integer counts in fp32) and gathers the sub-interval whose edge counts
    bracket `kth`. `kth` may be an int or a 0-d integer tensor. Rounds stop
    narrowing once every bracket is narrower than initial width *
    2^-n_bisect: a converged round keeps its bounds (torch.where, so the
    loop never syncs with the host). Returns the bracket's upper end, which
    guarantees #{x > t} <= kth.
    """
    if lo is None:
        lo = torch.amin(x, dim=dim)
    if hi is None:
        hi = torch.amax(x, dim=dim)
    xm = x.movedim(dim, 0)  # (n, *rest)
    n = xm.shape[0]
    rest = tuple(xm.shape[1:])
    dt, dev = xm.dtype, xm.device
    lo = torch.as_tensor(lo, dtype=dt, device=dev).expand(rest) - torch.tensor(
        1e-6, dtype=dt, device=dev
    )
    hi = torch.as_tensor(hi, dtype=dt, device=dev).expand(rest).clone()

    depth = bisect_ladder_depth(fanout)
    max_rounds = bisect_rounds(n_bisect, fanout)
    target = torch.amax(hi - lo) * torch.tensor(2.0 ** (-n_bisect), dtype=dt, device=dev)
    # one row of values per batch element, contiguous for batched searchsorted
    xr = xm.reshape(n, -1).t().contiguous()  # (R, n)
    n_rows = xr.shape[0]
    ones = torch.ones_like(xr, dtype=torch.float32)

    def fused_counts(pts):
        # #{x > pts[i]} for the interior ladder points i = 1..P-2
        n_pts = pts.shape[0]
        ptsr = pts.reshape(n_pts, -1).t().contiguous()  # (R, P)
        b = torch.searchsorted(ptsr, xr)  # #{ladder points < x}
        hist = torch.zeros((n_rows, n_pts + 1), dtype=torch.float32, device=dev)
        hist.scatter_add_(1, b, ones)
        rc = hist.flip(1).cumsum(1).flip(1)  # rc[:, i] = #{b >= i}
        return rc[:, 2:n_pts].t().reshape((n_pts - 2,) + rest)

    def ladder(lo_, hi_):
        pts = torch.stack([lo_, hi_])
        for _ in range(depth):
            mids = (pts[:-1] + pts[1:]) * 0.5
            body = torch.stack([pts[:-1], mids], dim=1).reshape((-1,) + rest)
            pts = torch.cat([body, pts[-1:]], dim=0)
        return pts

    def subinterval(pts, cnt):
        j = (cnt > kth).sum(dim=0, dtype=torch.int64)[None]
        return pts.gather(0, j)[0], pts.gather(0, j + 1)[0]

    pts = ladder(lo, hi)
    lo, hi = subinterval(pts, fused_counts(pts))
    for _ in range(max_rounds - 1):
        converged = torch.amax(hi - lo) <= target
        pts = ladder(lo, hi)
        new_lo, new_hi = subinterval(pts, fused_counts(pts))
        lo = torch.where(converged, lo, new_lo)
        hi = torch.where(converged, hi, new_hi)
    return hi


def bip_dual_update_global(
    s: Tensor,
    q0: Tensor,
    *,
    top_k: int,
    n_iters: int,
    token_mask: Optional[Tensor] = None,  # (n,) bool; False rows invisible
    n_bisect: int = 26,
    fanout: int = 1,
    score_bounds: Optional[Tuple[float, float]] = None,
) -> Tuple[Tensor, Tensor]:
    """ADMM dual update over the real tokens by threshold bisection.

    The single-device form of the reference function of the same name:
    masked rows are pushed to -1e30 so they sink out of every order
    statistic, and the capacity index floor(n_real·k/m) is a tensor taken
    from the real-row count. `score_bounds` is a static (lo, hi) on the
    entries of `s` ((0, 1) for softmax scores) that brackets x = s - p by
    [lo - max(hi, 0), hi] with no data-dependent bound. An all-padding call
    keeps q0. Returns (q, p). (The reference's forecast `window` and
    `with_stats` are not ported yet.)
    """
    n, m = s.shape
    dev = s.device
    if token_mask is None:
        s_m = s
        n_real = torch.tensor(n, dtype=torch.int64, device=dev)
    else:
        s_m = torch.where(
            token_mask[:, None], s, torch.tensor(-1e30, dtype=s.dtype, device=dev)
        )
        n_real = token_mask.sum(dtype=torch.int64)
    cap_idx = (n_real * top_k) // m
    slack = cap_idx >= torch.clamp_min(n_real, 1)

    if score_bounds is not None:
        s_lo, s_hi = float(score_bounds[0]), float(score_bounds[1])
        lo_b = torch.full((m,), s_lo - max(s_hi, 0.0), dtype=s.dtype, device=dev)
        hi_b = torch.full((m,), s_hi, dtype=s.dtype, device=dev)

    q = q0.to(s.dtype)
    p = torch.zeros((n,), dtype=s.dtype, device=dev)
    zero = torch.zeros((), dtype=s.dtype, device=dev)
    for _ in range(n_iters):
        if top_k >= m:
            p = torch.zeros((n,), dtype=s.dtype, device=dev)
        else:
            p = torch.clamp_min(kth_largest(s_m - q[None, :], top_k, dim=-1), 0.0)
        x = s_m - p[:, None]
        if score_bounds is not None:
            lo, hi = lo_b, hi_b
        elif token_mask is None:
            lo, hi = torch.amin(x, dim=0), torch.amax(x, dim=0)
        else:  # bisection bounds from real entries only
            real = token_mask[:, None]
            lo = torch.amin(torch.where(real, x, torch.inf), dim=0)
            hi = torch.amax(torch.where(real, x, -torch.inf), dim=0)
        t = kth_largest_threshold(
            x, cap_idx, dim=0, n_bisect=n_bisect, lo=lo, hi=hi, fanout=fanout
        )
        t = torch.where(slack, zero, t)  # slack capacity -> price 0
        q = torch.clamp_min(t, 0.0)
    # an all-padding invocation (idle engine step) must not move the dual
    q = torch.where(n_real > 0, q, q0.to(s.dtype))
    return q, p


def sanitize_duals(q: Tensor, abs_limit: float) -> Tuple[Tensor, Tensor]:
    """(q_safe, healthy): zeros when any entry is non-finite or exceeds
    `abs_limit` in magnitude, q itself (bitwise) otherwise."""
    healthy = torch.all(torch.isfinite(q) & (q.abs() <= abs_limit))
    return torch.where(healthy, q, torch.zeros_like(q)), healthy
