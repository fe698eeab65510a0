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

With `axis_names` (sync='global' on a mesh) `s` is this rank's token shard
and every collective quantity is reduced over those mesh axes
(distributed.collectives, under the caller's axis_env): the real-token
count, the bisection bounds where no static bracket is given, and one fused
exceedance-count psum per bisection round. The counts are exact integers,
so every rank converges on the dual the whole batch gives on one device.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.distributed import collectives
from repro_torch.kernels.bip_admm import expert_kth_index

Tensor = torch.Tensor

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


def bip_topk(s: Tensor, q: Tensor, top_k: int) -> Tuple[Tensor, Tensor]:
    """Top-k experts by corrected scores s - q; gate values are the raw s.
    Returns (combine_weights (n, k), expert_index (n, k) int32). Ties go to
    the lower expert index, as lax.top_k's do (a converged dual leaves
    exact ties at the capacity boundary): a stable descending sort, as
    balancers.topk_select."""
    idx = torch.sort(s - q[None, :], dim=-1, descending=True, stable=True).indices[:, :top_k]
    return torch.gather(s, -1, idx), idx.to(torch.int32)


def bip_route_reference(
    s: Tensor, q0: Tensor, *, top_k: int, n_iters: int
) -> Tuple[Tensor, Tensor, Tensor]:
    """The whole Algorithm 1 gate: the exact dual update, then the biased
    top-k. Returns (combine_weights, expert_index, q_new)."""
    q, _ = bip_dual_update(s, q0, top_k=top_k, n_iters=n_iters)
    w, idx = bip_topk(s, q, top_k)
    return w, idx, q


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
    axis_names: tuple = (),
    lo: Optional[Tensor] = None,
    hi: Optional[Tensor] = None,
    fanout: int = 1,
    window: Optional[Tuple[Tensor, Tensor]] = None,
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

    `window` is an optional (w_lo, w_hi) predicted bracket per batch element
    (the bip dual forecaster's). Its two edges are counted by direct compare
    beside round 0's fused count; where count(w_lo) > kth >= count(w_hi) and
    w_lo < w_hi, round 0's bracket is intersected with it, elsewhere (a
    stale window) it is ignored. The port's rounds run whether or not they
    narrow anything, so a window changes the bracket, not the launches.

    With `axis_names`, x is this rank's shard along `dim`: missing bounds
    come from pmin/pmax, and each round's counts (with round 0's window
    probes) are one psum over the axes.
    """
    axis_names = tuple(axis_names)
    if lo is None:
        lo = collectives.pmin(torch.amin(x, dim=dim), axis_names)
    if hi is None:
        hi = collectives.pmax(torch.amax(x, dim=dim), axis_names)
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

    def fused_counts(pts, extra=()):
        # #{x > pts[i]} for the interior ladder points i = 1..P-2, then
        # #{x > e} for each `extra` threshold, in one psum over the axes
        n_pts = pts.shape[0]
        ptsr = pts.reshape(n_pts, -1).t().contiguous()  # (R, P)
        b = torch.searchsorted(ptsr, xr)  # #{ladder points < x}
        hist = torch.zeros((n_rows, n_pts + 1), dtype=torch.float32, device=dev)
        hist.scatter_add_(1, b, ones)
        rc = hist.flip(1).cumsum(1).flip(1)  # rc[:, i] = #{b >= i}
        cnt = rc[:, 2:n_pts].t().reshape((n_pts - 2,) + rest)
        if extra:
            ex = [(xm > e[None]).sum(dim=0, dtype=torch.float32)[None] for e in extra]
            cnt = torch.cat([cnt] + ex, dim=0)
        return collectives.psum(cnt, axis_names)

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
    if window is None:
        lo, hi = subinterval(pts, fused_counts(pts))
    else:  # round 0 carries the window's two validation probes
        n_probes = pts.shape[0] - 2
        w_lo = torch.as_tensor(window[0], dtype=dt, device=dev).expand(rest)
        w_hi = torch.as_tensor(window[1], dtype=dt, device=dev).expand(rest)
        cnt = fused_counts(pts, extra=(w_lo, w_hi))
        new_lo, new_hi = subinterval(pts, cnt[:n_probes])
        c_lo, c_hi = cnt[n_probes], cnt[n_probes + 1]
        ok = (c_lo > kth) & (c_hi <= kth) & (w_lo < w_hi)
        lo = torch.where(ok, torch.maximum(w_lo, new_lo), new_lo)
        hi = torch.where(ok, torch.minimum(w_hi, new_hi), new_hi)
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
    axis_names: tuple = (),
    n_bisect: int = 26,
    fanout: int = 1,
    score_bounds: Optional[Tuple[float, float]] = None,
    window: Optional[Tuple[Tensor, Tensor]] = None,
    with_stats: bool = False,
):
    """ADMM dual update over the real tokens by threshold bisection.

    The single-device form of the reference function of the same name:
    masked rows are pushed to -1e30 so they sink out of every order
    statistic, and the capacity index floor(n_real·k/m) is a tensor taken
    from the real-row count. `score_bounds` is a static (lo, hi) on the
    entries of `s` ((0, 1) for softmax scores) that brackets x = s - p by
    [lo - max(hi, 0), hi] with no data-dependent bound. An all-padding call
    keeps q0. `window` is the forecaster's (w_lo, w_hi) bracket per expert,
    validated in round 0 of every iteration's bisection
    (`kth_largest_threshold`). Returns (q, p), or with `with_stats` (q, p,
    t) with t the last iteration's pre-clamp order statistic (q = max(0, t)),
    which the forecaster tracks.

    With `axis_names`, `s` is this rank's (n_local, m) shard and the update
    runs over the union of the real tokens of every rank of those axes:
    the capacity index comes from the psum'd real-token count, the
    bisection bounds (without `score_bounds`) from pmin/pmax, and the
    order statistic from psum'd counts; the token price p stays local.
    """
    n, m = s.shape
    axis_names = tuple(axis_names)
    dev = s.device
    if token_mask is None:
        s_m = s
        n_real = torch.tensor(n, dtype=torch.int64, device=dev)
    else:
        s_m = torch.where(
            token_mask[:, None], s, torch.tensor(-1e30, dtype=s.dtype, device=dev)
        )
        n_real = token_mask.sum(dtype=torch.int64)
    n_glob = collectives.psum(n_real, axis_names)
    cap_idx = (n_glob * top_k) // m
    slack = cap_idx >= torch.clamp_min(n_glob, 1)

    if score_bounds is not None:
        s_lo, s_hi = float(score_bounds[0]), float(score_bounds[1])
        lo_b = torch.full((m,), s_lo - max(s_hi, 0.0), dtype=s.dtype, device=dev)
        hi_b = torch.full((m,), s_hi, dtype=s.dtype, device=dev)

    q = q0.to(s.dtype)
    p = torch.zeros((n,), dtype=s.dtype, device=dev)
    zero = torch.zeros((), dtype=s.dtype, device=dev)
    t = torch.zeros_like(q)
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
        if score_bounds is None:
            lo, hi = collectives.pmin(lo, axis_names), collectives.pmax(hi, axis_names)
        t = kth_largest_threshold(
            x, cap_idx, dim=0, n_bisect=n_bisect, axis_names=axis_names, lo=lo, hi=hi,
            fanout=fanout, window=window,
        )
        t = torch.where(slack, zero, t)  # slack capacity -> price 0
        q = torch.clamp_min(t, 0.0)
    # an all-padding invocation (idle engine step) must not move the dual
    q = torch.where(n_glob > 0, q, q0.to(s.dtype))
    if with_stats:
        return q, p, t
    return q, p


def bip_dual_update_threshold(
    s: Tensor,
    q0: Tensor,
    *,
    top_k: int,
    n_iters: int,
    axis_names: tuple = (),
    n_bisect: int = 26,
    fanout: int = 1,
) -> Tuple[Tensor, Tensor]:
    """The sort-free dual update without a token mask: the reference's
    historically named alias of `bip_dual_update_global`. Matches
    `bip_dual_update` up to the bisection's resolution; with `axis_names`,
    global over the ranks' token shards."""
    return bip_dual_update_global(s, q0, top_k=top_k, n_iters=n_iters, axis_names=axis_names,
                                  n_bisect=n_bisect, fanout=fanout)


def bip_dual_update_masked(
    s: Tensor,
    q0: Tensor,
    mask: Tensor,  # (n,) bool; False rows are invisible to the update
    *,
    top_k: int,
    n_iters: int,
    n_bisect: int = 26,
    fanout: int = 1,
) -> Tuple[Tensor, Tensor]:
    """The dual update over the real rows only (a serving chunk's padding
    is masked out): the reference's single-device alias of
    `bip_dual_update_global` with a token mask."""
    return bip_dual_update_global(
        s, q0, top_k=top_k, n_iters=n_iters, token_mask=mask, n_bisect=n_bisect, fanout=fanout
    )


def sanitize_duals(q: Tensor, abs_limit: float) -> Tuple[Tensor, Tensor]:
    """(q_safe, healthy): zeros when any entry is non-finite or exceeds
    `abs_limit` in magnitude, q itself (bitwise) otherwise."""
    healthy = torch.all(torch.isfinite(q) & (q.abs() <= abs_limit))
    return torch.where(healthy, q, torch.zeros_like(q)), healthy
