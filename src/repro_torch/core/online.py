"""Algorithm 3 — online BIP-Based Balancing, one routing gate (the port's copy
of src/repro/core/online.py: host numpy; `route` also takes a torch row).

Tokens arrive one at a time; the gate keeps, per expert j, the multiset
Q_j = {s_j - p} of price-shifted scores seen so far, and the current dual
price q_j. Each arrival is routed by top-k over (s - q), then q is refreshed
by T rounds of:

    p   = max(0, (k+1)-th largest of {s_l - q_l})
    q_j = max(0, (rank)-th largest of Q_j ∪ {s_j - p})

Two capacity modes:

* faithful (adaptive_capacity=False): rank = nk/m + 1 with n the full nominal
  horizon, exactly Algorithm 3. The capacity constraint only starts to bind
  once |Q_j| exceeds nk/m, so balance is a property of the *whole* stream,
  not of early prefixes. Per-expert min-heaps keep the top (cap+1) members —
  lossless for this query since adding elements can only move the order
  statistic up — giving the paper's O(m log n) per-token cost (§5.2).

* adaptive (adaptive_capacity=True, default): rank = t·k/m + 1 where t is the
  number of tokens seen so far. The price binds from the start, giving prefix
  balance (the property the batch Algorithm 1 has). Needs the full multiset
  (ranks grow), so it stores all shifted scores — use ApproxBIPGate
  (Algorithm 4) for constant-space adaptive behaviour at scale.
"""
from __future__ import annotations

import heapq
from typing import List, Sequence, Tuple

import numpy as np

from repro_torch.core.lp_oracle import as_numpy


class OnlineBIPGate:
    """Streaming gate: call .route(scores) once per arriving token."""

    def __init__(
        self,
        n_tokens: int,
        n_experts: int,
        top_k: int,
        n_iters: int = 2,
        adaptive_capacity: bool = True,
    ):
        self.n = n_tokens            # nominal horizon (faithful-mode capacity)
        self.m = n_experts
        self.k = top_k
        self.t_iters = n_iters
        self.adaptive = adaptive_capacity
        self.q = np.zeros(n_experts, dtype=np.float64)
        self.cap = max(int(n_tokens * top_k // n_experts), 1)
        # faithful mode: min-heap per expert with top min(|Q_j|, cap+1) members
        self.heaps: List[List[float]] = [[] for _ in range(n_experts)]
        # adaptive mode: full history, shape (m, t)
        self._hist: List[np.ndarray] = []
        self.seen = 0

    # -- order statistics ----------------------------------------------------

    def _kth_of_union_heap(self, j: int, extra: float) -> float:
        """(cap+1)-th largest of Q_j ∪ {extra}, O(1), faithful mode."""
        h = self.heaps[j]
        size = self.seen  # |Q_j| == tokens seen (every token feeds every Q_j)
        if size + 1 <= self.cap:
            return 0.0  # union smaller than cap+1 -> capacity constraint slack
        if size == self.cap:
            return min(h[0], extra)  # union has exactly cap+1: its minimum
        root = h[0]  # heap holds top cap+1 of Q_j; root IS the answer sans extra
        if extra <= root:
            return root
        second = min(h[1:3]) if len(h) > 1 else extra
        return min(extra, second)

    def _kth_adaptive(self, shifted: np.ndarray) -> np.ndarray:
        """rank_t-th largest of Q_j ∪ {shifted_j}, vectorized over experts."""
        t = self.seen + 1  # union size
        rank = int(t * self.k // self.m) + 1  # (t·k/m + 1)-th largest
        if rank > t:
            return np.zeros(self.m)
        hist = np.vstack(self._hist + [shifted])  # (t, m)
        part = np.partition(hist, t - rank, axis=0)[t - rank]  # rank-th largest
        return np.maximum(part, 0.0)

    # -- public API -----------------------------------------------------------

    def route(self, scores: Sequence[float]) -> Tuple[np.ndarray, np.ndarray]:
        """Route one token. Returns (top-k expert ids, gate values = raw s)."""
        s = as_numpy(scores).astype(np.float64)
        assert s.shape == (self.m,)
        corrected = s - self.q
        idx = np.argsort(-corrected, kind="stable")[: self.k]
        gates = s[idx]

        p = 0.0
        for _ in range(self.t_iters):
            if self.k < self.m:
                part = np.partition(s - self.q, self.m - self.k - 1)
                p = max(0.0, float(part[self.m - self.k - 1]))
            shifted = s - p
            if self.adaptive:
                self.q = self._kth_adaptive(shifted)
            else:
                for j in range(self.m):
                    self.q[j] = max(0.0, self._kth_of_union_heap(j, float(shifted[j])))

        # Commit s_j - p into each Q_j (line 13-14 of Algorithm 3).
        shifted = s - p
        if self.adaptive:
            self._hist.append(shifted.copy())
        else:
            for j in range(self.m):
                h = self.heaps[j]
                if len(h) <= self.cap:  # keep up to cap+1 members
                    heapq.heappush(h, float(shifted[j]))
                elif shifted[j] > h[0]:
                    heapq.heapreplace(h, float(shifted[j]))
        self.seen += 1
        return idx.astype(np.int64), gates

    def load_stats(self, assignments: np.ndarray) -> dict:
        load = np.bincount(assignments.reshape(-1), minlength=self.m)
        mean = max(self.seen * self.k / self.m, 1e-9)
        return {"load": load, "max_vio": float(load.max()) / mean - 1.0}
