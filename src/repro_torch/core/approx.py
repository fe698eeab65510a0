"""Algorithm 4 — online BIP balancing with O(m·b) constant space (histograms)
(the port's copy of src/repro/core/approx.py; `route` also takes a torch row).

Instead of keeping the multisets Q_j, keep per-expert histograms over [0, 1)
with b bins. The (nk/m + 1)-th largest member is located by walking bin counts
from the top and linearly interpolating inside the located bin. Space is
O(m·b) regardless of stream length — the variant the paper recommends for
recommendation/ad-allocation scale (§5.2).

Vectorized over experts with numpy (this is a host-side streaming algorithm).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from repro_torch.core.lp_oracle import as_numpy


class ApproxBIPGate:
    """Streaming gate with histogram-approximated order statistics."""

    def __init__(
        self,
        n_tokens: int,
        n_experts: int,
        top_k: int,
        n_bins: int = 64,
        n_iters: int = 2,
        adaptive_capacity: bool = True,
    ):
        self.n = n_tokens
        self.m = n_experts
        self.k = top_k
        self.b = n_bins
        self.t_iters = n_iters
        self.adaptive = adaptive_capacity
        self.cap = max(int(n_tokens * top_k // n_experts), 1)
        self.q = np.zeros(n_experts, dtype=np.float64)
        # hist[j, l] counts members of Q_j in [l/b, (l+1)/b). Negative shifted
        # scores (s_j - p < 0) are clamped out (they can never top the order
        # statistic that matters, since q >= 0).
        self.hist = np.zeros((n_experts, n_bins), dtype=np.float64)
        self.seen = 0

    def _q_from_hist(self, extra: np.ndarray) -> np.ndarray:
        """Vectorized: (cap+1)-th largest of hist_j ∪ {extra_j}, interpolated."""
        h = self.hist.copy()
        valid = extra >= 0.0
        bins = np.clip((extra * self.b).astype(np.int64), 0, self.b - 1)
        h[np.arange(self.m)[valid], bins[valid]] += 1.0
        # cumulative count from the top bin downwards
        desc = h[:, ::-1]
        csum = np.cumsum(desc, axis=1)  # csum[:, i] = count in top i+1 bins
        if self.adaptive:  # rank grows with the stream: (t·k/m + 1)-th largest
            rank = int((self.seen + 1) * self.k // self.m) + 1
        else:
            rank = self.cap + 1
        total = csum[:, -1]
        located = csum >= rank  # first True column holds the answer
        has = located.any(axis=1)
        first = np.where(has, located.argmax(axis=1), 0)
        l = self.b - 1 - first  # original bin index
        # interpolate inside bin [l/b, (l+1)/b): fraction of the bin's count
        # still above the target rank.
        cnt_in = np.take_along_axis(h, l[:, None], axis=1)[:, 0]
        cnt_above = np.where(
            first > 0,
            np.take_along_axis(csum, (first - 1)[:, None].clip(min=0), axis=1)[:, 0],
            0.0,
        )
        need = rank - cnt_above  # 1 <= need <= cnt_in where located
        frac = np.where(cnt_in > 0, 1.0 - need / np.maximum(cnt_in, 1.0), 0.0)
        val = (l + frac) / self.b
        q = np.where(has & (total >= rank), np.maximum(val, 0.0), 0.0)
        return q

    def route(self, scores: Sequence[float]) -> Tuple[np.ndarray, np.ndarray]:
        s = as_numpy(scores).astype(np.float64)
        assert s.shape == (self.m,)
        corrected = s - self.q
        idx = np.argsort(-corrected, kind="stable")[: self.k]
        gates = s[idx]

        p = 0.0
        for _ in range(self.t_iters):
            if self.k < self.m:
                p = max(0.0, float(np.partition(s - self.q, self.m - self.k - 1)[self.m - self.k - 1]))
            shifted = s - p
            self.q = self._q_from_hist(shifted)

        # Commit into histograms (line 15: Q = Q').
        shifted = s - p
        valid = shifted >= 0.0
        bins = np.clip((shifted * self.b).astype(np.int64), 0, self.b - 1)
        self.hist[np.arange(self.m)[valid], bins[valid]] += 1.0
        self.seen += 1
        return idx.astype(np.int64), gates

    def load_stats(self, assignments: np.ndarray) -> dict:
        load = np.bincount(assignments.reshape(-1), minlength=self.m)
        mean = max(self.seen * self.k / self.m, 1e-9)
        return {"load": load, "max_vio": float(load.max()) / mean - 1.0}
