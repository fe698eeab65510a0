"""Serving SLO plane: streaming latency histograms + request lifecycle
(a copy of src/repro/telemetry/slo.py).

`StreamingHistogram` keeps integer counts over fixed log-spaced buckets so
p50/p99 queries are O(buckets) with no sample retention — the engine can
absorb millions of requests without growing. `ServingTelemetry` owns every
counter the engine used to keep ad hoc (step/token counts, per-expert load,
MaxVio trace, shed/deadline tallies) plus the SLO histograms:

  - TTFT  = t_first_token - t_submitted (includes queue wait)
  - ITL   = (t_done - t_first_token) / max(n_generated - 1, 1)
  - queue wait = t_admitted - t_submitted

Per-request lifecycle records ('kind': 'serve_request') and the final
summary ('kind': 'serve_summary') flow through the same Sink API as
training metrics. All timestamps come from the engine's injectable clock,
so deterministic-clock tests exercise the full SLO path.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from .sinks import Sink


class StreamingHistogram:
    """Fixed log-spaced buckets with integer counts and quantile queries.

    Bucket edges span [lo, hi) multiplicatively; values below lo land in the
    first bucket, values at/above hi in the overflow bucket. Quantiles are
    linearly interpolated inside the owning bucket (in log space the buckets
    are narrow enough that this is within a bucket-width of exact).
    """

    def __init__(self, lo: float = 1e-4, hi: float = 1e3, n_buckets: int = 128):
        assert lo > 0 and hi > lo and n_buckets >= 2
        self.edges = np.logspace(np.log10(lo), np.log10(hi), n_buckets + 1)
        self.counts = np.zeros(n_buckets + 1, dtype=np.int64)  # [+overflow]
        self.n = 0
        self._sum = 0.0
        self._max = 0.0

    def add(self, value: float) -> None:
        v = float(value)
        if not np.isfinite(v) or v < 0:
            return
        i = int(np.searchsorted(self.edges, v, side="right")) - 1
        i = min(max(i, 0), len(self.counts) - 1)
        self.counts[i] += 1
        self.n += 1
        self._sum += v
        self._max = max(self._max, v)

    def quantile(self, p: float) -> float:
        if self.n == 0:
            return 0.0
        target = p * self.n
        cum = np.cumsum(self.counts)
        i = int(np.searchsorted(cum, target, side="left"))
        i = min(i, len(self.counts) - 1)
        if i >= len(self.edges) - 1:  # overflow bucket has no right edge
            return self._max
        lo, hi = self.edges[i], self.edges[i + 1]
        prev = cum[i - 1] if i > 0 else 0
        frac = (target - prev) / max(self.counts[i], 1)
        return float(lo + (hi - lo) * min(max(frac, 0.0), 1.0))

    @property
    def mean(self) -> float:
        return self._sum / self.n if self.n else 0.0

    def to_dict(self) -> Dict[str, Any]:
        nz = np.nonzero(self.counts)[0]
        return {
            "n": int(self.n),
            "mean": self.mean,
            "max": self._max,
            "p50": self.quantile(0.50),
            "p90": self.quantile(0.90),
            "p99": self.quantile(0.99),
            # sparse bucket encoding keeps summary records compact
            "bucket_lo": [float(self.edges[i]) for i in nz],
            "bucket_count": [int(self.counts[i]) for i in nz],
        }

    def reset(self) -> None:
        self.counts[:] = 0
        self.n = 0
        self._sum = 0.0
        self._max = 0.0


class ServingTelemetry:
    """All engine-side observability state, reset-able between measured phases.

    The engine exposes these fields through read-only properties so existing
    consumers (`eng.expert_load`, `eng.n_steps`, ...) keep working; benchmark
    warmup resets go through `reset()` instead of poking engine attributes.
    """

    def __init__(self, n_experts: int, sink: Optional[Sink] = None):
        self.n_experts = n_experts
        self.sink = sink
        self.reset()

    def reset(self) -> None:
        self.n_steps = 0
        self.prefill_tokens = 0
        self.decode_tokens = 0
        self.expert_load = np.zeros(self.n_experts, dtype=np.float64)
        self.max_vio_per_step: List[float] = []
        self.n_deadline_missed = 0
        self.n_shed = 0
        self.n_finished = 0
        self.queue_depth: List[int] = []
        self.ttft = StreamingHistogram()
        self.itl = StreamingHistogram()
        self.queue_wait = StreamingHistogram()

    # -- engine step hooks ------------------------------------------------
    def on_step(self, mets, n_prefill: int, n_decode: int, queue_depth: int) -> None:
        self.n_steps += 1
        self.prefill_tokens += n_prefill
        self.decode_tokens += n_decode
        self.expert_load += np.asarray(mets["moe_load"], np.float64)
        self.max_vio_per_step.append(float(mets["max_vio"]))
        self.queue_depth.append(int(queue_depth))

    def on_finish(self, req, n_generated: int) -> None:
        """Record a finished request's lifecycle; req carries the timestamps."""
        self.n_finished += 1
        if req.finish_reason in ("shed", "timeout"):
            self.n_shed += 1
        elif req.finish_reason in ("deadline", "expired"):
            self.n_deadline_missed += 1
        ttft = itl = qwait = None
        if req.t_first_token is not None and req.t_submitted is not None:
            ttft = req.t_first_token - req.t_submitted
            self.ttft.add(ttft)
        if req.t_admitted is not None and req.t_submitted is not None:
            qwait = req.t_admitted - req.t_submitted
            self.queue_wait.add(qwait)
        if (
            req.t_done is not None
            and req.t_first_token is not None
            and n_generated > 1
        ):
            itl = (req.t_done - req.t_first_token) / (n_generated - 1)
            self.itl.add(itl)
        if self.sink is not None:
            self.sink.emit(
                {
                    "kind": "serve_request",
                    "rid": req.req_id,
                    "finish_reason": req.finish_reason,
                    "n_generated": n_generated,
                    "t_submitted": req.t_submitted,
                    "t_admitted": req.t_admitted,
                    "t_first_token": req.t_first_token,
                    "t_done": req.t_done,
                    "ttft": ttft,
                    "itl": itl,
                    "queue_wait": qwait,
                }
            )

    # -- derived views ----------------------------------------------------
    def throughput(self, wall_s: float, n_devices: int = 1) -> Dict[str, Any]:
        """Tokens/s views of a measured phase. The telemetry plane has no
        wall clock or device context of its own (steps are timed by the
        caller, the engine may or may not sit on a mesh), so both are
        supplied here; tokens/s/device is the serving roofline axis the
        throughput bench reports per mesh shape."""
        total = self.prefill_tokens + self.decode_tokens
        tps = total / wall_s if wall_s > 0 else 0.0
        return {
            "tokens": int(total),
            "wall_s": float(wall_s),
            "tokens_per_s": tps,
            "n_devices": int(n_devices),
            "tokens_per_s_per_device": tps / max(int(n_devices), 1),
        }

    def live_max_vio(self) -> float:
        """MaxVio of the cumulative per-expert load seen so far."""
        total = self.expert_load.sum()
        if total <= 0:
            return 0.0
        mean = total / self.n_experts
        return float(self.expert_load.max() / mean - 1.0)

    def summary(self) -> Dict[str, Any]:
        return {
            "kind": "serve_summary",
            "n_steps": self.n_steps,
            "n_finished": self.n_finished,
            "prefill_tokens": self.prefill_tokens,
            "decode_tokens": self.decode_tokens,
            "n_deadline_missed": self.n_deadline_missed,
            "n_shed": self.n_shed,
            "expert_load": self.expert_load.tolist(),
            "live_max_vio": self.live_max_vio(),
            "mean_step_max_vio": (
                float(np.mean(self.max_vio_per_step)) if self.max_vio_per_step else 0.0
            ),
            "queue_depth_max": max(self.queue_depth, default=0),
            "queue_depth_mean": (
                float(np.mean(self.queue_depth)) if self.queue_depth else 0.0
            ),
            "ttft": self.ttft.to_dict(),
            "itl": self.itl.to_dict(),
            "queue_wait": self.queue_wait.to_dict(),
        }

    def emit_summary(self) -> Dict[str, Any]:
        s = self.summary()
        if self.sink is not None:
            self.sink.emit(s)
        return s


__all__ = ["ServingTelemetry", "StreamingHistogram"]
