"""Metrics plane: a device-resident metric ring and its asynchronous drain
(port of src/repro/telemetry/metrics.py).

The contract is the reference's (DESIGN.md §Observability):

* **Accumulation on the device, no added syncs.** `MetricStream.accumulate`
  writes this step's metric values into one row of a ring
  (`slot = step % flush_every`) on the model's device. Every value written
  is one the step already computed, and the ring feeds nothing back, so a
  run with telemetry is bitwise the run without it. The row is one flat
  fp32 row and one flat int32 row, each written by one `torch.cat` into
  the ring (at most a few launches per step, not one per metric). Host
  scalars (`lr`) stay on the host: no host-to-device copy per step.

* **Asynchronous drain.** The port writes in place where the reference
  returns new buffers, so it keeps TWO rings and uses them in turn, one
  per window. When a window closes, a side stream waits on an event
  recorded on the compute stream after the window's last write and copies
  the ring into pinned host memory (allocated once, at `ensure_built`);
  the compute stream waits on the copy's done event before it writes that
  ring again, two windows later. A window is materialized (host arrays ->
  sink records) one window later, or at `finish()`, when its copy has long
  completed.

* **Integer load histograms.** The per-expert load keys (`LOAD_HIST_KEYS`)
  must arrive as integer counts; `MetricStream.build` asserts it, and the
  ring stores them as int32, as the reference's records: a histogram never
  passes through fp32.

Rollback: a guard rollback replays steps, so a drained window may hold rows
of steps that are emitted again later. Replay is deterministic, so the
duplicates agree; `metrics_report` keeps the last record of each step.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .sinks import Sink
from .trace import named_span

# per-expert load histogram keys: integer counts end to end (no float
# round trip), the telemetry dtype-audit contract
LOAD_HIST_KEYS = ("load", "moe_load", "load_per_layer")

# per-metric element cap: anything larger is not a metric but an activation
# that leaked into the metrics dict; it is not buffered
MAX_METRIC_ELEMS = 65536

_HOST_NUMERIC = (bool, int, float, np.number, np.bool_)
_NP_DTYPE = {torch.int32: np.int32, torch.float32: np.float32}


def _is_load_key(name: str) -> bool:
    return name in LOAD_HIST_KEYS


class MetricRing:
    """One ring of `flush_every` rows: the device rows (`f`: fp32, `i`:
    int32), their pinned host mirrors, the step each slot holds (`steps`,
    -1 = never written, on the host) and the host scalars of each slot."""

    def __init__(self, flush_every: int, n_float: int, n_int: int, device):
        dev = torch.device(device)
        pin = dev.type == "cuda"
        self.f = torch.zeros((flush_every, n_float), dtype=torch.float32, device=dev)
        self.i = torch.zeros((flush_every, n_int), dtype=torch.int32, device=dev)
        self.f_host = torch.zeros(self.f.shape, dtype=torch.float32, pin_memory=pin)
        self.i_host = torch.zeros(self.i.shape, dtype=torch.int32, pin_memory=pin)
        self.steps = np.full((flush_every,), -1, np.int64)
        self.host: List[Dict[str, Any]] = [{} for _ in range(flush_every)]
        self.copied = None  # CUDA event: the drain's copy of this ring is done

    @property
    def written(self) -> bool:
        return bool((self.steps >= 0).any())

    def reset(self) -> None:
        self.steps[:] = -1
        self.host = [{} for _ in self.host]


class MetricStream:
    """Layout and device ops of the (flush_every, ...) metric ring.

    `layout` maps each buffered metric to (shape, dtype): int32 for integer
    and bool metrics, fp32 for floating ones; `host_keys` are the metrics
    that arrive as host numbers and stay on the host."""

    def __init__(self, layout: Dict[str, Tuple[tuple, torch.dtype]], flush_every: int,
                 host_keys=()):
        assert flush_every >= 1
        self.layout = layout
        self.flush_every = int(flush_every)
        self.host_keys = tuple(k for k in layout if k in set(host_keys))
        dev = [k for k in layout if k not in self.host_keys]
        self.float_keys = tuple(k for k in dev if layout[k][1] == torch.float32)
        self.int_keys = tuple(k for k in dev if layout[k][1] == torch.int32)
        self._slices: Dict[str, slice] = {}
        for keys in (self.float_keys, self.int_keys):
            off = 0
            for k in keys:
                n = int(np.prod(layout[k][0], dtype=np.int64))
                self._slices[k] = slice(off, off + n)
                off += n
        self.n_float = sum(self._size(k) for k in self.float_keys)
        self.n_int = sum(self._size(k) for k in self.int_keys)

    def _size(self, k: str) -> int:
        return self._slices[k].stop - self._slices[k].start

    @classmethod
    def build(cls, mets: Dict[str, Any], flush_every: int) -> "MetricStream":
        """Derive the ring's layout from one step's metrics (tensors or host
        numbers): numeric and bool metrics only, at most MAX_METRIC_ELEMS
        elements each, bool stored as int32."""
        layout: Dict[str, Tuple[tuple, torch.dtype]] = {}
        host_keys = []
        for name in sorted(mets):
            v = mets[name]
            if isinstance(v, torch.Tensor):
                shape, dt = tuple(v.shape), v.dtype
                if dt.is_complex:
                    continue
                is_int = dt == torch.bool or not dt.is_floating_point
            elif isinstance(v, _HOST_NUMERIC):
                shape = ()
                is_int = isinstance(v, (bool, int, np.integer, np.bool_))
                host_keys.append(name)
            else:
                continue
            if int(np.prod(shape, dtype=np.int64)) > MAX_METRIC_ELEMS:
                continue
            if _is_load_key(name):
                assert is_int, (
                    f"load histogram {name!r} must be integer counts end-to-end "
                    f"(got {getattr(v, 'dtype', type(v).__name__)}); see LOAD_HIST_KEYS"
                )
            layout[name] = (shape, torch.int32 if is_int else torch.float32)
        return cls(layout, flush_every, host_keys)

    def init_buffer(self, device="cpu") -> MetricRing:
        return MetricRing(self.flush_every, self.n_float, self.n_int, device)

    def accumulate(self, buf: MetricRing, mets: Dict[str, Any], step_idx: int) -> MetricRing:
        """Write this step's metrics into the ring row `step_idx % flush_every`
        (in place; no host sync). Returns `buf`."""
        with named_span("telemetry/accumulate"):
            if buf.copied is not None:  # the last drain's copy must read the ring first
                torch.cuda.current_stream(buf.f.device).wait_event(buf.copied)
                buf.copied = None
            slot = int(step_idx) % self.flush_every
            if self.float_keys:
                torch.cat([mets[k].reshape(-1) for k in self.float_keys], out=buf.f[slot])
            if self.int_keys:
                torch.cat([mets[k].reshape(-1) for k in self.int_keys], out=buf.i[slot])
            buf.host[slot] = {k: _NP_DTYPE[self.layout[k][1]](mets[k]) for k in self.host_keys}
            buf.steps[slot] = int(step_idx)
        return buf

    def columns(self, f: np.ndarray, i: np.ndarray, steps: np.ndarray,
                host: List[Dict[str, Any]]) -> Dict[str, np.ndarray]:
        """The ring as the reference's buffer: {name: (flush_every, *shape)}
        plus '_step', from host copies of its rows."""
        out: Dict[str, np.ndarray] = {}
        for k, (shape, _) in self.layout.items():
            if k in self.host_keys:
                out[k] = np.asarray([h.get(k, 0) for h in host])
            else:
                rows = f if k in self.float_keys else i
                out[k] = rows[:, self._slices[k]].reshape((self.flush_every,) + shape)
        out["_step"] = steps.copy()
        return out

    def read(self, buf: MetricRing) -> Dict[str, np.ndarray]:
        """Read a ring back to the host now (waits for the device)."""
        return self.columns(buf.f.cpu().numpy(), buf.i.cpu().numpy(), buf.steps, buf.host)


class TrainTelemetry:
    """The host side: owns the stream, the two device rings and the async drain.

    Usage (train_loop wires this):
        tel = TrainTelemetry(sink, flush_every=10)
        step_fn = make_train_step(..., telemetry=tel)   # builds at step 0
        ...
        tel.before_step(i)                               # profiler window
        state, mets, buf = step_fn(state, batch, tel.buf, i)
        tel.note_step_time(i, dt)
        tel.after_step(i, buf)                           # drains at window ends
        ...
        tel.finish()                                     # partial window + pendings
    """

    def __init__(
        self,
        sink: Optional[Sink] = None,
        flush_every: int = 10,
        run_meta: Optional[Dict[str, Any]] = None,
        profiler=None,
    ):
        self.sink = sink
        self.profiler = profiler  # optional trace.Profiler ([N, M] windowed)
        self.flush_every = int(flush_every)
        self.stream: Optional[MetricStream] = None
        self._rings: List[MetricRing] = []
        self._cur = 0
        self._side = None  # CUDA stream of the drains' copies
        self._pending: List[Tuple[MetricRing, Any]] = []
        self._step_times: Dict[int, float] = {}
        self.n_records = 0
        if run_meta is not None and sink is not None:
            sink.emit({"kind": "run_meta", **run_meta})

    @property
    def built(self) -> bool:
        return self.stream is not None

    @property
    def buf(self) -> Optional[MetricRing]:
        """The ring the next step writes (None before the layout is built)."""
        return self._rings[self._cur] if self._rings else None

    def ensure_built(self, mets: Dict[str, Any]) -> None:
        """Build the layout from one step's metrics and allocate both rings
        (and their pinned mirrors) on the metrics' device, once."""
        if self.stream is not None:
            return
        self.stream = MetricStream.build(mets, self.flush_every)
        dev = next((v.device for v in mets.values() if isinstance(v, torch.Tensor)),
                   torch.device("cpu"))
        self._rings = [self.stream.init_buffer(dev) for _ in range(2)]
        if dev.type == "cuda":
            self._side = torch.cuda.Stream(dev)

    def before_step(self, step: int) -> None:
        """Pre-step hook: drives the profiler's capture window."""
        if self.profiler is not None:
            self.profiler.step(step)

    def note_step_time(self, step: int, dt: float) -> None:
        self._step_times[step] = dt

    def after_step(self, step: int, buf: Optional[MetricRing] = None) -> None:
        """Drain at window boundaries. `buf` is the ring the step wrote in
        place (the reference adopts the step's returned buffer here)."""
        if (step + 1) % self.flush_every == 0:
            self._start_drain()

    def event(self, record: Dict[str, Any]) -> None:
        """Emit a guard/fault/lifecycle event record immediately."""
        if self.sink is not None:
            rec = dict(record)
            rec.setdefault("kind", "event")
            self.sink.emit(rec)

    def _start_drain(self) -> None:
        ring = self.buf
        if ring is None or not ring.written:
            return
        done = None
        if self._side is not None:
            written = torch.cuda.Event()
            written.record(torch.cuda.current_stream(ring.f.device))
            self._side.wait_event(written)
            with torch.cuda.stream(self._side):
                ring.f_host.copy_(ring.f, non_blocking=True)
                ring.i_host.copy_(ring.i, non_blocking=True)
                done = torch.cuda.Event()
                done.record(self._side)
            ring.copied = done
        else:
            ring.f_host.copy_(ring.f)
            ring.i_host.copy_(ring.i)
        self._pending.append((ring, done))
        self._cur ^= 1
        # materialize older windows only: the newest copy keeps overlapping
        # with the next window's compute
        while len(self._pending) > 1:
            self._materialize(*self._pending.pop(0))

    def _materialize(self, ring: MetricRing, done) -> None:
        if done is not None and not done.query():
            done.synchronize()  # rare: the copy has had a whole window to finish
        host = self.stream.columns(ring.f_host.numpy().copy(), ring.i_host.numpy().copy(),
                                   ring.steps, ring.host)
        ring.reset()
        steps = host.pop("_step")
        for j in np.argsort(steps, kind="stable"):
            s = int(steps[j])
            if s < 0:
                continue  # never-written slot of a partial window
            rec: Dict[str, Any] = {"kind": "train_step", "step": s}
            dt = self._step_times.pop(s, None)
            if dt is not None:
                rec["step_time"] = dt
            for k, col in host.items():
                rec[k] = col[j]
            self.n_records += 1
            if self.sink is not None:
                self.sink.emit(rec)

    def finish(self) -> None:
        """Drain the partial window and every outstanding copy."""
        try:
            self._start_drain()
            while self._pending:
                self._materialize(*self._pending.pop(0))
        finally:
            if self.profiler is not None:
                self.profiler.close()


class MetricSeries:
    """Append-only host-side column store (backs TrainLog's list views).

    Columns are created on first sight and back-padded with None so every
    column has one entry per appended record; `truncate` serves the
    rollback rewind.
    """

    def __init__(self):
        self._cols: Dict[str, List[Any]] = {}
        self._n = 0

    def append(self, record: Dict[str, Any]) -> None:
        for k in self._cols:
            self._cols[k].append(record.get(k))
        for k, v in record.items():
            if k not in self._cols:
                self._cols[k] = [None] * self._n + [v]
        self._n += 1

    def column(self, name: str) -> List[Any]:
        return self._cols.get(name, [])

    def truncate(self, n: int) -> None:
        n = max(0, int(n))
        for k in self._cols:
            self._cols[k] = self._cols[k][:n]
        self._n = min(self._n, n)

    def __len__(self) -> int:
        return self._n


__all__ = [
    "LOAD_HIST_KEYS",
    "MAX_METRIC_ELEMS",
    "MetricRing",
    "MetricSeries",
    "MetricStream",
    "TrainTelemetry",
]
