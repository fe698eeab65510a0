"""Pluggable metric sinks (a copy of src/repro/telemetry/sinks.py).

A sink consumes flat dict records — one per train step, guard event,
serving request, or summary — and owns its own durability. The contract is
deliberately tiny so every telemetry producer (MetricStream drains, the
serving SLO tracker, guard events) shares one export path:

    sink.emit(record)   # record: JSON-serializable dict with a 'kind' key
    sink.close()        # flush + release; emit after close raises

`JSONLSink` is the canonical format (one JSON object per line, append-only,
crash-tolerant: a torn final line is ignorable). `CSVSink` flattens records
onto a fixed header inferred from the first record of each kind (one file
per kind, since train steps and serve requests share no columns).
`MemorySink` backs tests and the terminal reporter. `MultiSink` fans out.

`open_sink(path)` resolves a writer by extension so launchers need one flag.
"""
from __future__ import annotations

import csv
import json
import os
from typing import Any, Dict, List, Optional

import numpy as np


def _jsonable(v):
    """Coerce numpy scalars and arrays (and CPU tensors) into JSON-native types."""
    if isinstance(v, (np.generic,)):
        return v.item()
    if hasattr(v, "tolist"):  # np.ndarray / CPU torch.Tensor
        return np.asarray(v).tolist()
    if isinstance(v, dict):
        return {k: _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    return v


class Sink:
    """Base sink: emit() records, close() when done."""

    closed: bool = False

    def emit(self, record: Dict[str, Any]) -> None:
        raise NotImplementedError

    def close(self) -> None:
        self.closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class MemorySink(Sink):
    """Collects records in a list — tests and the terminal reporter."""

    def __init__(self):
        self.records: List[Dict[str, Any]] = []

    def emit(self, record: Dict[str, Any]) -> None:
        assert not self.closed, "emit() after close()"
        self.records.append(_jsonable(record))


class JSONLSink(Sink):
    """One JSON object per line, append-friendly and crash-tolerant."""

    def __init__(self, path: str):
        self.path = path
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._f = open(path, "w")

    def emit(self, record: Dict[str, Any]) -> None:
        assert not self.closed, "emit() after close()"
        self._f.write(json.dumps(_jsonable(record)) + "\n")

    def close(self) -> None:
        if not self.closed:
            self._f.flush()
            self._f.close()
        super().close()


class CSVSink(Sink):
    """Flat CSV, one file per record kind (<stem>.<kind>.csv).

    Array-valued fields are JSON-encoded into their cell so the row stays
    one line; the header is fixed by the first record of each kind and
    later records are projected onto it (missing fields empty, extras
    dropped) — CSV is the lossy convenience format, JSONL the faithful one.
    """

    def __init__(self, path: str):
        self.path = path
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._stem = path[:-4] if path.endswith(".csv") else path
        self._files: Dict[str, Any] = {}
        self._writers: Dict[str, csv.DictWriter] = {}

    def _cell(self, v):
        v = _jsonable(v)
        if isinstance(v, (list, dict)):
            return json.dumps(v)
        return v

    def emit(self, record: Dict[str, Any]) -> None:
        assert not self.closed, "emit() after close()"
        kind = str(record.get("kind", "record"))
        if kind not in self._writers:
            f = open(f"{self._stem}.{kind}.csv", "w", newline="")
            w = csv.DictWriter(f, fieldnames=list(record), extrasaction="ignore")
            w.writeheader()
            self._files[kind], self._writers[kind] = f, w
        self._writers[kind].writerow(
            {k: self._cell(record.get(k, "")) for k in self._writers[kind].fieldnames}
        )

    def close(self) -> None:
        if not self.closed:
            for f in self._files.values():
                f.flush()
                f.close()
        super().close()


class MultiSink(Sink):
    """Fan one emit out to several sinks."""

    def __init__(self, *sinks: Sink):
        self.sinks = [s for s in sinks if s is not None]

    def emit(self, record: Dict[str, Any]) -> None:
        for s in self.sinks:
            s.emit(record)

    def close(self) -> None:
        for s in self.sinks:
            s.close()
        super().close()


def open_sink(path: Optional[str]) -> Optional[Sink]:
    """Resolve a sink from a launcher --telemetry path (None passes through)."""
    if path is None:
        return None
    if path.endswith(".csv"):
        return CSVSink(path)
    return JSONLSink(path)


__all__ = [
    "CSVSink",
    "JSONLSink",
    "MemorySink",
    "MultiSink",
    "Sink",
    "open_sink",
]
