"""Telemetry of the port (the reference's three planes behind one sink API):

* metrics - `MetricStream` ring on the model's device, written after each
  train step and drained asynchronously every `flush_every` steps
  (`TrainTelemetry`): integer per-expert load histograms, MaxVio, BIP dual
  health, guard events;
* tracing - `named_span` / `trace_span` (torch.profiler.record_function)
  and `Profiler` windows for `--profile N:M`;
* serving SLOs - `ServingTelemetry` TTFT / inter-token / queue-wait
  histograms, per-expert live load, shed and deadline counters.

`metrics_report` renders a sink file on the terminal or as HTML.
"""
from repro_torch.telemetry.metrics import (
    LOAD_HIST_KEYS,
    MetricSeries,
    MetricStream,
    TrainTelemetry,
)
from repro_torch.telemetry.sinks import (
    CSVSink,
    JSONLSink,
    MemorySink,
    MultiSink,
    Sink,
    open_sink,
)
from repro_torch.telemetry.slo import ServingTelemetry, StreamingHistogram
from repro_torch.telemetry.trace import Profiler, named_span, profile_window, trace_span

__all__ = [
    "CSVSink",
    "JSONLSink",
    "LOAD_HIST_KEYS",
    "MemorySink",
    "MetricSeries",
    "MetricStream",
    "MultiSink",
    "Profiler",
    "ServingTelemetry",
    "Sink",
    "StreamingHistogram",
    "TrainTelemetry",
    "named_span",
    "open_sink",
    "profile_window",
    "trace_span",
]
