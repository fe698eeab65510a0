"""Serving telemetry of the port: SLO histograms and metric sinks."""
from repro_torch.telemetry.sinks import (
    CSVSink,
    JSONLSink,
    MemorySink,
    MultiSink,
    Sink,
    open_sink,
)
from repro_torch.telemetry.slo import ServingTelemetry, StreamingHistogram

__all__ = [
    "CSVSink",
    "JSONLSink",
    "MemorySink",
    "MultiSink",
    "ServingTelemetry",
    "Sink",
    "StreamingHistogram",
    "open_sink",
]
