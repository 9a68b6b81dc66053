"""Observability for the port: telemetry recorder, metrics registry and
the kernel-launch profiler (copies of ``repro.obs`` plus a torch-synced
profiler)."""

from .metrics import MetricsRegistry, NullMetrics, StreamingHistogram
from .telemetry import NULL, NullTelemetry, Telemetry
from .profiling import KernelProfiler, install, profiled

__all__ = [
    "MetricsRegistry", "NullMetrics", "StreamingHistogram",
    "NULL", "NullTelemetry", "Telemetry",
    "KernelProfiler", "install", "profiled",
]
