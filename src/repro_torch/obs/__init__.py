"""Observability for the port: telemetry recorder, metrics registry,
exporters, the flight recorder, per-tenant SLO monitors, the artifact
schema checks (copies of ``repro.obs``) and the kernel-launch profiler
(torch-synced).  ``repro.obs.fit`` and ``repro.obs.replay`` are not
ported yet."""

from .metrics import MetricsRegistry, NullMetrics, StreamingHistogram
from .telemetry import NULL, NullTelemetry, Telemetry
from .exporters import (chrome_trace, parse_prometheus, write_chrome_trace,
                        write_jsonl, write_metrics)
from .profiling import KernelProfiler, install, profiled
from .recorder import FlightRecorder, load_record
from .slo import SLOConfig, SLOMonitor
from .schema import (SCHEMA_VERSION, validate_chrome_trace,
                     validate_drift_report, validate_flight_record,
                     validate_metrics_snapshot, validate_slo_alert,
                     validate_telemetry_summary)

__all__ = [
    "MetricsRegistry", "NullMetrics", "StreamingHistogram",
    "NULL", "NullTelemetry", "Telemetry",
    "chrome_trace", "parse_prometheus", "write_chrome_trace", "write_jsonl",
    "write_metrics",
    "KernelProfiler", "install", "profiled",
    "FlightRecorder", "load_record",
    "SLOConfig", "SLOMonitor",
    "SCHEMA_VERSION", "validate_chrome_trace", "validate_drift_report",
    "validate_flight_record", "validate_metrics_snapshot",
    "validate_slo_alert", "validate_telemetry_summary",
]
