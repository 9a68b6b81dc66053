"""Observability for the port: telemetry recorder, metrics registry,
exporters, the flight recorder, telemetry-fitted oracles, replay drift
audits, per-tenant SLO monitors and the artifact schema checks (copies of
``repro.obs``), and the kernel-launch profiler (torch-synced).

Import surface is stdlib only but for the profiler's torch: replay and
fit lazy-import the simulator machinery (and replay the engine's
``Request``) on use, so importing this package builds no model."""

from .metrics import MetricsRegistry, NullMetrics, StreamingHistogram
from .telemetry import NULL, NullTelemetry, Telemetry, clock_anchor
from .exporters import (chrome_trace, parse_prometheus, write_chrome_trace,
                        write_jsonl, write_metrics)
from .profiling import KernelProfiler, install, profiled
from .recorder import FlightRecorder, load_record
from .fit import FittedOracle, fit_oracle, fit_table
from .replay import drift_report, replay_record
from .slo import SLOConfig, SLOMonitor
from .schema import (SCHEMA_VERSION, validate_chrome_trace,
                     validate_drift_report, validate_flight_record,
                     validate_metrics_snapshot, validate_slo_alert,
                     validate_telemetry_summary)

__all__ = [
    "MetricsRegistry", "NullMetrics", "StreamingHistogram",
    "NULL", "NullTelemetry", "Telemetry", "clock_anchor",
    "chrome_trace", "parse_prometheus", "write_chrome_trace", "write_jsonl",
    "write_metrics",
    "KernelProfiler", "install", "profiled",
    "FlightRecorder", "load_record",
    "FittedOracle", "fit_oracle", "fit_table",
    "drift_report", "replay_record",
    "SLOConfig", "SLOMonitor",
    "SCHEMA_VERSION", "validate_chrome_trace", "validate_drift_report",
    "validate_flight_record", "validate_metrics_snapshot",
    "validate_slo_alert", "validate_telemetry_summary",
]
