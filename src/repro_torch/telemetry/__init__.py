"""Telemetry of the port (counterpart of ``repro/telemetry``).

* :mod:`repro_torch.telemetry.events`  — versioned JSONL event log (typed,
  deterministic payload + wall-clock sidecar, truncate-on-resume) and its
  schema validator.
* :mod:`repro_torch.telemetry.metrics` — per-agent (m,) metric columns of
  the segment driver (loss, grad norm, distance to the mean, liveness,
  exact codec wire bytes) and the residency byte models.
* :mod:`repro_torch.telemetry.latency` — fixed-bucket latency histograms
  for the serving engine (TTFT, queue wait, decode step, per-token).
* :mod:`repro_torch.telemetry.trace`   — ``torch.profiler`` ranges and
  trace capture.
* :mod:`repro_torch.telemetry.export`  — periodic JSON snapshot reduction
  over the event stream (``EventLog(sink=SnapshotExporter(...))``) and the
  offline ``python -m repro_torch.telemetry.export`` CLI;
  ``python -m repro_torch.telemetry.validate`` is the stream validator's.
"""
from repro_torch.telemetry.events import (EVENT_SCHEMAS, SCHEMA_VERSION,
                                          EventLog, format_event,
                                          make_run_id, read_events,
                                          validate_event, validate_stream,
                                          wall_path)
from repro_torch.telemetry.export import SnapshotExporter, export_stream
from repro_torch.telemetry.latency import (Histogram, default_bounds,
                                           histogram_set)
from repro_torch.telemetry.trace import annotate, profile_trace, scope

__all__ = [
    "EVENT_SCHEMAS", "SCHEMA_VERSION", "EventLog", "format_event",
    "make_run_id", "read_events", "validate_event", "validate_stream",
    "wall_path", "SnapshotExporter", "export_stream",
    "Histogram", "default_bounds", "histogram_set",
    "annotate", "profile_trace", "scope",
]
