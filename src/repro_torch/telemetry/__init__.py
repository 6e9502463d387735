"""Telemetry of the port (counterpart of ``repro/telemetry``).

* :mod:`repro_torch.telemetry.events`  — versioned JSONL event log (typed,
  deterministic payload + wall-clock sidecar) and its schema validator.
* :mod:`repro_torch.telemetry.latency` — fixed-bucket latency histograms
  for the serving engine (TTFT, queue wait, decode step, per-token).
* :mod:`repro_torch.telemetry.trace`   — ``torch.profiler`` ranges and
  trace capture.
* :mod:`repro_torch.telemetry.metrics` — the residency accounting models
  (the per-agent metric panels of the reference's module come later).
"""
from repro_torch.telemetry.events import (EVENT_SCHEMAS, SCHEMA_VERSION,
                                          EventLog, format_event,
                                          make_run_id, read_events,
                                          validate_event, validate_stream,
                                          wall_path)
from repro_torch.telemetry.latency import (Histogram, default_bounds,
                                           histogram_set)
from repro_torch.telemetry.trace import annotate, profile_trace, scope

__all__ = [
    "EVENT_SCHEMAS", "SCHEMA_VERSION", "EventLog", "format_event",
    "make_run_id", "read_events", "validate_event", "validate_stream",
    "wall_path", "Histogram", "default_bounds", "histogram_set",
    "annotate", "profile_trace", "scope",
]
