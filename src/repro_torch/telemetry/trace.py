"""Trace and profiler hooks (counterpart of ``repro/telemetry/trace.py``).

Three layers, all safe to leave in hot code:

* :func:`scope` — a ``torch.profiler.record_function`` range: names the
  work of a region (``serve.decode``) on the profiler's timeline; under
  ``nsys`` with NVTX capture it shows as an NVTX range. Costs a few
  microseconds of host time a call when no profiler runs.
* :func:`annotate` — the same range for HOST-side scheduler work (admit,
  step); the reference keeps the two apart (trace-time op names against a
  host span), which eager PyTorch does not need.
* :func:`profile_trace` — capture a ``torch.profiler`` trace (CPU, and the
  card's activity where there is one) into a logdir as a Chrome trace
  (``--profile`` in the launchers). Degrades to a warning + no-op if the
  profiler cannot start or stop here (it must never take down a run).
"""
from __future__ import annotations

import os
import warnings

import torch


def scope(name: str):
    """Named profiler range (see module docstring)."""
    return torch.profiler.record_function(name)


def annotate(name: str, **kwargs):
    """Host-side profiler range (keyword arguments are accepted for
    signature parity with the reference and not recorded)."""
    return torch.profiler.record_function(name)


class profile_trace:
    """Context manager capturing a ``torch.profiler`` trace into ``logdir``
    (``trace.json``, a Chrome trace).

    ``enabled=False`` makes it a no-op (so call sites can pass the CLI flag
    straight through); a profiler that fails to start or stop only warns.
    ``bool(ctx)`` inside the block reports whether a trace is actually
    being captured."""

    def __init__(self, logdir: str, enabled: bool = True):
        self.logdir = logdir
        self.enabled = enabled
        self.active = False
        self._prof = None

    def __bool__(self):
        return self.active

    def start(self):
        if not self.enabled or self.active:
            return self
        try:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.__enter__()
            self.active = True
        except Exception as e:  # missing backend, busy profiler, ...
            self._prof = None
            warnings.warn(f"torch profiler trace could not start: {e}",
                          RuntimeWarning)
        return self

    def stop(self):
        if not self.active:
            return
        self.active = False
        prof, self._prof = self._prof, None
        try:
            prof.__exit__(None, None, None)
            os.makedirs(self.logdir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(self.logdir, "trace.json"))
        except Exception as e:
            warnings.warn(f"torch profiler trace could not stop: {e}",
                          RuntimeWarning)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
