"""Fixed-bucket latency histograms for the serving path (a copy of the
numpy-only ``repro/telemetry/latency.py``).

Prometheus-style: a fixed, log-spaced bucket ladder chosen ONCE at
construction (8 buckets per decade, 1 us .. ~100 s by default), so
recording is O(log B) with no allocation, snapshots are mergeable, and
percentiles are estimated by linear interpolation inside the bucket —
exactly the shape a scrape/export layer wants, unlike a growing list of
raw samples. Values are plain floats in SECONDS; summaries report
microseconds where the serving bench wants them.
"""
from __future__ import annotations

import math
from typing import List, Optional

import numpy as np


def default_bounds() -> np.ndarray:
    """Bucket upper bounds: 1 us .. ~100 s, 8 per decade (65 bounds)."""
    return 1e-6 * (10.0 ** (np.arange(65) / 8.0))


class Histogram:
    """Fixed-bucket histogram of nonnegative floats (seconds)."""

    def __init__(self, bounds: Optional[np.ndarray] = None):
        self.bounds = np.asarray(
            default_bounds() if bounds is None else bounds, np.float64)
        if self.bounds.ndim != 1 or len(self.bounds) < 1 or not np.all(
                np.diff(self.bounds) > 0):
            raise ValueError("bounds must be a 1-D increasing array")
        # counts[i] <= bounds[i]; counts[-1] is the overflow bucket
        self.counts = np.zeros(len(self.bounds) + 1, np.int64)
        self.n = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = 0.0

    def record(self, value: float, n: int = 1) -> None:
        """Record ``value`` (``n`` times — e.g. one decode-step latency
        counted once per live slot for the per-token view)."""
        v = float(value)
        i = int(np.searchsorted(self.bounds, v, side="left"))
        self.counts[i] += n
        self.n += n
        self.total += v * n
        self.vmin = min(self.vmin, v)
        self.vmax = max(self.vmax, v)

    def reset(self) -> None:
        self.counts[:] = 0
        self.n = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = 0.0

    @property
    def mean(self) -> float:
        return self.total / self.n if self.n else 0.0

    def percentile(self, p: float) -> float:
        """Bucket-interpolated p-quantile (p in [0, 100]), clamped to the
        observed [min, max]."""
        if not self.n:
            return 0.0
        target = (p / 100.0) * self.n
        cum = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            lo = self.bounds[i - 1] if i > 0 else 0.0
            hi = self.bounds[i] if i < len(self.bounds) else self.vmax
            if cum + c >= target:
                frac = (target - cum) / c
                est = lo + frac * (hi - lo)
                return float(min(max(est, self.vmin), self.vmax))
            cum += c
        return float(self.vmax)

    def summary(self) -> dict:
        """Compact export row: count, mean, p50/p90/p99, min/max (s)."""
        if not self.n:
            return {"count": 0}
        return {"count": int(self.n),
                "mean_s": float(self.mean),
                "p50_s": self.percentile(50),
                "p90_s": self.percentile(90),
                "p99_s": self.percentile(99),
                "min_s": float(self.vmin),
                "max_s": float(self.vmax)}

    def summary_us(self) -> dict:
        """summary() with latencies in rounded microseconds (bench/CLI)."""
        return {k.replace("_s", "_us"):
                (round(v * 1e6, 1) if k.endswith("_s") else v)
                for k, v in self.summary().items()}

    def to_dict(self, sparse: bool = True) -> dict:
        """Full export incl. bucket counts; ``sparse`` keeps only nonzero
        buckets as {upper-bound: count} (readable in BENCH json)."""
        out = self.summary()
        if sparse:
            out["buckets"] = {
                ("+inf" if i == len(self.bounds)
                 else f"{self.bounds[i]:.3g}"): int(c)
                for i, c in enumerate(self.counts) if c}
        else:
            out["bounds"] = [float(b) for b in self.bounds]
            out["counts"] = [int(c) for c in self.counts]
        return out

    def merge(self, other: "Histogram") -> "Histogram":
        # adding counts bucket-by-bucket is only meaningful on identical
        # ladders: merging a custom-``bounds`` snapshot into a default
        # one would silently mis-bin every sample, so refuse loudly and
        # name the first divergence
        if len(other.bounds) != len(self.bounds):
            raise ValueError(
                "cannot merge histograms with different bucket ladders: "
                f"{len(self.bounds)} bounds vs {len(other.bounds)}")
        if not np.all(other.bounds == self.bounds):
            i = int(np.argmax(other.bounds != self.bounds))
            raise ValueError(
                "cannot merge histograms with different bucket ladders: "
                f"bounds diverge at index {i} "
                f"({self.bounds[i]!r} vs {other.bounds[i]!r})")
        self.counts += other.counts
        self.n += other.n
        self.total += other.total
        self.vmin = min(self.vmin, other.vmin)
        self.vmax = max(self.vmax, other.vmax)
        return self


def histogram_set(names: List[str]) -> dict:
    """{name: fresh Histogram} — the engine's standard latency panel."""
    return {name: Histogram() for name in names}
