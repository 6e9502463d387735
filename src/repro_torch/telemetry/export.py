"""Periodic JSON snapshot export of a run's telemetry state (a copy of the
pure-Python ``repro/telemetry/export.py``: the same snapshot for the same
stream).

:class:`SnapshotExporter` is a live reduction over the deterministic
event stream: attach it as ``EventLog(sink=...)`` and it folds every
emitted record into a compact summary — event counts by type, the
latest round metrics, eval history, fault tally, the policy's
per-agent resident bytes — and rewrites ONE JSON snapshot file
atomically every ``every`` round events. Dashboards and schedulers poll
the snapshot instead of tailing and re-parsing the full JSONL stream;
the stream stays the byte-identical record (the exporter never writes
into it).

Latency histograms from other subsystems (the serving engine's TTFT /
decode panels) fold in via :meth:`SnapshotExporter.merge_hist`, which
accumulates through :meth:`repro_torch.telemetry.latency.Histogram.merge` —
snapshots carry their compact ``summary()`` rows.

The module is also the offline CLI for finished runs::

    python -m repro_torch.telemetry.export events.jsonl \
        [--out snapshot.json] [--every 0]

which replays a recorded stream through the same reduction and writes
the final snapshot (``--every N`` additionally writes every N rounds
while replaying, mirroring the live cadence).
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Optional

from repro_torch.telemetry.events import SCHEMA_VERSION, read_events


def _atomic_json(path: str, obj) -> None:
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=1, sort_keys=True)
        f.write("\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


class SnapshotExporter:
    """Fold deterministic events into a periodically-written snapshot.

    ``every=N`` rewrites the snapshot after every N ``round`` events
    (and on :meth:`close`); ``every=0`` disables the cadence — only
    explicit :meth:`write` / :meth:`close` calls touch the file.
    ``path=None`` keeps the reduction in memory (``snapshot()`` for
    tests and the CLI)."""

    def __init__(self, path: Optional[str] = None, *, every: int = 1):
        if every < 0:
            raise ValueError(f"every must be >= 0, got {every}")
        self.path = path
        self.every = int(every)
        self.counts: dict = {}
        self.last_round: Optional[dict] = None
        self.run: dict = {}
        self.evals: list = []
        self.faults: int = 0
        self.resident_bytes: Optional[int] = None
        self.hists: dict = {}
        self._rounds_since_write = 0

    # ------------------------------------------------------------ folding
    def __call__(self, ev: dict) -> None:
        """The ``EventLog.sink`` entry point: fold one event record."""
        t = ev.get("type")
        self.counts[t] = self.counts.get(t, 0) + 1
        if t in ("run_start", "serve_start"):
            self.run = {"run_id": ev.get("run_id"),
                        "schema": ev.get("schema"),
                        "config": ev.get("config")}
        elif t == "round":
            self.last_round = {k: v for k, v in ev.items()
                               if k not in ("type", "seq")
                               and not isinstance(v, list)}
            if ev.get("resident_bytes") is not None:
                self.resident_bytes = ev["resident_bytes"]
            self._rounds_since_write += 1
            if (self.path is not None and self.every
                    and self._rounds_since_write >= self.every):
                self.write()
        elif t == "eval":
            self.evals.append({"round": ev.get("round"),
                               "merged_eval": ev.get("merged_eval"),
                               "local_eval": ev.get("local_eval")})
        elif t == "fault":
            self.faults += 1
        elif t in ("run_end", "serve_end"):
            self.run = {**self.run, "end": {
                k: v for k, v in ev.items() if k not in ("type", "seq")}}

    def merge_hist(self, name: str, hist) -> None:
        """Accumulate a latency histogram under ``name`` (snapshots carry
        its summary row); repeated merges fold via Histogram.merge."""
        if name in self.hists:
            self.hists[name].merge(hist)
        else:
            # a private accumulator: merging into the caller's live
            # histogram would double-count its future updates
            import copy
            self.hists[name] = copy.deepcopy(hist)

    # ------------------------------------------------------------- output
    def snapshot(self) -> dict:
        out = {
            "schema": SCHEMA_VERSION,
            "events": dict(sorted(self.counts.items())),
            "run": self.run,
            "last_round": self.last_round,
            "faults": self.faults,
        }
        if self.resident_bytes is not None:
            out["resident_bytes_per_agent"] = self.resident_bytes
        if self.evals:
            out["evals"] = self.evals
        if self.hists:
            out["latency"] = {k: h.summary()
                              for k, h in sorted(self.hists.items())}
        return out

    def write(self) -> dict:
        """Atomically rewrite the snapshot file; returns the snapshot."""
        snap = self.snapshot()
        if self.path is not None:
            _atomic_json(self.path, snap)
        self._rounds_since_write = 0
        return snap

    def close(self) -> dict:
        """Final write (the run's last state always lands on disk)."""
        return self.write()


def export_stream(events_path: str, out_path: Optional[str] = None, *,
                  every: int = 0) -> dict:
    """Replay a recorded events JSONL through the snapshot reduction;
    returns (and optionally writes) the final snapshot."""
    exp = SnapshotExporter(out_path, every=every)
    for ev in read_events(events_path):
        exp(ev)
    return exp.close() if out_path is not None else exp.snapshot()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Reduce an events JSONL stream to a JSON snapshot")
    ap.add_argument("events", help="deterministic events .jsonl file")
    ap.add_argument("--out", default=None,
                    help="snapshot path (default: <events>.snapshot.json)")
    ap.add_argument("--every", type=int, default=0,
                    help="also rewrite the snapshot every N rounds while "
                         "replaying (0 = final only)")
    args = ap.parse_args(argv)
    out = args.out
    if out is None:
        base = args.events
        if base.endswith(".jsonl"):
            base = base[:-len(".jsonl")]
        out = base + ".snapshot.json"
    snap = export_stream(args.events, out, every=args.every)
    n = sum(snap["events"].values())
    print(f"{out}: {n} events "
          f"({snap['events'].get('round', 0)} rounds) reduced")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
