"""Structured, versioned event log: the run's trajectory as typed JSONL (a
copy of the pure-Python ``repro/telemetry/events.py``: the same schemas,
the same bytes for the same emits).

Two streams per run:

* **Deterministic events** (``events.jsonl``) — the trajectory record:
  run/round/merge/eval/fault lifecycle for training, request lifecycle for
  serving. Every record is a single JSON line with sorted keys, a
  monotonically increasing ``seq``, and a ``type`` validated against
  :data:`EVENT_SCHEMAS` at emit time. The payload carries NO wall-clock
  values, so two runs of the same configuration produce BYTE-IDENTICAL
  streams (in the reference, a baseline vs a SIGKILL + ``--resume`` pair
  too: the contract ``scripts/fault_smoke.py`` checks).
* **Wall-clock sidecar** (``events.wall.jsonl``) — operational records
  (:meth:`EventLog.emit_op`): per-event timestamps, segment wall times,
  checkpoint save/restore, profiler start/stop, serve latency notes.
  Free-schema, append-only, never compared across runs.

Appends are a SINGLE ``write()`` of the full line on a file opened in
append mode, flushed per event, so a crash never leaves a torn line and
concurrent emitters (the async checkpoint thread) interleave whole
records. :meth:`EventLog.truncate` rewrites the deterministic stream to
its first ``n`` records — the resume hook: the launcher checkpoints
``seq`` with the train state and truncates back to it before continuing,
giving exactly-once round events across kill/resume.

``run_id`` is a HASH of the run configuration (:func:`make_run_id`), not
a uuid/timestamp — determinism extends to the id itself.
"""
from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional

# v2: 'round' gains the optional 'resident_bytes' field — the exact
# per-agent resident-HBM cost of the run's residency policy
# (metrics.resident_bytes_model), a host constant stamped on every
# round. v1 streams (no such field) still validate.
# v3: 'round' gains the optional 'transient_bytes' field — the in-round
# peak of the f32 decode views the unfused storage path materializes
# (zero when the fused moment kernel is active); 'resident_bytes' stays
# the STORED total, so peak per-agent HBM is the sum of the two. Older
# streams still validate.
SCHEMA_VERSION = 3

# Field types: int / float / str / bool / dict / id (int-or-str) /
# list[float] / list[int]; a '?' prefix marks the field optional.
EVENT_SCHEMAS: Dict[str, Dict[str, str]] = {
    # ---------------------------------------------------------- training
    "run_start": {"run_id": "str", "schema": "int", "config": "dict"},
    "round": {
        "round": "int", "loss": "float", "grad_norm": "float",
        "grad_norm_max": "float", "consensus": "float",
        "comm_cost_P": "float",
        # per-agent metric panels (--telemetry): one entry per agent
        "loss_agent": "?list[float]", "grad_norm_agent": "?list[float]",
        "dist_to_mean": "?list[float]", "live": "?list[int]",
        "wire_bytes": "?list[int]",
        # per-agent resident HBM bytes under the residency policy (v2)
        "resident_bytes": "?int",
        # per-agent transient f32 decode-view bytes of the unfused
        # storage path; 0 under the fused moment kernel (v3)
        "transient_bytes": "?int",
    },
    "merge": {"round": "int", "operator": "str"},
    "eval": {"round": "int", "merged_eval": "float", "local_eval": "float"},
    "fault": {"round": "int", "agent": "int", "kind": "str"},  # kill|rejoin
    "run_end": {"rounds": "int", "final_loss": "float",
                "comm_cost_P": "float"},
    # ----------------------------------------------------------- serving
    "serve_start": {"run_id": "str", "schema": "int", "config": "dict"},
    "request_submit": {"rid": "id", "prompt_len": "int", "max_new": "int"},
    "request_admit": {"rid": "id", "slot": "int", "tick": "int"},
    "request_retire": {"rid": "id", "slot": "int", "tick": "int",
                       "tokens": "int"},
    "serve_end": {"requests": "int", "tokens": "int", "ticks": "int",
                  "occupancy": "float"},
}

# fields every record carries, written by the log itself
_RESERVED = ("type", "seq")


def wall_path(path: str) -> str:
    """Sidecar path for an events file: ``x.jsonl`` -> ``x.wall.jsonl``."""
    if path.endswith(".jsonl"):
        return path[:-len(".jsonl")] + ".wall.jsonl"
    return path + ".wall"


def make_run_id(config: dict) -> str:
    """Deterministic 12-hex run id from the run configuration (the same
    config — baseline or resumed — maps to the same id)."""
    blob = json.dumps(config, sort_keys=True, separators=(",", ":"),
                      default=str)
    return hashlib.sha1(blob.encode()).hexdigest()[:12]


def _jsonable(v):
    """numpy scalars/arrays -> plain Python so json emits canonical text."""
    if hasattr(v, "item") and not hasattr(v, "__len__"):
        return v.item()
    if hasattr(v, "tolist"):
        return v.tolist()
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {k: _jsonable(x) for k, x in v.items()}
    return v


def _check_type(v, spec: str) -> bool:
    if spec.startswith("list["):
        inner = spec[5:-1]
        return (isinstance(v, list)
                and all(_check_type(x, inner) for x in v))
    if spec == "int":
        return isinstance(v, int) and not isinstance(v, bool)
    if spec == "float":  # json ints are acceptable floats
        return (isinstance(v, (int, float))
                and not isinstance(v, bool))
    if spec == "str":
        return isinstance(v, str)
    if spec == "bool":
        return isinstance(v, bool)
    if spec == "dict":
        return isinstance(v, dict)
    if spec == "id":
        return isinstance(v, (int, str)) and not isinstance(v, bool)
    raise ValueError(f"unknown schema field type {spec!r}")


def validate_event(ev: dict) -> List[str]:
    """Schema errors for ONE decoded event record ([] = valid): unknown
    type, missing/unknown fields, wrong field types, bad seq."""
    errors = []
    etype = ev.get("type")
    if not isinstance(etype, str) or etype not in EVENT_SCHEMAS:
        return [f"unknown event type {etype!r}"]
    if not isinstance(ev.get("seq"), int):
        errors.append(f"{etype}: missing/non-int 'seq'")
    schema = EVENT_SCHEMAS[etype]
    for name, spec in schema.items():
        optional = spec.startswith("?")
        tspec = spec[1:] if optional else spec
        if name not in ev:
            if not optional:
                errors.append(f"{etype}: missing required field {name!r}")
            continue
        if not _check_type(ev[name], tspec):
            errors.append(f"{etype}: field {name!r} is not a {tspec}: "
                          f"{ev[name]!r}")
    for name in ev:
        if name not in schema and name not in _RESERVED:
            errors.append(f"{etype}: unknown field {name!r}")
    return errors


def validate_stream(path: str) -> List[str]:
    """Validate a whole events JSONL file. Checks every record's schema,
    that ``seq`` increments from 0 with no gaps or duplicates, and that
    ``round`` events' rounds are strictly increasing (no duplicated or
    missing rounds across a resume)."""
    errors = []
    last_round = None
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                errors.append(f"line {i}: empty line")
                continue
            try:
                ev = json.loads(line)
            except json.JSONDecodeError as e:
                errors.append(f"line {i}: bad JSON ({e})")
                continue
            errors += [f"line {i}: {e}" for e in validate_event(ev)]
            if ev.get("seq") != i:
                errors.append(f"line {i}: seq {ev.get('seq')!r} != line "
                              "index (gap or duplicate)")
            if ev.get("type") == "round":
                r = ev.get("round")
                if last_round is not None and r != last_round + 1:
                    errors.append(
                        f"line {i}: round {r} after round {last_round} "
                        "(duplicated or missing round event)")
                last_round = r
    return errors


def read_events(path: str) -> List[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def format_event(ev: dict) -> Optional[str]:
    """Human console line for a deterministic event (None = silent)."""
    t = ev.get("type")
    if t == "round":
        s = (f"[{ev['round']:4d}] loss={ev['loss']:.4f} "
             f"gn={ev['grad_norm']:.3f}/{ev['grad_norm_max']:.3f} "
             f"Xi={ev['consensus']:.3f} comm={ev['comm_cost_P']:.1f}P")
        if "live" in ev:
            s += f" live={sum(1 for x in ev['live'] if x == 1)}"
        return s
    if t == "eval":
        return (f"[{ev['round']:4d}] local={ev['local_eval']:.4f} "
                f"merged={ev['merged_eval']:.4f}")
    if t == "merge":
        return f"[{ev['round']:4d}] global merge ({ev['operator']})"
    if t == "fault":
        return f"[{ev['round']:4d}] fault: agent {ev['agent']} {ev['kind']}"
    if t == "run_start":
        return f"run {ev['run_id']} (events schema v{ev['schema']})"
    if t == "run_end":
        return (f"run end: {ev['rounds']} rounds, final loss "
                f"{ev['final_loss']:.4f}, comm {ev['comm_cost_P']:.1f}P")
    if t == "serve_end":
        return (f"serve end: {ev['requests']} requests / {ev['tokens']} "
                f"tokens in {ev['ticks']} ticks, occupancy "
                f"{ev['occupancy']:.2f}")
    return None


class EventLog:
    """Versioned JSONL event stream + wall-clock sidecar (module doc).

    ``path=None`` keeps the log console-only (events are validated and
    echoed but nothing is written) — the launcher's default sink when no
    ``--events`` file is requested. ``echo`` prints
    :func:`format_event`'s line for each deterministic event.
    ``resume_at=n`` truncates an existing stream to its first ``n``
    records and continues appending at ``seq=n`` (sidecar untouched —
    operational history keeps both lives of the run).
    """

    def __init__(self, path: Optional[str] = None, *, run_id: str = "",
                 echo: bool = False, resume_at: Optional[int] = None,
                 sidecar: bool = True,
                 sink: Optional[Callable[[dict], None]] = None):
        self.path = path
        self.run_id = run_id
        self.echo = echo
        self.sink = sink
        self.seq = 0
        self._lock = threading.Lock()
        self._f = self._wf = None
        if path is not None:
            d = os.path.dirname(path)
            if d:
                os.makedirs(d, exist_ok=True)
            if resume_at is not None:
                self.seq = self.truncate_file(path, resume_at)
                mode = "a"
            else:
                mode = "w"
            self._f = open(path, mode)
            if sidecar:
                self._wf = open(wall_path(path), "a")

    # ------------------------------------------------------------- emit
    def emit(self, etype: str, **fields) -> dict:
        """Append one validated deterministic event; returns the record."""
        ev = {"type": etype, "seq": self.seq}
        ev.update({k: _jsonable(v) for k, v in fields.items()})
        errors = validate_event(ev)
        if errors:
            raise ValueError("invalid event: " + "; ".join(errors))
        line = json.dumps(ev, sort_keys=True, separators=(",", ":"))
        with self._lock:
            if self._f is not None:
                self._f.write(line + "\n")  # one write: no torn lines
                self._f.flush()
            if self._wf is not None:
                self._wf.write(json.dumps(
                    {"seq": ev["seq"], "type": etype, "t": time.time()},
                    sort_keys=True, separators=(",", ":")) + "\n")
                self._wf.flush()
            self.seq += 1
        if self.echo:
            line = format_event(ev)
            if line:
                print(line, flush=True)
        if self.sink is not None:
            self.sink(ev)
        return ev

    def emit_op(self, etype: str, **fields) -> None:
        """Append an OPERATIONAL record to the wall-clock sidecar only:
        wall times welcome, schema free, never part of the deterministic
        stream. Thread-safe (the async checkpoint thread calls this)."""
        rec = {"op": etype, "t": time.time()}
        rec.update({k: _jsonable(v) for k, v in fields.items()})
        with self._lock:
            if self._wf is not None:
                self._wf.write(json.dumps(rec, sort_keys=True,
                                          separators=(",", ":")) + "\n")
                self._wf.flush()

    # ------------------------------------------------------------ resume
    @staticmethod
    def truncate_file(path: str, n: int) -> int:
        """Rewrite ``path`` to its first ``n`` records (atomic replace).
        Returns ``n``. A missing file is only acceptable at ``n == 0``."""
        if n < 0:
            raise ValueError(f"cannot truncate to {n} events")
        if not os.path.exists(path):
            if n == 0:
                return 0
            raise FileNotFoundError(
                f"resume expects {n} events at {path}, found no file")
        with open(path) as f:
            lines = f.readlines()
        if len(lines) < n:
            raise ValueError(
                f"resume expects {n} events at {path}, found {len(lines)}")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.writelines(lines[:n])
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        return n

    def close(self) -> None:
        with self._lock:
            for f in (self._f, self._wf):
                if f is not None:
                    f.close()
            self._f = self._wf = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
