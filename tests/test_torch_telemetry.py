"""The port's telemetry copies against the JAX package's: the latency
histograms give the reference's summaries, exports and merges for the same
records; the event log writes byte-identical streams for the same emits and
validates as the reference does; the trace hooks are context managers that
never take a run down. Everything is compared exactly (the same numpy
float64 and pure-Python arithmetic runs on both sides)."""
import json

import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401
from repro import telemetry as ref_tel
from repro_torch import telemetry

pytestmark = pytest.mark.telemetry


def _values(seed, n=500):
    rng = np.random.default_rng(seed)
    return np.exp(rng.normal(-6.0, 2.0, size=n))  # seconds, many decades


@pytest.mark.parametrize("seed", [0, 1])
def test_histogram_summaries_match_reference(seed):
    ours, ref = telemetry.Histogram(), ref_tel.Histogram()
    for v in _values(seed):
        ours.record(v)
        ref.record(v)
    ours.record(3e-4, n=5)
    ref.record(3e-4, n=5)
    assert ours.summary() == ref.summary()
    assert ours.summary_us() == ref.summary_us()
    assert ours.to_dict() == ref.to_dict()
    assert ours.to_dict(sparse=False) == ref.to_dict(sparse=False)
    for p in (0, 10, 50, 90, 99, 100):
        assert ours.percentile(p) == ref.percentile(p)
    np.testing.assert_array_equal(telemetry.default_bounds(),
                                  ref_tel.default_bounds())


def test_histogram_merge_reset_and_errors_match_reference():
    a, b = telemetry.histogram_set(["x", "y"]).values()
    ra, rb = ref_tel.histogram_set(["x", "y"]).values()
    for v in _values(2, 50):
        a.record(v)
        ra.record(v)
    for v in _values(3, 70):
        b.record(v)
        rb.record(v)
    assert a.merge(b).summary() == ra.merge(rb).summary()
    odd = telemetry.Histogram(bounds=np.array([1e-3, 1e-2]))
    with pytest.raises(ValueError, match="different bucket ladders"):
        a.merge(odd)
    with pytest.raises(ValueError, match="increasing"):
        telemetry.Histogram(bounds=np.array([1.0, 0.5]))
    a.reset()
    assert a.summary() == {"count": 0} and a.percentile(50) == 0.0


def _emit_run(module, path):
    """The same emits into a log of ``module`` (the port's or the
    reference's telemetry); returns the console lines."""
    cfg = {"arch": "olmo-1b", "seed": 0, "concurrency": 2}
    log = module.EventLog(path, run_id=module.make_run_id(cfg))
    lines = [module.format_event(log.emit(
        "serve_start", run_id=log.run_id, schema=module.SCHEMA_VERSION,
        config=cfg))]
    for rid in range(3):
        log.emit("request_submit", rid=rid, prompt_len=8, max_new=np.int64(4))
        log.emit("request_admit", rid=rid, slot=rid % 2, tick=rid)
        log.emit("request_retire", rid=f"r{rid}", slot=rid % 2, tick=rid + 4,
                 tokens=4)
    lines.append(module.format_event(log.emit(
        "round", round=0, loss=np.float32(2.5), grad_norm=1.25,
        grad_norm_max=1.5, consensus=0.125, comm_cost_P=1.0,
        live=[1, 1, 0], resident_bytes=1024)))
    lines.append(module.format_event(log.emit(
        "eval", round=0, merged_eval=2.0, local_eval=2.25)))
    lines.append(module.format_event(log.emit(
        "serve_end", requests=3, tokens=12, ticks=7, occupancy=0.75)))
    log.emit_op("serve_latency", ttft={"p50_s": 0.1})
    log.close()
    return lines


def test_event_streams_byte_identical_to_reference(tmp_path):
    ours, ref = tmp_path / "ours.jsonl", tmp_path / "ref.jsonl"
    lines = _emit_run(telemetry, str(ours))
    ref_lines = _emit_run(ref_tel, str(ref))
    assert lines == ref_lines
    assert ours.read_bytes() == ref.read_bytes()
    assert telemetry.validate_stream(str(ours)) == []
    assert telemetry.read_events(str(ours)) == ref_tel.read_events(str(ref))
    assert telemetry.wall_path(str(ours)) == str(tmp_path /
                                                 "ours.wall.jsonl")
    side = [json.loads(x) for x in
            (tmp_path / "ours.wall.jsonl").read_text().splitlines()]
    assert len(side) == 14 and side[-1]["op"] == "serve_latency"


@pytest.mark.parametrize("event", [
    {"type": "nope", "seq": 0},
    {"type": "request_admit", "seq": 0, "rid": 1, "slot": 0},
    {"type": "request_admit", "seq": "0", "rid": True, "slot": 0,
     "tick": 1.5, "extra": 1},
    {"type": "round", "seq": 3, "round": 1, "loss": 1, "grad_norm": 1.0,
     "grad_norm_max": 1.0, "consensus": 0.0, "comm_cost_P": 0.0,
     "live": [1, "x"]},
])
def test_validate_event_matches_reference(event):
    assert telemetry.validate_event(event) == ref_tel.validate_event(event)
    assert telemetry.validate_event(event)


def test_validate_stream_and_truncate_match_reference(tmp_path):
    path = tmp_path / "ev.jsonl"
    recs = [{"type": "round", "seq": i, "round": r, "loss": 1.0,
             "grad_norm": 1.0, "grad_norm_max": 1.0, "consensus": 0.0,
             "comm_cost_P": 0.0} for i, r in enumerate([0, 1, 1, 3])]
    path.write_text("\n".join(json.dumps(r) for r in recs) + "\n\n")
    assert telemetry.validate_stream(str(path)) == ref_tel.validate_stream(
        str(path))
    assert len(telemetry.validate_stream(str(path))) == 3
    assert telemetry.EventLog.truncate_file(str(path), 2) == 2
    assert telemetry.validate_stream(str(path)) == []
    with pytest.raises(ValueError, match="expects 5 events"):
        telemetry.EventLog.truncate_file(str(path), 5)
    log = telemetry.EventLog(str(path), resume_at=1)
    assert log.emit("merge", round=1, operator="uniform")["seq"] == 1
    log.close()
    with pytest.raises(ValueError, match="invalid event"):
        telemetry.EventLog(None).emit("merge", round="1", operator="u")


def test_trace_scopes_and_profile_capture(tmp_path):
    with telemetry.scope("serve.decode"), telemetry.annotate("serve.step"):
        y = torch.ones(4) * 2
    assert float(y.sum()) == 8.0
    off = telemetry.profile_trace(str(tmp_path / "off"), enabled=False)
    with off as ctx:
        assert not ctx
    assert not (tmp_path / "off").exists()
    with telemetry.profile_trace(str(tmp_path / "on")) as prof:
        with telemetry.scope("traced.region"):
            torch.ones(8).sum()
        active = bool(prof)
    if active:  # a profiler that cannot start only warns (and writes none)
        assert "traced.region" in (tmp_path / "on" / "trace.json").read_text()
