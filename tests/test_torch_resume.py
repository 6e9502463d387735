"""The port's checkpointed runs: a training run killed between segments and
resumed continues bit for bit, its event stream byte for byte.

* A mirror of ``tests/test_checkpoint.py:213``: a segment saved after its
  first half and restored into a fresh init (and a fresh wire generator)
  ends bit for bit where the uninterrupted run ends, through int8_ef's
  stochastic rounding and the fisher merge, and with stochastic int8
  moments (their streams seeded from the generator and the step count).
* The CPU counterpart of ``scripts/fault_smoke.py``: three ``--device
  cpu`` children of the launcher with its CFG (a baseline, a run SIGKILLed
  after its first segment, its ``--resume``): equal histories, streams
  byte-identical and valid under both packages' validators.
* The same in one process across elastic rounds (``--faults``, where the
  optimizer's step count becomes per-agent), the kill raised instead of
  sent.
* The launcher's refusals: the adaptive schedule, a state over the blob's
  4,294,967,295-byte payload (``checkpoint.io.payload_bytes``, held equal to
  the bytes ``save`` packs); a fresh start from an empty directory, the
  fingerprint guard; ``--profile`` writing ``trace.json`` on the CPU.
"""
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401
from repro.telemetry import events as ref_events
from repro_torch.checkpoint import io as ckpt_io
from repro_torch.checkpoint import restore, save
from repro_torch.core import dsgd, topology
from repro_torch.launch import train
from repro_torch.optim import make_optimizer
from repro_torch.telemetry import events

ROOT = Path(__file__).resolve().parents[1]
M, H, DIM, CLASSES = 4, 2, 8, 3
# scripts/fault_smoke.py's CFG, on the CPU
CFG = ["--rounds", "6", "--segment", "2", "--agents", "4",
       "--local-steps", "2", "--batch", "4", "--seq", "32",
       "--wire", "int8_ef", "--merge", "fisher",
       "--schedule", "final_merge", "--seed", "0", "--telemetry",
       "--device", "cpu"]
TAG = "olmo-1b_final_merge_a0.1_mfisher.json"


def _same(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _same(a[k], b[k])
    elif torch.is_tensor(a):
        assert a.dtype == b.dtype and torch.equal(a, b)
    else:
        assert type(a) is type(b)
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------ the segment, resumed


def _init(gen, device):
    return {"w": torch.randn((DIM, CLASSES), generator=gen,
                             device=device) * 0.1,
            "b": torch.zeros(CLASSES, device=device)}


def _loss(p, batch, rng=None):
    lg = batch["x"] @ p["w"] + p["b"]
    return torch.nn.functional.cross_entropy(lg, batch["y"].long()), {}


@pytest.mark.parametrize("merger,res", [
    ("fisher", None), ("var", "moments=int8,stats=int8r,wire_err=int8")])
def test_segment_resume_bit_exact(tmp_path, merger, res):
    opt = make_optimizer("adamw", 1e-2)
    host = np.random.default_rng(0)
    segs = []
    for _ in range(2):  # two segments of 2 rounds; the last round global
        Ws = np.stack([topology.random_matching(M, 0.9, host),
                       topology.fully_connected(M)]).astype(np.float32)
        segs.append((Ws, {
            "x": host.normal(size=(2, H, M, 8, DIM)).astype(np.float32),
            "y": host.integers(0, CLASSES, size=(2, H, M, 8))},
            np.array([False, True])))
    path = str(tmp_path / "mid.ckpt")

    def run(resume):
        st, spec = dsgd.init_panel_state(_init, opt, M, 0, device="cpu",
                                         wire="int8_ef", merger=merger,
                                         residency=res)
        seg = dsgd.make_panel_segment(_loss, opt, H, spec)
        gen = torch.Generator().manual_seed(7)
        start = 0
        if resume:
            gen = torch.Generator().manual_seed(99)
            tree, meta = restore(path, train._ckpt_tree(st, gen, M),
                                 with_meta=True)
            st = train._from_ckpt(tree, meta["count_per_agent"])
            gen.set_state(tree["wire_gen"])
            start = 1
        for i in range(start, 2):
            Ws, batches, glob = segs[i]
            st, _ = seg(st, batches, Ws, gen, global_rounds=glob)
            if i == 0:
                save(path, train._ckpt_tree(st, gen, M),
                     meta={"count_per_agent": False})
        return st

    full, resumed = run(False), run(True)
    assert resumed["step"] == full["step"] == 8
    _same(full, resumed)


# -------------------------------------------- fault_smoke, on the CPU


def _child(out, extra):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *CFG, "--out",
         str(out), *extra], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def _finish(proc, rc=0):
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == rc, out + err
    return out


def test_fault_smoke_on_cpu(tmp_path):
    base, intr = tmp_path / "baseline", tmp_path / "interrupted"
    ev_base, ev_intr = base / "events.jsonl", intr / "events.jsonl"
    procs = [_child(base, ["--events", str(ev_base)]),
             _child(intr, ["--checkpoint-every", "1",
                           "--die-after-segments", "1", "--events",
                           str(ev_intr)])]
    _finish(procs[0])
    dying = _finish(procs[1], -signal.SIGKILL)
    assert "dying after segment 1 (round 2)" in dying
    manifest = intr / ("ckpt_" + TAG[:-5]) / "MANIFEST.json"
    assert json.loads(manifest.read_text())["checkpoints"][-1]["step"] == 2
    resumed = _finish(_child(intr, ["--checkpoint-every", "1", "--resume",
                                    "--events", str(ev_intr)]))
    assert "resumed from checkpoint step 2 (round 2)" in resumed
    hb = json.loads((base / TAG).read_text())["history"]
    hr = json.loads((intr / TAG).read_text())["history"]
    assert len(hb) == 6 and hb == hr
    assert ev_base.read_bytes() == ev_intr.read_bytes()
    for path in (ev_base, ev_intr):
        assert events.validate_stream(str(path)) == []
        assert ref_events.validate_stream(str(path)) == []
    # the sidecar keeps both lives: the kill's segment, the resume
    ops = [json.loads(x).get("op") for x in
           (intr / "events.wall.jsonl").read_text().splitlines()]
    assert ops.count("resume") == 1 and ops.count("checkpoint_save") == 3


# --------------------------------- kill and resume in one process


class _Killed(Exception):
    pass


def _kill(pid, sig):
    assert pid == os.getpid() and sig == signal.SIGKILL
    raise _Killed


FAULT_ARGS = ["--rounds", "6", "--segment", "2", "--agents", "4",
              "--local-steps", "2", "--batch", "4", "--seq", "32",
              "--faults", "2@1-3;0@4", "--merge", "var", "--wire", "topk",
              "--residency", "moments=int8", "--telemetry", "--device",
              "cpu"]


def test_resume_across_elastic_rounds(tmp_path, monkeypatch, capsys):
    """Killed after segment 2 (agent 2 dead through it: the step counts are
    per agent) and resumed in one process; the kill is raised instead of
    sent."""
    base = train.main(FAULT_ARGS + ["--out", str(tmp_path / "base")])
    ev = str(tmp_path / "intr" / "events.jsonl")
    args = FAULT_ARGS + ["--out", str(tmp_path / "intr"), "--events", ev,
                         "--checkpoint-every", "2"]
    monkeypatch.setattr(train.os, "kill", _kill)
    with pytest.raises(_Killed):
        train.main(args + ["--die-after-segments", "2"])
    assert "dying after segment 2 (round 4)" in capsys.readouterr().out
    resumed = train.main(args + ["--resume"])
    assert "resumed from checkpoint step 4 (round 4)" in \
        capsys.readouterr().out
    assert resumed == base
    base_ev = tmp_path / "base" / \
        "events_olmo-1b_final_merge_a0.1_mvar_rmomentsint8.jsonl"
    assert Path(ev).read_bytes() == base_ev.read_bytes()
    assert events.validate_stream(ev) == []


# ---------------------------------------------------------- refusals


def test_adaptive_schedule_refuses_checkpoints(tmp_path):
    for flag in (["--checkpoint-every", "1"], ["--resume"]):
        with pytest.raises(SystemExit, match="adaptive schedule"):
            train.main(["--schedule", "adaptive", "--rounds", "2",
                        "--agents", "2", "--device", "cpu", "--out",
                        str(tmp_path)] + flag)
    assert not list(tmp_path.iterdir())


def test_payload_bytes_is_what_save_packs():
    gen = torch.Generator().manual_seed(0)
    tree = {"a": torch.randn(3, generator=gen), "n": 5,
            "b": {"c": np.zeros((100, 70), np.int64),
                  "d": torch.zeros(1 << 15, dtype=torch.bfloat16),
                  "e": torch.zeros((4, 1 << 14), dtype=torch.int8)},
            "s": np.ones(7, np.int64), "none": None, "empty": {}}
    flat = ckpt_io._flatten_to_host(tree)
    payload = ckpt_io._msgpack.packb(
        {k: {"dtype": name, "shape": list(a.shape),
             "data": memoryview(np.ascontiguousarray(a)).cast("B")}
         for k, (name, a) in flat.items()})
    assert ckpt_io.payload_bytes(tree) == len(payload)


def test_state_over_the_blob_limit_is_refused(tmp_path, monkeypatch):
    """The main path's full-width state (olmo-1b cut to 2 layers, 8 agents,
    float32 parameters and AdamW moments; on the meta device, no memory)
    cannot fit the blob's payload, and the refusal names both numbers; a
    launcher over a lowered limit exits at startup, before any event."""
    D, m = 237_502_464, 8
    pan = {"float32": torch.empty((m, D), device="meta")}
    state = {"panel": pan, "opt": {
        "m": {"float32": torch.empty((m, D), device="meta")},
        "v": {"float32": torch.empty((m, D), device="meta")},
        "step_count": np.zeros(m, np.int64)}, "step": 0}
    tree = {"state": state, "wire_gen": torch.zeros(16, dtype=torch.uint8)}
    total = 3 * 4 * D
    with pytest.raises(SystemExit) as exc:
        train.refuse_oversized_checkpoint(tree, total, m)
    msg = str(exc.value)
    assert str(m * total) in msg and "4294967295" in msg
    small = {"state": {"panel": {"float32": torch.empty((m, 1000),
                                                        device="meta")}}}
    train.refuse_oversized_checkpoint(small, 4000, m)  # fits: no exit
    monkeypatch.setattr(ckpt_io, "MAX_PAYLOAD_BYTES", 1 << 20)
    ev = tmp_path / "events.jsonl"
    with pytest.raises(SystemExit, match="1048576"):
        train.main(["--rounds", "2", "--agents", "2", "--device", "cpu",
                    "--checkpoint-every", "1", "--out", str(tmp_path),
                    "--events", str(ev)])
    assert not ev.exists()


def test_resume_fresh_and_fingerprint_guard(tmp_path, capsys):
    args = ["--rounds", "2", "--segment", "1", "--agents", "2",
            "--local-steps", "1", "--batch", "2", "--seq", "16",
            "--device", "cpu", "--out", str(tmp_path), "--resume",
            "--checkpoint-every", "1"]
    train.main(args)
    assert "resume: no checkpoint found, starting fresh" in \
        capsys.readouterr().out
    with pytest.raises(ValueError, match="lr"):
        train.main(args + ["--lr", "0.01"])


def test_profile_writes_a_chrome_trace(tmp_path):
    prof = tmp_path / "prof"
    ev = tmp_path / "events.jsonl"
    train.main(["--rounds", "2", "--segment", "1", "--agents", "2",
                "--local-steps", "1", "--batch", "2", "--seq", "16",
                "--device", "cpu", "--out", str(tmp_path), "--events",
                str(ev), "--profile", str(prof)])
    trace = json.loads((prof / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert any(n and n.startswith("aten::") for n in names)
    ops = [json.loads(x).get("op") for x in
           (tmp_path / "events.wall.jsonl").read_text().splitlines()]
    assert ops.index("profile_start") < ops.index("profile_stop")
    assert events.validate_stream(str(ev)) == []
