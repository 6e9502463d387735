"""The port's train launcher, observed: its event stream, snapshot and the
telemetry CLIs against the JAX package's.

One configuration runs through both launchers (``--telemetry --events
--snapshot`` at the CPU preset, a fault plan and the fisher merge, so the
stream carries fault, round, merge, eval, run_start and run_end records
with the per-agent columns), the port's from the reference's init handed
over. Held:
* equal ``run_id`` (the same run configuration keys), the same record
  types in the same order, equal non-float fields, floats at rtol 1e-4 /
  atol 1e-6 (the launchers' tolerance: other float32 summation orders),
  but a rejoining (RESYNC) agent's ``dist_to_mean``: its row is the live
  mean rounded to float32, which the reference measures against the same
  rounded mean (0) and the port against the float64 mean (that rounding,
  held under 1e-5);
* each package's ``validate_stream`` accepts both streams;
* the snapshot each launcher wrote live equals its stream's offline
  ``export_stream``, and the two snapshots agree as the streams do;
* ``export_stream`` and the ``export`` and ``validate`` CLIs of the port
  give byte-identical files and output to the reference's on the same
  streams (the modules are copies).
"""
import json
import sys

import jax
import numpy as np
import pytest

import _torch_threads  # noqa: F401
from repro.configs import get_config as ref_get_config
from repro.core import dsgd as ref_dsgd
from repro.core import panel as ref_panel
from repro.launch import train as ref_train
from repro.models import build_model as ref_build_model
from repro.optim import make_optimizer as ref_make_optimizer
from repro.telemetry import events as ref_events
from repro.telemetry import export as ref_export
from repro.telemetry import validate as ref_validate
from repro_torch.core import dsgd
from repro_torch.launch import train
from repro_torch.telemetry import events, export, validate
from repro_torch.weights import from_reference_params

ARGS = ["--rounds", "6", "--segment", "2", "--agents", "4",
        "--local-steps", "2", "--batch", "4", "--seq", "32",
        "--faults", "2@1-3", "--merge", "fisher", "--telemetry"]
RTOL, ATOL = 1e-4, 1e-6


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    """{'ref': dir, 'port': dir} of the two launchers' runs of ARGS (each
    holding events.jsonl and snapshot.json)."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for name in ("ref", "port"):
            d = tmp_path_factory.mktemp(name)
            out[name] = d
            flags = ARGS + ["--out", str(d), "--events",
                            str(d / "events.jsonl"), "--snapshot",
                            str(d / "snapshot.json")]
            if name == "ref":
                mp.setattr(sys, "argv", ["train"] + flags)
                ref_train.main()
            else:
                mp.setattr(train.dsgd, "init_panel_state", _handover())
                train.main(flags + ["--device", "cpu"])
    return out


def _handover():
    """init_panel_state for the port's launcher that hands the reference
    launcher's init (its seed-0 key) over."""
    ref_model = ref_build_model(ref_train.build_cpu_preset(
        ref_get_config("olmo-1b"), 4))
    ref_opt = ref_make_optimizer("adamw", 3e-3, weight_decay=5e-4,
                                 total_steps=12)

    def init(init_params, opt, m, gen, *, device, merger, wire, residency):
        rs, rspec = ref_dsgd.init_panel_state(
            ref_model.init_params, ref_opt, m, jax.random.PRNGKey(0),
            merger=merger, wire=wire, residency=residency)
        params, _, _ = from_reference_params(jax.tree.map(
            np.asarray, ref_panel.from_panel(rs["panel"], rspec)),
            device=device)
        return dsgd.panel_state_from_params(params, opt, wire=wire,
                                            merger=merger,
                                            residency=residency)
    return init


def _close(a, b, where):
    """Two decoded JSON values: equal but for floats, held at the
    launchers' tolerance."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for k in a:
            _close(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{where}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL,
                                   err_msg=where)
    else:
        assert a == b and type(a) is type(b), f"{where}: {a!r} != {b!r}"


def test_stream_matches_reference(streams):
    port = events.read_events(str(streams["port"] / "events.jsonl"))
    ref = ref_events.read_events(str(streams["ref"] / "events.jsonl"))
    assert [e["type"] for e in port] == [e["type"] for e in ref]
    kinds = {e["type"] for e in port}
    assert kinds == {"run_start", "fault", "round", "merge", "eval",
                     "run_end"}
    assert port[0]["run_id"] == ref[0]["run_id"]
    assert port[0]["config"] == ref[0]["config"]
    for i, (p, r) in enumerate(zip(port, ref)):
        for k, trit in enumerate(p.get("live", ())):
            if trit == 2:
                # the RESYNC row is the live mean rounded to float32: the
                # reference measures it against that rounded mean (0), the
                # port against the float64 mean (the rounding's size)
                assert r["dist_to_mean"][k] == 0.0
                assert 0.0 <= p["dist_to_mean"][k] <= 1e-5
                p["dist_to_mean"][k] = 0.0
        _close(p, r, f"record {i} ({p['type']})")
    rounds = [e for e in port if e["type"] == "round"]
    assert all(len(e[k]) == 4 for e in rounds for k in train.AGENT_COLUMNS)
    assert [e["live"][2] for e in rounds] == [1, 0, 0, 2, 1, 1]
    assert rounds[-1]["consensus"] == 0.0
    assert rounds[-1]["dist_to_mean"] == [0.0] * 4


def test_each_validator_accepts_both_streams(streams):
    for d in streams.values():
        path = str(d / "events.jsonl")
        assert events.validate_stream(path) == []
        assert ref_events.validate_stream(path) == []


def test_live_snapshot_is_the_streams_export(streams):
    snaps = {}
    for name, d in streams.items():
        with open(d / "snapshot.json") as f:
            snaps[name] = json.load(f)
        exporter = export if name == "port" else ref_export
        assert exporter.export_stream(str(d / "events.jsonl")) == \
            snaps[name]
    _close(snaps["port"], snaps["ref"], "snapshot")
    assert snaps["port"]["faults"] == 2
    assert snaps["port"]["events"]["round"] == 6


@pytest.mark.parametrize("every", [0, 2])
def test_export_matches_reference_byte_for_byte(streams, tmp_path, capsys,
                                                every):
    for name, d in streams.items():
        ev = str(d / "events.jsonl")
        out = {}
        for pkg, mod in (("port", export), ("ref", ref_export)):
            path = str(tmp_path / f"{name}_{pkg}.json")
            assert mod.export_stream(ev, path, every=every) == \
                (export if pkg == "port" else ref_export).export_stream(ev)
            out[pkg] = open(path, "rb").read()
        assert out["port"] == out["ref"]
        # the CLI: the same snapshot file and the same line
        lines = {}
        for pkg, mod in (("port", export), ("ref", ref_export)):
            cli = str(tmp_path / "cli.json")
            assert mod.main([ev, "--out", cli, "--every", str(every)]) == 0
            lines[pkg] = capsys.readouterr().out
            assert open(cli, "rb").read() == out["ref"]
        assert lines["port"] == lines["ref"]


def test_validate_cli_matches_reference(streams, tmp_path, capsys):
    bad = tmp_path / "bad.jsonl"
    good = (streams["port"] / "events.jsonl").read_text().splitlines()
    rec = json.loads(good[1])
    rec["wallclock"] = 1.5  # an unknown field
    bad.write_text("\n".join(good[:1] + [json.dumps(rec)] + good[3:])
                   + "\n")  # and a seq gap
    paths = [str(streams["port"] / "events.jsonl"),
             str(streams["ref"] / "events.jsonl"), str(bad),
             str(tmp_path / "missing.jsonl")]
    for argv, rc in ((paths[:2], 0), (paths, 1),
                     ([str(bad), "--max-errors", "1"], 1)):
        assert validate.main(argv) == rc
        port = capsys.readouterr().out
        assert ref_validate.main(argv) == rc
        assert port == capsys.readouterr().out
    assert "INVALID" in port
