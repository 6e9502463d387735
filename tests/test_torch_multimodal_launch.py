"""The port's launchers on the last two families: ``launch.train --arch
qwen2-vl-72b`` at the CPU preset (d_model 128, 2 layers, vocab 256; M-RoPE
(8, 4, 4)) against the reference launcher, the port's from the reference
launcher's init handed over; ``--arch seamless-m4t-medium`` refused by
name (the batches carry no encoder frames: the reference's launcher
raises ``KeyError: 'frame_embeds'``); ``launch.serve`` of both families,
the engine and ``--one-shot``, with their patch prefixes and frames.

The history is held at rtol 1e-5 (atol 1e-7 for Xi's zeros): the preset's
two rounds of 2 AdamW steps stay that close (read: the loss 3.4e-7, the
grad norm 4.1e-7, Xi 9.2e-8, the evals 3.4e-7 relative)."""
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
from repro_torch.core import dsgd
from repro_torch.launch import serve as serve_launch
from repro_torch.launch import train
from repro_torch.weights import from_reference_params

ROUNDS, AGENTS, H = 2, 4, 2
ARGS = ["--rounds", str(ROUNDS), "--segment", "2", "--agents", str(AGENTS),
        "--local-steps", str(H), "--batch", "4", "--seq", "32"]
ARCH = "qwen2-vl-72b"


def _handover():
    """init_panel_state for the port's launcher that hands the reference
    launcher's init (its seed-0 key) over."""
    ref_model = ref_build_model(ref_train.build_cpu_preset(
        ref_get_config(ARCH), AGENTS))
    ref_opt = ref_make_optimizer("adamw", 3e-3, weight_decay=5e-4,
                                 total_steps=ROUNDS * H)

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


def test_vlm_launcher_history_matches_reference(tmp_path, monkeypatch):
    dirs = {}
    for name in ("ref", "port"):
        d = tmp_path / name
        dirs[name] = d
        flags = ARGS + ["--arch", ARCH, "--out", str(d)]
        if name == "ref":
            monkeypatch.setattr(sys, "argv", ["train"] + flags)
            ref_train.main()
        else:
            monkeypatch.setattr(train.dsgd, "init_panel_state", _handover())
            hist = train.main(flags + ["--device", "cpu"])

    def history(d):
        with open(d / f"{ARCH}_final_merge_a0.1.json") as f:
            return json.load(f)["history"]

    ref, port = history(dirs["ref"]), history(dirs["port"])
    assert port == hist and len(port) == len(ref) == ROUNDS
    for r, p in zip(ref, port):
        assert sorted(r) == sorted(p)
        for k in r:
            if r[k] is None or isinstance(r[k], int):
                assert p[k] == r[k], k
            else:
                np.testing.assert_allclose(p[k], r[k], rtol=1e-5, atol=1e-7,
                                           err_msg=k)
    assert port[-1]["consensus"] == 0.0
    assert port[-1]["merged_eval"] == port[-1]["local_eval"]


def test_encdec_refused_by_the_train_launcher():
    with pytest.raises(SystemExit, match="seamless-m4t-medium.*frame_embeds"):
        train.main(ARGS + ["--arch", "seamless-m4t-medium", "--device",
                           "cpu"])


@pytest.mark.parametrize("one_shot", [False, True])
@pytest.mark.parametrize("arch", [ARCH, "seamless-m4t-medium"])
def test_serve_launcher_runs_with_extras(arch, one_shot, capsys):
    """The CPU preset served: 4 requests with their patch prefixes or
    frames (``request_inputs``), through 2 slots or as one static batch;
    3 in-vocabulary tokens each."""
    argv = ["--arch", arch, "--device", "cpu", "--requests", "4",
            "--concurrency", "2", "--prompt-len", "8", "--max-new", "3"]
    out = serve_launch.main(argv + (["--one-shot"] if one_shot else []))
    toks = (np.asarray(out) if one_shot
            else np.stack([out[i] for i in range(4)]))
    assert toks.shape == (4, 3)
    assert ((toks >= 0) & (toks < 256)).all()
    text = capsys.readouterr().out
    assert ("generated (4, 3)" if one_shot else "serve end") in text
