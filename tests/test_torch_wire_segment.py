"""The port's training segment under the compressed gossip wire at the
verify recipe's size (split from ``tests/test_torch_wire.py``, whose
docstring states the cases): ``topk``, ``bf16`` and the round-to-nearest
``int8_ef`` and ``int4_ef`` against the jitted reference segment at rtol
1e-4 (the wider bounds below each set from measurements), the final
residuals, and the launcher with ``--wire int8_ef`` on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_threads  # noqa: F401
from repro.configs import get_config as ref_get_config
from repro.core import dsgd as ref_dsgd
from repro.core import merge as ref_merge
from repro.core import panel as ref_panel
from repro.launch.train import build_cpu_preset as ref_cpu_preset
from repro.models import build_model as ref_build_model
from repro.optim import make_optimizer as ref_make_optimizer
from repro_torch.configs import get_config
from repro_torch.core import dsgd, panel
from repro_torch.core.schedule import make_schedule
from repro_torch.data.synthetic import SyntheticLM, make_agent_lm_batches
from repro_torch.launch import train
from repro_torch.models import build_model
from repro_torch.optim import make_optimizer
from repro_torch.weights import from_reference_params
from test_torch_wire import CODEC_CASES, _ref_twin, _same_bits


# --------------------------------------------- segment at the verify size

ROUNDS, M, H, B, SEQ = 10, 4, 2, 4, 32
RTOL = 1e-4
# Bounds wider than RTOL, each set from measurements (CPU): under the
# round-to-nearest int4_ef one rounding decision taken the other way moves
# an entry by a whole int4 step (1/7 of its group's amax), and such
# decisions feed the later rounds; a 1-ulp change of the port's OWN initial
# panel moves its grad norms by 2.4e-3 over the 10 rounds. Against the
# reference the grad norms differ by up to 4.2e-3 (bound 1e-2) and the
# evals by 2.9e-4 (bound 1e-3); loss (2.9e-5) and Xi (3.5e-7) hold RTOL.
# Under bf16 the last round's Xi is the bf16 rounding residue of the merged
# row, which a 1e-6 change of the row moves by ~5e-4 of itself (the same
# 1-ulp init change moves it 2.3e-4): measured 5.1e-4, bound 1e-3; every
# other round and metric holds RTOL.
WIDER = {("int4_ef_rtn", "grad_norm"): 1e-2,
         ("int4_ef_rtn", "grad_norm_max"): 1e-2,
         ("int4_ef_rtn", "eval"): 1e-3}
BF16_LAST_XI_RTOL = 1e-3


def _segment_runs(codec):
    ref = _ref_twin(codec)
    ref_cfg = ref_cpu_preset(ref_get_config("olmo-1b"), M)
    cfg = train.build_cpu_preset(get_config("olmo-1b"), M)
    ref_model, model = ref_build_model(ref_cfg), build_model(cfg)
    ref_opt = ref_make_optimizer("adamw", 3e-3, weight_decay=5e-4,
                                 total_steps=ROUNDS * H)
    opt = make_optimizer("adamw", 3e-3, weight_decay=5e-4,
                         total_steps=ROUNDS * H)
    ref_state, ref_spec = ref_dsgd.init_panel_state(
        ref_model.init_params, ref_opt, M, jax.random.PRNGKey(0),
        merger="uniform", wire={"float32": ref})
    stacked = jax.tree.map(np.asarray,
                           ref_panel.from_panel(ref_state["panel"], ref_spec))
    params, _, _ = from_reference_params(stacked, device="cpu")
    state, spec = dsgd.panel_state_from_params(params, opt,
                                               wire={"float32": codec})
    assert ("wire_err" in state) == ("wire_err" in ref_state)
    for k in state.get("wire_err", {}):  # the same initial EF state
        _same_bits(state["wire_err"][k].numpy(), ref_state["wire_err"][k])

    sched = make_schedule("final_merge", M, ROUNDS, prob=0.2, seed=0)
    lm = SyntheticLM(vocab=cfg.vocab_size, num_domains=8, seed=0)
    mixtures = lm.domain_mixtures(M, 0.1, seed=1)
    Ws = np.stack([sched.mixing_matrix(t)
                   for t in range(ROUNDS)]).astype(np.float32)
    batches = train.sample_segment_batches(lm, mixtures, ROUNDS, H, B, SEQ,
                                           np.random.default_rng(2))
    glob_mix = np.ones(lm.num_domains) / lm.num_domains
    eval_b = {k: v[0] for k, v in make_agent_lm_batches(
        lm, [glob_mix], 2 * B, SEQ, np.random.default_rng(999)).items()}

    ref_seg = ref_dsgd.make_panel_segment(ref_model.loss_fn, ref_opt, H,
                                          ref_spec)
    ref_state, ref_mets = ref_seg(ref_state,
                                  jax.tree.map(jnp.asarray, batches),
                                  jnp.asarray(Ws), jax.random.PRNGKey(1))
    jb = jax.tree.map(jnp.asarray, eval_b)

    def ref_loss(p):
        return ref_model.loss_fn(p, jb, None)[0]

    ref_merged = float(jax.jit(lambda pan: ref_merge.counterfactual_eval_panel(
        ref_loss, pan, ref_spec))(ref_state["panel"]))
    ref_local = float(jax.jit(lambda pan: jnp.mean(jax.vmap(ref_loss)(
        ref_panel.from_panel(pan, ref_spec))))(ref_state["panel"]))

    seg = dsgd.make_panel_segment(model.loss_fn, opt, H, spec)
    state, mets = seg(state, batches, Ws)
    tb = train.to_device(eval_b, "cpu")
    merged = train.eval_merged(model.loss_fn, state["panel"], spec, tb)
    local = train.eval_local(model.loss_fn, state["panel"], spec, tb)
    return {"Ws": Ws,
            "ref": ({k: np.asarray(v) for k, v in ref_mets.items()},
                    ref_merged, ref_local,
                    {k: np.asarray(v) for k, v in
                     ref_state.get("wire_err", {}).items()},
                    {k: np.asarray(v) for k, v in ref_state["panel"].items()}),
            "port": ({k: v.numpy() for k, v in mets.items()}, merged, local,
                     {k: v.numpy() for k, v in
                      state.get("wire_err", {}).items()},
                     {k: v.numpy() for k, v in state["panel"].items()})}


@pytest.fixture(scope="module", params=["topk", "int8_ef_rtn", "int4_ef_rtn",
                                        "bf16"])
def segment_runs(request):
    return request.param, _segment_runs(CODEC_CASES[request.param])


def test_segment_metrics_and_evals_match(segment_runs):
    case, runs = segment_runs
    ref_mets, ref_merged, ref_local = runs["ref"][:3]
    mets, merged, local = runs["port"][:3]
    eye = np.eye(M, dtype=np.float32)
    idle = [np.array_equal(W, eye) for W in runs["Ws"]]
    assert any(idle) and not all(idle)  # both kinds of round ran
    for k in ("loss", "grad_norm", "grad_norm_max", "consensus"):
        assert mets[k].shape == (ROUNDS,)
        got, want = mets[k], ref_mets[k]
        if case == "bf16" and k == "consensus":
            np.testing.assert_allclose(got[-1], want[-1],
                                       rtol=BF16_LAST_XI_RTOL)
            got, want = got[:-1], want[:-1]
        np.testing.assert_allclose(got, want, rtol=WIDER.get((case, k), RTOL),
                                   atol=1e-6, err_msg=f"{case} {k}")
    rtol = WIDER.get((case, "eval"), RTOL)
    np.testing.assert_allclose(merged, ref_merged, rtol=rtol)
    np.testing.assert_allclose(local, ref_local, rtol=rtol)
    for x in runs["port"][4].values():  # every agent holds the merged row
        assert np.array_equal(x, np.broadcast_to(x[:1], x.shape))
    # bf16's Xi measures its rounded rows against the float32 mean (the
    # reference's rule, matched above); every other wire reports 0
    assert case == "bf16" or mets["consensus"][-1] == 0.0
    assert abs(local - merged) <= 1e-6 * abs(merged)


def test_segment_final_wire_err_matches(segment_runs):
    """The final error-feedback panel against the reference's.

    An elementwise 1e-6 cannot hold: after 20 AdamW steps the two
    packages' final PARAMETERS already differ by up to 2e-4 on a few
    entries (float32 rounding amplified where |g| is near eps; the f32
    wire shows the same), and a residual inherits every such difference.
    So: the topk mirror, reset to the merged panel by the final merge,
    matches at relative l2 error 1e-4 (measured 2.0e-5). The round-to-
    nearest int8_ef residual (a fraction of a quantization step in size)
    agrees within a twentieth of a step — the step is the row's amax/127
    — on at least 99.5 % of entries; a rounding decision taken the other
    way moves an entry by a whole step, the allowance for a jitted
    reference, and at most 0.5 % of entries may do so (measured 0.09 %).
    The round-to-nearest int4_ef residual is held the same way against its
    step, the group's amax/7. bf16 carries no residual."""
    case, runs = segment_runs
    ref_err, err = runs["ref"][3], runs["port"][3]
    assert sorted(err) == sorted(ref_err)
    assert bool(err) == (case != "bf16")
    for k in err:
        d = np.abs(err[k] - ref_err[k])
        if case == "topk":  # the mirror IS the merged panel, in both
            assert np.array_equal(err[k], runs["port"][4][k])
            assert np.array_equal(ref_err[k], runs["ref"][4][k])
            assert np.linalg.norm(d) <= RTOL * np.linalg.norm(ref_err[k])
            continue
        mag = np.abs(runs["ref"][4][k])
        if case == "int4_ef_rtn":  # one scale per row per 128 columns
            g = 128
            pad = np.pad(mag, ((0, 0), (0, -mag.shape[1] % g)))
            amax = pad.reshape(mag.shape[0], -1, g).max(axis=2)
            step = np.repeat(amax, g, axis=1)[:, :mag.shape[1]] / 7
        else:
            step = np.max(mag, axis=1, keepdims=True) / 127
        assert np.all(np.abs(err[k]) <= 2 * step)  # a residual, not params
        assert np.mean(d > step / 20) <= 5e-3
        assert np.mean(d > step / 2) <= 5e-3


def test_launcher_wire_int8_ef_on_cpu(tmp_path, capsys):
    """The launcher's --wire at the verify size: it prints the payload line
    (1 byte per parameter, + a 4-byte scale per agent), reaches Xi 0 and
    merged == local eval after the final merge, and writes its history."""
    import json
    hist = train.main(["--rounds", str(ROUNDS), "--segment", "4",
                       "--agents", str(M), "--local-steps", str(H),
                       "--batch", str(B), "--seq", str(SEQ), "--wire",
                       "int8_ef", "--device", "cpu", "--out",
                       str(tmp_path)])
    out = capsys.readouterr().out
    D = train.build_cpu_preset(get_config("olmo-1b"), M)
    D = panel.make_spec(build_model(D).init_params(None, "meta"),
                        rows=M).width
    assert (f"wire codec int8_ef: {D} B/agent payload ({D + 4} B with "
            "scales/indices) per full-panel exchange") in out
    saved = json.loads((tmp_path / "olmo-1b_final_merge_a0.1.json")
                       .read_text())
    assert saved["history"] == hist and len(hist) == ROUNDS
    assert saved["args"]["wire"] == "int8_ef"
    assert hist[-1]["consensus"] == 0.0
    assert abs(hist[-1]["local_eval"] - hist[-1]["merged_eval"]) <= \
        1e-6 * abs(hist[-1]["merged_eval"])
    assert all(np.isfinite(h["train_loss"]) for h in hist)
