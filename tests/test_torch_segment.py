"""The port's training segment and launcher against the JAX package's, at
the size of the repository's verify recipe (reduced olmo-1b, 4 agents, 10
rounds, 2 local AdamW steps, batch 4, seq 32, final_merge).

Both segments start from the same init (the reference's panel, handed
over), see the same batches and the same W stream (drawn from the same
seeds, in the launcher's order), and report per-round loss, grad norms and
Xi; then both evaluate the merged model and the local models on the same
global batch. Tolerance rtol 1e-4: 20 AdamW steps amplify float32 rounding
(the two frameworks sum products in other orders). After the final merge
Xi <= 1e-6 and local eval == merged eval to 1e-6 relative."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401
from repro.configs import get_config as ref_get_config
from repro.core import dsgd as ref_dsgd
from repro.core import merge as ref_merge
from repro.core import panel as ref_panel
from repro.launch.train import build_cpu_preset as ref_cpu_preset
from repro.models import build_model as ref_build_model
from repro.optim import make_optimizer as ref_make_optimizer
from repro_torch.configs import get_config
from repro_torch.core import dsgd
from repro_torch.core.schedule import make_schedule
from repro_torch.data.synthetic import SyntheticLM, make_agent_lm_batches
from repro_torch.launch import train
from repro_torch.models import build_model
from repro_torch.optim import make_optimizer
from repro_torch.weights import from_reference_params

ROUNDS, M, H, B, SEQ = 10, 4, 2, 4, 32
RTOL = 1e-4


@pytest.fixture(scope="module")
def runs():
    ref_cfg = ref_cpu_preset(ref_get_config("olmo-1b"), M)
    cfg = train.build_cpu_preset(get_config("olmo-1b"), M)
    ref_model, model = ref_build_model(ref_cfg), build_model(cfg)
    ref_opt = ref_make_optimizer("adamw", 3e-3, weight_decay=5e-4,
                                 total_steps=ROUNDS * H)
    opt = make_optimizer("adamw", 3e-3, weight_decay=5e-4,
                         total_steps=ROUNDS * H)

    ref_state, ref_spec = ref_dsgd.init_panel_state(
        ref_model.init_params, ref_opt, M, jax.random.PRNGKey(0),
        merger="uniform")
    stacked = jax.tree.map(np.asarray,
                           ref_panel.from_panel(ref_state["panel"], ref_spec))
    params, _, _ = from_reference_params(stacked, device="cpu")
    state, spec = dsgd.panel_state_from_params(params, opt)

    sched = make_schedule("final_merge", M, ROUNDS, prob=0.2, seed=0)
    lm = SyntheticLM(vocab=cfg.vocab_size, num_domains=8, seed=0)
    mixtures = lm.domain_mixtures(M, 0.1, seed=1)
    rng_np = np.random.default_rng(2)
    Ws = np.stack([sched.mixing_matrix(t)
                   for t in range(ROUNDS)]).astype(np.float32)
    batches = train.sample_segment_batches(lm, mixtures, ROUNDS, H, B, SEQ,
                                           rng_np)
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
                    ref_merged, ref_local),
            "port": ({k: v.numpy() for k, v in mets.items()}, merged, local),
            "state": state}


@pytest.mark.parametrize("metric", ["loss", "grad_norm", "grad_norm_max",
                                    "consensus"])
def test_per_round_metrics_match(runs, metric):
    ref, port = runs["ref"][0][metric], runs["port"][0][metric]
    assert port.shape == (ROUNDS,)
    np.testing.assert_allclose(port, ref, rtol=RTOL, atol=1e-6)


def test_stream_has_idle_and_communicating_rounds(runs):
    """The W stream drives both branches of the round (idle W == I and
    the folded-mean mix), and the last round is the global merge."""
    eye = np.eye(M, dtype=np.float32)
    idle = [np.array_equal(W, eye) for W in runs["Ws"]]
    assert any(idle) and not all(idle)
    assert np.all(runs["Ws"][-1] == np.float32(1.0 / M))


def test_evals_match_and_final_merge_collapses(runs):
    _, ref_merged, ref_local = runs["ref"]
    mets, merged, local = runs["port"]
    np.testing.assert_allclose(merged, ref_merged, rtol=RTOL)
    np.testing.assert_allclose(local, ref_local, rtol=RTOL)
    assert mets["consensus"][-1] <= 1e-6
    assert abs(local - merged) <= 1e-6 * abs(merged)
    assert runs["state"]["step"] == ROUNDS * H
    assert runs["state"]["opt"]["step_count"] == ROUNDS * H


def test_launcher_runs_on_cpu_and_writes_history(tmp_path):
    hist = train.main(["--rounds", "4", "--segment", "3", "--agents", "4",
                       "--local-steps", "1", "--batch", "2", "--seq", "16",
                       "--device", "cpu", "--out", str(tmp_path)])
    path = tmp_path / "olmo-1b_final_merge_a0.1.json"
    saved = json.loads(path.read_text())
    assert saved["history"] == hist and len(hist) == 4
    assert [h["round"] for h in hist] == [0, 1, 2, 3]
    last = hist[-1]
    assert last["consensus"] == 0.0
    assert abs(last["local_eval"] - last["merged_eval"]) <= \
        1e-6 * abs(last["merged_eval"])
    assert hist[1]["merged_eval"] is None and hist[2]["merged_eval"] is not None
    assert all(np.isfinite(h["train_loss"]) for h in hist)
    assert torch.backends.cuda.matmul.allow_tf32 is False


def _no_tensor_in_cycles(fn):
    """Run ``fn`` with the cyclic collector off, then return the tensors
    that only a reference cycle kept alive (they would stay allocated until
    the collector happened to run)."""
    import gc
    gc.collect()
    gc.disable()
    gc.set_debug(gc.DEBUG_SAVEALL)
    try:
        fn()
        gc.collect()
        return [o for o in gc.garbage if torch.is_tensor(o)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        gc.enable()


def test_tree_walks_free_their_leaves_at_once():
    """Flattening and rebuilding a tree leaves no reference cycle behind:
    the recursive walks were closures (function -> cell -> function), which
    held every leaf until the cyclic collector ran — on the card, the 8
    agents' initial parameter trees (7.6 GB at olmo-1b's width) stayed
    allocated into the first rounds, and the peak memory of a path depended
    on when the collector ran."""
    import weakref
    from repro_torch.utils.tree import tree_flatten, tree_unflatten

    def walk():
        t = torch.zeros(3)
        leaves, skel = tree_flatten({"a": {"b": t}, "c": torch.ones(2)})
        tree_unflatten(skel, leaves)
        walk.ref = weakref.ref(t)

    assert _no_tensor_in_cycles(walk) == []
    assert walk.ref() is None


@pytest.mark.parametrize("wire", [None, "int4_ef", "bf16"])
def test_segment_leaves_no_tensor_in_reference_cycles(wire):
    """Init, a segment with communicating, idle and merge rounds, and the
    evals free every tensor they drop by reference counting alone."""
    from repro_torch.core.topology import random_matching
    cfg = train.build_cpu_preset(get_config("olmo-1b"), M)
    model = build_model(cfg)
    W = np.stack([random_matching(M, 0.7, np.random.default_rng(0)),
                  np.eye(M), np.full((M, M), 1.0 / M)]).astype(np.float32)
    lm = SyntheticLM(vocab=cfg.vocab_size, seed=0)
    batches = train.sample_segment_batches(
        lm, lm.domain_mixtures(M, 0.1, seed=1), 3, H, 2, 16,
        np.random.default_rng(2))

    def run():
        opt = make_optimizer("adamw", 3e-3)
        state, spec = dsgd.init_panel_state(model.init_params, opt, M, 0,
                                            device="cpu", wire=wire)
        seg = dsgd.make_panel_segment(model.loss_fn, opt, H, spec)
        state, _ = seg(state, batches, W, 1)
        eval_b = {k: torch.as_tensor(v[0, 0, 0]) for k, v in batches.items()}
        train.eval_merged(model.loss_fn, state["panel"], spec, eval_b)
        train.eval_local(model.loss_fn, state["panel"], spec, eval_b)

    assert _no_tensor_in_cycles(run) == []


def test_after_step_reads_every_local_step():
    """``make_panel_segment(after_step=)`` is called once per local step, in
    order, with the optimizer state in its stored form (grouped int8
    moments under --residency moments=int8), and changes nothing: the
    segment's metrics and panels equal those of a run without it."""
    cfg = train.build_cpu_preset(get_config("olmo-1b"), M)
    model = build_model(cfg)
    W = np.stack([np.full((M, M), 1.0 / M)] * 2).astype(np.float32)
    lm = SyntheticLM(vocab=cfg.vocab_size, seed=0)
    batches = train.sample_segment_batches(
        lm, lm.domain_mixtures(M, 0.1, seed=1), 2, H, 2, 16,
        np.random.default_rng(2))
    runs, seen = [], []
    for hook in (None, lambda step, opt: seen.append(
            (step, sorted(opt["v"]["float32"])))):
        opt = make_optimizer("adamw", 3e-3)
        state, spec = dsgd.init_panel_state(model.init_params, opt, M, 0,
                                            device="cpu",
                                            residency="moments=int8")
        seg = dsgd.make_panel_segment(model.loss_fn, opt, H, spec,
                                      after_step=hook)
        runs.append(seg(state, batches, W, 7))
    assert seen == [(s, ["q", "scale"]) for s in range(2 * H)]
    (s0, m0), (s1, m1) = runs
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    assert torch.equal(s0["panel"]["float32"], s1["panel"]["float32"])
