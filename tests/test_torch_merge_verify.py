"""The port's merge operators at the verify recipe's size against the JAX
package's (split from ``tests/test_torch_merge.py``, whose docstring states
the cases and tolerances): the segment at the verify size (reduced olmo-1b,
4 agents, 10 rounds, 2 AdamW steps) under every non-uniform operator
against the jitted reference segment, per-round metrics and evals at rtol
1e-4; the global merge held by merging the reference's own pre-merge state
(bit for bit against its operator, within 1e-6 of its segment's row, but
'var' within 1e-3); the launcher with ``--merge ties`` on the CPU; and why
the TIES evals are not compared across packages (a 1-ulp change of the
initial panel moves its merged eval by ~1e-2)."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401
from repro import merging as ref_merging
from repro.configs import get_config as ref_get_config
from repro.core import dsgd as ref_dsgd
from repro.core import merge as ref_merge
from repro.core import panel as ref_panel
from repro.launch.train import build_cpu_preset as ref_cpu_preset
from repro.models import build_model as ref_build_model
from repro.optim import make_optimizer as ref_make_optimizer
from repro_torch import merging
from repro_torch.configs import get_config
from repro_torch.core import dsgd
from repro_torch.core.schedule import make_schedule
from repro_torch.data.synthetic import SyntheticLM, make_agent_lm_batches
from repro_torch.launch import train
from repro_torch.models import build_model
from repro_torch.optim import make_optimizer
from repro_torch.weights import (from_reference_params,
                                 merge_stat_from_reference)
from test_torch_merge import NON_UNIFORM, _np, _t


# ------------------------------------------- the verify size vs JAX

ROUNDS, M, H, B, SEQ = 10, 4, 2, 4, 32
RTOL = 1e-4


def _verify_runs(name):
    """Both packages in two segments (rounds 0-8, then the global round 9)
    from the same handed-over init, batches, W stream and global-round
    mask; and the reference's PRE-MERGE state (round 9 with W = I)."""
    ref_cfg = ref_cpu_preset(ref_get_config("olmo-1b"), M)
    cfg = train.build_cpu_preset(get_config("olmo-1b"), M)
    ref_model, model = ref_build_model(ref_cfg), build_model(cfg)
    ref_opt = ref_make_optimizer("adamw", 3e-3, weight_decay=5e-4,
                                 total_steps=ROUNDS * H)
    opt = make_optimizer("adamw", 3e-3, weight_decay=5e-4,
                         total_steps=ROUNDS * H)
    ref_state, ref_spec = ref_dsgd.init_panel_state(
        ref_model.init_params, ref_opt, M, jax.random.PRNGKey(0),
        merger=name)
    stacked = jax.tree.map(np.asarray,
                           ref_panel.from_panel(ref_state["panel"], ref_spec))
    params, _, _ = from_reference_params(stacked, device="cpu")
    state, spec = dsgd.panel_state_from_params(params, opt, merger=name)

    sched = make_schedule("final_merge", M, ROUNDS, prob=0.2, seed=0,
                          merger=name)
    Ws, glob = [], []
    for t in range(ROUNDS):
        Ws.append(sched.mixing_matrix(t))
        glob.append(sched.last_kind == "global")
    Ws, glob = np.stack(Ws).astype(np.float32), np.asarray(glob)
    assert glob[-1] and not glob[:-1].any()
    lm = SyntheticLM(vocab=cfg.vocab_size, num_domains=8, seed=0)
    batches = train.sample_segment_batches(
        lm, lm.domain_mixtures(M, 0.1, seed=1), ROUNDS, H, B, SEQ,
        np.random.default_rng(2))
    glob_mix = np.ones(lm.num_domains) / lm.num_domains
    eval_b = {k: v[0] for k, v in make_agent_lm_batches(
        lm, [glob_mix], 2 * B, SEQ, np.random.default_rng(999)).items()}
    parts = [slice(0, ROUNDS - 1), slice(ROUNDS - 1, ROUNDS)]

    ref_seg = ref_dsgd.make_panel_segment(ref_model.loss_fn, ref_opt, H,
                                          ref_spec, donate=False)
    ref_mets, pre = [], None
    for i, sl in enumerate(parts):
        b = jax.tree.map(lambda v: jnp.asarray(v[sl]), batches)
        key = jax.random.PRNGKey(1 + i)
        if i == 1:
            pre, _ = ref_seg(ref_state, b, jnp.asarray(
                np.eye(M, dtype=np.float32)[None]), key, None,
                jnp.asarray([False]))
        ref_state, mt = ref_seg(ref_state, b, jnp.asarray(Ws[sl]), key,
                                None, jnp.asarray(glob[sl]))
        ref_mets.append({k: np.asarray(v) for k, v in mt.items()})
    jb = jax.tree.map(jnp.asarray, eval_b)

    def ref_loss(p):
        return ref_model.loss_fn(p, jb, None)[0]

    ref_merged = float(jax.jit(
        lambda pan, ms: ref_merge.counterfactual_eval_panel(
            ref_loss, pan, ref_spec, stats=ms))(
                ref_state["panel"], ref_state.get("merge_stat")))
    ref_local = float(jax.jit(lambda pan: jnp.mean(jax.vmap(ref_loss)(
        ref_panel.from_panel(pan, ref_spec))))(ref_state["panel"]))

    seg = dsgd.make_panel_segment(model.loss_fn, opt, H, spec)
    mets = []
    for sl in parts:
        state, mt = seg(state, {k: v[sl] for k, v in batches.items()},
                        Ws[sl], global_rounds=glob[sl])
        mets.append({k: v.numpy() for k, v in mt.items()})
    tb = train.to_device(eval_b, "cpu")
    merged = train.eval_merged(model.loss_fn, state["panel"], spec, tb,
                               state.get("merge_stat"))
    local = train.eval_local(model.loss_fn, state["panel"], spec, tb)
    cat = {k: np.concatenate([mt[k] for mt in mets]) for k in mets[0]}
    ref_cat = {k: np.concatenate([mt[k] for mt in ref_mets])
               for k in mets[0]}
    return {"name": name, "spec": spec,
            "ref": (ref_cat, ref_merged, ref_local,
                    np.asarray(ref_state["panel"]["float32"]),
                    jax.tree.map(np.asarray, pre)),
            "port": (cat, merged, local, state)}


@pytest.fixture(scope="module", params=NON_UNIFORM)
def verify_runs(request):
    return _verify_runs(request.param)


def test_verify_size_metrics_and_evals_match(verify_runs):
    name = verify_runs["name"]
    ref_mets, ref_merged, ref_local = verify_runs["ref"][:3]
    mets, merged, local, state = verify_runs["port"]
    for k in ("loss", "grad_norm", "grad_norm_max", "consensus"):
        assert mets[k].shape == (ROUNDS,)
        np.testing.assert_allclose(mets[k], ref_mets[k], rtol=RTOL,
                                   atol=1e-6, err_msg=f"{name} {k}")
    assert mets["consensus"][-1] == 0.0
    x = state["panel"]["float32"]
    assert torch.equal(x, x[:1].expand_as(x))
    assert abs(local - merged) <= 1e-6 * abs(merged)
    if name != "ties":  # ill-conditioned after the merge (module doc)
        np.testing.assert_allclose(merged, ref_merged, rtol=RTOL)
        np.testing.assert_allclose(local, ref_local, rtol=RTOL)
    mg = merging.get_merger(name)
    assert sorted(state.get("merge_stat", {})) == sorted(mg.stat_panels)


def test_verify_size_merge_of_reference_premerge_state(verify_runs):
    """The port's merge round on the reference's own pre-merge panel and
    statistics gives the reference operator's merged row (eager) bit for
    bit, but 'weighted' (its tensordot sums in XLA's order; 1e-6), and the
    reference SEGMENT's merged row within 1e-6 — but 'var', within 1e-3
    absolute: the jitted reference contracts max(m2 - mu^2, 0) into fused
    multiply-adds, so its segment's row differs from its own eager
    merge_row (measured up to 1.8e-4; the variance of a coordinate that
    barely moves is rounding noise, and its weight 1 / (var + eps) follows
    the noise)."""
    name, spec = verify_runs["name"], verify_runs["spec"]
    ref_final, pre = verify_runs["ref"][3], verify_runs["ref"][4]
    stats = (merge_stat_from_reference(pre["merge_stat"], spec,
                                       device="cpu")
             if "merge_stat" in pre else None)
    mixed, row, _ = merging.merge_panel(
        {"float32": _t(pre["panel"]["float32"])}, name, stats=stats,
        spec=spec)
    got = row["float32"].numpy()
    assert torch.equal(mixed["float32"],
                       row["float32"][None].expand(M, -1))
    eager = _np(ref_merging.get_merger(name).merge_row(
        {"float32": jnp.asarray(pre["panel"]["float32"])},
        stats=pre.get("merge_stat"))["float32"])
    if name == "weighted":
        np.testing.assert_allclose(got, eager, rtol=1e-6, atol=1e-6)
    else:
        assert got.tobytes() == eager.tobytes()
    assert np.all(ref_final == ref_final[:1])
    np.testing.assert_allclose(got, ref_final[0], rtol=1e-6,
                               atol=1e-3 if name == "var" else 1e-6)


def test_launcher_merge_ties_on_cpu(tmp_path):
    hist = train.main(["--rounds", "4", "--segment", "4", "--agents", "4",
                       "--local-steps", "1", "--batch", "2", "--seq", "16",
                       "--merge", "ties", "--eval-merged-every", "2",
                       "--device", "cpu", "--out", str(tmp_path)])
    saved = json.loads(
        (tmp_path / "olmo-1b_final_merge_a0.1_mties.json").read_text())
    assert saved["history"] == hist and len(hist) == 4
    assert saved["args"]["merge"] == "ties"
    # --eval-merged-every 2 cuts the 4-round segment in two
    assert [h["merged_eval"] is not None for h in hist] == [
        False, True, False, True]
    last = hist[-1]
    assert last["consensus"] == 0.0
    assert abs(last["local_eval"] - last["merged_eval"]) <= \
        1e-6 * abs(last["merged_eval"])
    assert all(np.isfinite(h["train_loss"]) for h in hist)


def _port_ties_eval(nudge):
    """The port alone at the verify size (its own init), TIES merged eval
    after the final merge; ``nudge`` moves every initial parameter by one
    ulp."""
    cfg = train.build_cpu_preset(get_config("olmo-1b"), M)
    model = build_model(cfg)
    opt = make_optimizer("adamw", 3e-3, weight_decay=5e-4,
                         total_steps=ROUNDS * H)
    state, spec = dsgd.init_panel_state(model.init_params, opt, M, 0,
                                        device="cpu", merger="ties")
    if nudge:
        x = state["panel"]["float32"]
        x.copy_(torch.nextafter(x, torch.full_like(x, np.inf)))
    sched = make_schedule("final_merge", M, ROUNDS, prob=0.2, seed=0)
    Ws = np.stack([sched.mixing_matrix(t)
                   for t in range(ROUNDS)]).astype(np.float32)
    lm = SyntheticLM(vocab=cfg.vocab_size, num_domains=8, seed=0)
    batches = train.sample_segment_batches(
        lm, lm.domain_mixtures(M, 0.1, seed=1), ROUNDS, H, B, SEQ,
        np.random.default_rng(2))
    glob_mix = np.ones(lm.num_domains) / lm.num_domains
    eval_b = train.to_device({k: v[0] for k, v in make_agent_lm_batches(
        lm, [glob_mix], 2 * B, SEQ, np.random.default_rng(999)).items()},
        "cpu")
    seg = dsgd.make_panel_segment(model.loss_fn, opt, H, spec)
    state, mets = seg(state, batches, Ws)
    loss = float(mets["loss"][-1])
    return loss, train.eval_merged(model.loss_fn, state["panel"], spec,
                                   eval_b)


def test_ties_merge_is_ill_conditioned_at_the_verify_size():
    """Why the TIES evals are not compared across packages: a 1-ulp change
    of the initial panel leaves the last round's training loss within 1e-5
    but moves the TIES merged eval by far more (measured: the loss by
    9.9e-7 relative, the merged eval by 9.4e-3)."""
    loss0, ev0 = _port_ties_eval(False)
    loss1, ev1 = _port_ties_eval(True)
    assert abs(loss1 - loss0) <= 1e-5 * abs(loss0)
    assert abs(ev1 - ev0) > 1e-3 * abs(ev0)
