"""The split route (``make_panel_segment(param_shardings=)``: one agent's
local step split over its fsdp and model ranks, ``models/tensor_parallel.py``)
against the port's one-process segment and the JAX package's unsharded
``make_panel_segment``, on gloo ranks (``tests/_torch_dist.py`` mode ``tp``).

Meshes (1, 1, 1, 2) (heads, d_ff and vocabulary over 2 model ranks),
(1, 1, 2, 2) (and the batch over 2 fsdp ranks) and (1, 2, 1, 2) (agents
over 2 ranks as well), for olmo-1b at the CPU preset's widths (tied table,
Kv 2 of H 2) and phi3-mini-3.8b, yi-34b and gemma-2b at ``reduced()``
(phi3 and yi: untied heads, GQA groups of 2; gemma: one kv head, whole on
both model ranks, and a tied table), 4 agents, 2 local steps, batch 4 x 16,
3 rounds (two ring rounds, then the global merge), the reference's inits
handed over:

- one step's gradient panel, gathered, leaf by leaf against the one-process
  ``panel_grads`` (atol 1e-6 + rtol 1e-5; measured: within 1.3e-6 of each
  leaf's largest element, the all-reduces summing the heads', vocabulary
  parts' and batch shares' parts in another order);
- the segment's per-round loss, grad norm, Xi and evals (PORT_RTOL against
  the port's one process, REF_RTOL against the reference; measured at most
  1.4e-6, 1.1e-5, 2.0e-7, 1.4e-5 and 2.8e-6, 1.5e-5, 1.0e-7, 6.8e-7).
  Those float32 differences of the first gradients grow through six
  AdamW steps: the port's one process itself sits 1.3e-5 from the
  reference on phi3's evals, 1.5e-5 on yi's grad norm. After the merge Xi
  0.0, every agent's row identical, merged == local;
- the FLOPs of one agent's step a rank on (1, 1, 2, 2) for olmo at most
  0.30 of the replica route's (the matmuls a quarter: half the batch, half
  the heads, d_ff columns and vocabulary);
- what stays whole: the plan names each leaf's rule; the published widths'
  head granularity (yi's 56 heads, gemma's 8 at M = 16; gemma's kv head at
  M = 2); a family the route does not split and an uneven batch refused by
  name.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist
import _torch_threads  # noqa: F401
from _torch_dist import (TP_B, TP_CASES, TP_H, TP_M, TP_ROUNDS, TP_S,
                         tp_config)
from repro.configs import get_config as ref_get_config
from repro.core import dsgd as ref_dsgd
from repro.core import merge as ref_merge
from repro.core import panel as ref_panel
from repro.models import build_model as ref_build_model
from repro.optim import make_optimizer as ref_make_optimizer
from repro_torch.configs import get_config
from repro_torch.core import dsgd
from repro_torch.launch import train
from repro_torch.launch.mesh import mesh_of_shape
from repro_torch.models import build_model
from repro_torch.models import tensor_parallel as tp
from repro_torch.optim import make_optimizer
from repro_torch.utils.tree import tree_map
from repro_torch.weights import from_reference_params

MESHES = ("1,1,1,2", "1,1,2,2", "1,2,1,2")
PORT_RTOL = {"loss": 5e-6, "consensus": 1e-6, "grad_norm": 5e-5,
             "eval": 5e-5}
REF_RTOL = {"loss": 1e-5, "consensus": 1e-6, "grad_norm": 1e-4,
            "eval": 1e-5}


def _stream(cfg):
    """Batches (S, H, m, b, seq), the rounds' W (two rings, the merge) and
    their global mask, and an eval batch, from a seeded numpy generator."""
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, size=(
        TP_ROUNDS, TP_H, TP_M, TP_B, TP_S + 1)).astype(np.int32)
    batches = {"tokens": toks[..., :-1], "targets": toks[..., 1:],
               "mask": np.ones(toks[..., 1:].shape, np.float32)}
    batches["mask"][..., -3:] = 0.0
    ring = np.zeros((TP_M, TP_M), np.float32)
    for k in range(TP_M):
        ring[k, k] = 0.5
        ring[k, (k + 1) % TP_M] += 0.25
        ring[k, (k - 1) % TP_M] += 0.25
    Ws = np.stack([ring, ring, np.full((TP_M, TP_M), 1.0 / TP_M,
                                       np.float32)])
    ev = rng.integers(0, cfg.vocab_size, size=(2 * TP_B, TP_S + 1)
                      ).astype(np.int32)
    evb = {"tokens": ev[:, :-1], "targets": ev[:, 1:],
           "mask": np.ones((2 * TP_B, TP_S), np.float32)}
    return batches, Ws, np.array([False, False, True]), evb


def _reference(case, batches, Ws, evb):
    """The reference's init (stacked numpy) and its jitted unsharded
    segment's metrics and evals."""
    cfg = tp_config(case, ref_get_config)
    model = ref_build_model(cfg)
    opt = ref_make_optimizer("adamw", 3e-3, weight_decay=5e-4,
                             total_steps=TP_ROUNDS * TP_H)
    state, spec = ref_dsgd.init_panel_state(model.init_params, opt, TP_M,
                                            jax.random.PRNGKey(0))
    stacked = jax.tree.map(np.asarray,
                           ref_panel.from_panel(state["panel"], spec))
    seg = ref_dsgd.make_panel_segment(model.loss_fn, opt, TP_H, spec)
    state, mets = seg(state, jax.tree.map(jnp.asarray, batches),
                      jnp.asarray(Ws), jax.random.PRNGKey(1))
    jb = jax.tree.map(jnp.asarray, evb)

    def loss(p):
        return model.loss_fn(p, jb, None)[0]

    merged = float(jax.jit(lambda pan: ref_merge.counterfactual_eval_panel(
        loss, pan, spec))(state["panel"]))
    local = float(jax.jit(lambda pan: jnp.mean(jax.vmap(loss)(
        ref_panel.from_panel(pan, spec))))(state["panel"]))
    return stacked, {"mets": {k: np.asarray(v) for k, v in mets.items()},
                     "merged": merged, "local": local}


def _one_process(case, params, batches, Ws, glob, evb):
    """The port's one-process segment from the handed-over init: metrics,
    evals, and one step's gradient panel (the segment's first batch)."""
    model = build_model(tp_config(case, get_config))
    opt = make_optimizer("adamw", 3e-3, weight_decay=5e-4,
                         total_steps=TP_ROUNDS * TP_H)
    state, spec = dsgd.panel_state_from_params(params, opt)
    step0 = {k: torch.as_tensor(v[0, 0]) for k, v in batches.items()}
    grads, _ = dsgd.panel_grads(model.loss_fn, state["panel"], spec, step0)
    state, mets = dsgd.make_panel_segment(model.loss_fn, opt, TP_H, spec)(
        state, batches, Ws, global_rounds=glob)
    ev = train.to_device(evb, "cpu")
    return {"mets": {k: v.numpy() for k, v in mets.items()},
            "merged": train.eval_merged(model.loss_fn, state["panel"], spec,
                                        ev),
            "local": train.eval_local(model.loss_fn, state["panel"], spec,
                                      ev),
            "grads": grads, "spec": spec}


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """Per case: the reference's results, the port's one-process results;
    ``tp_inputs.pt`` written for the ranks."""
    tmp = tmp_path_factory.mktemp("tp")
    inputs, out = {}, {}
    for case in TP_CASES:
        batches, Ws, glob, evb = _stream(tp_config(case, get_config))
        stacked, ref = _reference(case, batches, Ws, evb)
        params, _, _ = from_reference_params(stacked, device="cpu")
        inputs[case] = {"params": [tree_map(lambda x, k=k: x[k].clone(),
                                            params) for k in range(TP_M)],
                        "batches": batches, "Ws": Ws, "glob": glob,
                        "eval": evb}
        out[case] = {"ref": ref, "port": _one_process(
            case, params, batches, Ws, glob, evb)}
    torch.save(inputs, tmp / "tp_inputs.pt")
    return tmp, out


@pytest.fixture(scope="module")
def worlds(cases):
    """Each mesh's ranks' records, run once."""
    tmp, _ = cases
    done = {}

    def run(shape):
        if shape not in done:
            world = int(np.prod([int(x) for x in shape.split(",")]))
            sub = tmp / shape.replace(",", "_")
            sub.mkdir()
            (sub / "tp_inputs.pt").symlink_to(tmp / "tp_inputs.pt")
            _torch_dist.spawn(world, "tp", str(sub), args=(shape,),
                              timeout=240)
            done[shape] = [torch.load(sub / f"rank{r}.pt",
                                      weights_only=False)
                           for r in range(world)]
        return done[shape]
    return run


def _close(got, want, rtol, what):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=1e-7, err_msg=what)


@pytest.mark.parametrize("shape", MESHES)
def test_split_segment_matches_one_process_and_reference(cases, worlds,
                                                         shape):
    """Per round loss, grad norm and Xi, and the evals, of every rank's
    split segment against the port's one process and the reference; after
    the merge Xi 0.0, every row identical and merged == local."""
    _, res = cases
    for r, rec in enumerate(worlds(shape)):
        for case in TP_CASES:
            got = rec[case]
            for against, rtol in (("port", PORT_RTOL), ("ref", REF_RTOL)):
                want = res[case][against]
                for k in ("loss", "grad_norm", "consensus"):
                    _close(got["mets"][k].numpy(), want["mets"][k], rtol[k],
                           f"{shape} rank {r} {case} {k} against {against}")
                for k in ("merged", "local"):
                    _close(got[k], want[k], rtol["eval"],
                           f"{shape} rank {r} {case} {k} against {against}")
            assert float(got["mets"]["consensus"][-1]) == 0.0
            for x in got["panel"].values():
                assert torch.equal(x, x[:1].expand_as(x)), (shape, case)
            assert abs(got["local"] - got["merged"]) <= \
                1e-6 * abs(got["merged"])


@pytest.mark.parametrize("shape", MESHES)
def test_split_gradient_panel_leaf_by_leaf(cases, worlds, shape):
    """One step's gradient panel of the split route, gathered, against the
    one-process panel_grads, leaf by leaf (atol 1e-6 + rtol 1e-5)."""
    _, res = cases
    for r, rec in enumerate(worlds(shape)):
        for case in TP_CASES:
            want, spec = res[case]["port"]["grads"], res[case]["port"]["spec"]
            got = rec[case]["grads"]
            for i, ls in enumerate(spec.leaves):
                sl = slice(ls.offset, ls.offset + ls.size)
                torch.testing.assert_close(
                    got[ls.group][:, sl], want[ls.group][:, sl], atol=1e-6,
                    rtol=1e-5, msg=lambda m, i=i: f"{shape} rank {r} {case} "
                                                  f"leaf {i}: {m}")


def test_split_flops_a_rank(worlds):
    """One agent's step on (1, 1, 2, 2): a rank's FLOPs at most 0.30 of the
    replica route's (olmo-1b, CPU preset widths)."""
    for rec in worlds("1,1,2,2"):
        olmo = rec["olmo-1b"]
        ratio = olmo["flops_split"] / olmo["flops_replica"]
        assert 0.2 < ratio <= 0.30, ratio


def test_split_plan_names_what_stays_whole(worlds):
    """The ranks' leaf plans on (1, 1, 1, 2): attention and MLP projections
    split; olmo's and gemma's tied tables summed (the head's rows split,
    the lookup whole), phi3's and yi's head.w split; gemma's one kv head
    whole and summed; norms whole."""
    plans = {case: worlds("1,1,1,2")[0][case]["plan"] for case in TP_CASES}
    blk = "decoder.main.p0."
    for case, plan in plans.items():
        for leaf in ("mixer.wq", "mixer.wo", "ffn.w_in", "ffn.w_gate",
                     "ffn.w_out"):
            assert blk + leaf in plan["split"], (case, leaf)
    assert set(plans["gemma-2b"]["summed"]) == {
        "embed.table", blk + "mixer.wk", blk + "mixer.wv"}
    assert plans["olmo-1b"]["summed"] == ["embed.table"]
    for case in ("phi3-mini-3.8b", "yi-34b"):
        assert "head.w" in plans[case]["split"]
        assert blk + "mixer.wk" in plans[case]["split"]
        assert plans[case]["summed"] == []
        assert "embed.table" in plans[case]["whole"]
    assert blk + "norm1.scale" in plans["gemma-2b"]["whole"]


@pytest.mark.parametrize("case,M,attn,kv", [
    ("yi-34b", 16, False, False), ("gemma-2b", 16, False, False),
    ("gemma-2b", 2, True, False), ("olmo-1b", 16, True, True),
    ("phi3-mini-3.8b", 16, True, True)])
def test_head_granularity_at_published_widths(case, M, attn, kv):
    """A dim the model line does not divide stays whole: the decisions and
    the plan at the published widths on a (1, 1, 1, M) mesh of shape only
    (yi's 56 heads and gemma's 8 at M = 16: the whole attention on every
    model rank; gemma's one kv head at M = 2)."""
    cfg = get_config(case)
    mesh = mesh_of_shape((1, 1, 1, M))
    split = tp.Split(mesh)
    assert (split.attn(cfg.attn), split.kv(cfg.attn)) == (attn, kv)
    model = build_model(cfg)
    plan = tp.describe(tp.leaf_plan(cfg, split, tp.train_shardings(
        model, mesh, 1)))
    wq = "decoder.main.p0.mixer.wq"
    assert (wq in plan["split"]) == attn
    assert (wq in plan["whole"]) == (not attn)
    assert ("decoder.main.p0.ffn.w_in" in plan["split"]) == (
        cfg.d_ff % M == 0)


def test_unsplit_family_and_uneven_batch_refused():
    """An MoE config given param_shardings raises by name; a batch the
    fsdp line does not divide is a ValueError naming both."""
    cfg = get_config("arctic-480b").reduced()
    model = build_model(cfg)
    mesh = mesh_of_shape((1, 1, 1, 2))
    opt = make_optimizer("adamw", 1e-3)
    _, spec = dsgd.init_panel_state(model.init_params, opt, 1, 0,
                                    device="cpu", mesh=mesh)
    with pytest.raises(NotImplementedError, match="arctic-480b.*MoE"):
        dsgd.make_panel_segment(model.loss_fn, opt, 1, spec,
                                param_shardings=tp.train_shardings(
                                    model, mesh, 1))
    with pytest.raises(ValueError, match="batch of 3 rows.*2 ranks"):
        tp.Split(mesh_of_shape((1, 1, 2, 1))).batch_rows(3)
