"""The split route (``make_panel_segment(param_shardings=)``: one agent's
local step split over its fsdp and model ranks, ``models/tensor_parallel.py``)
against the port's one-process segment and the JAX package's unsharded
``make_panel_segment``, on gloo ranks (``tests/_torch_dist.py`` mode ``tp``).

Meshes (1, 1, 1, 2) (heads, d_ff and vocabulary over 2 model ranks),
(1, 1, 2, 2) (and the batch over 2 fsdp ranks) and (1, 2, 1, 2) (agents
over 2 ranks as well), for olmo-1b at the CPU preset's widths (tied table,
Kv 2 of H 2) and phi3-mini-3.8b, yi-34b, gemma-2b, arctic-480b and
qwen2-vl-72b at ``reduced()`` (phi3 and yi: untied heads, GQA groups of 2;
gemma: one kv head, whole on both model ranks, and a tied table; arctic:
4 experts top-2, 2 a model rank, its dense MLP split; qwen2-vl: M-RoPE
(8, 4, 4) with seeded per-row positions and an 8-row seeded patch
prefix), 4 agents, 2 local steps, batch 4 x 16, 3 rounds (two ring
rounds, then the global merge), the reference's inits handed over:

- one step's gradient panel, gathered, leaf by leaf against the one-process
  ``panel_grads`` (atol 1e-6 + rtol 1e-5; measured: within 1.3e-6 of each
  leaf's largest element, the all-reduces summing the heads', vocabulary
  parts' and batch shares' parts in another order);
- the segment's per-round loss, grad norm, Xi and evals (PORT_RTOL against
  the port's one process, REF_RTOL against the reference; measured at most
  1.4e-6, 1.1e-5, 2.0e-7, 1.4e-5 and 2.8e-6, 1.5e-5, 1.0e-7, 6.8e-7).
  Those float32 differences of the first gradients grow through six
  AdamW steps: the port's one process itself sits 1.3e-5 from the
  reference on phi3's evals, 1.5e-5 on yi's grad norm. arctic's segment
  is held within twice its own conditioning (CONDITIONED). After the
  merge Xi 0.0, every agent's row identical, merged == local;
- arctic's overflow step (capacity factor 0.5: one process drops
  assignments): the ranks keep exactly the assignments one process keeps,
  and its gradient panel at the gradient tolerance;
- the FLOPs of one agent's step a rank on (1, 1, 2, 2) for olmo at most
  0.30 of the replica route's (the matmuls a quarter: half the batch, half
  the heads, d_ff columns and vocabulary), for arctic at most 0.45;
- what stays whole: the plan names each leaf's rule; the published widths'
  head granularity (yi's and arctic's 56 heads, gemma's 8 at M = 16;
  gemma's kv head at M = 2; qwen2-vl's 64 heads split at M = 16, a kv
  head shared by two ranks; arctic's experts 8 a rank); a family the
  route does not split and an uneven batch refused by name.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist
import _torch_threads  # noqa: F401
from _torch_dist import (TP_B, TP_CAPACITY, TP_CASES, TP_H, TP_M, TP_ROUNDS,
                         TP_S, tp_config)
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
from repro_torch.models import build_model, moe
from repro_torch.models import tensor_parallel as tp
from repro_torch.optim import make_optimizer
from repro_torch.utils.tree import tree_map
from repro_torch.weights import from_reference_params

MESHES = ("1,1,1,2", "1,1,2,2", "1,2,1,2")
PORT_RTOL = {"loss": 5e-6, "consensus": 1e-6, "grad_norm": 5e-5,
             "eval": 5e-5}
REF_RTOL = {"loss": 1e-5, "consensus": 1e-6, "grad_norm": 1e-4,
            "eval": 1e-5}
# the cases whose segment one process cannot itself hold to those
# tolerances: arctic's MoE (a one-ulp move of its init moves one process's
# loss 6.8e-6 at the second round and 1.0e-4 at the third: AdamW's eps
# turns float32 noise in its ~1e-8 gradients into different first steps,
# and a routing or drop decided otherwise follows). Each metric there is
# held at the tolerance or COND_FACTOR times that move, whichever is
# larger; its one step's gradient panel at the gradient tolerance.
CONDITIONED = ("arctic-480b",)
COND_FACTOR = 2.0


def _mrope_positions(lead, b, n):
    """M-RoPE's (..., 3, b, n) positions: time 0.., height and width the
    prefix's grid (4 wide) then time's, each row offset by its index (so a
    cut on the wrong dim shows)."""
    t = np.arange(n)
    rows = np.arange(b)[:, None]
    p3 = np.stack([t + 0 * rows, t // 4 + rows, t % 4 + 2 * rows])
    return np.broadcast_to(p3, lead + p3.shape).astype(np.int32).copy()


def _extras(cfg, lead, b, rng):
    """qwen2-vl's seeded patch prefix (..., b, P, d) and M-RoPE positions
    (..., 3, b, P + TP_S); {} for the others."""
    if not cfg.mm_prefix:
        return {}
    P = cfg.mm_prefix
    return {"patch_embeds": rng.standard_normal(
                lead + (b, P, cfg.d_model)).astype(np.float32),
            "positions3": _mrope_positions(lead, b, P + TP_S)}


def _stream(cfg):
    """Batches (S, H, m, b, seq) (qwen2-vl's with its prefix and M-RoPE
    positions), the rounds' W (two rings, the merge) and their global
    mask, and an eval batch, from a seeded numpy generator."""
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, size=(
        TP_ROUNDS, TP_H, TP_M, TP_B, TP_S + 1)).astype(np.int32)
    batches = {"tokens": toks[..., :-1], "targets": toks[..., 1:],
               "mask": np.ones(toks[..., 1:].shape, np.float32)}
    batches["mask"][..., -3:] = 0.0
    batches.update(_extras(cfg, (TP_ROUNDS, TP_H, TP_M), TP_B, rng))
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
    evb.update(_extras(cfg, (), 2 * TP_B, rng))
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
    evals, and one step's gradient panel (the segment's first batch); for
    an MoE case also that step's at TP_CAPACITY and the assignments it
    kept."""
    model = build_model(tp_config(case, get_config))
    opt = make_optimizer("adamw", 3e-3, weight_decay=5e-4,
                         total_steps=TP_ROUNDS * TP_H)
    state, spec = dsgd.panel_state_from_params(params, opt)
    step0 = {k: torch.as_tensor(v[0, 0]) for k, v in batches.items()}
    grads, _ = dsgd.panel_grads(model.loss_fn, state["panel"], spec, step0)
    over = None
    if model.cfg.moe is not None:
        # the overflow step (TP_CAPACITY) and the assignments it keeps (an
        # agent's layers in order, the agents in order)
        kept, orig = [], moe.dispatch_ranks

        def record(sel, C):
            out = orig(sel, C)
            kept.append(out[2])
            return out
        moe.dispatch_ranks = record
        try:
            fn = build_model(tp_config(case, get_config, TP_CAPACITY)).loss_fn
            g, _ = dsgd.panel_grads(fn, state["panel"], spec, step0)
        finally:
            moe.dispatch_ranks = orig
        over = {"grads": g, "kept": kept}
    state, mets = dsgd.make_panel_segment(model.loss_fn, opt, TP_H, spec)(
        state, batches, Ws, global_rounds=glob)
    ev = train.to_device(evb, "cpu")
    return {"mets": {k: v.numpy() for k, v in mets.items()},
            "merged": train.eval_merged(model.loss_fn, state["panel"], spec,
                                        ev),
            "local": train.eval_local(model.loss_fn, state["panel"], spec,
                                      ev),
            "grads": grads, "spec": spec, "overflow": over}


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
        if case in CONDITIONED:
            out[case]["cond"] = _conditioning(
                out[case]["port"], _one_process(case, tree_map(
                    lambda x: torch.nextafter(x, torch.full_like(
                        x, float("inf"))), params), batches, Ws, glob, evb))
    torch.save(inputs, tmp / "tp_inputs.pt")
    return tmp, out


def _conditioning(one, nudged):
    """Each metric's relative move (per round; the evals) of one process's
    segment when its init moves one ulp up."""
    def rel(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return np.abs(a - b) / np.maximum(np.abs(b), 1e-30)
    out = {k: rel(nudged["mets"][k], one["mets"][k])
           for k in ("loss", "grad_norm", "consensus")}
    out.update({k: rel(nudged[k], one[k]) for k in ("merged", "local")})
    return out


def _rtol(res, case, rtol, k):
    """The tolerance of metric ``k``: ``rtol``'s, or for a CONDITIONED case
    at least COND_FACTOR times the metric's move under a one-ulp init
    nudge (per round)."""
    base = rtol["eval" if k in ("merged", "local") else k]
    if case not in CONDITIONED:
        return base
    return np.maximum(base, COND_FACTOR * res[case]["cond"][k])


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
    """Each element within its own rtol (a scalar, or one a round)."""
    got = np.atleast_1d(np.asarray(got, np.float64))
    want = np.atleast_1d(np.asarray(want, np.float64))
    rtol = np.broadcast_to(np.asarray(rtol, np.float64), want.shape)
    for i in np.ndindex(want.shape):
        np.testing.assert_allclose(got[i], want[i], rtol=float(rtol[i]),
                                   atol=1e-7, err_msg=f"{what} {i}")


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
                    _close(got["mets"][k].numpy(), want["mets"][k],
                           _rtol(res, case, rtol, k),
                           f"{shape} rank {r} {case} {k} against {against}")
                for k in ("merged", "local"):
                    _close(got[k], want[k], _rtol(res, case, rtol, k),
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


def test_split_flops_a_rank_arctic(worlds):
    """One arctic agent's step on (1, 1, 2, 2): a rank's FLOPs at most 0.45
    of the replica route's (half the batch, heads, dense MLP columns and
    vocabulary; half the experts, each at min(C, the rank's tokens)
    slots: 16 of 16 here)."""
    ratios = []
    for rec in worlds("1,1,2,2"):
        arctic = rec["arctic-480b"]
        ratios.append(arctic["flops_split"] / arctic["flops_replica"])
    print(f"arctic-480b reduced() on (1, 1, 2, 2): a rank's FLOPs over the "
          f"replica route's {ratios}")
    assert all(0.2 < r <= 0.45 for r in ratios), ratios


@pytest.mark.parametrize("shape", MESHES)
def test_split_keeps_the_assignments_one_process_keeps(cases, worlds, shape):
    """arctic's overflow step (capacity factor TP_CAPACITY, 0.5): one
    process drops assignments, and the ranks' kept ones, an agent's layers
    each put together from its fsdp rows and model ranks' experts, are
    exactly one process's; the step's gradient panel leaf by leaf against
    one process's (atol 1e-6 + rtol 1e-5)."""
    _, res = cases
    one = res["arctic-480b"]["port"]
    want = one["overflow"]["kept"]
    for r, rec in enumerate(worlds(shape)):
        got = rec["arctic-480b"]["overflow"]["grads"]
        ref = one["overflow"]["grads"]
        for i, ls in enumerate(one["spec"].leaves):
            sl = slice(ls.offset, ls.offset + ls.size)
            torch.testing.assert_close(
                got[ls.group][:, sl], ref[ls.group][:, sl],
                atol=1e-6, rtol=1e-5,
                msg=lambda m, i=i: f"{shape} rank {r} leaf {i}: {m}")
    layers = len(want) // TP_M
    assert 0 < sum(int(v.sum()) for v in want) < sum(v.numel()
                                                     for v in want)
    got = [torch.zeros_like(v) for v in want]
    F = int(shape.split(",")[2])
    for rec in worlds(shape):
        r = rec["arctic-480b"]
        lo, hi = r["agents"]
        kept = r["overflow"]["kept"]
        assert len(kept) == (hi - lo) * layers
        for i, v in enumerate(kept):
            k, layer = lo + i // layers, i % layers
            n = v.numel()
            f = r["coord"]["fsdp"]
            assert n * F == want[k * layers + layer].numel()
            got[k * layers + layer][f * n:(f + 1) * n] |= v
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), (shape, i)


def test_split_plan_names_what_stays_whole(worlds):
    """The ranks' leaf plans on (1, 1, 1, 2): attention and MLP projections
    split; olmo's and gemma's tied tables summed (the head's rows split,
    the lookup whole), phi3's and yi's head.w split; gemma's one kv head
    whole and summed; norms whole; arctic's expert banks split (by
    experts), its dense MLP split, its router summed."""
    plans = {case: worlds("1,1,1,2")[0][case]["plan"] for case in TP_CASES}
    blk = "decoder.main.p0."
    for case, plan in plans.items():
        for leaf in ("mixer.wq", "mixer.wo", "ffn.w_in", "ffn.w_gate",
                     "ffn.w_out"):
            assert blk + leaf in plan["split"], (case, leaf)
    arctic = plans["arctic-480b"]
    assert {blk + f"ffn.dense.{k}" for k in ("w_in", "w_gate", "w_out")} <= \
        set(arctic["split"])
    assert arctic["summed"] == [blk + "ffn.router"]
    assert plans["qwen2-vl-72b"]["summed"] == []
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
    ("phi3-mini-3.8b", 16, True, True), ("arctic-480b", 16, False, False),
    ("qwen2-vl-72b", 16, True, False)])
def test_head_granularity_at_published_widths(case, M, attn, kv):
    """A dim the model line does not divide stays whole: the decisions and
    the plan at the published widths on a (1, 1, 1, M) mesh of shape only
    (yi's and arctic's 56 heads and gemma's 8 at M = 16: the whole
    attention on every model rank; gemma's one kv head at M = 2;
    qwen2-vl's 64 heads split at M = 16, each rank's 4 sharing one of the
    8 kv heads, whole and summed). arctic's 128 experts split 8 a rank,
    its dense MLP's 4864 columns 304, its router summed."""
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
        cfg.d_ff % M == 0 or cfg.moe is not None)
    kv_rule = "split" if kv else ("summed" if attn else "whole")
    assert "decoder.main.p0.mixer.wk" in plan[kv_rule]
    if cfg.moe is not None:
        assert split.expert_block(cfg.moe.num_experts) == (0, 8)
        assert split.mlp(cfg.moe.dense_ff)
        assert "decoder.main.p0.ffn.dense.w_out" in plan["split"]
        assert "decoder.main.p0.ffn.router" in plan["summed"]
    if case == "qwen2-vl-72b":
        assert split.local_heads(cfg.attn) == (4, 0, 1)
        assert tp.Split(mesh_of_shape((1, 1, 1, M), 3)).local_heads(
            cfg.attn) == (4, 1, 1)


def test_unsplit_family_and_uneven_batch_refused():
    """An MLA config given param_shardings raises by name; a batch the
    fsdp line does not divide is a ValueError naming both."""
    cfg = get_config("deepseek-v3-671b").reduced()
    model = build_model(cfg)
    mesh = mesh_of_shape((1, 1, 1, 2))
    opt = make_optimizer("adamw", 1e-3)
    _, spec = dsgd.init_panel_state(model.init_params, opt, 1, 0,
                                    device="cpu", mesh=mesh)
    with pytest.raises(NotImplementedError,
                       match="deepseek-v3-671b.*MLA"):
        dsgd.make_panel_segment(model.loss_fn, opt, 1, spec,
                                param_shardings=tp.train_shardings(
                                    model, mesh, 1))
    with pytest.raises(ValueError, match="batch of 3 rows.*2 ranks"):
        tp.Split(mesh_of_shape((1, 1, 2, 1))).batch_rows(3)
