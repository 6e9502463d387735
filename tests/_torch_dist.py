"""Multi-rank runs of the port on the CPU for ``tests/test_torch_sharded.py``
and ``tests/test_torch_sharded_options.py``.

:func:`spawn` starts ``world`` processes of this file (gloo, a ``file://``
rendezvous in the test's tmp dir, so xdist workers cannot collide on a TCP
port), each with one intra-op thread, and waits for them with a timeout.
Each rank runs one mode and, where it has something to report, writes
``rank<r>.pt`` (a torch.save of a dict of tensors) into the tmp dir.
Rank 0 also runs the single-process counterpart of the same computation
in its own process (the same thread count and allocator), so a
comparison bit for bit is a comparison of two routes, not of two
processes. Imports no JAX.

Modes:
  ops      -- a seeded mixed-dtype panel (float32 2 x 3 x 17 = 102 columns,
              bfloat16 33: odd, so it stays whole on a 2-way fsdp axis) on
              the (1, 2, 2, 1) mesh: the sharded mix, mix with the folded
              mean, Xi from it, merged, consensus_distance, global_merge and
              global_merge_allreduce, gathered; rank 0 adds the
              single-process results;
  segment  -- a reduced() olmo-1b segment (4 agents, 3 rounds: a gossip
              round, an idle round, the final merge) with an extra unused
              bf16 leaf of 5 columns, sharded and on one process;
  launch   -- launch/train.py with the remaining arguments (every rank;
              the mesh comes from --mesh);
  codecs   -- (test_torch_sharded_options.py) every lossy wire codec on a
              seeded panel (float32 2 x 1024 columns: shards of 1024, a
              multiple of 512 and of int4's 128; bfloat16 33, whole) on the
              (1, 2, 2, 1) mesh: the encode with supplied uniforms, the mix
              with the folded mean and the error-feedback or mirror panel,
              Xi, then the global merge, gathered; rank 0 adds the
              single-process results (the same generator seeds);
  merges   -- every merge operator's merge_row (with statistics moved off
              their initial values, with and without a live mask), a lossy
              merge_panel under a live mask, and the distributed TIES
              thresholds on rows with tied magnitudes, a NaN and zeros, at
              small gather and selection slabs, gathered; rank 0 adds the
              single-process results and the inputs;
  options  -- reduced() olmo-1b segments (4 agents) under OPTION_CASES'
              combinations of codec, merge operator, residency policy,
              fault plan and telemetry, sharded and on one process;
  ipc      -- (test_torch_cuda.py, on the card) the four ranks' mesh
              collectives through the CUDA IPC exchange buffers;
  ckpt_save -- (test_torch_sharded_checkpoint.py) olmo-1b states at the
              launcher's CPU preset of CKPT_CASES on the (1, 2, 2, 1) mesh, a round of the
              segment apart, saved as steps 1 and 2 by the sharded
              checkpointer in small parts; each rank writes its trees and
              blocks, rank 0 also the one-process run's trees and its
              one-process checkpoints of the same steps;
  dryrun   -- (test_torch_dryrun.py) DRY_CASES' reduced() olmo-1b runs on
              the (1, 2, 2, 1) mesh as launch/dryrun.py:reckon traces them
              (the init, a segment of its default rounds, the evals), for
              real: each rank writes Mesh.stats of the init and of the rest;
              with the argument ``split``, DRY_SPLIT_CASE on DRY_SPLIT_MESH
              on the split route (param_shardings);
  tp       -- (test_torch_tensor_parallel.py) TP_CASES' configs on the mesh
              of the given shape on the split route (param_shardings):
              from the handed-over inits, batches and W stream in
              ``tp_inputs.pt``, one step's gradient panel and a segment
              (two gossip rounds, the merge), then the evals; each rank
              writes the gathered gradient panel and final panel, the
              metrics, the evals and the leaf plan; on the (1, 1, 2, 2)
              mesh also the FLOPs of one agent's step on both routes;
  ckpt_restore -- the newest good step of each given checkpoint directory
              restored on the mesh of the given shape into a fresh init
              of its case: each rank writes its step, trees, blocks and
              the warnings it raised;
  moe      -- (test_torch_split_moe.py) MOE_CASES' split MoE FFN on the mesh
              of the given shape: outputs, aux, gradients, kept
              assignments and a dropless forward;
  serve    -- (test_torch_split_serve.py) SERVE_CASES' configs served split
              on the serve mesh of the given shape (data on fsdp, model on
              model): from the handed-over weights, prompts and decode
              tokens in ``serve_inputs.pt``, each rank cuts its pieces
              (``tensor_parallel.serve_pieces``) and its data rows, runs
              ``prefill`` and the decode steps and writes its logits, its
              rows and its cache blocks; rank 0 also the one-process run's.
"""
from __future__ import annotations

import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")


def spawn(world, mode, tmp, args=(), timeout=120, check=True):
    """Run ``mode`` on ``world`` ranks; returns the CompletedProcess of
    each rank (stdout and stderr captured)."""
    os.makedirs(tmp, exist_ok=True)
    env = dict(os.environ)
    env.update({"WORLD_SIZE": str(world), "LOCAL_WORLD_SIZE": str(world),
                "REPRO_TORCH_INIT_METHOD": f"file://{tmp}/rendezvous",
                "PYTHONPATH": SRC + os.pathsep + env.get("PYTHONPATH", ""),
                "OMP_NUM_THREADS": "1"})
    procs = []
    for r in range(world):
        e = dict(env, RANK=str(r), LOCAL_RANK=str(r))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), mode, str(tmp),
             *args], env=e, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    out = []
    try:
        for p in procs:
            so, se = p.communicate(timeout=timeout)
            out.append(subprocess.CompletedProcess(p.args, p.returncode, so,
                                                   se))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if check:
        for r, p in enumerate(out):
            assert p.returncode == 0, f"rank {r}:\n{p.stdout}\n{p.stderr}"
    return out


def _mixed_panel(m=4, seed=0):
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    tree = {"w": torch.from_numpy(rng.standard_normal((m, 2, 3, 17))
                                  .astype(np.float32)),
            "emb": torch.from_numpy(rng.standard_normal((m, 33))
                                    .astype(np.float32)).to(torch.bfloat16)}
    return tree


def mode_ops(tmp):
    import numpy as np
    import torch
    from repro_torch.core import gossip, panel
    from repro_torch.core.topology import random_matching
    from repro_torch.launch.mesh import make_debug_mesh
    mesh = make_debug_mesh(agents=2, fsdp=2, model=1, device="cpu")
    tree = _mixed_panel()
    full_spec = panel.make_spec(tree)
    full = panel.to_panel(tree, full_spec)
    spec = panel.shard_spec(full_spec, mesh)
    local = panel.shard_panel(full, spec)
    W = random_matching(4, 0.9, np.random.default_rng(1)).astype(np.float32)
    out = {}

    def put(name, pan):
        for k, v in panel.gather_panel(pan, spec).items():
            out[f"{name}.{k}"] = v

    put("mix", panel.mix_dense(local, W, spec=spec))
    mixed, mean, _ = panel.mix_dense_mean(local, W, spec=spec)
    put("mixm", mixed)
    for k, v in mean.items():
        out[f"mean.{k}"] = panel.gather_cols(v, spec, k)
    out["xi_mean"] = panel.consensus_from_mean(mixed, mean, spec=spec)
    for k, v in panel.merged(local, spec=spec).items():
        out[f"merged.{k}"] = panel.gather_cols(v, spec, k)
    out["xi"] = panel.consensus_distance(local, spec=spec)
    put("gm", panel.global_merge(local, spec=spec))
    put("gm_bf16", panel.global_merge(local, spec=spec, wire_dtype="bfloat16"))
    put("mix_bf16", panel.mix_dense(local, W, spec=spec,
                                    wire_dtype="bfloat16"))
    out["spec"] = torch.tensor([list(spec.row_range(k)) + list(
        spec.col_range(k)) for k, _ in spec.groups])
    lo, hi = spec.row_range("float32")
    rows = {k: v[lo:hi] for k, v in tree.items()}
    for k, v in gossip.global_merge_allreduce(rows, mesh).items():
        out[f"gmar.{k}"] = v
    if mesh.rank == 0:
        out["single.mix"] = panel.mix_dense(full, W)
        m1, mu1, _ = panel.mix_dense_mean(full, W)
        out["single.mixm"], out["single.mean"] = m1, mu1
        out["single.xi_mean"] = panel.consensus_from_mean(m1, mu1)
        out["single.merged"] = panel.merged(full)
        out["single.xi"] = panel.consensus_distance(full)
        out["single.gm"] = panel.global_merge(full)
        out["single.gm_bf16"] = panel.global_merge(full,
                                                   wire_dtype="bfloat16")
        out["single.mix_bf16"] = panel.mix_dense(full, W,
                                                 wire_dtype="bfloat16")
    torch.save(out, os.path.join(tmp, f"rank{mesh.rank}.pt"))


SEG_M, SEG_ROUNDS, SEG_H = 4, 3, 2


def _segment_parts():
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.topology import random_matching
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.launch import train
    from repro_torch.models import build_model
    cfg = get_config("olmo-1b").reduced()
    model = build_model(cfg)

    def init_params(gen, device):
        p = model.init_params(gen, device)
        p["aux"] = torch.randn(5, generator=gen, device=device).to(
            torch.bfloat16)
        return p

    def loss_fn(params, batch, rng):
        return model.loss_fn({k: v for k, v in params.items()
                              if k != "aux"}, batch, rng)

    lm = SyntheticLM(vocab=cfg.vocab_size, seed=0)
    batches = train.sample_segment_batches(
        lm, lm.domain_mixtures(SEG_M, 0.1, seed=1), SEG_ROUNDS, SEG_H, 2, 16,
        np.random.default_rng(2))
    Ws = np.stack([random_matching(SEG_M, 0.9, np.random.default_rng(0)),
                   np.eye(SEG_M), np.full((SEG_M, SEG_M), 1.0 / SEG_M)]
                  ).astype(np.float32)
    return cfg, init_params, loss_fn, batches, Ws


def mode_segment(tmp):
    import torch
    from repro_torch.core import dsgd, panel
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.optim import make_optimizer
    mesh = make_debug_mesh(agents=2, fsdp=2, model=1, device="cpu")
    cfg, init_params, loss_fn, batches, Ws = _segment_parts()
    opt = make_optimizer("adamw", 3e-3, weight_decay=5e-4,
                         total_steps=SEG_ROUNDS * SEG_H)
    state, spec = dsgd.init_panel_state(init_params, opt, SEG_M, 0,
                                        mesh=mesh)
    seg = dsgd.make_panel_segment(loss_fn, opt, SEG_H, spec)
    state, mets = seg(state, batches, Ws)
    out = {f"met.{k}": v for k, v in mets.items()}
    for name, pan in (("panel", state["panel"]), ("m", state["opt"]["m"]),
                      ("v", state["opt"]["v"])):
        for k, v in panel.gather_panel(pan, spec).items():
            out[f"{name}.{k}"] = v
    out["pspecs"] = repr(spec.pspecs)
    if mesh.rank == 0:
        st1, spec1 = dsgd.init_panel_state(init_params, opt, SEG_M, 0,
                                           device="cpu")
        st1, mets1 = dsgd.make_panel_segment(loss_fn, opt, SEG_H, spec1)(
            st1, batches, Ws)
        out.update({f"single.met.{k}": v for k, v in mets1.items()})
        for name, pan in (("panel", st1["panel"]), ("m", st1["opt"]["m"]),
                          ("v", st1["opt"]["v"])):
            for k, v in pan.items():
                out[f"single.{name}.{k}"] = v
    torch.save(out, os.path.join(tmp, f"rank{mesh.rank}.pt"))


def _codec_tree(m=4, seed=3):
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    return {"w": torch.from_numpy(rng.standard_normal((m, 2, 1024))
                                  .astype(np.float32)),
            "emb": torch.from_numpy(rng.standard_normal((m, 33))
                                    .astype(np.float32)).to(torch.bfloat16)}


CODEC_CASES = ("int8", "int8_ef", "int8_ef native", "int4", "int4_ef",
               "topk", "topk strided")


def _codec(name):
    from repro_torch.wire import CODECS, Int8Codec, TopKCodec
    if name == "int8_ef native":
        return Int8Codec("int8_ef", error_feedback=True, draws="kernel")
    if name == "topk strided":
        # 2048 columns over a sample of 60: stride 34, 31 samples in the
        # first shard and 30 in the second
        return TopKCodec("topk", density=0.125, thresh_sample=60)
    return CODECS[name]


def _small_slabs():
    """Gather, selection and residency slabs far below the shards' width,
    so every sharded op runs over several slabs with a ragged last one
    (the residency's 2^17-column slabs: a shard boundary inside one)."""
    from repro_torch.core import panel
    from repro_torch.merging import ops
    from repro_torch.residency import storage
    panel.GATHER_SLAB = 300
    ops.TIES_SLAB = 250
    storage.SLAB = 1 << 17


def mode_codecs(tmp):
    import numpy as np
    import torch
    from repro_torch.core import panel
    from repro_torch.core.topology import random_matching
    from repro_torch.launch.mesh import make_debug_mesh
    _small_slabs()
    mesh = make_debug_mesh(agents=2, fsdp=2, model=1, device="cpu")
    tree = _codec_tree()
    base = panel.make_spec(tree)
    full = panel.to_panel(tree, base)
    W = random_matching(4, 0.9, np.random.default_rng(1)).astype(np.float32)
    u = {k: torch.from_numpy(np.random.default_rng(9).random(x.shape)
                             .astype(np.float32)) for k, x in full.items()}
    out = {}

    def run(pan, spec, single):
        codec = _codec(name)
        err = None
        if codec.error_feedback:
            err = {k: codec.init_err(x) for k, x in full.items()}
            if not single:
                err = panel.shard_panel(err, spec)
        gen = torch.Generator().manual_seed(5)
        res = {}
        if codec.needs_key and name != "int8_ef native":
            res["view"] = {k: codec.encode(
                pan[k], u=u[k], err=None if err is None else err[k],
                shard=None if single else spec.shard(k))[0]
                for k in sorted(pan)}
        mixed, mean, ne = panel.mix_dense_mean(pan, W, spec=spec, gen=gen,
                                               err=err)
        res["xi"] = {"xi": panel.consensus_from_mean(mixed, mean, spec=spec)}
        res["mean"] = mean
        res["mix"] = mixed
        if ne is not None:
            res["err"] = ne
        gm = panel.global_merge(mixed, spec=spec, gen=gen, err=ne)
        if ne is not None:
            gm, res["gm_err"] = gm
        res["gm"] = gm
        return res

    for name in CODEC_CASES:
        spec1 = panel.with_wire(base, _codec(name))
        spec = panel.shard_spec(spec1, mesh)
        res = run(panel.shard_panel(full, spec), spec, False)
        for part, d in res.items():
            if part == "mean":
                d = {k: panel.gather_cols(v, spec, k) for k, v in d.items()}
            elif part != "xi":
                d = panel.gather_panel(d, spec)
            for k, v in d.items():
                out[f"{name}.{part}.{k}"] = v
        if mesh.rank == 0:
            for part, d in run(full, spec1, True).items():
                for k, v in d.items():
                    out[f"single.{name}.{part}.{k}"] = v
    torch.save(out, os.path.join(tmp, f"rank{mesh.rank}.pt"))


MERGE_OPS = ("uniform", "weighted", "var", "fisher", "ties", "swa")
MERGE_LIVE = (True, False, True, True)


def _merge_inputs():
    """The codec panel, a second panel the round statistics take and a
    gradient panel the Fisher statistics take (float32 group only for the
    statistics' EMAs to move), each seeded."""
    import numpy as np
    import torch
    from repro_torch.core import panel
    tree = _codec_tree()
    spec = panel.make_spec(tree)
    full = panel.to_panel(tree, spec)
    rng = np.random.default_rng(4)
    later = {k: (x.float() + torch.from_numpy(rng.standard_normal(
        x.shape).astype(np.float32)) * 0.3).to(x.dtype)
        for k, x in full.items()}
    grads = {k: torch.from_numpy(rng.standard_normal(x.shape)
                                 .astype(np.float32)) for k, x in full.items()}
    return spec, full, later, grads


def _merge_stats(name, full, later, grads):
    from repro_torch.merging import get_merger
    mg = get_merger(name)
    stats = mg.init_stats(full)
    if mg.round_stat:
        stats = mg.update_round(stats, later)
    if mg.local_stat:
        stats = mg.update_local(stats, grads)
    return stats or None


def _ties_rows():
    """(4, 2048) deviations: random; magnitudes drawn from 5 values (ties
    across the two shards); a NaN in the second shard; zeros."""
    import numpy as np
    import torch
    rng = np.random.default_rng(8)
    tau = rng.standard_normal((4, 2048)).astype(np.float32)
    tau[1] = rng.choice([-2.0, -1.0, 0.0, 1.0, 2.0], 2048).astype(np.float32)
    tau[2, 1500] = np.nan
    tau[3] = 0.0
    return torch.from_numpy(tau)


def mode_merges(tmp):
    import numpy as np
    import torch
    from repro_torch.core import panel
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.merging import get_merger, merge_panel
    from repro_torch.merging.ops import ties_thresh_sharded
    _small_slabs()
    mesh = make_debug_mesh(agents=2, fsdp=2, model=1, device="cpu")
    base, full, later, grads = _merge_inputs()
    spec = panel.shard_spec(base, mesh)
    local = panel.shard_panel(full, spec)
    out = {}
    for name in MERGE_OPS:
        stats = _merge_stats(name, full, later, grads)
        st_loc = None if stats is None else {
            n: panel.shard_panel(v, spec) for n, v in stats.items()}
        for tag, live in (("all", None), ("live", MERGE_LIVE)):
            row = get_merger(name).merge_row(local, stats=st_loc, live=live,
                                             spec=spec)
            for k, v in row.items():
                out[f"{name}.{tag}.{k}"] = panel.gather_cols(v, spec, k)
            if mesh.rank == 0:
                for k, v in get_merger(name).merge_row(
                        full, stats=stats, live=live).items():
                    out[f"single.{name}.{tag}.{k}"] = v
        if mesh.rank == 0 and stats is not None:
            for n, v in stats.items():
                for k, x in v.items():
                    out[f"stats.{name}.{n}.{k}"] = x
    # a lossy merge round under a live mask: dead rows and their
    # error-feedback rows pass through
    from repro_torch.wire import CODECS
    codec = CODECS["int8_ef"]
    wspec1 = panel.with_wire(base, "int8_ef")
    wspec = panel.shard_spec(wspec1, mesh)
    err = {k: codec.init_err(x) + 0.01 for k, x in full.items()}
    mixed, _, ne = merge_panel(
        local, "ties", spec=wspec, gen=torch.Generator().manual_seed(2),
        err=panel.shard_panel(err, wspec), live=MERGE_LIVE)
    for part, d in (("mix", mixed), ("err", ne)):
        for k, v in panel.gather_panel(d, wspec).items():
            out[f"merge_panel.{part}.{k}"] = v
    if mesh.rank == 0:
        m1, _, ne1 = merge_panel(full, "ties", spec=wspec1,
                                 gen=torch.Generator().manual_seed(2),
                                 err=err, live=MERGE_LIVE)
        for part, d in (("mix", m1), ("err", ne1)):
            for k, v in d.items():
                out[f"single.merge_panel.{part}.{k}"] = v
    # the distributed TIES thresholds
    tau = _ties_rows()
    tspec = panel.shard_spec(panel.make_spec({"t": tau}), mesh)
    tloc = panel.shard_panel({"float32": tau}, tspec)["float32"]
    for trim in (0.2, 0.5, 1.0):
        th = ties_thresh_sharded(lambda lo, hi: tloc[:, lo:hi],
                                 tloc.shape[0], tloc.shape[1], trim,
                                 tspec.shard("float32"))
        out[f"ties_thresh.{trim}"] = panel.gather_rows(th, tspec, "float32")
    out["tau"] = tau
    torch.save(out, os.path.join(tmp, f"rank{mesh.rank}.pt"))


# label: (wire, merge operator, residency policy, fused, fault plan,
# telemetry); reduced() olmo-1b at 4 agents, OPT_ROUNDS rounds
OPTION_CASES = {
    "int8_ef var moments=int8 fused telemetry": (
        "int8_ef", "var", "moments=int8", True, None, True),
    "int8_ef native stats=int8r moments=int8 unfused": (
        "native", "var", "moments=int8,stats=int8r", False, None, False),
    "topk ties faults telemetry": ("topk", "ties", None, None, "1@0-1",
                                   True),
    "int4_ef fisher moments=int8g wire_err=int8r": (
        "int4_ef", "fisher", "moments=int8g,wire_err=int8r", None, None,
        False),
    "int4 swa moments=bf16 stats=bf16 faults": (
        "int4", "swa", "moments=bf16,stats=bf16", None, "2@1", False),
    "int8 weighted faults moments=int8 fused": (
        "int8", "weighted", "moments=int8", True, "3@0-2", True),
}
OPT_M, OPT_ROUNDS, OPT_H = 4, 3, 2


def _option_inputs(plan, cfg=None):
    """(Ws, global, live, batches) of OPT_ROUNDS rounds of the final-merge
    schedule (a gossip round, another, the merge) under ``plan``; the
    batches over ``cfg``'s vocabulary (default olmo-1b's reduced())."""
    import numpy as np
    from repro_torch.core.faults import FaultPlan
    from repro_torch.core.schedule import make_schedule
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.launch import train
    from repro_torch.configs import get_config
    kw = {} if plan is None else {"faults": FaultPlan.parse(OPT_M, plan)}
    sched = make_schedule("final_merge", OPT_M, OPT_ROUNDS, prob=1.0, seed=0,
                          **kw)
    Ws, glob, live = [], [], []
    for t in range(OPT_ROUNDS):
        Ws.append(np.asarray(sched.mixing_matrix(t), np.float32))
        glob.append(sched.last_kind == "global")
        live.append(np.ones(OPT_M, np.int64) if sched.last_live is None
                    else np.asarray(sched.last_live, np.int64))
    cfg = cfg or get_config("olmo-1b").reduced()
    lm = SyntheticLM(vocab=cfg.vocab_size, seed=0)
    batches = train.sample_segment_batches(
        lm, lm.domain_mixtures(OPT_M, 0.1, seed=1), OPT_ROUNDS, OPT_H, 2, 16,
        np.random.default_rng(2))
    return (np.stack(Ws), np.asarray(glob),
            None if plan is None else np.stack(live), batches)


def mode_options(tmp, *labels):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import dsgd, panel
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import build_model
    from repro_torch.optim import make_optimizer
    from repro_torch.wire import Int8Codec
    _small_slabs()
    mesh = make_debug_mesh(agents=2, fsdp=2, model=1, device="cpu")
    model = build_model(get_config("olmo-1b").reduced())
    out = {}
    for label in labels or OPTION_CASES:
        wire, merger, res, fused, plan, tele = OPTION_CASES[label]
        if wire == "native":
            wire = Int8Codec("int8_ef", error_feedback=True, draws="kernel")
        Ws, glob, live, batches = _option_inputs(plan)
        for where in ("shard", "single"):
            if where == "single" and mesh.rank != 0:
                continue
            opt = make_optimizer("adamw", 3e-3, weight_decay=5e-4,
                                 total_steps=OPT_ROUNDS * OPT_H)
            kw = {"mesh": mesh} if where == "shard" else {"device": "cpu"}
            state, spec = dsgd.init_panel_state(
                model.init_params, opt, OPT_M, 0, wire=wire, merger=merger,
                residency=res, **kw)
            seg = dsgd.make_panel_segment(model.loss_fn, opt, OPT_H, spec,
                                          fused=fused, telemetry=tele)
            state, mets = seg(state, batches, Ws, 7, global_rounds=glob,
                              live=live)
            key = f"{label}.{where}"
            for k, v in mets.items():
                out[f"{key}.met.{k}"] = v
            panels = {"panel": state["panel"]}
            for mk in ("m", "v"):
                panels[mk] = state["opt"][mk]
            if "wire_err" in state:
                panels["wire_err"] = state["wire_err"]
            for n, v in state.get("merge_stat", {}).items():
                panels[f"stat.{n}"] = v
            for name, d in panels.items():
                for k, v in d.items():
                    for part, t in (v.items() if isinstance(v, dict)
                                    else (("", v),)):
                        if where == "shard" and (part != "scale"
                                                 or t.shape[1] > 1):
                            t = panel.gather_panel({k: t}, spec)[k] \
                                if part != "scale" else _gather_scale(
                                    t, spec, k)
                        elif where == "shard":
                            t = panel.gather_rows(t, spec, k)
                        out[f"{key}.{name}.{k}.{part}"] = t
            count = torch.as_tensor(state["opt"]["step_count"])
            if where == "shard" and count.dim():  # an (rows,) count a rank
                count = panel.gather_agents(count, spec)
            out[f"{key}.step_count"] = count
    torch.save(out, os.path.join(tmp, f"rank{mesh.rank}.pt"))


def _gather_scale(t, spec, k):
    """A grouped scale sidecar's shard (the rank's rows x its columns'
    groups) -> the whole (m, groups) sidecar."""
    import torch
    from repro_torch.core import panel
    rows = panel.gather_rows(t, spec, k)
    return torch.stack([panel.gather_cols(r.contiguous(), spec, k)
                        for r in rows])


def mode_ipc(tmp):
    """(test_torch_cuda.py, on the card) the (1, 2, 2, 1) mesh's four
    ranks on one card: each line's all_gather and all_reduce (sum, max)
    of a rank-seeded tensor through the CUDA IPC buffers, and of a tensor
    larger than a buffer, which goes through it a buffer's worth at a
    time."""
    import torch
    from repro_torch.launch.mesh import IPC_BYTES, make_debug_mesh
    mesh = make_debug_mesh(agents=2, fsdp=2, model=1)
    r, dev = mesh.rank, mesh.device
    x = torch.arange(6, dtype=torch.float32, device=dev).view(2, 3) + 10 * r
    # a tensor over the exchange buffer: two exchanges
    big = torch.full((IPC_BYTES // 4 + 1,), float(r), device=dev)
    big[-1] = -r
    out = {"transport": mesh.transport,
           "members": torch.tensor(mesh.members["rows"]
                                   + mesh.members["fsdp"]),
           "rows": mesh.all_gather(x, "rows").cpu(),
           "fsdp": mesh.all_gather(x, "fsdp").cpu(),
           "sum": mesh.all_reduce(x.clone(), "rows").cpu(),
           "max": mesh.all_reduce(x.clone(), "fsdp", op="max").cpu(),
           "ints": mesh.all_reduce(torch.full((3,), r + 1, dtype=torch.int64,
                                              device=dev), "fsdp").cpu(),
           "big": mesh.all_gather(big, "rows")[::1 << 20].cpu(),
           "big_tail": mesh.all_gather(big[-2:], "rows").cpu(),
           "big_max": mesh.all_reduce(big.clone(), "fsdp",
                                      op="max")[-2:].cpu(),
           "stats": mesh.stats}
    torch.save(out, os.path.join(tmp, f"rank{r}.pt"))


# the sharded checkpoints' cases: (wire, merge, residency, fault plan)
CKPT_CASES = {
    "f32": ("f32", "uniform", None, None),
    "int8_ef fisher int8": ("int8_ef", "fisher",
                            "moments=int8,stats=int8r", None),
    "topk ties faults": ("topk", "ties", None, "2@1-2"),
}
CKPT_PART_BYTES = 1 << 16  # small parts: leaves split over several
# each case's residency stamp ({kind: storage})
CKPT_RES = {label: None if res is None else dict(
    kv.split("=") for kv in res.split(","))
    for label, (_, _, res, _) in CKPT_CASES.items()}


def ckpt_config():
    """The checkpoint cases' model: olmo-1b at the launcher's CPU preset
    (D = 491,520: column shards of 245,760 = 1,920 groups of 128)."""
    from repro_torch.configs import get_config
    return get_config("olmo-1b").reduced(d_model=128, layers=2, vocab=256)


def _ckpt_run(label, mesh, rounds=2):
    """[(checkpoint tree, its layout)] of CKPT_CASES[label] on ``mesh``
    (None: one process) after each of ``rounds`` rounds (0: the fresh
    init alone), and the spec."""
    from repro_torch.configs import get_config
    from repro_torch.core import dsgd
    from repro_torch.launch import train
    from repro_torch.models import build_model
    from repro_torch.optim import make_optimizer
    import torch
    wire, merger, res, plan = CKPT_CASES[label]
    cfg = ckpt_config()
    Ws, glob, live, batches = _option_inputs(plan, cfg)
    model = build_model(cfg)
    opt = make_optimizer("adamw", 3e-3, weight_decay=5e-4,
                         total_steps=OPT_ROUNDS * OPT_H)
    kw = {"mesh": mesh} if mesh is not None else {"device": "cpu"}
    state, spec = dsgd.init_panel_state(model.init_params, opt, OPT_M, 0,
                                        wire=wire, merger=merger,
                                        residency=res, **kw)
    seg = dsgd.make_panel_segment(model.loss_fn, opt, OPT_H, spec)
    gen = torch.Generator().manual_seed(7)
    here = spec.agent_range()[1] - spec.agent_range()[0]
    trees = []
    if not rounds:
        tree = train._ckpt_tree(state, gen, here)
        return [(tree, train._ckpt_layout(tree, spec))], spec
    for t in range(rounds):
        state, _ = seg(state, {k: v[t:t + 1] for k, v in batches.items()},
                       Ws[t:t + 1], gen, global_rounds=glob[t:t + 1],
                       live=None if live is None else live[t:t + 1])
        tree = train._ckpt_tree(state, gen, here)
        trees.append((tree, train._ckpt_layout(tree, spec)))
    return trees, spec


def _flat_blocks(tree, layout):
    from repro_torch.checkpoint import io as ckpt_io
    import torch
    out = {}
    for (kp, leaf), (_, b) in zip(ckpt_io._leaves_with_path(tree),
                                  ckpt_io._leaves_with_path(layout)):
        out[ckpt_io._key_str(kp)] = (torch.as_tensor(leaf).clone(), b.index,
                                     b.shape, b.owner)
    return out


def mode_ckpt_save(tmp):
    import torch
    from repro_torch.checkpoint import Checkpointer, ShardedCheckpointer
    from repro_torch.launch.mesh import make_debug_mesh
    mesh = make_debug_mesh(agents=2, fsdp=2, model=1, device="cpu")
    out = {}
    for i, label in enumerate(CKPT_CASES):
        trees, spec = _ckpt_run(label, mesh)
        ck = ShardedCheckpointer(os.path.join(tmp, f"case{i}"), mesh,
                                 part_bytes=CKPT_PART_BYTES,
                                 residency=CKPT_RES[label])
        # the trees the tests compare: step 2's, and the f32 case's step 1
        # (where a torn step 2 sends a restore)
        kept = (1, 2) if label == "f32" else (2,)
        for step, (tree, layout) in enumerate(trees, 1):
            ck.save(step, tree, layout, meta={"round": step}, block=False)
            if step in kept:
                out[f"{label}.{step}"] = _flat_blocks(tree, layout)
        ck.wait()
        if mesh.rank == 0:
            one, _ = _ckpt_run(label, None)
            ck1 = Checkpointer(os.path.join(tmp, f"one{i}"),
                               residency=CKPT_RES[label])
            for step, (tree, layout) in enumerate(one, 1):
                ck1.save(step, tree, meta={"round": step})
                if step in kept:
                    out[f"single.{label}.{step}"] = _flat_blocks(tree,
                                                                 layout)
    torch.save(out, os.path.join(tmp, f"rank{mesh.rank}.pt"))


def mode_ckpt_restore(tmp, shape, *dirs):
    """``dirs``: 'CASE_INDEX:PATH' pairs."""
    import warnings
    import torch
    from repro_torch.checkpoint import restore_latest
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh(tuple(int(x) for x in shape.split(",")), device="cpu")
    out = {}
    for item in dirs:
        i, path = item.split(":", 1)
        label = list(CKPT_CASES)[int(i)]
        [(like, layout)], _ = _ckpt_run(label, mesh, rounds=0)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            step, tree, meta = restore_latest(path, like, layout, mesh=mesh,
                                              residency=CKPT_RES[label])
        out[path] = {"step": step, "meta": meta,
                     "warnings": [str(w.message) for w in caught],
                     "blocks": _flat_blocks(tree, layout)}
    torch.save(out, os.path.join(tmp, f"rank{mesh.rank}.pt"))


# the dry run's cases on the small mesh: (wire, merge, residency)
DRY_CASES = {"f32": (None, "uniform", None),
             "int4 fisher int8": ("int4", "fisher",
                                  "moments=int8,stats=int8r")}
DRY_M, DRY_H, DRY_B, DRY_S = 4, 2, 2, 16
# the split route's dry-run case: its mesh (fsdp 2 x model 2, one agent
# block) and its case of DRY_CASES
DRY_SPLIT_MESH, DRY_SPLIT_CASE = (1, 1, 2, 2), "f32"


def mode_dryrun(tmp, split=""):
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import dsgd
    from repro_torch.launch import train
    from repro_torch.launch.dryrun import default_rounds
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import build_model
    from repro_torch.optim import make_optimizer
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import tensor_parallel as tp
    mesh = (make_mesh(DRY_SPLIT_MESH, device="cpu") if split else
            make_debug_mesh(agents=2, fsdp=2, model=1, device="cpu"))
    cfg = get_config("olmo-1b").reduced()
    model = build_model(cfg)
    shardings = tp.train_shardings(model, mesh, DRY_M) if split else None
    rounds = default_rounds(DRY_M)
    Ws = np.concatenate([r[0] for r in rounds])
    glob = np.concatenate([r[1] for r in rounds])
    out = {}
    cases = ({DRY_SPLIT_CASE: DRY_CASES[DRY_SPLIT_CASE]} if split
             else DRY_CASES)
    for label, (wire, merger, res) in cases.items():
        opt = make_optimizer("adamw", 3e-3, weight_decay=5e-4,
                             total_steps=len(Ws) * DRY_H)
        mesh.stats.update(dict.fromkeys(mesh.stats, 0))
        state, spec = dsgd.init_panel_state(
            model.init_params, opt, DRY_M, torch.Generator().manual_seed(0),
            mesh=mesh, wire=wire, merger=merger, residency=res)
        init = dict(mesh.stats)
        mesh.stats.update(dict.fromkeys(mesh.stats, 0))
        seg = dsgd.make_panel_segment(model.loss_fn, opt, DRY_H, spec,
                                      param_shardings=shardings)
        lead = (len(Ws), DRY_H, DRY_M, DRY_B, DRY_S)
        batches = {"tokens": np.zeros(lead, np.int32),
                   "targets": np.zeros(lead, np.int32),
                   "mask": np.ones(lead, np.float32)}
        state, _ = seg(state, batches, Ws, torch.Generator().manual_seed(3),
                       global_rounds=glob)
        ev = {k: torch.as_tensor(v[0, 0, 0]).repeat(2, 1)
              for k, v in batches.items()}
        train.eval_merged(model.loss_fn, state["panel"], spec, ev,
                          state.get("merge_stat"))
        train.eval_local(model.loss_fn, state["panel"], spec, ev)
        out[label] = {"init": init, "run": dict(mesh.stats)}
    torch.save(out, os.path.join(tmp, f"rank{mesh.rank}.pt"))


# the split route's test configs: case -> the port's config of the arch
TP_M, TP_H, TP_B, TP_S, TP_ROUNDS = 4, 2, 4, 16, 3
# arctic's overflow step: capacity factor TP_CAPACITY, C = 16 slots an
# expert of an agent's 64 tokens x 2 slots over 4 experts (32 a balanced
# expert), so assignments overflow and the capacity rule over the whole
# batch decides which; one step's gradient panel at it (a segment there is
# ill-conditioned: a one-ulp move of the init moves one process's losses
# 1e-4, a drop decided otherwise)
TP_CAPACITY = 0.5


def tp_config(case, get, capacity=None):
    """The config of ``case`` from a package's ``get_config``: olmo-1b at
    the launcher's CPU preset's widths, the others at ``reduced()``
    (arctic-480b: 4 experts top-2 and a dense MLP, at its capacity factor
    or ``capacity``; qwen2-vl-72b: M-RoPE sections (8, 4, 4), an 8-row
    patch prefix)."""
    import dataclasses
    if case == "olmo-1b":
        return get(case).reduced(d_model=128, layers=2, vocab=256)
    cfg = get(case).reduced()
    if capacity is not None:
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity))
    return cfg


TP_CASES = ("olmo-1b", "phi3-mini-3.8b", "yi-34b", "gemma-2b", "arctic-480b",
            "qwen2-vl-72b")


def record_calls(module, name, keep):
    """Wrap ``module.name`` so that each call appends ``keep(its
    output)`` to the list returned (the wrapper stays for the process)."""
    orig, got = getattr(module, name), []

    def wrapped(*a, **kw):
        out = orig(*a, **kw)
        got.append(keep(out))
        return out
    setattr(module, name, wrapped)
    return got


def mode_tp(tmp, shape):
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_config
    from repro_torch.core import dsgd, panel
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model, moe
    from repro_torch.models import tensor_parallel as tp
    from repro_torch.optim import make_optimizer
    from repro_torch.utils.tree import tree_flatten, tree_unflatten
    shape = tuple(int(x) for x in shape.split(","))
    mesh = make_mesh(shape, device="cpu")
    inputs = torch.load(os.path.join(tmp, "tp_inputs.pt"),
                        weights_only=False)
    kept = record_calls(moe, "split_dispatch", lambda o: o[2].clone())
    out = {}
    for case in TP_CASES:
        cfg = tp_config(case, get_config)
        model = build_model(cfg)
        inp = inputs[case]
        trees = iter(inp["params"])
        opt = make_optimizer("adamw", 3e-3, weight_decay=5e-4,
                             total_steps=TP_ROUNDS * TP_H)
        state, spec = dsgd.init_panel_state(lambda g, d: next(trees), opt,
                                            TP_M, 0, mesh=mesh)
        ps = tp.train_shardings(model, mesh, TP_M)
        loss_fn, split = dsgd.split_route(model.loss_fn, spec, ps)
        step0 = {k: torch.as_tensor(v[0, 0]) for k, v in
                 inp["batches"].items()}
        kept.clear()
        gpan, losses = dsgd.panel_grads(loss_fn, state["panel"], spec, step0,
                                        split=split)
        rec = {"grads": panel.gather_panel(gpan, spec), "grad_losses": losses,
               "plan": tp.describe(tree_unflatten(
                   tree_flatten(ps)[1], split[1])),
               "agents": spec.agent_range(), "coord": dict(mesh.coord)}
        del gpan
        if cfg.moe is not None:
            # the overflow step: the same weights and batch at TP_CAPACITY
            over = build_model(tp_config(case, get_config, TP_CAPACITY))
            fn, sp = dsgd.split_route(over.loss_fn, spec, ps)
            kept.clear()
            gpan, _ = dsgd.panel_grads(fn, state["panel"], spec, step0,
                                       split=sp)
            rec["overflow"] = {"grads": panel.gather_panel(gpan, spec),
                               "kept": list(kept)}
            del gpan
        if shape == (1, 1, 2, 2) and case in ("olmo-1b", "arctic-480b"):
            lo = spec.agent_range()[0]
            for label, kw in (("split", {"split": split}), ("replica", {})):
                fn = loss_fn if kw else model.loss_fn
                with FlopCounterMode(display=False) as fc:
                    dsgd.panel_grads(fn, state["panel"], spec, step0,
                                     rows=[lo], **kw)
                rec[f"flops_{label}"] = fc.get_total_flops()
        seg = dsgd.make_panel_segment(model.loss_fn, opt, TP_H, spec,
                                      param_shardings=ps)
        state, mets = seg(state, inp["batches"], inp["Ws"],
                          global_rounds=inp["glob"])
        ev = train.to_device(inp["eval"], "cpu")
        rec["merged"] = train.eval_merged(model.loss_fn, state["panel"],
                                          spec, ev)
        rec["local"] = train.eval_local(model.loss_fn, state["panel"], spec,
                                        ev)
        rec["mets"] = mets
        rec["panel"] = panel.gather_panel(state["panel"], spec)
        out[case] = rec
    torch.save(out, os.path.join(tmp, f"rank{mesh.rank}.pt"))


# the split serve cases: (arch, attn_block) at reduced() widths, a batch of
# SERVE_B prompts of SERVE_S tokens (past gemma-2b-sw's reduced window of
# 64, so its prefill lays the ring out and decode writes through it; after
# qwen2-vl-72b's 8-row seeded patch prefix), then SERVE_STEPS decode steps;
# qwen2-vl-72b's requests (a prompt and its prefix each) also through the
# engine, SERVE_NEW tokens each, a data rank serving its rows' requests
SERVE_CASES = (("olmo-1b", 16), ("phi3-mini-3.8b", 0), ("yi-34b", 0),
               ("gemma-2b", 16), ("gemma-2b-sw", 16), ("arctic-480b", 0),
               ("qwen2-vl-72b", 16))
SERVE_B, SERVE_S, SERVE_STEPS = 4, 80, 6
SERVE_NEW = 4


def serve_config(case, get_config):
    import dataclasses
    arch, block = case
    cfg = get_config(arch).reduced()
    return cfg.replace(dist=dataclasses.replace(cfg.dist, attn_block=block))


def _serve_run(model, params, inp, rows):
    import torch
    logits = []
    batch = {k: torch.as_tensor(v[rows]) for k, v in inp["extras"].items()}
    batch["tokens"] = torch.as_tensor(inp["tokens"][rows])
    with torch.no_grad():
        lg, caches = model.prefill(params, batch, max_len=inp["max_len"])
        logits.append(lg)
        for tok, pos in inp["steps"]:
            lg, caches = model.decode_step(params, caches,
                                           torch.as_tensor(tok[rows]),
                                           torch.as_tensor(pos[rows]))
            logits.append(lg)
    return torch.stack(logits), caches


def _serve_engine(model, params, inp, rows):
    """The requests of ``rows`` (a prompt and its extras each) through the
    engine, greedy: {request index: tokens}."""
    from repro_torch.serving import ServingEngine
    from repro_torch.serving.engine import Request
    reqs = [Request(i, inp["tokens"][i], SERVE_NEW,
                    {k: v[i] for k, v in inp["extras"].items()})
            for i in range(rows.start, rows.stop)]
    eng = ServingEngine(model, params, max_concurrency=2,
                        max_len=inp["max_len"])
    return {k: [int(t) for t in v] for k, v in eng.serve(reqs).items()}


def mode_serve(tmp, shape):
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.models import tensor_parallel as tp
    shape = tuple(int(x) for x in shape.split(","))
    mesh = make_mesh(shape, device="cpu")
    split = tp.Split(mesh)
    inputs = torch.load(os.path.join(tmp, "serve_inputs.pt"),
                        weights_only=False)
    out = {}
    for case in SERVE_CASES:
        cfg = serve_config(case, get_config)
        inp = inputs[case[0]]
        whole = build_model(cfg)
        pieces = tp.serve_pieces(inp["params"], mesh,
                                 tp.serve_shardings(whole, mesh))
        rows = split.data_rows(SERVE_B)
        logits, caches = _serve_run(build_model(cfg, split=split), pieces,
                                    inp, rows)
        blk = pieces["decoder"]["main"]["p0"]
        rec = {"logits": logits, "rows": (rows.start, rows.stop),
               "caches": caches, "coord": dict(mesh.coord),
               "pieces": {k: tuple(v.shape) for k, v in
                          blk["mixer"].items()},
               "ffn": {k: tuple(v.shape) for k, v in blk["ffn"].items()
                       if isinstance(v, torch.Tensor)}}
        if cfg.mm_prefix:
            rec["engine"] = _serve_engine(build_model(cfg, split=split),
                                          pieces, inp, rows)
        if mesh.rank == 0:
            rec["one"] = _serve_run(whole, inp["params"], inp,
                                    slice(0, SERVE_B))
            if cfg.mm_prefix:
                rec["one_engine"] = _serve_engine(whole, inp["params"], inp,
                                                  slice(0, SERVE_B))
        out[case[0]] = rec
    torch.save(out, os.path.join(tmp, f"rank{mesh.rank}.pt"))


# the split MoE FFN's module cases: name -> (arch, experts) at
# reduced(d_model=64) (arctic: the softmax router and a dense MLP;
# deepseek-v3: the sigmoid router and a shared MLP; arctic with 3 experts:
# a bank no model line of 2 divides, whole beside its split dense MLP),
# capacity factor MOE_CAPACITY (assignments overflow), a batch of MOE_B x
# MOE_S tokens
MOE_CASES = {"arctic": ("arctic-480b", 4), "deepseek": ("deepseek-v3-671b", 4),
             "arctic_e3": ("arctic-480b", 3)}
MOE_B, MOE_S, MOE_CAPACITY = 4, 8, 0.5


def moe_config(case, get):
    import dataclasses
    arch, E = MOE_CASES[case]
    cfg = get(arch).reduced(d_model=64, experts=E)
    return cfg.replace(moe=dataclasses.replace(
        cfg.moe, capacity_factor=MOE_CAPACITY))


def moe_rules(cfg, split):
    """The gradient rule of each leaf of an MoE FFN's parameters on
    ``split`` (the test's own statement of it): {key: ('split', dim) |
    ('once',) | ('sum',)}, the MLPs' keys 'dense/w_in' etc."""
    m, M = cfg.moe, split.model_size
    ex = M > 1 and m.num_experts % M == 0
    rules = {k: ("split", 0) if ex else ("once",)
             for k in ("w_in", "w_gate", "w_out")}
    rules["router"] = ("sum",) if ex else ("once",)
    for name, width in (("dense", m.dense_ff), ("shared", m.shared_ff)):
        if width:
            cut = M > 1 and width % M == 0
            for k, dim in (("w_in", 1), ("w_gate", 1), ("w_out", 0)):
                rules[f"{name}/{k}"] = ("split", dim) if cut else ("once",)
    return rules


def mode_moe(tmp, shape):
    """(test_torch_split_moe.py) MOE_CASES' split ``moe_forward`` on the
    mesh of the given shape: each rank cuts its pieces of the handed-over
    parameters (moe_rules) and its fsdp rows of x, runs the training
    forward and ``sum(y * g) + aux``'s gradient, and writes y, aux, the
    gradient of x's rows, each leaf's gradient made whole (its rule's part
    placed in zeros, summed over the agent block), the assignments it kept
    and a dropless forward of its rows."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe
    from repro_torch.models import tensor_parallel as tp
    mesh = make_mesh(tuple(int(x) for x in shape.split(",")), device="cpu")
    split = tp.Split(mesh)
    j, M = split.model_rank, split.model_size
    inputs = torch.load(os.path.join(tmp, "moe_inputs.pt"),
                        weights_only=False)
    kept = record_calls(moe, "split_dispatch", lambda o: o[2].clone())
    out = {}
    for case in MOE_CASES:
        cfg = moe_config(case, get_config)
        inp = inputs[case]
        rules = moe_rules(cfg, split)
        whole = {k: v for k, v in inp["flat"].items()}
        pieces = {}
        for k, v in whole.items():
            rule = rules[k]
            if rule[0] == "split":
                n = v.shape[rule[1]] // M
                v = v.narrow(rule[1], j * n, n)
            pieces[k] = v.clone().requires_grad_(True)
        params = {k: pieces[k] for k in pieces if "/" not in k}
        for k in pieces:
            if "/" in k:
                name, leaf = k.split("/")
                params.setdefault(name, {})[leaf] = pieces[k]
        rows = split.batch_rows(MOE_B)
        x = inp["x"][rows].clone().requires_grad_(True)
        kept.clear()
        y, aux = moe.moe_forward(params, x, cfg=cfg, act_name=cfg.act,
                                 split=split)
        loss = torch.sum(y * inp["g"][rows]) + aux
        keys = sorted(pieces)
        grads = torch.autograd.grad(loss, [pieces[k] for k in keys] + [x])
        full = {}
        for k, g in zip(keys, grads):
            z = torch.zeros_like(whole[k])
            rule = rules[k]
            if rule[0] == "split":
                n = z.shape[rule[1]] // M
                z.narrow(rule[1], j * n, n).copy_(g)
            elif rule[0] == "sum" or j == 0:
                z.copy_(g)
            full[k] = split.block_sum(z)
        with torch.no_grad():
            served, _ = moe.moe_forward(params, inp["x"][rows], cfg=cfg,
                                        act_name=cfg.act, dropless=True,
                                        split=split)
        out[case] = {"y": y.detach(), "aux": aux.detach(), "gx": grads[-1],
                     "grads": full, "rows": (rows.start, rows.stop),
                     "kept": kept[0], "served": served,
                     "coord": dict(mesh.coord)}
    torch.save(out, os.path.join(tmp, f"rank{mesh.rank}.pt"))


def mode_launch(tmp, *argv):
    from repro_torch.launch import train
    train.main(list(argv))


if __name__ == "__main__":
    import torch
    torch.set_num_threads(1)
    mode, tmp, rest = sys.argv[1], sys.argv[2], sys.argv[3:]
    {"ops": mode_ops, "segment": mode_segment, "launch": mode_launch,
     "codecs": mode_codecs, "merges": mode_merges,
     "options": mode_options, "ipc": mode_ipc,
     "ckpt_save": mode_ckpt_save, "ckpt_restore": mode_ckpt_restore,
     "dryrun": mode_dryrun, "tp": mode_tp, "serve": mode_serve,
     "moe": mode_moe}[mode](
        tmp, *rest)
    import torch.distributed as dist
    if dist.is_initialized():
        # every rank past its last collective before any exits: a rank
        # that exits while gloo's threads still serve a peer aborts
        # ("terminate called without an active exception")
        dist.barrier()
        dist.destroy_process_group()
