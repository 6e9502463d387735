"""Decentralized LM training launcher (counterpart of
``repro/launch/train.py``).

Runs the paper's algorithm end to end on synthetic non-IID token streams:
per-agent local AdamW/SGD steps, scheduled gossip, and the single final
global merge, on the panel engine (core/dsgd.py), under any wire codec
(``--wire``), merge operator (``--merge``) and residency policy of the
state panels (``--residency``, ``--fused-moments``), and under a fault plan
(``--faults``: agents that die and rejoin, the elastic run), and saves the
merged model for serving (``--save-merged``). Every registered ``--arch``
trains (qwen2-vl on tokens alone, its M-RoPE positions broadcast from the
1-D ones, as the reference's launcher trains it) but the encoder-decoder
seamless-m4t-medium, which is refused by name: the batches carry no
encoder frames. It draws the
schedule's mixing matrices and the batches from the same numpy seeds, in
the same order, as the reference launcher, so both see byte-identical W
streams and batches.

``--mesh`` spreads the run over the ranks of a ``torch.distributed``
world (launch/mesh.py; started by ``torchrun``): the panel rows over
('pod', 'agent'), the flat parameter columns over 'fsdp', as the
reference's ``--mesh`` shards its panel (``auto`` is ``train`` for
``--preset pod`` and ``none`` otherwise; ``debug`` is the (1, 2, 2, 2)
mesh of 8 ranks, ``P,A,F,M`` a mesh of that shape). Every rank runs the
same loop on its shard, draws the same batches and keeps its agents'
rows; the history, the events and ``--save-merged`` are written by rank 0
alone, and the console is rank 0's. A sharded run takes every ``--wire``, ``--merge``, ``--residency``
(fused and unfused), ``--faults`` and ``--telemetry`` (every agent's
columns in rank 0's stream), and ``--checkpoint-every`` / ``--resume``:
each rank saves its blocks of the state
(``checkpoint.io.ShardedCheckpointer``), and a resume, on a mesh or on one process, cuts
its blocks out of a checkpoint saved on any layout
(``checkpoint.io.restore_latest``). A generator-drawn ``--wire`` (int8,
int4 and their ``_ef``) whose whole (m, D_g) uniform panel, which every
rank draws, would take over a quarter of the rank's device memory is
refused by name (``refuse_oversized_draws``). On the CPU:
  torchrun --nproc-per-node 8 -m repro_torch.launch.train --device cpu \
      --mesh debug --rounds 6 --segment 3 --agents 4 --local-steps 2 \
      --batch 4 --seq 32 --wire int8_ef --merge ties

The run is observable and resumable as the reference's is:
``--telemetry`` adds the per-agent (S, m) columns to every round event,
``--events`` writes the deterministic JSONL stream (+ a wall-clock
sidecar), ``--snapshot`` a JSON snapshot rewritten each round,
``--profile`` a Chrome trace of the training loop; ``--checkpoint-every``
saves the state, the numpy and generator streams and the stream's seq
asynchronously every N segments, and ``--resume`` continues from the
newest good checkpoint bit for bit (the event stream truncated back to the
checkpointed seq, so a killed and resumed run writes the same bytes as an
uninterrupted one). The console prints the stream's events
(``telemetry.format_event``).

Runs on the CUDA card unless ``--device cpu`` is given. Example:
  PYTHONPATH=src python -m repro_torch.launch.train --rounds 10 \
      --segment 4 --agents 4 --local-steps 2 --batch 4 --seq 32 \
      --schedule final_merge --device cpu
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import signal
import time

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch.checkpoint import Checkpointer, ShardedCheckpointer, save
from repro_torch.checkpoint import io as ckpt_io
from repro_torch.configs import get_config
from repro_torch.core import dsgd
from repro_torch.core import faults as faults_mod
from repro_torch.core import merge as merge_mod
from repro_torch.core import panel as panel_mod
from repro_torch.core.schedule import make_schedule
from repro_torch.data.synthetic import SyntheticLM, make_agent_lm_batches
from repro_torch.device import resolve_device
from repro_torch.launch import mesh as mesh_mod
from repro_torch.merging import MERGERS
from repro_torch.models import build_model
from repro_torch.optim import make_optimizer
from repro_torch.residency import STORAGE, parse_policy
from repro_torch.telemetry.metrics import (AGENT_COLUMNS,
                                           fused_moments_auto,
                                           resident_bytes_model)
from repro_torch.wire import CODECS, get_codec


def build_mesh(kind: str, cfg, device=None):
    """This rank's ('pod', 'agent', 'fsdp', 'model') mesh (launch/mesh.py)
    of ``--mesh train`` or ``debug``, the panel is sharded on."""
    if kind == "train":
        return mesh_mod.make_training_mesh(cfg.dist.agents_per_pod,
                                           device=device)
    if kind == "debug":
        return mesh_mod.make_debug_mesh(agents=2, fsdp=2, model=2,
                                        device=device)
    return mesh_mod.make_mesh(mesh_shape(kind), device=device)


def mesh_shape(kind: str):
    """The (pod, agent, fsdp, model) shape a ``--mesh P,A,F,M`` names."""
    try:
        shape = tuple(int(x) for x in kind.split(","))
    except ValueError:
        shape = ()
    if len(shape) != 4 or min(shape) < 1:
        raise SystemExit(f"--mesh {kind!r}: expected auto, none, train, "
                         "debug or four sizes P,A,F,M (pod, agent, fsdp, "
                         "model), e.g. 1,4,1,1")
    return shape


# the share of a rank's device memory that a generator-drawn wire's
# uniform panel may take (the rest holds the rank's panel shard, its
# gathered rows, its optimizer state and its activations)
DRAW_SHARE = 0.25


def refuse_oversized_draws(spec, share_bytes: int):
    """SystemExit naming the ``--wire`` of a sharded ``spec`` whose
    stochastic rounding draws from the generator when its (m, D_g) float32
    uniform panel exceeds DRAW_SHARE of ``share_bytes`` (the rank's share
    of its device's memory): on a mesh every rank draws a group's whole
    panel each encode and keeps its block (ROADMAP C)."""
    if not spec.sharded:
        return
    widths = dict(spec.groups)
    for key, name in spec.wire:
        codec = get_codec(name)
        if not codec.needs_key \
                or getattr(codec, "draws", "generator") != "generator":
            continue
        need = spec.rows * widths[key] * 4
        if need > DRAW_SHARE * share_bytes:
            raise SystemExit(
                f"--wire {codec.name} on --mesh: every rank draws the "
                f"{key} group's whole ({spec.rows}, {widths[key]}) float32 "
                f"uniform panel each encode ({need} bytes), over "
                f"{DRAW_SHARE} of the rank's {share_bytes} bytes of device "
                "memory (ROADMAP C, the generator route's draws on a "
                "mesh). Take --wire topk, bf16 or f32, fewer agents or "
                "more cards, or an Int8Codec(draws='kernel') through "
                "core.dsgd.init_panel_state(wire=): its draws are keyed "
                "by panel row and column, each block drawn alone")


def build_cpu_preset(cfg, agents):
    cfg = cfg.reduced(d_model=128, layers=2, vocab=256)
    return cfg.replace(dist=dataclasses.replace(cfg.dist,
                                                agents_per_pod=agents))


def sample_segment_batches(lm, mixtures, rounds, local_steps, batch, seq,
                           rng_np):
    """(S, H, m, b, seq) numpy batches: H DISTINCT batches per round, drawn
    in the reference launcher's order."""
    per_round = []
    for _ in range(rounds):
        hs = [make_agent_lm_batches(lm, mixtures, batch, seq, rng_np)
              for _ in range(local_steps)]
        per_round.append({k: np.stack([h[k] for h in hs]) for k in hs[0]})
    return {k: np.stack([r[k] for r in per_round]) for k in per_round[0]}


def to_device(batch, device):
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


@torch.no_grad()
def eval_merged(loss_fn, panel, spec, batch, stats=None, live=None):
    """Loss on ``batch`` (a float) of the model merged by the spec's merge
    operator (``stats``: the state's ``merge_stat``; ``live``: (m,) bool,
    the agents holding a usable model, the only ones merged)."""
    return float(merge_mod.counterfactual_eval_panel(
        lambda p: loss_fn(p, batch, None)[0], panel, spec, stats=stats,
        live=live))


@torch.no_grad()
def eval_local(loss_fn, panel, spec, batch, live=None):
    """Mean over agents of each agent's own loss on ``batch`` (a float);
    with ``live`` ((m,) bool) over the live agents only (a dead one's place
    holds 0, unevaluated). On a sharded spec each rank evaluates its agents
    (their rows gathered over the fsdp line) and the losses are gathered
    in agent order."""
    alive = (np.ones(spec.rows, bool) if live is None
             else np.asarray(live, bool))
    dev = next(iter(panel.values())).device
    lo, hi = spec.agent_range()
    losses = [loss_fn(panel_mod.agent_params(panel, spec, k), batch,
                      None)[0] if alive[k] else
              torch.zeros((), dtype=torch.float32, device=dev)
              for k in range(lo, hi)]
    every = panel_mod.gather_agents(torch.stack(losses), spec)
    return float(torch.mean(every[torch.as_tensor(np.flatnonzero(alive),
                                                  device=every.device)]))


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--preset", default="cpu", choices=["cpu", "pod"])
    ap.add_argument("--agents", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--local-steps", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--segment", type=int, default=8,
                    help="rounds per segment call (the adaptive schedule "
                         "forces 1: it needs per-round feedback)")
    ap.add_argument("--schedule", default="final_merge",
                    choices=["constant", "local", "windowed", "final_merge",
                             "periodic", "adaptive"])
    ap.add_argument("--window-start", type=int, default=0)
    ap.add_argument("--window-end", type=int, default=0)
    ap.add_argument("--wire", default="f32", choices=sorted(CODECS),
                    help="gossip wire codec (repro_torch.wire): bf16 "
                         "halves wire bytes, int8 sends 1 byte per scalar "
                         "and int4 half a byte (plus a scale per 128) with "
                         "stochastic rounding, the _ef variants add error "
                         "feedback, topk sends the top 1/8 of the "
                         "innovation over a mirror")
    ap.add_argument("--residency", default="",
                    help="storage policy of the state panels "
                         "(repro_torch.residency): 'kind=storage' pairs "
                         "joined by ',' over the kinds moments, stats and "
                         "wire_err, or a bare storage for the moments "
                         "(e.g. 'moments=int8,stats=bf16'). Storages: "
                         + ", ".join(sorted(STORAGE)) + ". int8 and int8g "
                         "keep signed-sqrt companded int8 with one scale "
                         "per row per 128 (int8g: 32) columns and "
                         "stochastic rounding, about 4x fewer bytes per "
                         "moment panel; int8r is linear int8 with one "
                         "scale per row (for stats and wire_err, not for "
                         "moments); bf16 halves the bytes. Parameters stay "
                         "float32; empty or f32 = no policy")
    ap.add_argument("--fused-moments", default="auto",
                    choices=["auto", "on", "off"],
                    help="the fused int8 moment update (the "
                         "adamw_fused_int8 kernel: decode, AdamW and the "
                         "stochastic re-encode in one sweep, no float32 "
                         "moment panel): auto = on wherever the moments' "
                         "storage is grouped int8; its trajectory equals "
                         "the unfused one bit for bit")
    ap.add_argument("--merge", default="uniform", choices=sorted(MERGERS),
                    help="merge operator of global rounds "
                         "(repro_torch.merging): uniform mean, weighted "
                         "(inverse consensus distance), var/fisher "
                         "(per-coordinate precision weights; extra stats "
                         "panels), ties (trim and sign election), swa "
                         "(merge of per-agent EMA accumulators)")
    ap.add_argument("--eval-merged-every", type=int, default=0,
                    help="merged/local eval cadence in rounds (segments "
                         "are cut at it); 0 = once per segment")
    ap.add_argument("--faults", default="",
                    help="fault plan 'AGENT@KILL[-REJOIN]' joined by ';' "
                         "(core.faults.FaultPlan.parse): the agent is dead "
                         "from round KILL and rejoins at round REJOIN by "
                         "pulling the live agents' mean (e.g. '2@5-9;0@3')")
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--alpha", type=float, default=0.1,
                    help="Dirichlet heterogeneity")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="results/torch_train")
    ap.add_argument("--save-merged", default="",
                    help="after the run, save the model merged by the run's "
                         "merge operator (over the agents alive at the end) "
                         "to this checkpoint file (repro_torch.checkpoint; "
                         "launch/serve.py --restore serves it)")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="save a resumable checkpoint every N SEGMENTS (0 = "
                         "off; and after the last segment); saves are "
                         "asynchronous (a host copy on this thread, the "
                         "write on another). On one process the whole "
                         "state must fit the blob's 4 GiB payload (a larger "
                         "one is refused at startup); on a --mesh each rank "
                         "saves its blocks, in parts under that limit")
    ap.add_argument("--checkpoint-dir", default="",
                    help="checkpoint directory (default: OUT/ckpt_<run "
                         "tag>)")
    ap.add_argument("--checkpoint-keep", type=int, default=3,
                    help="keep only the newest K checkpoints")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the newest good checkpoint of the "
                         "checkpoint directory (saved on any mesh, or on "
                         "one process), bit for bit: the panel "
                         "state, the wire generator, the data and schedule "
                         "streams, the round counter and the event stream's "
                         "seq; starts fresh when the directory is empty")
    ap.add_argument("--die-after-segments", type=int, default=0,
                    help="fault injection: SIGKILL the process after N "
                         "segments (a pending checkpoint is written first)")
    ap.add_argument("--telemetry", action="store_true",
                    help="per-agent (S, m) metric columns from the segment "
                         "(loss, grad norm, distance to the mean, liveness, "
                         "exact codec wire bytes) on each round event; "
                         "fetched with the scalars in one transfer a "
                         "segment; the trajectory is the same bit for bit")
    ap.add_argument("--events", default="",
                    help="deterministic JSONL event stream path (+ a "
                         ".wall.jsonl wall-clock sidecar); default "
                         "OUT/events_<tag>.jsonl under --telemetry, else "
                         "console only. A resume truncates it to the "
                         "checkpointed seq, so a killed and resumed run "
                         "writes the same bytes as an uninterrupted one")
    ap.add_argument("--snapshot", default="",
                    help="JSON telemetry snapshot path "
                         "(telemetry.SnapshotExporter on the event log's "
                         "sink; rewritten atomically each round)")
    ap.add_argument("--profile", default="",
                    help="capture a torch.profiler trace of the training "
                         "loop (host and card) into this directory as "
                         "trace.json (a Chrome trace; a profiler that "
                         "cannot start only warns)")
    ap.add_argument("--mesh", default="auto",
                    help="shard the (m, D) panel over the ranks of a "
                         "torch.distributed world (launch with torchrun): "
                         "rows over ('pod', 'agent'), D over 'fsdp'. auto: "
                         "train for --preset pod, none for cpu; debug: the "
                         "(1, 2, 2, 2) mesh of 8 ranks; P,A,F,M: a mesh of "
                         "that (pod, agent, fsdp, model) shape, e.g. "
                         "1,4,1,1")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' to "
                         "run on the CPU)")
    return ap.parse_args(argv)


def main(argv=None):
    return run(parse_args(argv))


def _fetch(mets):
    """The segment's metrics on the host: every device tensor in ONE
    transfer (the float columns with the scalars), the host-computed
    integer columns as they are. {name: numpy array}."""
    dev = [k for k, v in mets.items() if v.device.type != "cpu"]
    out = {k: v.numpy() for k, v in mets.items() if k not in dev}
    if dev:
        S = mets[dev[0]].shape[0]
        flat = torch.cat([mets[k].reshape(S, -1).to(torch.float32)
                          for k in dev], 1).cpu().numpy()
        lo = 0
        for k in dev:
            n = int(np.prod(mets[k].shape[1:], dtype=np.int64))
            out[k] = flat[:, lo:lo + n].reshape(mets[k].shape)
            lo += n
    return out


def _ckpt_tree(state, wire_gen, m):
    """The checkpointed tree: the panel state with its optimizer step count
    as an (m,) array over the m agents this rank holds (a shared count is
    one repeated; ``meta`` says which it was) and the wire generator's
    state."""
    opt = dict(state["opt"])
    opt["step_count"] = np.broadcast_to(
        np.asarray(opt["step_count"], np.int64), (m,)).copy()
    return {"state": {**state, "opt": opt}, "wire_gen": wire_gen.get_state()}


def _ckpt_layout(tree, spec):
    """This rank's blocks of :func:`_ckpt_tree`'s leaves (the state's by
    ``dsgd.panel_state_layout``; the wire generator, the same on every
    rank, saved by rank 0)."""
    return {"state": dsgd.panel_state_layout(tree["state"], spec),
            "wire_gen": panel_mod.whole_block(
                tree["wire_gen"].shape,
                owner=not spec.sharded or spec.mesh.rank == 0)}


def _from_ckpt(tree, per_agent):
    """The panel state of a restored :func:`_ckpt_tree`: Python ints where
    the live state holds them."""
    state = tree["state"]
    state["step"] = int(state["step"])
    if not per_agent:
        state["opt"]["step_count"] = int(state["opt"]["step_count"][0])
    return state


def refuse_oversized_checkpoint(tree, res_total: int, m: int):
    """SystemExit when ``tree`` cannot fit the checkpoint blob one process
    saves: its array table is one msgpack bin of at most
    ``checkpoint.io.MAX_PAYLOAD_BYTES`` (4,294,967,295) bytes, in both
    packages' format (the ranks of a mesh save their blocks in parts)."""
    need = ckpt_io.payload_bytes(tree)
    if need > ckpt_io.MAX_PAYLOAD_BYTES:
        raise SystemExit(
            f"--checkpoint-every on one process: the state is {m} agents x "
            f"{res_total} B resident = {m * res_total} B, a checkpoint "
            f"payload of {need} B with its headers, over the checkpoint "
            f"format's {ckpt_io.MAX_PAYLOAD_BYTES} B (one msgpack bin); "
            f"run fewer agents or a narrower model, on a --mesh (each rank "
            f"saves its blocks in parts), or without checkpoints")


def run(args, *, cfg=None, lm=None):
    """Train as ``args`` (parse_args) say; returns the per-round history.

    ``cfg`` replaces the model config of ``--arch``/``--preset`` (e.g. a
    full-width model cut in depth, which no preset gives) and ``lm`` the
    synthetic data source (e.g. a ``SyntheticLM`` over fewer token ids than
    the vocabulary: its tables are num_domains x V x V); neither enters the
    run's id or the checkpoint fingerprint, which are the reference's
    (the run configuration of the flags). Under ``--mesh`` every rank
    returns the same history; rank 0 alone prints and writes."""
    if cfg is None:
        cfg = get_config(args.arch)
        if args.preset == "cpu":
            cfg = build_cpu_preset(cfg, args.agents)
    kind = getattr(args, "mesh", "none")
    if kind == "auto":
        kind = "train" if args.preset == "pod" else "none"
    if kind == "none":
        return _run(args, cfg, lm, None)
    if kind not in ("train", "debug"):
        mesh_shape(kind)  # refused before any process group starts
    mesh = build_mesh(kind, cfg, args.device)
    try:
        if mesh_mod.is_primary(mesh):
            return _run(args, cfg, lm, mesh)
        with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
            return _run(args, cfg, lm, mesh)
    finally:
        import torch.distributed as dist
        dist.destroy_process_group()


def _run(args, cfg, lm, mesh):
    device = mesh.device if mesh is not None else resolve_device(args.device)
    primary = mesh_mod.is_primary(mesh)
    if cfg.encoder_layers:
        raise SystemExit(
            f"--arch {args.arch}: the encoder-decoder {cfg.name} is not "
            "trained by the launcher: its synthetic batches carry tokens "
            "only, and the model's encoder reads batch['frame_embeds'] (the "
            "reference's launcher raises KeyError: 'frame_embeds'; ROADMAP "
            "C, findings about the reference). Train it through "
            "core.dsgd.make_panel_segment with frame_embeds in the batches")
    m = args.agents
    if mesh is not None:
        rows = mesh_mod.num_agents(mesh)
        if m % rows:
            raise SystemExit(f"--agents {m} must be divisible by the mesh's "
                             f"pod*agent = {rows} so panel rows shard evenly")
        print(f"panel sharded on mesh {mesh.shape} ({mesh.backend}, rank "
              f"{mesh.rank} on {mesh.device})")
    model = build_model(cfg)
    opt = make_optimizer(args.optimizer, args.lr, weight_decay=5e-4,
                         total_steps=args.rounds * args.local_steps)
    plan = (faults_mod.FaultPlan.parse(m, args.faults) if args.faults
            else None)
    kw = {"prob": 0.2, "seed": args.seed, "merger": args.merge}
    if args.schedule == "windowed":
        kw.update(start=args.window_start, end=args.window_end or
                  args.rounds // 10)
    if plan is not None:
        kw["faults"] = plan
    sched = make_schedule(args.schedule, m, args.rounds, **kw)
    seg_len = 1 if args.schedule == "adaptive" else max(1, args.segment)
    if args.schedule == "adaptive" and (args.checkpoint_every or
                                        args.resume):
        raise SystemExit(
            "--checkpoint-every/--resume do not support the adaptive "
            "schedule: its controller state is host-side feedback that a "
            "checkpoint cannot replay bit-exactly")
    tag = f"{args.arch}_{args.schedule}_a{args.alpha}"
    if args.merge != "uniform":
        tag += f"_m{args.merge}"
    if args.residency:
        tag += "_r" + args.residency.replace("=", "").replace(",", "_")

    # the run configuration that DEFINES the trajectory (the reference's
    # keys: equal configurations give equal ids in both packages);
    # checkpoint, telemetry and device plumbing stay out, so a baseline and
    # its kill+resume twin share one run_id
    run_cfg = {k: vars(args)[k] for k in (
        "arch", "preset", "agents", "rounds", "local_steps", "batch",
        "seq", "segment", "schedule", "window_start", "window_end",
        "optimizer", "lr", "alpha", "wire", "residency", "merge",
        "eval_merged_every", "seed", "faults")}
    run_id = telemetry.make_run_id(run_cfg)
    events_path = args.events or (
        os.path.join(args.out, f"events_{tag}.jsonl")
        if args.telemetry else None)
    if not primary:  # rank 0 alone writes the stream and the snapshot
        events_path = None

    gen = torch.Generator(device=device).manual_seed(args.seed)
    state, spec = dsgd.init_panel_state(model.init_params, opt, m, gen,
                                        device=device, merger=sched.merger,
                                        wire=args.wire,
                                        residency=args.residency or None,
                                        **({} if mesh is None
                                           else {"mesh": mesh}))
    del gen
    if mesh is not None:
        refuse_oversized_draws(spec, mesh_mod.rank_share_bytes(mesh))
    print(f"{cfg.name}: {spec.width} parameters per agent, {m} agents, "
          f"device {device}")
    print(f"wire codec {args.wire}: {spec.wire_payload_bytes} B/agent "
          f"payload ({spec.wire_total_bytes} B with scales/indices) per "
          f"full-panel exchange; merge operator {spec.merger}")
    fused = {"auto": None, "on": True, "off": False}[args.fused_moments]
    fused_active = fused_moments_auto(spec, opt) if fused is None else fused
    res_bytes = resident_bytes_model(spec, opt, fused=fused_active)
    print(f"residency {args.residency or 'f32'}: "
          f"{res_bytes['total']} B/agent resident "
          f"(params {res_bytes['params']}, moments {res_bytes['moments']}, "
          f"wire_err {res_bytes['wire_err']}, "
          f"merge_stat {res_bytes['merge_stat']}); "
          f"peak {res_bytes['peak']} B/agent "
          f"(+{res_bytes['transient_bytes']} transient); "
          f"fused moments {'on' if fused_active else 'off'}")
    # the stochastic codecs' draws: one generator for the whole run (the
    # residency streams are seeded from it and never draw from it); a
    # checkpoint carries its state where the reference's carries a key
    wire_gen = torch.Generator(device=device).manual_seed(args.seed + 3)

    ckpt = None
    here = spec.agent_range()[1] - spec.agent_range()[0]
    ckpt_dir = args.checkpoint_dir or os.path.join(args.out, "ckpt_" + tag)
    policy = parse_policy(args.residency or None)
    if args.checkpoint_every or args.resume:
        # the residency stamp guards --resume against decoding stored
        # panels with another --residency. One process saves whole blobs
        # (the reference's format, one bin: refused when the state cannot
        # fit it); the ranks of a mesh save their blocks, in parts
        if mesh is None:
            if args.checkpoint_every:  # a resume alone saves nothing
                refuse_oversized_checkpoint(
                    _ckpt_tree(state, wire_gen, here), res_bytes["total"], m)
            ckpt = Checkpointer(ckpt_dir, keep=args.checkpoint_keep,
                                fingerprint=run_cfg, residency=policy)
        else:
            ckpt = ShardedCheckpointer(ckpt_dir, mesh,
                                       keep=args.checkpoint_keep,
                                       fingerprint=run_cfg,
                                       residency=policy)
    segment_fn = dsgd.make_panel_segment(model.loss_fn, opt,
                                         args.local_steps, spec, fused=fused,
                                         telemetry=args.telemetry)

    if lm is None:
        lm = SyntheticLM(vocab=cfg.vocab_size, num_domains=8, seed=args.seed)
    mixtures = lm.domain_mixtures(m, args.alpha, seed=args.seed + 1)
    rng_np = np.random.default_rng(args.seed + 2)
    # a fixed GLOBAL eval batch (uniform domain mixture = global dist)
    glob_mix = np.ones(lm.num_domains) / lm.num_domains
    eval_batch = to_device({
        k: v[0] for k, v in make_agent_lm_batches(
            lm, [glob_mix], 2 * args.batch, args.seq,
            np.random.default_rng(999)).items()}, device)

    def alive_after(r):
        """(m,) bool of the agents holding a usable model after round r
        (None without a fault plan): dead agents' rows are stale and left
        out of both evals."""
        return None if plan is None else plan.mask(r) >= faults_mod.LIVE

    history = []
    monitor = {}
    comm_cost = 0.0
    t = 0
    seg_idx = 0
    resume_seq = None
    if args.resume:
        like = _ckpt_tree(state, wire_gen, here)
        rec = ckpt_io.restore_latest(
            ckpt_dir, like, _ckpt_layout(like, spec) if mesh else None,
            mesh=mesh, residency=policy)
        del like
        if rec is None:
            print("resume: no checkpoint found, starting fresh")
        else:
            step, tree, meta = rec
            del state
            state = _from_ckpt(tree, meta.get("count_per_agent", False))
            wire_gen.set_state(tree["wire_gen"])
            del tree
            t = int(meta["round"])
            seg_idx = int(meta["segments"])
            comm_cost = float(meta["comm_cost"])
            monitor = meta["monitor"]
            history = meta["history"]
            rng_np.bit_generator.state = meta["data_rng"]
            sched.rng.bit_generator.state = meta["sched_rng"]
            resume_seq = meta.get("events_seq")
            print(f"resumed from checkpoint step {step} (round {t})")

    # the event log: the deterministic stream (+ wall sidecar) when a path
    # is set, console only otherwise. On resume the stream is truncated
    # back to the checkpointed seq: replayed rounds are emitted exactly
    # once, keeping a baseline and its kill+resume twin byte-identical
    snap = (telemetry.SnapshotExporter(args.snapshot)
            if args.snapshot and primary else None)
    log = telemetry.EventLog(
        events_path, run_id=run_id,
        resume_at=resume_seq if events_path else None, sink=snap)
    if resume_seq is None:
        print(telemetry.format_event(log.emit(
            "run_start", run_id=run_id, schema=telemetry.SCHEMA_VERSION,
            config=run_cfg)), flush=True)
    else:
        log.emit_op("resume", round=t, segments=seg_idx, seq=log.seq)
    if ckpt is not None:
        ckpt.events = log  # sidecar checkpoint_save records
    prof = telemetry.profile_trace(args.profile,
                                   enabled=bool(args.profile)
                                   and primary).start()
    if prof:
        log.emit_op("profile_start", logdir=args.profile)
    t0 = time.time()
    ev = args.eval_merged_every
    while t < args.rounds:
        S = min(seg_len, args.rounds - t)
        if ev > 0:  # cut segments at the eval cadence
            S = min(S, (t // ev + 1) * ev - t)
        Ws, comm_after, glob, lives = [], [], [], []
        for s in range(S):
            W = sched.mixing_matrix(t + s, monitor)
            comm_cost += sched.round_cost(W)
            comm_after.append(comm_cost)
            Ws.append(W)
            # the schedule knows which rounds are global: a gossip W can
            # equal the 1/m average at small m
            glob.append(sched.last_kind == "global")
            lives.append(sched.last_live)
        batches = sample_segment_batches(lm, mixtures, S, args.local_steps,
                                         args.batch, args.seq, rng_np)
        seg_t0 = time.perf_counter()
        state, mets = segment_fn(state, batches,
                                 np.stack(Ws).astype(np.float32), wire_gen,
                                 global_rounds=np.asarray(glob),
                                 live=None if plan is None else
                                 np.stack(lives))
        mets = _fetch(mets)
        monitor = {"grad_norm": float(mets["grad_norm"][-1]),
                   "consensus": float(mets["consensus"][-1])}
        # merged/local eval at the eval cadence (--eval-merged-every, or at
        # every segment's end when 0) and always after the last round
        merged_l = local_l = None
        if ev == 0 or (t + S) % ev == 0 or t + S == args.rounds:
            lv_now = alive_after(t + S - 1)
            merged_l = eval_merged(model.loss_fn, state["panel"], spec,
                                   eval_batch, state.get("merge_stat"),
                                   live=lv_now)
            local_l = eval_local(model.loss_fn, state["panel"], spec,
                                 eval_batch, live=lv_now)
        rev = None
        for s in range(S):
            r = t + s
            if plan is not None:
                for agent, kind in plan.at(r):
                    log.emit("fault", round=r, agent=agent, kind=kind)
            extra = ({k: mets[k][s] for k in AGENT_COLUMNS}
                     if args.telemetry else {})
            rev = log.emit(
                "round", round=r, loss=float(mets["loss"][s]),
                grad_norm=float(mets["grad_norm"][s]),
                grad_norm_max=float(mets["grad_norm_max"][s]),
                consensus=float(mets["consensus"][s]),
                comm_cost_P=float(comm_after[s]),
                resident_bytes=int(res_bytes["total"]),
                transient_bytes=int(res_bytes["transient_bytes"]), **extra)
            if glob[s]:
                log.emit("merge", round=r, operator=spec.merger)
            # the evals are measured at the segment's end; the other
            # rounds carry None, so every record has the same keys
            last = s == S - 1
            history.append({"round": r,
                            "train_loss": float(mets["loss"][s]),
                            "consensus": float(mets["consensus"][s]),
                            "grad_norm": float(mets["grad_norm"][s]),
                            "merged_eval": merged_l if last else None,
                            "local_eval": local_l if last else None,
                            "comm_cost_P": comm_after[s]})
        t += S
        seg_idx += 1
        print(telemetry.format_event(rev), flush=True)
        if merged_l is not None:
            print(telemetry.format_event(log.emit(
                "eval", round=t - 1, merged_eval=merged_l,
                local_eval=local_l)), flush=True)
        log.emit_op("segment", seg=seg_idx, rounds=S,
                    dt=time.perf_counter() - seg_t0)
        if ckpt is not None and args.checkpoint_every and (
                seg_idx % args.checkpoint_every == 0 or t >= args.rounds):
            # asynchronous: the host copy is taken before save() returns,
            # so the next segment may update the state in place; events_seq
            # is the stream's position, the truncate-on-resume cursor
            tree = _ckpt_tree(state, wire_gen, here)
            ckpt.save(t, tree, *(() if mesh is None else (
                _ckpt_layout(tree, spec),)), block=False, meta={
                "round": t, "segments": seg_idx, "comm_cost": comm_cost,
                "monitor": monitor, "history": history,
                "data_rng": rng_np.bit_generator.state,
                "sched_rng": sched.rng.bit_generator.state,
                "events_seq": log.seq,
                "count_per_agent": isinstance(state["opt"]["step_count"],
                                              np.ndarray)})
            del tree
        if args.die_after_segments and seg_idx >= args.die_after_segments:
            if ckpt is not None:
                ckpt.wait()
            print(f"fault injection: dying after segment {seg_idx} "
                  f"(round {t})", flush=True)
            os.kill(os.getpid(), signal.SIGKILL)
    if prof:
        prof.stop()
        log.emit_op("profile_stop", logdir=args.profile)
        print(f"profiler trace captured to {args.profile}")
    print(telemetry.format_event(log.emit(
        "run_end", rounds=args.rounds,
        final_loss=history[-1]["train_loss"] if history else 0.0,
        comm_cost_P=comm_cost)), flush=True)
    print(f"total {time.time() - t0:.1f}s")
    if ckpt is not None:
        ckpt.wait()
    log.close()
    if snap is not None:
        snap.close()
        print(f"telemetry snapshot: {args.snapshot}")
    if events_path:
        print(f"events: {events_path} (+ {telemetry.wall_path(events_path)})")

    if primary:
        os.makedirs(args.out, exist_ok=True)
        path = os.path.join(args.out, tag + ".json")
        with open(path, "w") as f:
            json.dump({"args": vars(args), "history": history}, f, indent=1)
        print(f"history: {path}")
    if args.save_merged:
        # merge with the RUN'S operator (+ its stats), not the uniform mean:
        # the checkpoint is the model whose merged eval the history reports;
        # under a fault plan only the agents alive at the end contribute.
        # On a mesh every rank takes part in the merge; rank 0 saves it
        tree = merge_mod.merged_panel_tree(
            state["panel"], spec, stats=state.get("merge_stat"),
            live=alive_after(args.rounds - 1))
        if primary:
            save(args.save_merged, tree)
            print(f"saved {spec.merger}-merged model to", args.save_merged)
        del tree
    return history


if __name__ == "__main__":
    main()
