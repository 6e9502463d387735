"""Decentralized LM training launcher, main path (counterpart of
``repro/launch/train.py``).

Runs the paper's algorithm end to end on synthetic non-IID token streams:
per-agent local AdamW/SGD steps, scheduled gossip, and the single final
global merge, on the panel engine (core/dsgd.py), under any wire codec
(``--wire``), merge operator (``--merge``) and residency policy of the
state panels (``--residency``, ``--fused-moments``), and under a fault plan
(``--faults``: agents that die and rejoin, the elastic run), and saves the
merged model for serving (``--save-merged``). It draws the
schedule's mixing matrices and the batches from the same numpy seeds, in
the same order, as the reference launcher, so both see byte-identical W
streams and batches.

Runs on the CUDA card unless ``--device cpu`` is given. Example:
  PYTHONPATH=src python -m repro_torch.launch.train --rounds 10 \
      --segment 4 --agents 4 --local-steps 2 --batch 4 --seq 32 \
      --schedule final_merge --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from repro_torch.checkpoint import save
from repro_torch.configs import get_config
from repro_torch.core import dsgd
from repro_torch.core import faults as faults_mod
from repro_torch.core import merge as merge_mod
from repro_torch.core import panel as panel_mod
from repro_torch.core.schedule import make_schedule
from repro_torch.data.synthetic import SyntheticLM, make_agent_lm_batches
from repro_torch.device import resolve_device
from repro_torch.merging import MERGERS
from repro_torch.models import build_model
from repro_torch.optim import make_optimizer
from repro_torch.residency import STORAGE
from repro_torch.telemetry.metrics import (fused_moments_auto,
                                           resident_bytes_model)
from repro_torch.wire import CODECS


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
    with ``live`` ((m,) bool) over the live agents only."""
    rows = range(spec.rows) if live is None else np.flatnonzero(live)
    losses = [loss_fn(panel_mod.agent_params(panel, spec, k), batch,
                      None)[0] for k in rows]
    return float(torch.mean(torch.stack(losses)))


def main(argv=None):
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
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' to "
                         "run on the CPU)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config(args.arch)
    if args.preset == "cpu":
        cfg = build_cpu_preset(cfg, args.agents)
    m = args.agents
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
    tag = f"{args.arch}_{args.schedule}_a{args.alpha}"
    if args.merge != "uniform":
        tag += f"_m{args.merge}"
    if args.residency:
        tag += "_r" + args.residency.replace("=", "").replace(",", "_")

    gen = torch.Generator(device=device).manual_seed(args.seed)
    state, spec = dsgd.init_panel_state(model.init_params, opt, m, gen,
                                        device=device, merger=sched.merger,
                                        wire=args.wire,
                                        residency=args.residency or None)
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
    # residency streams are seeded from it and never draw from it)
    wire_gen = torch.Generator(device=device).manual_seed(args.seed + 3)
    segment_fn = dsgd.make_panel_segment(model.loss_fn, opt,
                                         args.local_steps, spec, fused=fused)

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
        mets = {k: v.cpu().numpy() for k, v in mets.items()}  # one transfer
        monitor = {"grad_norm": float(mets["grad_norm"][-1]),
                   "consensus": float(mets["consensus"][-1])}
        merged_l = local_l = None
        if ev == 0 or (t + S) % ev == 0 or t + S == args.rounds:
            lv_now = alive_after(t + S - 1)
            merged_l = eval_merged(model.loss_fn, state["panel"], spec,
                                   eval_batch, state.get("merge_stat"),
                                   live=lv_now)
            local_l = eval_local(model.loss_fn, state["panel"], spec,
                                 eval_batch, live=lv_now)
        dt = time.perf_counter() - seg_t0
        for s in range(S):
            last = s == S - 1
            history.append({"round": t + s,
                            "train_loss": float(mets["loss"][s]),
                            "consensus": float(mets["consensus"][s]),
                            "grad_norm": float(mets["grad_norm"][s]),
                            "merged_eval": merged_l if last else None,
                            "local_eval": local_l if last else None,
                            "comm_cost_P": comm_after[s]})
        t += S
        evals = ("" if merged_l is None else
                 f" merged {merged_l:.4f} local {local_l:.4f}")
        print(f"round {t - 1}: loss {mets['loss'][-1]:.4f} "
              f"Xi {mets['consensus'][-1]:.6g}{evals} comm {comm_cost:.1f}P "
              f"({dt:.2f}s for {S} rounds)", flush=True)
    print(f"total {time.time() - t0:.1f}s")
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, tag + ".json")
    with open(path, "w") as f:
        json.dump({"args": vars(args), "history": history}, f, indent=1)
    print(f"history: {path}")
    if args.save_merged:
        # merge with the RUN'S operator (+ its stats), not the uniform mean:
        # the checkpoint is the model whose merged eval the history reports;
        # under a fault plan only the agents alive at the end contribute
        save(args.save_merged, merge_mod.merged_panel_tree(
            state["panel"], spec, stats=state.get("merge_stat"),
            live=alive_after(args.rounds - 1)))
        print(f"saved {spec.merger}-merged model to", args.save_merged)
    return history


if __name__ == "__main__":
    main()
