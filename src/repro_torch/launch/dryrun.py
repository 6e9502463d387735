"""Dry run of the sharded training round on a mesh of H100s (counterpart of
``repro/launch/dryrun.py``, its panel variants).

For an arch, the ``train_4k`` shape and the reference's training meshes
(``--mesh single``: (1, A, 16 / A, 16), 256 cards; ``multi``: two pods, 512;
A the arch's ``agents_per_pod``) this reckons what ONE rank of the port's
sharded run holds and does, without a card and without allocating the
state: the port's own code (``core.dsgd.init_panel_state`` on the mesh,
then ``make_panel_segment``: a gossip round and the global merge, H local
steps each, then the merged and local evals) runs under
``utils.fake_trace.trace`` (FakeTensorMode on the CPU) on rank 0's
coordinate of a mesh of shape only (``launch.mesh.mesh_of_shape``), its
collectives recorded by a ``RecordingMesh``. One JSON record a pair, with
the reference's field names where the meaning is the same:

* ``agents``, ``panel_width``, ``chips``, ``wire_bytes_per_agent``,
  ``resident_bytes_per_agent`` (``telemetry.metrics.resident_bytes_model``);
* ``memory``: ``state_bytes`` (what the rank holds of the state:
  ``core.dsgd.panel_state_layout``'s blocks), ``transient_bytes`` (the
  traced peak above it), ``traced_peak_bytes``, ``per_device_total``
  (:func:`device_total`: the peak, the rank's reserve beyond its tensors
  and, for ranks sharing one card, its CUDA IPC buffer) and ``fits``
  against the card's memory (``hardware.MEMORY_BYTES``); NCCL's own
  buffers are not reckoned (``unreckoned``);
* ``cost``: the FLOPs a rank (``FlopCounterMode``: matmuls and attention)
  and the bytes its operations read and write, over the traced segment,
  and one local step's FLOPs;
* ``collectives``: the bytes and calls a rank (the payload
  ``launch.mesh.Mesh.stats`` counts), ``per_kind``, ``counts`` and, a
  line ('rows', 'fsdp'), the bytes a ring moves and the link it crosses;
* ``model_flops`` (``utils.flops.model_flops``);
* ``roofline``: compute (FLOPs over the float32 peak), memory (bytes over
  HBM) and collective seconds (each line's ring bytes over its link:
  NVLink within a node of ``--ranks-per-node`` cards, the inter-node rate
  across), and the ``dominant`` one (``hardware``'s H100 SXM rates).

The dense GQA decoders (olmo-1b, phi3-mini-3.8b, yi-34b, gemma-2b,
gemma-2b-sw) are traced on the reference's ``param_shardings`` route
(``core.dsgd.make_panel_segment(param_shardings=)``,
``models/tensor_parallel.py``): each agent's local step split over its
agent block, its batch rows over ``fsdp``, its heads, d_ff columns and
vocabulary over ``model``; their records carry ``split``, the leaves split,
left whole and summed. The other families' ``model`` axis still holds
replicas (every ``model`` rank computes its agents' whole step, so the
activation peak is one agent's whole step on one card) and their records
say so (``note``; their split blocks are ROADMAP A16d's second item). The
serve shapes (``prefill_32k``, ``decode_32k``, ``long_500k``: A16d's first
item) and the reference's non-panel variants (``baseline``, ``merge``,
``nocomm``, ``bf16wire``, ``pairwise``, ``remat_dots``, ``nochunk``,
``seqpar``, ``moeshard``: its third, the tree-state variants) are refused
by name.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b \\
      --shape train_4k --mesh single --variant panel --out results/dryrun

:func:`reckon` is the same trace for any configuration: an explicit mesh
shape, agents, batch, rounds and options (``chip_smoke.py`` phase 12e
reckons its phase-12 runs with it).
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import numpy as np
import torch

from repro_torch import hardware
from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.core import dsgd
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import build_model
from repro_torch.models import tensor_parallel as tp
from repro_torch.models.model import extra_inputs
from repro_torch.optim import make_optimizer
from repro_torch.telemetry.metrics import resident_bytes_model
from repro_torch.utils import flops as flops_mod
from repro_torch.utils.fake_trace import RecordingMesh, trace

ARCHS = ["gemma-2b", "phi3-mini-3.8b", "arctic-480b", "qwen2-vl-72b",
         "xlstm-1.3b", "seamless-m4t-medium", "deepseek-v3-671b",
         "recurrentgemma-2b", "olmo-1b", "yi-34b"]
# the reference's panel variants: the wire codec and the residency policy
VARIANTS = {"panel": (None, None), "panel_bf16wire": ("bf16", None),
            "panel_int8wire": ("int8", None),
            "panel_int4wire": ("int4", None),
            "panel_topkwire": ("topk", None),
            "panel_residency_int8": (None, "moments=int8")}
# what the port does not reckon, and the ROADMAP A16d item that owns it
TREE_STATE = "ROADMAP A16d's tree-state variants"
REFUSED_VARIANTS = {
    "baseline": f"the tree-state step of dense per-leaf gossip ({TREE_STATE})",
    "merge": f"the tree-state step's psum merge ({TREE_STATE})",
    "nocomm": f"the tree-state step without a mix ({TREE_STATE})",
    "bf16wire": f"the tree-state step with a bf16 payload ({TREE_STATE})",
    "pairwise": f"the tree-state step's pairwise gossip ({TREE_STATE})",
    "remat_dots": f"XLA's remat policy on the tree-state step ({TREE_STATE};"
                  " the port has no remat)",
    "nochunk": f"the tree-state step's un-chunked loss ({TREE_STATE})",
    "seqpar": "a hint to XLA's partitioner (sequence sharding over model: "
              "ROADMAP A16d's split blocks)",
    "moeshard": "a hint to XLA's partitioner (MoE dispatch sharding: "
                "ROADMAP A16d's split MoE blocks)",
    "moeshard2": "a hint to XLA's partitioner (MoE dispatch sharding: "
                 "ROADMAP A16d's split MoE blocks)",
}
SERVE_SHAPES = ("prefill_32k", "decode_32k", "long_500k")
NOTE = ("the port's 'model' axis holds replicas for this family: each model "
        "rank computes its agents' whole local step (the reference shards "
        "it by tensor parallelism; its split blocks are ROADMAP A16d's "
        "second item), so the activation peak is one agent's whole step")


def device_total(peak: int, route: str = "nccl") -> dict:
    """The card's bytes a rank of traced ``peak`` needs on ``route``: the
    peak, ``hardware.RANK_RESERVE_BYTES`` (its CUDA context and the
    caching allocator's reserve over the peak, which no trace of tensors
    sees) and, for ranks sharing one card ('cuda ipc'), the exchange
    buffer each allocates outside the allocator (``mesh.IPC_BYTES``)."""
    ipc = mesh_mod.IPC_BYTES if route == "cuda ipc" else 0
    return {"per_device_total": peak + hardware.RANK_RESERVE_BYTES + ipc,
            "reserve_bytes": hardware.RANK_RESERVE_BYTES, "ipc_bytes": ipc}


def _refuse(shape_name: str, variant: str):
    if shape_name in SERVE_SHAPES:
        raise SystemExit(f"--shape {shape_name}: the dry run of the serve "
                         "shapes (the reference's build_serve: weights and KV "
                         "caches over model on the production mesh) is "
                         "ROADMAP A16d's first item; the port reckons "
                         "train_4k")
    if variant not in VARIANTS:
        why = REFUSED_VARIANTS.get(variant, "not a variant of the reference")
        raise SystemExit(f"--variant {variant}: {why}; the port reckons the "
                         f"panel variants {sorted(VARIANTS)}")


def default_rounds(m: int):
    """The traced segment's rounds: a gossip round (a ring: every agent
    sends) and the global merge, as (W (1, m, m), global (1,), live)."""
    ring = np.zeros((m, m), np.float32)
    for k in range(m):
        ring[k, k] += 0.5
        ring[k, (k + 1) % m] += 0.25
        ring[k, (k - 1) % m] += 0.25
    full = np.full((m, m), 1.0 / m, np.float32)
    return [(ring[None], np.array([False]), None),
            (full[None], np.array([True]), None)]


def _tensor_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tensor_bytes(v) for v in tree.values())
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0


def _batches(cfg, rounds, local_steps, m, batch, seq):
    """Batches of ``rounds`` rounds as the launcher hands them over, as
    fakes: (S, H, m, b, seq) tokens, targets and mask, and the arch's
    extra inputs."""
    lead = (rounds, local_steps, m, batch)
    out = {"tokens": torch.zeros(lead + (seq,), dtype=torch.int32),
           "targets": torch.zeros(lead + (seq,), dtype=torch.int32),
           "mask": torch.ones(lead + (seq,), dtype=torch.float32)}
    for k, shape in extra_inputs(cfg, seq).items():
        out[k] = torch.zeros(lead + tuple(shape), dtype=torch.float32)
    return out


def _stats(mesh):
    return {"bytes": int(mesh.stats["bytes"]),
            "calls": int(mesh.stats["calls"]),
            "log": {f"{line}/{kind}": dict(v)
                    for (line, kind), v in sorted(mesh.log.items())}}


def reckon(cfg, mesh_shape, *, rank: int = 0, agents=None,
           local_steps: int = 1, batch: int, seq: int, rounds=None,
           wire=None, merger="uniform", residency=None, fused=None,
           telemetry: bool = False, route: str = "nccl",
           evals: bool = True, split: bool = False):
    """Trace rank ``rank`` of a sharded run of ``cfg`` on a mesh of
    ``mesh_shape`` (pod, agent, fsdp, model): the state's init, then a
    call of the segment for each entry of ``rounds`` ([(W (S, m, m),
    global (S,), live (S, m) or None)]; default: :func:`default_rounds`
    in one call) with ``batch`` x ``seq`` tokens an agent a local step,
    then the merged and local evals (``evals``) on 2 x ``batch`` rows.
    ``route`` is the transport whose calls the collectives count ('nccl',
    'gloo' or 'cuda ipc'). ``split`` traces the ``param_shardings`` route
    (``tensor_parallel.train_shardings`` of the mesh: each agent's step
    split over its agent block); the evals stay whole. Returns {"spec",
    "state_bytes", "peak", "marks", "flops", "bytes_accessed",
    "host_reads", "agents_here", "init" and "run" (the collectives of the
    init and of the rest: bytes, calls, log by line/kind), "segment0" (the
    first call's rounds and FLOPs), "split" (the leaves split, whole and
    summed, or None)}."""
    from repro_torch.launch import train
    mesh = RecordingMesh.of(mesh_mod.mesh_of_shape(mesh_shape, rank),
                            route=route)
    m = agents or mesh_mod.num_agents(mesh)
    if rounds is None:
        (W0, g0, _), (W1, g1, _) = default_rounds(m)
        rounds = [(np.concatenate([W0, W1]), np.concatenate([g0, g1]),
                   None)]
    model = build_model(cfg)
    shardings = tp.train_shardings(model, mesh, m) if split else None
    out = {"split": None if shardings is None else tp.describe(
        tp.leaf_plan(cfg, tp.Split(mesh), shardings))}
    n_rounds = sum(r[0].shape[0] for r in rounds)
    opt = make_optimizer("adamw", 3e-3, weight_decay=5e-4,
                         total_steps=n_rounds * local_steps)

    def program(rec):
        gen = torch.Generator().manual_seed(0)
        state, spec = dsgd.init_panel_state(
            model.init_params, opt, m, gen, mesh=mesh, wire=wire,
            merger=merger, residency=residency)
        rec.mark("init")
        out["spec"] = spec
        out["state_bytes"] = _tensor_bytes(state)
        out["init"] = _stats(mesh)
        mesh.reset()
        seg = dsgd.make_panel_segment(model.loss_fn, opt, local_steps, spec,
                                      fused=fused, telemetry=telemetry,
                                      param_shardings=shardings)
        wire_gen = torch.Generator().manual_seed(3)
        first = None
        for W, glob, live in rounds:
            S = W.shape[0]
            before = rec.flops_now()
            state, mets = seg(state, _batches(cfg, S, local_steps, m, batch,
                                              seq), W, wire_gen,
                              global_rounds=glob, live=live)
            if first is None:
                first = rec.flops_now() - before
            del mets
        rec.mark("segments")
        if evals:
            ev = {k: v[0, 0, 0].repeat(2, *([1] * (v.dim() - 4)))
                  for k, v in _batches(cfg, 1, 1, 1, batch, seq).items()}
            lv = rounds[-1][2]
            alive = None if lv is None else lv[-1] == 1
            with rec.host_reads_allowed():
                train.eval_merged(model.loss_fn, state["panel"], spec, ev,
                                  state.get("merge_stat"), live=alive)
                train.eval_local(model.loss_fn, state["panel"], spec, ev,
                                 live=alive)
            rec.mark("evals")
        out["run"] = _stats(mesh)
        out["segment_flops"] = first
        return None

    rec = trace(program)
    lo, hi = out["spec"].agent_range()
    out.update(peak=rec.peak, marks=rec.marks, flops=rec.flops,
               bytes_accessed=rec.bytes_accessed, host_reads=rec.host_reads,
               agents_here=hi - lo,
               segment0={"rounds": int(rounds[0][0].shape[0]),
                         "flops": out.pop("segment_flops")})
    return out


def _link(members, ranks_per_node: int) -> tuple:
    """(link name, bytes/s) of a line whose members are ``members``."""
    if len({r // ranks_per_node for r in members}) == 1:
        return "nvlink", hardware.NVLINK_BYTES_PER_S
    return "inter_node", hardware.INTER_NODE_BYTES_PER_S


def collective_record(run: dict, mesh, ranks_per_node: int) -> dict:
    """The record's ``collectives`` from a :func:`reckon` run's log: the
    payload bytes and calls a rank (``Mesh.stats``), by kind, and a line's
    ring bytes (all-gather (n - 1) x payload, all-reduce 2 (n - 1) / n x
    payload) and seconds over its link."""
    per_kind, counts, lines = {}, {}, {}
    seconds = 0.0
    for key, v in run["log"].items():
        line, kind = key.split("/")
        per_kind[kind] = per_kind.get(kind, 0) + v["bytes"]
        counts[kind] = counts.get(kind, 0) + v["calls"]
        members = mesh.members[line]
        n = len(members)
        ring = v["bytes"] * ((n - 1) if kind == "all_gather"
                             else 2 * (n - 1) / n)
        link, bw = _link(members, ranks_per_node)
        rec = lines.setdefault(line, {"ranks": n, "link": link,
                                      "ring_bytes": 0, "seconds": 0.0})
        rec["ring_bytes"] += int(ring)
        rec["seconds"] += ring / bw
        seconds += ring / bw
    return {"bytes_per_device": run["bytes"], "calls": run["calls"],
            "per_kind": per_kind, "counts": counts, "per_line": lines,
            "seconds": seconds}


def run_pair(arch: str, shape_name: str, multi_pod: bool,
             variant: str = "panel", outdir=None,
             ranks_per_node: int = hardware.CARDS_PER_NODE):
    """Reckon one (arch, shape, mesh, variant) pair; writes
    ``outdir/<arch>_<shape>_<mesh>_<variant>.json`` when ``outdir`` is
    set and returns the record (status OK, or FAIL with the error)."""
    _refuse(shape_name, variant)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "variant": variant, "status": "OK"}
    t0 = time.time()
    try:
        cfg = get_config(arch)
        split = not tp.unsplit_parts(cfg)
        if not split:
            rec["note"] = NOTE
        shape = INPUT_SHAPES[shape_name]
        mesh_shape = mesh_mod.training_shape(cfg.dist.agents_per_pod,
                                             multi_pod)
        chips = int(np.prod(mesh_shape))
        m = mesh_shape[0] * mesh_shape[1]
        if shape.global_batch % m:
            raise ValueError(f"global batch {shape.global_batch} does not "
                             f"split over {m} agents")
        wire, residency = VARIANTS[variant]
        r = reckon(cfg, mesh_shape, batch=shape.global_batch // m,
                   seq=shape.seq_len, wire=wire, residency=residency,
                   split=split)
        if split:
            rec["split"] = r["split"]
        spec = r["spec"]
        opt = make_optimizer("adamw", 1e-4)
        rec.update(agents=m, panel_width=spec.width, chips=chips,
                   mesh_shape=list(mesh_shape),
                   wire_bytes_per_agent=spec.wire_total_bytes,
                   resident_bytes_per_agent=resident_bytes_model(spec, opt),
                   agents_per_rank=r["agents_here"])
        peak = r["peak"]
        total = device_total(peak)
        rec["memory"] = {"state_bytes": r["state_bytes"],
                         "transient_bytes": peak - r["state_bytes"],
                         "traced_peak_bytes": peak, **total,
                         "card_bytes": hardware.MEMORY_BYTES,
                         "fits": bool(total["per_device_total"]
                                      <= hardware.MEMORY_BYTES),
                         "unreckoned": "NCCL's communicator buffers",
                         "marks": r["marks"]}
        rec["cost"] = {"flops_per_device": r["flops"],
                       "bytes_per_device": r["bytes_accessed"],
                       "segment": r["segment0"]}
        shape_mesh = mesh_mod.mesh_of_shape(mesh_shape)
        coll = collective_record(r["run"], shape_mesh, ranks_per_node)
        rec["collectives"] = coll
        rec["host_reads"] = r["host_reads"]
        model = build_model(cfg)
        rec["model_flops"] = flops_mod.model_flops(model, shape)
        terms = {"compute_s": r["flops"] / hardware.FP32_FLOPS,
                 "memory_s": r["bytes_accessed"] / hardware.HBM_BYTES_PER_S,
                 "collective_s": coll["seconds"]}
        rec["roofline"] = dict(terms, dominant=max(terms, key=terms.get))
    except Exception as e:  # noqa: BLE001
        rec["status"] = "FAIL"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    rec["wall_s"] = round(time.time() - t0, 2)
    if outdir:
        os.makedirs(outdir, exist_ok=True)
        tag = f"{arch}_{shape_name}_{mesh_name}_{variant}"
        with open(os.path.join(outdir, tag + ".json"), "w") as f:
            json.dump(rec, f, indent=1, default=str)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all",
                    help="a registered arch, or all")
    ap.add_argument("--shape", default="train_4k",
                    choices=sorted(INPUT_SHAPES))
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--variant", default="panel",
                    help="one of the reference's panel variants: "
                         + ", ".join(VARIANTS))
    ap.add_argument("--ranks-per-node", type=int,
                    default=hardware.CARDS_PER_NODE,
                    help="cards a node joins by NVLink (the collective "
                         "term's links)")
    ap.add_argument("--out", default="results/torch_dryrun")
    args = ap.parse_args(argv)
    _refuse(args.shape, args.variant)
    archs = ARCHS if args.arch == "all" else [args.arch]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    ok = fail = 0
    for arch in archs:
        for mp in meshes:
            rec = run_pair(arch, args.shape, mp, args.variant, args.out,
                           args.ranks_per_node)
            ok += rec["status"] == "OK"
            fail += rec["status"] == "FAIL"
            mem = rec.get("memory", {})
            print(f"[{rec['status']:4s}] {arch:22s} {args.shape:10s} "
                  f"{rec['mesh']:8s} {args.variant:20s} state "
                  f"{mem.get('state_bytes')} peak "
                  f"{mem.get('traced_peak_bytes')} device "
                  f"{mem.get('per_device_total')} fits {mem.get('fits')} "
                  f"dom={rec.get('roofline', {}).get('dominant', '-')} "
                  f"wall={rec['wall_s']}s"
                  + (f" err={rec.get('error', '')[:200]}"
                     if rec["status"] == "FAIL" else ""), flush=True)
    print(f"done: ok={ok} fail={fail}")
    return 1 if fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
