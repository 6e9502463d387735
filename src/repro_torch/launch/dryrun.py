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

The GQA decoders (olmo-1b, phi3-mini-3.8b, yi-34b, gemma-2b, gemma-2b-sw,
arctic-480b, qwen2-vl-72b) are traced on the reference's
``param_shardings`` route (``core.dsgd.make_panel_segment(
param_shardings=)``, ``models/tensor_parallel.py``): each agent's local
step split over its agent block, its batch rows over ``fsdp``, its heads,
d_ff columns, experts (arctic's 128 at 8 a model rank, the capacity rule
over the agent's whole batch) and vocabulary over ``model``; their records
carry ``split``, the leaves split, left whole and summed. qwen2-vl's
batches are the reference's ``input_specs``: seq - mm_prefix tokens beside
its mm_prefix patch rows (3,840 + 256 at ``train_4k``). The other
families' ``model`` axis still holds replicas (every ``model`` rank
computes its agents' whole step, so the activation peak is one agent's
whole step on one card) and their records say so (``note``; their split
blocks are the rest of ROADMAP A16d's second item: MLA, the MTP head and
the dense front layers, the recurrent mixers, the encoder and cross
attention). The reference's non-panel training variants (``baseline``,
``merge``, ``nocomm``, ``bf16wire``, ``pairwise``, ``remat_dots``,
``nochunk``, ``seqpar``, ``moeshard``: A16d's third item, the tree-state
variants) are refused by name.

The serve shapes (``prefill_32k``: 32 prompts of 32,768 tokens;
``decode_32k``: one step of 128 rows over caches of 32,768;
``long_500k``: one step of 1 row over 524,288) are the reference's
``build_serve``: bfloat16 parameters, on its production mesh
(``launch.mesh.serve_shape``: (16, 16) or (2, 16, 16) over ((pod,) data,
model), the data axes on the port's fsdp line), the weights and KV caches
as ``param_spec()`` / ``cache_spec()`` resolve under ``serve_rules(mesh,
big)`` (``big``: fewer than 16 agents a pod, yi-34b: the weights' fsdp dim
over the data axes too), the batch over the data axes, its variants
``baseline`` (the config's own ``attn_block``, the default at a serve
shape) and ``flashxla`` (``attn_block`` 512). :func:`reckon_serve` traces
rank 0's ``prefill`` or ``decode_step`` on the split serve route
(``models/tensor_parallel.py``) for the GQA decoders (arctic's experts
kept over ``model``, its MoE blocks dropless on the data rank's rows;
qwen2-vl's prompts seq - mm_prefix tokens after the patch prefix); a
record holds
``memory`` (``param_bytes`` and ``cache_bytes`` a rank, the traced peak,
``per_device_total``, ``fits``), ``cost`` (FLOPs), ``collectives`` (calls
and bytes) and a bfloat16 roofline. ``long_500k`` is the reference's SKIP
for olmo-1b, phi3-mini-3.8b, yi-34b, arctic-480b and qwen2-vl-72b (full
quadratic attention) and runs gemma-2b as gemma-2b-sw (its note); every
other family at a serve shape is refused by name (``REFUSED`` under
``--arch all``; a SystemExit for one arch): its split blocks are ROADMAP
A16d's second item.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b \\
      --shape train_4k --mesh single --variant panel --out results/dryrun
  PYTHONPATH=src python -m repro_torch.launch.dryrun --shape prefill_32k

:func:`reckon` is the same trace for any configuration: an explicit mesh
shape, agents, batch, rounds and options (``chip_smoke.py`` phase 12e
reckons its phase-12 runs with it); :func:`reckon_serve` for serving
(phase 12g); :func:`reckon_step` for one agent's local step on the split
route alone, without a panel (phase 12h, at widths whose panels do not
fit a card).
"""
from __future__ import annotations

import argparse
import dataclasses
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
from repro_torch.utils.tree import tree_flatten

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
    "moeshard": "a hint to XLA's partitioner (MoE dispatch sharding) on "
                f"the tree-state step ({TREE_STATE}; the split MoE blocks of "
                "the panel variants keep each fsdp rank's tokens on it)",
    "moeshard2": "a hint to XLA's partitioner (MoE dispatch sharding) on "
                 f"the tree-state step ({TREE_STATE}; the split MoE blocks "
                 "of the panel variants keep each fsdp rank's tokens on it)",
}
SERVE_SHAPES = ("prefill_32k", "decode_32k", "long_500k")
# the serve shapes' variants: the config's own attn_block, and 512
SERVE_VARIANTS = ("baseline", "flashxla")
# the reference's long_500k policy (repro/launch/dryrun.py: LONG_OK,
# LONG_VIA_SW and the SKIP record's reason)
LONG_VIA_SW = {"gemma-2b": "gemma-2b-sw"}
LONG_NOTE = "sliding-window variant (window=4096)"
LONG_SKIP = ("full quadratic attention family; long_500k reserved for "
             "sub-quadratic archs (DESIGN.md §5)")
SERVE_REFUSED = ("the serve shapes split the GQA decoders ({}); this "
                 "family's split blocks are ROADMAP A16d's second item")
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
        if variant not in SERVE_VARIANTS:
            raise SystemExit(f"--variant {variant} at --shape {shape_name}: "
                             f"the serve shapes take {SERVE_VARIANTS}")
        return
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
    fakes: (S, H, m, b, ...) tokens, targets and mask, and the arch's
    extra inputs, a sequence of ``seq`` positions as the reference's
    ``input_specs`` lays it out (the vlm: seq - mm_prefix tokens after its
    mm_prefix patch rows)."""
    lead = (rounds, local_steps, m, batch)
    n = seq - max(0, cfg.mm_prefix)
    out = {"tokens": torch.zeros(lead + (n,), dtype=torch.int32),
           "targets": torch.zeros(lead + (n,), dtype=torch.int32),
           "mask": torch.ones(lead + (n,), dtype=torch.float32)}
    for k, shape in extra_inputs(cfg, seq).items():
        out[k] = torch.zeros(lead + tuple(shape), dtype=torch.float32)
    return out


def serve_batch(cfg, rows: int, prompt: int) -> dict:
    """A prefill batch of ``rows`` prompts of ``prompt`` positions as the
    reference's ``input_specs`` lays it out, as fakes: the vlm's prompt
    - mm_prefix tokens after its patch prefix (``cfg``'s param_dtype),
    the encoder-decoder's ``prompt`` frames."""
    dt = {"float32": torch.float32,
          "bfloat16": torch.bfloat16}[cfg.param_dtype]
    out = {"tokens": torch.zeros((rows, prompt - max(0, cfg.mm_prefix)),
                                 dtype=torch.int32)}
    for k, shape in extra_inputs(cfg, prompt).items():
        out[k] = torch.zeros((rows,) + tuple(shape), dtype=dt)
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


def reckon_step(cfg, mesh_shape, *, rank: int = 0, batch: int, seq: int,
                route: str = "nccl"):
    """Trace rank ``rank``'s share of one agent's local step on the split
    route (``build_model(cfg, split=)``'s loss and its gradient) on a mesh
    of ``mesh_shape``, without a panel: the rank's pieces of one agent's
    parameters (as ``tensor_parallel.train_pieces`` cuts them: a split
    leaf's block, the others whole) and the agent's batch of ``batch``
    rows of ``seq`` positions (:func:`_batches`). Returns {"peak", "marks", "flops",
    "bytes_accessed", "host_reads", "run" (the collectives), "split",
    "param_bytes"}."""
    mesh = RecordingMesh.of(mesh_mod.mesh_of_shape(mesh_shape, rank),
                            route=route)
    split = tp.Split(mesh)
    whole = build_model(cfg)
    model = build_model(cfg, split=split)
    shardings = tp.train_shardings(whole, mesh, 1)
    plan = tp.leaf_plan(cfg, split, shardings)
    # the pieces' shapes, from the meta device outside the trace
    shapes = tp.train_pieces(whole.init_params(None, torch.device("meta")),
                             plan, split)
    out = {"split": tp.describe(plan)}

    def program(rec):
        pieces = tp._map_paths(
            lambda _, x: torch.empty(x.shape, dtype=x.dtype), shapes)
        leaves = [x.requires_grad_(True) for x in tree_flatten(pieces)[0]]
        out["param_bytes"] = _tensor_bytes(pieces)
        step = {k: v[0, 0, 0] for k, v in _batches(
            cfg, 1, 1, 1, batch, seq).items()}
        rec.mark("params")
        loss, _ = model.loss_fn(pieces, step)
        torch.autograd.grad(loss, leaves, allow_unused=True)
        rec.mark("step")
        out["run"] = _stats(mesh)
        return None

    rec = trace(program)
    out.update(peak=rec.peak, marks=rec.marks, flops=rec.flops,
               bytes_accessed=rec.bytes_accessed, host_reads=rec.host_reads)
    return out


def _serve_refusal(arch: str, shape_name: str):
    """Why ``arch`` has no serve record at ``shape_name`` (None if it has
    one): a family the split serve route does not split."""
    if arch in tp.SPLIT_FAMILIES:
        return None
    return (f"{arch} at {shape_name}: "
            + SERVE_REFUSED.format(", ".join(tp.SPLIT_FAMILIES)))


def reckon_serve(cfg, mesh_shape, *, rank: int = 0, batch: int,
                 prompt: int, max_len: int, decode_steps: int,
                 route: str = "nccl"):
    """Trace rank ``rank`` of the split serve route (``build_model(cfg,
    split=)``) on a serve mesh of ``mesh_shape``: the rank's pieces (each
    weight's block as ``serve_rules`` resolves it, in ``cfg``'s
    param_dtype), then its data rows of a batch of ``batch``: a
    ``prefill`` of ``prompt`` tokens into caches of ``max_len`` (or, with
    ``prompt`` 0, ``init_cache``), then ``decode_steps`` decode steps
    (``prompt`` positions: the vlm's prefix and prompt - mm_prefix tokens,
    :func:`serve_batch`).
    Returns {"param_bytes", "cache_bytes", "rows", "peak", "marks",
    "flops", "bytes_accessed", "host_reads", "run" (the collectives),
    "big"}."""
    mesh = RecordingMesh.of(mesh_mod.mesh_of_shape(mesh_shape, rank),
                            route=route)
    split = tp.Split(mesh)
    whole = build_model(cfg)
    model = build_model(cfg, split=split)
    shardings = tp.serve_shardings(whole, mesh)
    meta = whole.init_params(None, torch.device("meta"))
    rows = split.data_rows(batch)
    b = rows.stop - rows.start
    out = {"rows": b, "big": tp.serve_big(cfg)}

    model.serve_plan()  # its shapes from the meta device, outside the trace

    def program(rec):
        pieces = tp._map_paths(
            lambda _, x, e: torch.empty(tp.block_shape(x.shape, e, mesh),
                                        dtype=x.dtype), meta, shardings)
        out["param_bytes"] = _tensor_bytes(pieces)
        rec.mark("params")
        mesh.reset()
        with torch.no_grad():
            if prompt:
                _, caches = model.prefill(pieces, serve_batch(cfg, b, prompt),
                                          max_len=max_len)
                rec.mark("prefill")
            else:
                caches = model.init_cache(b, max_len, device="cpu")
            out["cache_bytes"] = _tensor_bytes(caches)
            pos = torch.full((b,), max_len - 1, dtype=torch.int32)
            for _ in range(decode_steps):
                _, caches = model.decode_step(
                    pieces, caches, torch.zeros((b, 1), dtype=torch.int32),
                    pos)
            if decode_steps:
                rec.mark("decode")
        out["run"] = _stats(mesh)
        return None

    rec = trace(program)
    out.update(peak=rec.peak, marks=rec.marks, flops=rec.flops,
               bytes_accessed=rec.bytes_accessed, host_reads=rec.host_reads)
    return out


def run_serve_pair(arch: str, shape_name: str, multi_pod: bool,
                   variant: str = "baseline", outdir=None,
                   ranks_per_node: int = hardware.CARDS_PER_NODE):
    """Reckon one serve (arch, shape, mesh, variant) pair as the
    reference's ``build_serve`` lays it out; writes
    ``outdir/<arch>_<shape>_<mesh>_<variant>.json`` when ``outdir`` is set
    and returns the record (OK, SKIP, REFUSED, or FAIL with the error)."""

    def body(rec):
        eff = arch
        if shape_name == "long_500k" and arch in LONG_VIA_SW:
            eff = LONG_VIA_SW[arch]
            rec["note"] = LONG_NOTE
        refusal = _serve_refusal(arch, shape_name)
        if refusal is not None:
            rec.update(status="REFUSED", reason=refusal)
            return
        if shape_name == "long_500k" and eff == arch:
            rec.update(status="SKIP", reason=LONG_SKIP)
            return
        cfg = get_config(eff).replace(param_dtype="bfloat16")
        if variant == "flashxla":
            cfg = cfg.replace(dist=dataclasses.replace(cfg.dist,
                                                       attn_block=512))
        shape = INPUT_SHAPES[shape_name]
        mesh_shape = mesh_mod.serve_shape(multi_pod)
        prefill = shape.kind == "prefill"
        r = reckon_serve(cfg, mesh_shape, batch=shape.global_batch,
                         prompt=shape.seq_len if prefill else 0,
                         max_len=shape.seq_len,
                         decode_steps=0 if prefill else 1)
        rec.update(big=r["big"], chips=int(np.prod(mesh_shape)),
                   mesh_shape=list(mesh_shape),
                   attn_block=cfg.dist.attn_block, rows_per_rank=r["rows"])
        _reckoned(rec, r, {"param_bytes": r["param_bytes"],
                           "cache_bytes": r["cache_bytes"]}, mesh_shape,
                  hardware.BF16_FLOPS, ranks_per_node,
                  flops_mod.model_flops(build_model(get_config(eff)),
                                        shape))

    return _pair(arch, shape_name, multi_pod, variant, outdir, body)


def _pair(arch, shape_name, multi_pod, variant, outdir, body):
    """The record of one (arch, shape, mesh, variant) pair: ``body(rec)``
    fills it (status OK unless it sets another); an exception in it makes
    a FAIL record with the error and its traceback. Written to
    ``outdir`` when that is set (:func:`_dump`)."""
    _refuse(shape_name, variant)
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "2x16x16" if multi_pod else "16x16",
           "variant": variant, "status": "OK"}
    t0 = time.time()
    try:
        body(rec)
    except Exception as e:  # noqa: BLE001
        rec["status"] = "FAIL"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    rec["wall_s"] = round(time.time() - t0, 2)
    _dump(rec, outdir)
    return rec


def _reckoned(rec, r, held, mesh_shape, rate, ranks_per_node, model_flops,
              **cost):
    """A record's numbers from the reckoning ``r`` on ``mesh_shape``: the
    memory (``held``: the bytes a rank holds beyond its transients, by
    name; the device total and whether it fits the card), the cost
    (``cost``'s entries beside the traced FLOPs and bytes), the
    collectives, the host reads, ``model_flops`` and the roofline terms
    (the compute term at ``rate`` FLOP/s)."""
    peak = r["peak"]
    total = device_total(peak)
    rec["memory"] = {**held, "transient_bytes": peak - sum(held.values()),
                     "traced_peak_bytes": peak, **total,
                     "card_bytes": hardware.MEMORY_BYTES,
                     "fits": bool(total["per_device_total"]
                                  <= hardware.MEMORY_BYTES),
                     "unreckoned": "NCCL's communicator buffers",
                     "marks": r["marks"]}
    rec["cost"] = {"flops_per_device": r["flops"],
                   "bytes_per_device": r["bytes_accessed"], **cost}
    coll = collective_record(r["run"], mesh_mod.mesh_of_shape(mesh_shape),
                             ranks_per_node)
    rec["collectives"] = coll
    rec["host_reads"] = r["host_reads"]
    rec["model_flops"] = model_flops
    terms = {"compute_s": r["flops"] / rate,
             "memory_s": r["bytes_accessed"] / hardware.HBM_BYTES_PER_S,
             "collective_s": coll["seconds"]}
    rec["roofline"] = dict(terms, dominant=max(terms, key=terms.get))


def _dump(rec, outdir):
    if outdir:
        os.makedirs(outdir, exist_ok=True)
        tag = f"{rec['arch']}_{rec['shape']}_{rec['mesh']}_{rec['variant']}"
        with open(os.path.join(outdir, tag + ".json"), "w") as f:
            json.dump(rec, f, indent=1, default=str)


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

    def body(rec):
        cfg = get_config(arch)
        split = not tp.unsplit_parts(cfg)
        if not split:
            rec["note"] = NOTE
        shape = INPUT_SHAPES[shape_name]
        mesh_shape = mesh_mod.training_shape(cfg.dist.agents_per_pod,
                                             multi_pod)
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
        rec.update(agents=m, panel_width=spec.width,
                   chips=int(np.prod(mesh_shape)),
                   mesh_shape=list(mesh_shape),
                   wire_bytes_per_agent=spec.wire_total_bytes,
                   resident_bytes_per_agent=resident_bytes_model(spec, opt),
                   agents_per_rank=r["agents_here"])
        _reckoned(rec, r, {"state_bytes": r["state_bytes"]}, mesh_shape,
                  hardware.FP32_FLOPS, ranks_per_node,
                  flops_mod.model_flops(build_model(cfg), shape),
                  segment=r["segment0"])

    return _pair(arch, shape_name, multi_pod, variant, outdir, body)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all",
                    help="a registered arch, or all")
    ap.add_argument("--shape", default="train_4k",
                    choices=sorted(INPUT_SHAPES))
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--variant", default=None,
                    help="one of the reference's panel variants at "
                         "train_4k (default panel): " + ", ".join(VARIANTS)
                         + "; at a serve shape " + " or ".join(SERVE_VARIANTS)
                         + " (default baseline)")
    ap.add_argument("--ranks-per-node", type=int,
                    default=hardware.CARDS_PER_NODE,
                    help="cards a node joins by NVLink (the collective "
                         "term's links)")
    ap.add_argument("--out", default="results/torch_dryrun")
    args = ap.parse_args(argv)
    serving = args.shape in SERVE_SHAPES
    variant = args.variant or ("baseline" if serving else "panel")
    _refuse(args.shape, variant)
    archs = ARCHS if args.arch == "all" else [args.arch]
    if serving and args.arch != "all":
        why = _serve_refusal(args.arch, args.shape)
        if why is not None:
            raise SystemExit(why)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    counts = {}
    for arch in archs:
        for mp in meshes:
            run = run_serve_pair if serving else run_pair
            rec = run(arch, args.shape, mp, variant, args.out,
                      args.ranks_per_node)
            counts[rec["status"]] = counts.get(rec["status"], 0) + 1
            mem = rec.get("memory", {})
            held = (f"params {mem.get('param_bytes')} cache "
                    f"{mem.get('cache_bytes')}" if serving
                    else f"state {mem.get('state_bytes')}")
            print(f"[{rec['status']:4s}] {arch:22s} {args.shape:10s} "
                  f"{rec['mesh']:8s} {variant:20s} {held} peak "
                  f"{mem.get('traced_peak_bytes')} device "
                  f"{mem.get('per_device_total')} fits {mem.get('fits')} "
                  f"dom={rec.get('roofline', {}).get('dominant', '-')} "
                  f"wall={rec['wall_s']}s"
                  + (f" err={rec.get('error', '')[:200]}"
                     if rec["status"] == "FAIL" else "")
                  + (f" ({rec['reason'][:120]})" if "reason" in rec
                     else ""), flush=True)
    print("done: " + " ".join(f"{k.lower()}={v}"
                              for k, v in sorted(counts.items())))
    return 1 if counts.get("FAIL") else 0


if __name__ == "__main__":
    raise SystemExit(main())
