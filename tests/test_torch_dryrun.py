"""The dry run's estimate (``launch/dryrun.py``): what one rank of a
sharded run holds and does, traced on the CPU without allocating.

* **Pod meshes.** At the reference's 16 x 16 and 2 x 16 x 16 training
  meshes, for olmo-1b (16 agents a pod, fsdp 1) and arctic-480b (MoE, 2
  agents a pod, fsdp 8), every panel variant's state bytes a rank equal
  the per-device shard bytes of the reference's ``panel_state_shardings``
  leaf by leaf (the reference's shapes in a subprocess with 512 forced host
  devices, no compile); the one difference is named: at fsdp > 1 the
  port's grouped scale sidecars sit beside their columns (1 / fsdp of the
  reference's rows-only sidecar). ``panel_state_layout``'s blocks have the
  local shapes the state's leaves have.
* **Small mesh.** On (1, 2, 2, 1) at ``reduced()`` the recording mesh's
  collective bytes and calls equal ``Mesh.stats`` of the same program run
  for real over gloo (``tests/_torch_dist.py`` mode ``dryrun``), f32 and a
  lossy case (int4, fisher, int8 moments and int8r statistics).
* **FLOPs.** One agent's traced local step equals 6 x its matmul
  parameters x tokens plus the attention's 12 B S^2 H hd a layer (the
  plain attention computes the whole square; ``utils/flops.py`` counts its
  causal half): olmo-1b's reduced() (tied embedding, norms without
  weights: N itself) and phi3-mini's (its untied input embedding and norm
  weights are not matmuls) within 1e-9 relative.
* **No allocation.** The CLI's olmo-1b ``train_4k`` record at 16 x 16,
  whose state is 14.1 GB a rank, raises the process's peak RSS by under
  1 GB, in a subprocess; and it refuses the non-panel training variants,
  and the serve shapes of a family the split serve route does not split,
  by name. That record is traced on the split route
  (``param_shardings``): no replica note, the leaves split and whole named.
* **Serve shapes.** ``prefill_32k``, ``decode_32k`` and ``long_500k`` on
  both production meshes (the reference's ``build_serve``): each OK
  record's parameter and cache bytes a rank equal the blocks that
  ``resolve(param_spec / cache_spec, serve_rules)`` gives on a ('data',
  'model') mesh of the reference's shape, computed here from the shapes
  (bfloat16 weights and caches, int32 positions; yi-34b, arctic-480b and
  qwen2-vl-72b ``big``: their weights' fsdp dim over data); ``long_500k``
  keeps the reference's SKIP reason for olmo-1b, phi3-mini-3.8b, yi-34b,
  arctic-480b and qwen2-vl-72b and runs gemma-2b as gemma-2b-sw; every
  other family is REFUSED naming A16d's second item. The batches are the
  reference's ``input_specs`` (qwen2-vl: seq - mm_prefix tokens beside
  its patch rows; seamless: frames of seq rows).
* **Split route.** On (1, 1, 2, 2) at ``reduced()`` olmo-1b's split
  record names its leaves, its traced peak and FLOPs a rank are below the
  replica route's (FLOPs about a quarter: half the batch, half the heads),
  and its collectives equal ``Mesh.stats`` of the same program run for
  real over gloo. arctic-480b's and qwen2-vl-72b's ``train_4k`` records
  (published widths, one layer) are traced on it: no replica note, the
  expert banks split, the router and qwen2-vl's shared kv heads summed.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401
from _torch_dist import (DRY_B, DRY_CASES, DRY_H, DRY_M, DRY_S,
                         DRY_SPLIT_CASE, DRY_SPLIT_MESH, spawn)
from repro_torch import hardware
from repro_torch.checkpoint import io as ckpt_io
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import dsgd
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import build_model
from repro_torch.optim import make_optimizer
from repro_torch.utils import flops as flops_mod
from repro_torch.utils.fake_trace import RecordingMesh, trace

SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")
POD_ARCHS = ["olmo-1b", "arctic-480b"]

REFERENCE_SHARDS = textwrap.dedent("""
    import json
    import jax
    from repro.configs import get_config
    from repro.core import dsgd
    from repro.core import panel as panel_mod
    from repro.launch import mesh as mesh_mod
    from repro.launch.dryrun import build_train_panel
    from repro.models import build_model
    from repro.optim import make_optimizer
    out = {}
    for arch in ARCHS:
        cfg = get_config(arch)
        model = build_model(cfg)
        for multi in (False, True):
            mesh = mesh_mod.make_training_mesh(cfg.dist.agents_per_pod,
                                               multi_pod=multi)
            m = mesh_mod.num_agents(mesh)
            key = jax.random.PRNGKey(0)
            params = jax.eval_shape(lambda k: dsgd._init_agent_params(
                model.init_params, m, k, False), key)
            for variant, (wire, res) in VARIANTS.items():
                spec = panel_mod.shard_spec(panel_mod.make_spec(params), mesh)
                spec = panel_mod.with_residency(
                    panel_mod.with_wire(spec, wire), res)
                opt = make_optimizer("adamw", 1e-4)
                st = jax.eval_shape(lambda k: dsgd.init_panel_state(
                    model.init_params, opt, m, k, wire=wire,
                    residency=res)[0], key)
                sh = dsgd.panel_state_shardings(st, spec)
                leaves = {}
                for (path, s), x in zip(
                        jax.tree_util.tree_flatten_with_path(sh)[0],
                        jax.tree.leaves(st)):
                    k = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                                 for p in path)
                    n = 1
                    for d in s.shard_shape(x.shape):
                        n *= d
                    leaves[k] = n * x.dtype.itemsize
                out[f"{arch}|{multi}|{variant}"] = leaves
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def reference_shards():
    from _multidevice import run_multidevice
    variants = {v: (w, None if r is None else {"moments": "int8"})
                for v, (w, r) in dryrun.VARIANTS.items()}
    script = (f"ARCHS = {POD_ARCHS!r}\nVARIANTS = {variants!r}\n"
              + REFERENCE_SHARDS)
    return run_multidevice(script, devices=512)


def _port_state(arch, multi, variant):
    """{key: local bytes} of rank 0's state, and its layout's blocks."""
    cfg = get_config(arch)
    shape = mesh_mod.training_shape(cfg.dist.agents_per_pod, multi)
    mesh = mesh_mod.mesh_of_shape(shape)
    m = mesh_mod.num_agents(mesh)
    wire, res = dryrun.VARIANTS[variant]
    out = {}

    def init(rec):
        state, spec = dsgd.init_panel_state(
            build_model(cfg).init_params, make_optimizer("adamw", 1e-4), m,
            torch.Generator().manual_seed(0), mesh=mesh, wire=wire,
            residency=res)
        layout = dsgd.panel_state_layout(state, spec)
        for (kp, x), (_, b) in zip(ckpt_io._leaves_with_path(state),
                                   ckpt_io._leaves_with_path(layout)):
            k = ckpt_io._key_str(kp)
            if isinstance(x, torch.Tensor):
                assert tuple(x.shape) == b.local_shape, (k, x.shape, b)
                out[k] = x.numel() * x.element_size()
        return spec

    spec = trace(init).value
    return out, spec, mesh


@pytest.mark.parametrize("multi", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", POD_ARCHS)
def test_state_bytes_a_rank_equal_the_reference_shards(reference_shards,
                                                       arch, multi):
    for variant in dryrun.VARIANTS:
        got, spec, mesh = _port_state(arch, multi, variant)
        want = {k: v for k, v in
                reference_shards[f"{arch}|{multi}|{variant}"].items()
                if k not in ("step", "opt/step_count")}
        assert set(got) == set(want), (variant, set(got) ^ set(want))
        fsdp = mesh.shape["fsdp"]
        for k, n in got.items():
            if k.endswith("/scale") and fsdp > 1:
                # beside their columns: 1 / fsdp of a rows-only sidecar
                assert n * fsdp == want[k], (variant, k, n, want[k])
            else:
                assert n == want[k], (arch, multi, variant, k, n, want[k])


@pytest.fixture(scope="module")
def gloo_stats(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    spawn(4, "dryrun", tmp, timeout=240)
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(4)]


@pytest.mark.parametrize("label", list(DRY_CASES))
def test_recording_mesh_equals_mesh_stats_of_a_real_run(gloo_stats, label):
    wire, merger, res = DRY_CASES[label]
    cfg = get_config("olmo-1b").reduced()
    for rank in (0, 3):  # the ranks' collectives are alike: two corners
        real = gloo_stats[rank]
        r = dryrun.reckon(cfg, (1, 2, 2, 1), rank=rank, agents=DRY_M,
                          local_steps=DRY_H, batch=DRY_B, seq=DRY_S,
                          wire=wire, merger=merger, residency=res,
                          route="gloo")
        for part in ("init", "run"):
            assert (r[part]["calls"], r[part]["bytes"]) == (
                real[label][part]["calls"], real[label][part]["bytes"]), \
                (label, rank, part, r[part], real[label][part])
        assert r["host_reads"]["traced"] == 0
        assert r["run"]["calls"] > 10


def test_split_record_on_a_small_mesh(tmp_path):
    """reduced() olmo-1b on (1, 1, 2, 2) traced on the split route against
    the replica route, and its collectives against a real gloo run's."""
    cfg = get_config("olmo-1b").reduced()
    wire, merger, res = DRY_CASES[DRY_SPLIT_CASE]
    kw = dict(agents=DRY_M, local_steps=DRY_H, batch=DRY_B, seq=DRY_S,
              wire=wire, merger=merger, residency=res, route="gloo")
    split = dryrun.reckon(cfg, DRY_SPLIT_MESH, split=True, **kw)
    blk = "decoder.main.p0."
    assert {blk + "mixer.wq", blk + "ffn.w_out"} <= set(
        split["split"]["split"])
    assert split["split"]["summed"] == ["embed.table"]
    assert split["host_reads"]["traced"] == 0
    # one local step at a batch whose activations outweigh the state's
    # transients (16 x 512 tokens an agent), no evals: both routes
    big = dict(kw, local_steps=1, batch=16, seq=512, evals=False)
    one = {s: dryrun.reckon(cfg, DRY_SPLIT_MESH, split=s, **big)
           for s in (True, False)}
    assert one[False]["split"] is None
    assert one[True]["peak"] < 0.5 * one[False]["peak"]
    ratio = one[True]["segment0"]["flops"] / one[False]["segment0"]["flops"]
    assert 0.2 < ratio < 0.3, ratio
    logged = {k.split("/")[0] for k in split["run"]["log"]}
    assert {"model", "block"} <= logged
    spawn(4, "dryrun", tmp_path, args=("split",), timeout=240)
    for rank in (0, 3):
        real = torch.load(tmp_path / f"rank{rank}.pt",
                          weights_only=False)[DRY_SPLIT_CASE]
        r = split if rank == 0 else dryrun.reckon(
            cfg, DRY_SPLIT_MESH, rank=rank, split=True, **kw)
        for part in ("init", "run"):
            assert (r[part]["calls"], r[part]["bytes"]) == (
                real[part]["calls"], real[part]["bytes"]), (rank, part)


def test_recording_mesh_counts_the_ipc_route_as_the_mesh_plans_it():
    """On ranks sharing one card an all-reduce is a call a CUDA IPC
    buffer's worth of elements, its flat result and gathered parts alive
    beside the tensor (the traced peak); an all-gather is one call; the
    other routes one call each (``Mesh.plan``, which ``Mesh``'s own
    collectives follow)."""
    ipc = RecordingMesh.of(mesh_mod.mesh_of_shape((1, 2, 2, 1)),
                           route="cuda ipc")
    step = mesh_mod.IPC_BYTES // 4
    n = 2 * step + 5

    def prog(rec):
        ipc.all_reduce(torch.empty(n), "rows", op="max")
        ipc.all_gather(torch.empty(3, 7), "fsdp")

    r = trace(prog)
    assert ipc.log[("rows", "all_reduce_max")] == {"calls": 3,
                                                   "bytes": 4 * n}
    assert ipc.log[("fsdp", "all_gather")] == {"calls": 1, "bytes": 84}
    assert r.peak == 4 * (n + n + 2 * step)
    plan = ipc.plan(torch.empty(n), "all_reduce", "rows")
    assert plan.parts == ((0, step), (step, 2 * step), (2 * step, n))
    for route in ("nccl", "gloo", "gloo (host staged)"):
        other = RecordingMesh.of(ipc, route=route)
        assert other.plan(torch.empty(n), "all_reduce", "rows").parts == \
            ((0, n),)


def _matmul_params(model, cfg):
    """Parameters that enter a matmul: N less an untied input embedding
    and the norms' weights (a gather and elementwise scales)."""
    n = 0
    for kp, x in ckpt_io._leaves_with_path(flops_mod.param_shapes(model)):
        key = ckpt_io._key_str(kp)
        if "norm" in key or (key == "embed/table"
                             and not cfg.tie_embeddings):
            continue
        n += int(np.prod(x.shape))
    return n


@pytest.mark.parametrize("arch", ["olmo-1b", "phi3-mini-3.8b"])
def test_traced_local_step_flops_are_the_model_flops(arch):
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    b, S = 2, 64
    idle = [(np.eye(1, dtype=np.float32)[None], np.array([False]), None)]
    r = dryrun.reckon(cfg, (1, 1, 1, 1), agents=1, batch=b, seq=S,
                      rounds=idle, evals=False)
    mf = flops_mod.model_flops(model, ShapeConfig("step", S, b, "train"))
    attn_full = 2 * mf["attn_flops"]  # the whole square, not its half
    want = 6 * _matmul_params(model, cfg) * b * S + attn_full
    assert abs(r["segment0"]["flops"] - want) <= 1e-9 * want
    if arch == "olmo-1b":  # N itself: utils/flops.py's own count
        assert mf["model_flops"] + attn_full == want


def test_mesh_of_shape_reads_as_a_live_mesh():
    shape = (2, 16, 1, 16)
    for rank in (0, 17, 511):
        mesh = mesh_mod.mesh_of_shape(shape, rank)
        coord = np.unravel_index(rank, shape)
        assert [mesh.coord[a] for a in mesh_mod.AXES] == list(coord)
        assert rank in mesh.members["rows"] and rank in mesh.members["fsdp"]
        assert len(mesh.members["rows"]) == 32
        assert len(mesh.members["fsdp"]) == 1
        assert mesh_mod.num_agents(mesh) == 32
    with pytest.raises(ValueError, match="not on a mesh"):
        mesh_mod.mesh_of_shape(shape, 512)


@pytest.mark.parametrize("shape,variant", [
    ("prefill_32k", "panel"), ("decode_32k", "panel"),
    ("long_500k", "panel"), ("train_4k", "baseline"),
    ("train_4k", "seqpar"), ("train_4k", "moeshard")])
def test_dry_run_refuses_what_it_does_not_reckon(shape, variant):
    # the serve shapes: a family the split serve route does not split (the
    # "panel" variant there reads as the serve shapes' default, baseline)
    serving = shape != "train_4k"
    arch = "deepseek-v3-671b" if serving else "olmo-1b"
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", arch, "--shape", shape]
                    + ([] if serving else ["--variant", variant]))
    assert "A16d" in str(e.value)
    assert (shape if serving else variant) in str(e.value)
    if serving:
        with pytest.raises(SystemExit, match="serve shapes take"):
            dryrun.main(["--arch", "olmo-1b", "--shape", shape,
                         "--variant", variant])


RSS_SCRIPT = textwrap.dedent("""
    import json, resource, sys
    from repro_torch.launch import dryrun
    before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    rc = dryrun.main(["--arch", "olmo-1b", "--shape", "train_4k", "--mesh",
                      "single", "--variant", "panel", "--out", sys.argv[1]])
    after = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    print(json.dumps({"rc": rc, "kib": after - before}))
""")


def test_cli_record_at_16x16_allocates_no_state(tmp_path):
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", RSS_SCRIPT, str(tmp_path)],
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["rc"] == 0 and got["kib"] * 1024 < 1e9, got
    rec = json.loads((tmp_path / "olmo-1b_train_4k_16x16_panel.json")
                     .read_text())
    assert rec["status"] == "OK" and rec["chips"] == 256
    assert rec["agents"] == 16 and rec["agents_per_rank"] == 1
    mem = rec["memory"]
    assert 14.0e9 < mem["state_bytes"] < 14.2e9  # 12 B x 1,177,026,560
    assert mem["state_bytes"] == 12 * rec["panel_width"]
    assert mem["traced_peak_bytes"] >= mem["state_bytes"]
    assert mem["fits"] == (mem["per_device_total"] <= mem["card_bytes"])
    # one rank a card (NCCL): the peak and the rank's reserve, no IPC
    assert mem["ipc_bytes"] == 0
    assert mem["reserve_bytes"] == hardware.RANK_RESERVE_BYTES
    assert mem["per_device_total"] == (mem["traced_peak_bytes"]
                                       + mem["reserve_bytes"])
    assert rec["host_reads"]["traced"] == 0
    assert rec["collectives"]["per_line"]["rows"]["ranks"] == 16
    assert set(rec["roofline"]) == {"compute_s", "memory_s",
                                    "collective_s", "dominant"}
    # the split route: no replica note, what stayed whole named
    assert "note" not in rec
    assert rec["split"]["summed"] == ["embed.table"]
    assert "decoder.main.p0.mixer.wq" in rec["split"]["split"]
    assert "decoder.main.p0.norm1" not in rec["split"]["whole"]
    assert set(rec["collectives"]["per_line"]) >= {"rows", "model"}


# the serve records checked against resolve: (arch, shape, multi_pod,
# variant)
SERVE_RECORDS = [("olmo-1b", "prefill_32k", False, "baseline"),
                 ("phi3-mini-3.8b", "decode_32k", True, "baseline"),
                 ("yi-34b", "decode_32k", False, "baseline"),
                 ("gemma-2b", "long_500k", False, "baseline"),
                 ("gemma-2b", "prefill_32k", True, "flashxla"),
                 ("arctic-480b", "decode_32k", False, "baseline"),
                 ("arctic-480b", "prefill_32k", True, "baseline"),
                 ("qwen2-vl-72b", "prefill_32k", False, "baseline")]
BIG = ("yi-34b", "arctic-480b", "qwen2-vl-72b")


class _RefMesh:
    """A mesh of the reference's production shape and axis names."""

    def __init__(self, multi_pod):
        self.shape = ({"pod": 2, "data": 16, "model": 16} if multi_pod
                      else {"data": 16, "model": 16})
        self.axis_names = tuple(self.shape)


def _block_bytes(spec, tree, mesh, rules):
    from repro_torch.models.sharding import resolve
    total = 0
    for ent, x in zip(_flat(resolve(spec, tree, mesh, rules)), _flat(tree)):
        n = x.element_size()
        for dim, e in zip(x.shape, ent):
            names = () if e is None else ((e,) if isinstance(e, str) else e)
            n *= dim // int(np.prod([mesh.shape[a] for a in names] or [1]))
        total += n
    return total


def _flat(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    return [tree]


@pytest.mark.parametrize("arch,shape,multi,variant", SERVE_RECORDS)
def test_serve_record_bytes_are_the_resolved_blocks(arch, shape, multi,
                                                    variant, tmp_path):
    from repro_torch.configs import INPUT_SHAPES
    from repro_torch.models.sharding import serve_rules
    from repro_torch.models.tensor_parallel import serve_big
    rec = dryrun.run_serve_pair(arch, shape, multi, variant, tmp_path)
    assert rec["status"] == "OK", rec.get("traceback", rec)
    eff = "gemma-2b-sw" if shape == "long_500k" else arch
    cfg = get_config(eff).replace(param_dtype="bfloat16")
    model = build_model(cfg)
    mesh = _RefMesh(multi)
    rules = serve_rules(mesh, serve_big(cfg))
    assert rec["big"] == serve_big(cfg) == (arch in BIG)
    meta = model.init_params(None, torch.device("meta"))
    assert rec["memory"]["param_bytes"] == _block_bytes(
        model.param_spec(), meta, mesh, rules)
    sh = INPUT_SHAPES[shape]
    caches = model.init_cache(sh.global_batch, sh.seq_len,
                              device=torch.device("meta"))
    assert rec["memory"]["cache_bytes"] == _block_bytes(
        model.cache_spec(), caches, mesh, rules)
    assert rec["chips"] == (512 if multi else 256)
    assert rec["attn_block"] == (512 if variant == "flashxla" else 0)
    assert rec["memory"]["traced_peak_bytes"] >= (
        rec["memory"]["param_bytes"] + rec["memory"]["cache_bytes"])
    assert rec["cost"]["flops_per_device"] > 0
    assert rec["collectives"]["calls"] > 0
    if shape == "long_500k":
        assert rec["note"] == "sliding-window variant (window=4096)"
    assert os.path.exists(tmp_path / f"{arch}_{shape}_{rec['mesh']}_"
                          f"{variant}.json")


def test_serve_shapes_skip_and_refuse_as_named(tmp_path):
    for arch in ("olmo-1b", "phi3-mini-3.8b", "yi-34b"):
        rec = dryrun.run_serve_pair(arch, "long_500k", False)
        assert rec["status"] == "SKIP"
        assert rec["reason"] == (
            "full quadratic attention family; long_500k reserved for "
            "sub-quadratic archs (DESIGN.md §5)")
    for arch in ("arctic-480b", "qwen2-vl-72b"):  # split, full attention
        rec = dryrun.run_serve_pair(arch, "long_500k", True)
        assert rec["status"] == "SKIP", rec
        assert rec["reason"] == dryrun.LONG_SKIP
    for arch in ("xlstm-1.3b", "recurrentgemma-2b", "seamless-m4t-medium",
                 "deepseek-v3-671b"):
        for shape in dryrun.SERVE_SHAPES:
            rec = dryrun.run_serve_pair(arch, shape, True)
            assert rec["status"] == "REFUSED"
            assert arch in rec["reason"] and "A16d's second" in \
                rec["reason"]


@pytest.mark.parametrize("arch", ["arctic-480b", "qwen2-vl-72b"])
def test_split_families_train_record_is_split(arch, tmp_path, monkeypatch):
    """arctic-480b's and qwen2-vl-72b's ``train_4k`` record at 16 x 16 is
    traced on the split route: no replica note, the leaves split, whole
    and summed named (arctic's expert banks split by experts, its router
    summed; qwen2-vl's heads split, its kv head whole and summed); the
    card's fit as the dry run finds it. At the published widths cut to
    one layer (the CLI's full depth takes 305 s for arctic, 79 s for
    qwen2-vl here: its layers are traced one by one)."""
    monkeypatch.setattr(dryrun, "get_config",
                        lambda a: get_config(a).replace(num_layers=1))
    rec = dryrun.run_pair(arch, "train_4k", False, "panel", tmp_path)
    assert rec["status"] == "OK", rec.get("traceback", rec)
    assert "note" not in rec
    blk = "decoder.main.p0."
    split = rec["split"]
    assert blk + "mixer.wq" in split[
        "whole" if arch == "arctic-480b" else "split"]
    if arch == "arctic-480b":
        assert {blk + "ffn.w_in", blk + "ffn.w_out",
                blk + "ffn.dense.w_in"} <= set(split["split"])
        assert split["summed"] == [blk + "ffn.router"]
    else:
        assert {blk + "mixer.wk", blk + "mixer.wv"} <= set(split["summed"])
        assert blk + "ffn.w_in" in split["split"]
    assert rec["host_reads"]["traced"] == 0
    mem = rec["memory"]
    assert mem["fits"] == (mem["per_device_total"] <= mem["card_bytes"])
    print(f"{arch} train_4k 16x16 panel: state {mem['state_bytes']} B, "
          f"peak {mem['traced_peak_bytes']} B, device "
          f"{mem['per_device_total']} B, fits {mem['fits']}")
    assert set(rec["collectives"]["per_line"]) >= {"rows", "model",
                                                   "block"}


def _shapes(tree):
    return {k: tuple(v.shape) for k, v in tree.items()}


@pytest.mark.parametrize("arch", ["qwen2-vl-72b", "seamless-m4t-medium"])
def test_batches_are_the_reference_input_specs(arch):
    """The dry run's training batches (an agent's, at train_4k's 16 x 16
    mesh) and prefill batch have the reference's ``input_specs`` shapes:
    qwen2-vl's seq - mm_prefix tokens (3,840) beside its 256 patch rows,
    seamless's frames of seq rows."""
    from repro.configs import INPUT_SHAPES as REF_SHAPES
    from repro.configs import get_config as ref_get_config
    from repro.models import build_model as ref_build_model
    from repro_torch.configs import INPUT_SHAPES
    cfg = get_config(arch)
    ref = ref_build_model(ref_get_config(arch))
    m = mesh_mod.num_agents(mesh_mod.mesh_of_shape(
        mesh_mod.training_shape(cfg.dist.agents_per_pod)))
    train = INPUT_SHAPES["train_4k"]
    b = train.global_batch // m
    got = {k: v[0, 0] for k, v in dryrun._batches(
        cfg, 1, 1, m, b, train.seq_len).items()}
    want = ref.input_specs(REF_SHAPES["train_4k"], agents=m)
    assert _shapes(got) == _shapes(want)
    if arch == "qwen2-vl-72b":
        assert got["tokens"].shape == (m, b, 3840)
        assert got["patch_embeds"].shape == (m, b, 256, cfg.d_model)
    pre = INPUT_SHAPES["prefill_32k"]
    got = dryrun.serve_batch(cfg.replace(param_dtype="bfloat16"),
                             pre.global_batch, pre.seq_len)
    want = ref.input_specs(REF_SHAPES["prefill_32k"])
    assert _shapes(got) == _shapes(want)


def test_reckon_step_traces_a_rank_share_of_one_step():
    """``reckon_step`` (phase 12h's reckon: one agent's step on the split
    route, no panel) at arctic's ``reduced()`` on (1, 1, 2, 2): the rank's
    pieces' bytes (its experts, heads, d_ff columns and vocabulary), a peak
    over the pieces and their gradients, no host read, and the step's
    collectives over the model line (the heads', experts' and
    vocabulary's parts) and the fsdp line (the token count, the experts'
    counts and probabilities over the agent's whole batch)."""
    from repro_torch.models import tensor_parallel as tp
    cfg = get_config("arctic-480b").reduced()
    shape = (1, 1, 2, 2)
    r = dryrun.reckon_step(cfg, shape, batch=4, seq=16)
    split = tp.Split(mesh_mod.mesh_of_shape(shape))
    model = build_model(cfg)
    plan = tp.leaf_plan(cfg, split, tp.train_shardings(
        model, split.mesh, 1))
    pieces = tp.train_pieces(model.init_params(None, torch.device("meta")),
                             plan, split)
    want = sum(x.numel() * x.element_size()
               for _, x in ckpt_io._leaves_with_path(pieces))
    assert r["param_bytes"] == want
    whole = sum(int(np.prod(x.shape)) * 4 for _, x in
                ckpt_io._leaves_with_path(flops_mod.param_shapes(model)))
    assert want < 0.75 * whole  # the banks, heads and vocabulary halved
    assert r["peak"] >= 2 * want
    assert r["host_reads"]["traced"] == 0
    assert {k.split("/")[0] for k in r["run"]["log"]} == {"model", "fsdp"}
    assert r["split"]["summed"] == ["decoder.main.p0.ffn.router"]
