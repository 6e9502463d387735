"""Sharded checkpoints: a sharded run's state saved by each rank in parts,
restored on the same mesh, re-sharded onto another or onto one process,
assembled into the one-process blob, and a killed sharded launcher resumed.

On the (1, 2, 2, 1) mesh of 4 gloo ranks (``tests/_torch_dist.py``: the
``ckpt_save`` and ``ckpt_restore`` modes) three states of an olmo-1b run
at the launcher's CPU preset (``CKPT_CASES``: the f32 wire; int8_ef with
fisher statistics under ``moments=int8,stats=int8r``, so grouped scales
beside their columns
and per-row scales whole on every column shard; topk with ties under the
fault plan ``2@1-2``, so a mirror panel and per-agent step counts) are
saved after rounds 0 and 1 as steps 1 and 2, in parts of 64 KiB (leaves
split over several). Then:

* restored on the same mesh, on (1, 4, 1, 1) and on one process, every
  leaf of every rank is the one-process run's block bit for bit, the wire
  generator's state included;
* ``assemble``'s blob has the one-process checkpoint's array table byte for
  byte, and the reference package restores it and places it with
  ``panel_state_shardings`` on its (1, 2, 2, 2) debug mesh exactly;
* a part missing on one rank, or corrupt, sends every rank to step 1;
* a reference-format whole blob restores on the mesh (its int32 counters
  widened, the caller's wire generator kept);
* in one process, a leaf of another shape or a missing key raises from a
  whole blob (``Checkpointer.restore_latest``) and from a sharded step
  alike, and a missing newest file warns and falls back.

The launcher: a run on the (1, 2, 2, 1) mesh killed after its first
segment's checkpoint and resumed on the same mesh writes the uninterrupted
sharded run's history and event stream byte for byte; resumed on (1, 4, 1,
1) and on one process its losses, evals and comm costs are bit for bit and
its grad norms and Xi within 1e-6 relative (summed over the ranks in
another order); every resume's merged model (``--save-merged``) is the
uninterrupted run's byte for byte; a one-process run's checkpoint resumes
on the mesh.
"""
import json
import os
import shutil
import textwrap

import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401
from _torch_dist import CKPT_CASES, CKPT_PART_BYTES, spawn
from repro_torch.checkpoint import assemble, restore_latest
from repro_torch.checkpoint import io as ckpt_io

RTOL = 1e-6
LABELS = list(CKPT_CASES)


def _load(tmp, world):
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ckpt")
    spawn(4, "ckpt_save", tmp, timeout=300)
    yield tmp, _load(tmp, 4)
    shutil.rmtree(tmp, ignore_errors=True)  # the checkpoints: tens of MB


def _same_block(got, single, label, step):
    """Every leaf of a rank's restored blocks equals the one-process run's
    block at the same index, bit for bit."""
    want = single[f"single.{label}.{step}"]
    assert set(got) == set(want)
    for key, (t, index, shape, _) in got.items():
        whole = want[key][0]
        assert tuple(whole.shape) == tuple(shape), key
        block = whole[tuple(slice(lo, hi) for lo, hi in index)]
        assert t.dtype == block.dtype and torch.equal(t, block), (label, key)


def test_sharded_save_is_parts_of_the_one_process_state(saved):
    """What the ranks hold before saving is the one-process state's blocks
    (the premise of every restore below), and every owned block of every
    leaf is saved exactly once across the ranks' parts."""
    tmp, ranks = saved
    for label, step in [(label, 2) for label in LABELS] + [("f32", 1)]:
        for r in ranks:
            _same_block(r[f"{label}.{step}"], ranks[0], label, step)
        owned = {}
        for r in ranks:
            for key, (t, _, _, owner) in r[f"{label}.{step}"].items():
                if owner:
                    owned[key] = owned.get(key, 0) + t.numel()
        for key, (_, _, shape, _) in ranks[0][f"{label}.{step}"].items():
            assert owned[key] == int(np.prod(shape)), (label, key)
    man = json.loads((tmp / "case0" / "MANIFEST.json").read_text())
    assert [c["step"] for c in man["checkpoints"]] == [1, 2]
    parts = man["checkpoints"][-1]["parts"]
    assert {p["rank"] for p in parts} == {0, 1, 2, 3}
    assert all(p["bytes"] <= CKPT_PART_BYTES + 4096 for p in parts)


def _restore(tmp, saved_tmp, shape, world, items):
    spawn(world, "ckpt_restore", tmp, [shape, *items], timeout=240)
    return _load(tmp, world)


@pytest.fixture(scope="module")
def same_mesh(saved, tmp_path_factory):
    """The three cases restored on (1, 2, 2, 1); and the f32 case with a
    part of rank 1's step 2 missing, and with one of rank 2's corrupt."""
    src, _ = saved
    tmp = tmp_path_factory.mktemp("restore_same")
    missing, corrupt = tmp / "missing", tmp / "corrupt"
    shutil.copytree(src / "case0", missing)
    shutil.copytree(src / "case0", corrupt)
    os.remove(missing / "step_00000002" / "r00001_p001.ckpt")
    bad = corrupt / "step_00000002" / "r00002_p000.ckpt"
    raw = bytearray(bad.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    bad.write_bytes(bytes(raw))
    items = [f"{i}:{src / f'case{i}'}" for i in range(len(LABELS))]
    items += [f"0:{missing}", f"0:{corrupt}"]
    yield _restore(tmp, src, "1,2,2,1", 4, items), items
    shutil.rmtree(tmp, ignore_errors=True)


@pytest.mark.parametrize("label", LABELS)
def test_restore_on_the_same_mesh_bit_for_bit(saved, same_mesh, label):
    src, ranks = saved
    out, items = same_mesh
    path = items[LABELS.index(label)].split(":", 1)[1]
    for r in out:
        rec = r[path]
        assert rec["step"] == 2 and rec["meta"]["round"] == 2
        assert not rec["warnings"]
        _same_block(rec["blocks"], ranks[0], label, 2)


@pytest.mark.parametrize("which", ["missing", "corrupt"])
def test_torn_part_sends_every_rank_to_the_previous_step(saved, same_mesh,
                                                         which):
    _, ranks = saved
    out, items = same_mesh
    path = items[3 if which == "missing" else 4].split(":", 1)[1]
    for r in out:
        rec = r[path]
        assert rec["step"] == 1 and rec["meta"]["round"] == 1
        _same_block(rec["blocks"], ranks[0], "f32", 1)
        assert len(rec["warnings"]) == 1 and "step 2" in rec["warnings"][0]
    # the rank that read the bad part names it; the others, another rank
    bad_rank = 1 if which == "missing" else 2
    assert ("corrupt on rank %d" % bad_rank) in \
        out[bad_rank][path]["warnings"][0]
    assert "torn on another rank" in out[0][path]["warnings"][0]


@pytest.fixture(scope="module")
def resharded(saved, tmp_path_factory):
    """The three cases re-sharded onto (1, 4, 1, 1), and a reference-format
    whole blob of the f32 case's step 2 restored on (1, 2, 2, 1)."""
    src, ranks = saved
    tmp = tmp_path_factory.mktemp("restore_other")
    ref = tmp / "ref"
    ref.mkdir()
    _reference_blob(src / "one0" / "step_00000002.ckpt",
                    ref / "step_00000002.ckpt")
    items = [f"{i}:{src / f'case{i}'}" for i in range(len(LABELS))]
    other = _restore(tmp / "a", src, "1,4,1,1", 4, items)
    refd = _restore(tmp / "b", src, "1,2,2,1", 4, [f"0:{ref}"])
    yield other, items, refd, str(ref)
    shutil.rmtree(tmp, ignore_errors=True)


def _reference_blob(one, out):
    """The one-process blob rewritten as the reference's launcher saves
    its tree: int32 scalar counters and a jax.random key in place of the
    wire generator."""
    from repro.checkpoint import io as ref_io
    flat, meta = ckpt_io._unpack_blob(ckpt_io._read(str(one)))
    tree = {}
    for key, rec in flat.items():
        a = np.frombuffer(rec["data"], dtype=rec["dtype"]).reshape(
            rec["shape"])
        if key == "wire_gen":
            continue
        if key == "state/opt/step_count":
            a = np.int32(a[0])
        elif key == "state/step":
            a = np.int32(a)
        node = tree
        *path, last = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[last] = a
    tree["key"] = np.array([0, 7], np.uint32)
    ref_io.save(str(out), tree, meta=meta)


@pytest.mark.parametrize("label", LABELS)
def test_reshard_onto_another_mesh_bit_for_bit(saved, resharded, label):
    _, ranks = saved
    other, items, _, _ = resharded
    path = items[LABELS.index(label)].split(":", 1)[1]
    for r in other:
        rec = r[path]
        assert rec["step"] == 2 and not rec["warnings"]
        _same_block(rec["blocks"], ranks[0], label, 2)


def test_reference_whole_blob_restores_on_the_mesh(saved, resharded):
    _, ranks = saved
    _, _, refd, path = resharded
    want = ranks[0]["single.f32.2"]
    for r in refd:
        rec = r[path]
        assert rec["step"] == 2
        blocks = dict(rec["blocks"])
        gen = blocks.pop("wire_gen")[0]
        # no generator state in the reference's blob: the caller's, fresh
        assert torch.equal(gen, torch.Generator().manual_seed(7).get_state())
        for key, (t, index, _, _) in blocks.items():
            block = want[key][0][tuple(slice(lo, hi) for lo, hi in index)]
            assert torch.equal(t, block), key


@pytest.mark.parametrize("label", LABELS)
def test_reshard_onto_one_process_bit_for_bit(saved, label):
    from _torch_dist import CKPT_RES, _ckpt_run
    src, ranks = saved
    [(like, _)], _ = _ckpt_run(label, None, rounds=0)
    step, tree, meta = restore_latest(
        str(src / f"case{LABELS.index(label)}"), like,
        residency=CKPT_RES[label])
    assert step == 2 and meta["round"] == 2
    want = ranks[0][f"single.{label}.2"]
    for kp, leaf in ckpt_io._leaves_with_path(tree):
        key = ckpt_io._key_str(kp)
        got = torch.as_tensor(leaf)
        assert got.dtype == want[key][0].dtype and torch.equal(
            got, want[key][0]), (label, key)


@pytest.mark.parametrize("label", LABELS)
def test_assemble_is_the_one_process_blob(saved, label):
    src, _ = saved
    i = LABELS.index(label)
    path = assemble(str(src / f"case{i}"), 2, str(src / f"asm{i}.ckpt"))
    a = ckpt_io._msgpack.unpackb(ckpt_io._read(path))
    b = ckpt_io._msgpack.unpackb(ckpt_io._read(
        str(src / f"one{i}" / "step_00000002.ckpt")))
    assert bytes(a["payload"]) == bytes(b["payload"])
    assert json.loads(bytes(a["meta"])) == json.loads(bytes(b["meta"]))


REFERENCE_PLACES = textwrap.dedent("""
    import json, sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.checkpoint import restore
    from repro.configs import get_config
    from repro.core import dsgd
    from repro.launch import mesh as mesh_mod
    from repro.models import build_model
    from repro.optim import make_optimizer
    path, wire, merger, res, ngen = sys.argv[1:6]
    res = None if res == "-" else res
    mesh = mesh_mod.make_debug_mesh(agents=2, fsdp=2, model=2)
    model = build_model(get_config("olmo-1b").reduced(d_model=128, layers=2,
                                                      vocab=256))
    opt = make_optimizer("adamw", 3e-3, weight_decay=5e-4, total_steps=6)
    from repro.core import panel as panel_mod
    key = jax.random.PRNGKey(0)
    st, spec = dsgd.init_panel_state(model.init_params, opt, 4, key,
                                     wire=wire, merger=merger,
                                     residency=res)
    params = jax.eval_shape(
        lambda k: dsgd._init_agent_params(model.init_params, 4, k, False),
        key)
    spec = panel_mod.with_merger(panel_mod.with_residency(
        panel_mod.with_wire(panel_mod.shard_spec(
            panel_mod.make_spec(params), mesh), wire), res), merger)
    like = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), st)
    like["opt"]["step_count"] = np.zeros(4, np.int64)
    like["step"] = np.zeros((), np.int64)
    host = restore(path, {"state": like,
                          "wire_gen": np.zeros(ngen, np.uint8)})["state"]
    host["opt"]["step_count"] = np.int32(host["opt"]["step_count"][0])
    host["step"] = np.int32(host["step"])
    sh = dsgd.panel_state_shardings(st, spec)
    placed = jax.device_put(host, sh)
    exact = all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in
                zip(jax.tree.leaves(host), jax.tree.leaves(placed)))
    laid = all(b.sharding.is_equivalent_to(s, b.ndim) for s, b in
               zip(jax.tree.leaves(sh), jax.tree.leaves(placed)))
    print(json.dumps({"exact": exact, "laid": laid,
                      "devices": jax.device_count(),
                      "leaves": len(jax.tree.leaves(placed))}))
""")


def test_assembled_blob_restores_in_the_reference(saved, multidevice):
    """The reference's ``checkpoint.io.restore`` takes the assembled blob
    of the int8_ef / fisher / int8-moments case and places it with its
    ``panel_state_shardings`` on its (1, 2, 2, 2) debug mesh exactly."""
    src, _ = saved
    path = assemble(str(src / "case1"), 2, str(src / "ref_asm.ckpt"))
    wire, merger, res, _ = CKPT_CASES["int8_ef fisher int8"]
    rec = multidevice(REFERENCE_PLACES.replace(
        "sys.argv[1:6]", repr([path, wire, merger, res, torch.Generator()
                                .get_state().numel()])), devices=8)
    assert rec["devices"] == 8 and rec["exact"] and rec["laid"]
    # the panel, m and v {q, scale}, the count, the step, the residual and
    # fisher {q, scale}
    assert rec["leaves"] == 10


ARGS = ["--rounds", "4", "--segment", "2", "--agents", "4", "--local-steps",
        "2", "--batch", "4", "--seq", "32", "--device", "cpu", "--wire",
        "int8_ef", "--merge", "fisher", "--telemetry"]
TAG = "olmo-1b_final_merge_a0.1_mfisher.json"
MESH = ["--mesh", "1,2,2,1"]
# summed over the ranks in another order on another layout: the scalar
# norms within RTOL, the per-agent columns within 1e-4 (the bounds of
# test_torch_sharded_options.py)
NORMS = {"grad_norm": RTOL, "grad_norm_max": RTOL, "consensus": RTOL,
         "grad_norm_agent": 1e-4, "dist_to_mean": 1e-4}


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """An uninterrupted run on (1, 2, 2, 1); the same run killed after its
    first segment's checkpoint and resumed on (1, 2, 2, 1), (1, 4, 1, 1)
    and one process; a one-process run killed likewise and resumed on
    (1, 2, 2, 1)."""
    tmp = tmp_path_factory.mktemp("launch")

    def run(world, name, extra, check=True):
        out = tmp / name
        return spawn(world, "launch", out, ARGS + [
            "--out", str(out), "--events", str(out / "ev.jsonl"),
            "--save-merged", str(out / "merged.ckpt")] + extra,
            timeout=180, check=check)

    def resume(world, name, src, ck, extra):
        (tmp / name).mkdir()
        shutil.copy(tmp / src / "ev.jsonl", tmp / name / "ev.jsonl")
        shutil.copytree(tmp / ck, tmp / f"ck_{name}")
        run(world, name, extra + ["--resume", "--checkpoint-dir",
                                  str(tmp / f"ck_{name}")])

    run(4, "base", MESH)
    kill = ["--checkpoint-every", "1", "--die-after-segments", "1"]
    killed = run(4, "kill", MESH + kill + ["--checkpoint-dir",
                                          str(tmp / "ck")], check=False)
    killed1 = run(1, "kill1", kill + ["--checkpoint-dir", str(tmp / "ck1")],
                  check=False)
    resume(4, "same", "kill", "ck", MESH)
    resume(4, "other", "kill", "ck", ["--mesh", "1,4,1,1"])
    resume(1, "one", "kill", "ck", [])
    resume(4, "from_one", "kill1", "ck1", MESH)
    yield tmp, killed + killed1
    shutil.rmtree(tmp, ignore_errors=True)


def _history(d):
    return json.loads((d / TAG).read_text())["history"]


def _events(d):
    return [json.loads(ln) for ln in (d / "ev.jsonl").read_text()
            .splitlines()]


def test_killed_sharded_launcher_resumes_on_the_same_mesh(launched):
    tmp, killed = launched
    assert all(p.returncode == -9 for p in killed)  # SIGKILL
    assert (tmp / "same" / TAG).read_bytes() != b""
    assert _history(tmp / "same") == _history(tmp / "base")
    assert (tmp / "same" / "ev.jsonl").read_bytes() == \
        (tmp / "base" / "ev.jsonl").read_bytes()
    assert (tmp / "same" / "merged.ckpt").read_bytes() == \
        (tmp / "base" / "merged.ckpt").read_bytes()


def _close(a, b, what):
    if isinstance(a, list):
        assert len(a) == len(b), what
        for x, y in zip(a, b):
            _close(x, y, what)
    else:
        np.testing.assert_allclose(a, b, rtol=NORMS[what], atol=0)


@pytest.mark.parametrize("name", ["other", "one", "from_one"])
def test_resumed_on_another_layout(launched, name):
    tmp, _ = launched
    got, want = _history(tmp / name), _history(tmp / "base")
    assert len(got) == len(want) == 4
    for x, y in zip(got, want):
        for k in x:
            if k in NORMS:
                _close(x[k], y[k], k)
            else:
                assert x[k] == y[k], (name, k, x, y)
    assert got[-1]["consensus"] == 0.0
    assert got[-1]["merged_eval"] == got[-1]["local_eval"]
    ev, base = _events(tmp / name), _events(tmp / "base")
    assert [e["type"] for e in ev] == [e["type"] for e in base]
    for x, y in zip(ev, base):
        assert set(x) == set(y)
        for k in x:
            if k in NORMS:
                _close(x[k], y[k], k)
            else:
                assert x[k] == y[k], (name, k)
    # the merged model: column results, the one-process bits on any layout
    assert (tmp / name / "merged.ckpt").read_bytes() == \
        (tmp / "base" / "merged.ckpt").read_bytes()


@pytest.mark.parametrize("how", ["restore", "restore_latest"])
def test_restored_tensors_need_no_garbage_collector(tmp_path, how):
    """A restored leaf is freed once the caller drops it, with the cyclic
    collector off: no reference cycle holds the restore's tensors (a
    resumed run would otherwise keep its restored panel beside the one
    its first mix makes, 1.9 GB a rank at full width)."""
    import gc
    import weakref
    tree = {"a": {"x": torch.randn(4, 5)}, "b": torch.zeros(3)}
    ckpt_io.save(str(tmp_path / "step_00000001.ckpt"), tree)
    gc.disable()
    try:
        got = (ckpt_io.restore(str(tmp_path / "step_00000001.ckpt"), tree)
               if how == "restore" else restore_latest(str(tmp_path),
                                                       tree)[1])
        ref = weakref.ref(got["a"]["x"])
        del got
        assert ref() is None
    finally:
        gc.enable()


@pytest.mark.parametrize("kind", ["whole", "sharded"])
def test_a_leaf_of_another_shape_raises_instead_of_falling_back(tmp_path,
                                                                kind):
    """Structure drift raises naming the key, from a whole blob (through
    ``Checkpointer.restore_latest``, which is ``restore_latest``) and from
    a sharded step alike; a missing newest file warns and falls back."""
    tree = {"a": torch.arange(12.0).reshape(4, 3), "b": torch.arange(5.0)}
    if kind == "whole":
        ck = ckpt_io.Checkpointer(str(tmp_path), keep=2)
    else:
        ck = ckpt_io.ShardedCheckpointer(str(tmp_path), None, keep=2)
    for step in (1, 2):
        ck.save(step, tree, *([] if kind == "whole" else [None]),
                meta={"round": step})

    def back(like):
        return (ck.restore_latest(like) if kind == "whole"
                else restore_latest(str(tmp_path), like))

    with pytest.raises(ValueError, match="'a' has shape"):
        back({"a": torch.zeros(3, 4), "b": torch.zeros(5)})
    with pytest.raises(KeyError, match="missing key 'c'"):
        back({**tree, "c": torch.zeros(1)})
    step, got, meta = back({"a": torch.zeros(4, 3), "b": torch.zeros(5)})
    assert step == 2 and meta["round"] == 2
    assert all(torch.equal(got[k], tree[k]) for k in tree)
    newest = (tmp_path / "step_00000002.ckpt" if kind == "whole" else
              tmp_path / "step_00000002" / "r00000_p000.ckpt")
    newest.unlink()
    with pytest.warns(RuntimeWarning, match="step 2|step_00000002"):
        step, got, _ = back(tree)
    assert step == 1 and torch.equal(got["b"], tree["b"])
