"""The sharded run's other options (torch.distributed, gloo on the CPU):
every lossy wire codec, merge operator, residency storage, live mask and
telemetry column on a sharded panel, against the port's single-process
route and the JAX package's replicated ``merge_row``.

Every multi-rank run is a set of subprocesses (``tests/_torch_dist.py``:
a ``file://`` rendezvous in the test's tmp dir, one intra-op thread a rank,
its own timeout), on the (1, 2, 2, 1) mesh of 4 ranks (agents over 2 ranks,
columns over 2) with gather and selection slabs far below the shards'
width (several slabs a shard, a ragged last one):

* ``codecs``: int8, int8_ef, int8_ef with the kernel's draws, int4,
  int4_ef, topk (exact threshold) and topk on the strided threshold route
  (a sample of 60 of 2048 columns: 31 and 30 samples in the two shards):
  the encode with supplied uniforms, the mix with the folded mean, the
  error-feedback or mirror panel and the global merge bit for bit with one
  process (the generator route's uniforms are the whole panel's, cut to
  the shard); Xi within ``XI_RTOL`` (summed over the ranks in another
  order);
* ``merges``: every operator's ``merge_row`` bit for bit with one process
  (``weighted`` within ``WEIGHTED_RTOL``: its per-agent distances are the
  column shards' partial sums), with and without a live mask, and within
  ``REF_RTOL`` of the reference's jitted replicated ``merge_row``; a lossy
  ``merge_panel`` under a live mask; the distributed TIES thresholds
  (a radix select over the column shards) bit for bit with
  ``ties_thresh_ref`` on a random row, a row of tied magnitudes, a row
  with a NaN and a row of zeros;
* ``options``: reduced() olmo-1b segments (4 agents, a gossip round,
  another, the merge) under ``OPTION_CASES``: the panels, the moments
  (stored q and scales, companded, grouped and per-row, bf16), the
  error-feedback panels and the statistics bit for bit, the mean loss,
  the per-agent losses, the live trits and wire bytes equal; the grad
  norms and Xi within ``XI_RTOL``, the per-agent grad norms and distances
  to the mean within ``COL_RTOL``; ``weighted``'s final panel within
  ``WEIGHTED_RTOL``.

On the (1, 2, 2, 2) ``--mesh debug`` mesh of 8 ranks the launcher with
each flag that a sharded run now takes writes the history of the launcher
without a mesh (``LAUNCH_CASES``: the losses and evals bit for bit, the
grad norms and Xi within ``XI_RTOL``, the last Xi 0.0; under
``--telemetry`` rank 0's event stream carries every agent's columns).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401
from _torch_dist import (CODEC_CASES, MERGE_LIVE, MERGE_OPS, OPTION_CASES,
                         _codec, _merge_inputs, _option_inputs, spawn)
from repro import merging as ref_merging
from repro_torch.kernels.ref import ties_thresh_ref

# Xi and the grad norms: sums over whole rows, summed over the ranks in
# another order (test_torch_sharded.py's bound)
XI_RTOL = 1e-6
# weighted: its per-agent squared distances summed over the column shards
# (the reference's own bound for its sharded merge_row)
WEIGHTED_RTOL = 1e-5
# the per-agent telemetry columns: a row's norm from its shards' sums of
# squares (the CPU's float32 row norm of 1.9 M columns is itself ~1e-5
# from the float64 one) and the float64 distances summed per shard
COL_RTOL = 1e-4
# the reference's jitted merge_row (XLA's order of its mean and sums)
REF_RTOL = 1e-5


def _load(tmp, world):
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def bits_equal(a, b):
    """Same dtype, shape and bit patterns (a NaN equals its own bits)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype.is_floating_point:
        as_int = {2: torch.int16, 4: torch.int32, 8: torch.int64}
        it = as_int[a.element_size()]
        return torch.equal(a.contiguous().view(it), b.contiguous().view(it))
    return torch.equal(a, b)


@pytest.fixture(scope="module")
def codecs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("codecs")
    spawn(4, "codecs", tmp, timeout=120)
    return _load(tmp, 4)


@pytest.mark.parametrize("name", CODEC_CASES)
def test_sharded_codec_equals_single_process(codecs, name):
    s = codecs[0]
    keys = [k for k in s if k.startswith(f"{name}.")]
    parts = {k.split(".")[-2] for k in keys}
    want = {"mix", "mean", "gm", "xi"}
    codec = _codec(name)
    if codec.error_feedback:
        want |= {"err", "gm_err"}
    if codec.needs_key and name != "int8_ef native":
        want.add("view")  # the encode with supplied uniforms
    assert parts == want, parts
    for k in keys:
        got, ref = s[k], s[f"single.{k}"]
        assert all(bits_equal(o[k], got) for o in codecs), k
        if k.endswith(".xi.xi"):
            np.testing.assert_allclose(float(got), float(ref), rtol=XI_RTOL)
        else:
            assert bits_equal(got, ref), k
    # the merge's rows identical, the mirror reset to them for topk
    for k in ("float32", "bfloat16"):
        gm = s[f"{name}.gm.{k}"]
        assert bits_equal(gm, gm[:1].expand(gm.shape).contiguous())


@pytest.fixture(scope="module")
def merges(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("merges")
    spawn(4, "merges", tmp, timeout=120)
    return _load(tmp, 4)


@pytest.mark.parametrize("name", MERGE_OPS)
def test_sharded_merge_row_equals_single_process(merges, name):
    s = merges[0]
    for tag in ("all", "live"):
        for k in ("float32", "bfloat16"):
            key = f"{name}.{tag}.{k}"
            got, ref = s[key], s[f"single.{key}"]
            assert got.shape == ref.shape and got.dtype == torch.float32
            assert all(bits_equal(o[key], got) for o in merges), key
            if name == "weighted":
                np.testing.assert_allclose(got.numpy(), ref.numpy(),
                                           rtol=WEIGHTED_RTOL, atol=1e-6)
            else:
                assert bits_equal(got, ref), key


def _ref_panel(tree_panel):
    return {k: jnp.asarray(v.float().numpy()).astype(
        jnp.bfloat16 if v.dtype == torch.bfloat16 else jnp.float32)
        for k, v in tree_panel.items()}


@pytest.mark.parametrize("name", MERGE_OPS)
def test_sharded_merge_row_matches_reference(merges, name):
    _, full, _, _ = _merge_inputs()
    s = merges[0]
    stats = {}
    for key, v in s.items():
        if key.startswith(f"stats.{name}."):
            _, _, n, k = key.split(".")
            stats.setdefault(n, {})[k] = jnp.asarray(v.numpy())
    mg = ref_merging.get_merger(name)
    for tag, live in (("all", None), ("live", np.asarray(MERGE_LIVE))):
        if name == "ties" and live is not None:
            want = _ref_ties_on_port_mean(full, live)
        else:
            # var eagerly: jit contracts its m2 - mu^2 into a fused
            # multiply-add, and 1 / (var + eps) magnifies that cancellation
            # to 1e-2 (the port follows the eager expression bit for bit)
            fn = lambda p, st: mg.merge_row(p, stats=st or None, live=live)
            want = (fn if name == "var" else jax.jit(fn))(
                _ref_panel(full), stats)
        for k in ("float32", "bfloat16"):
            np.testing.assert_allclose(
                s[f"{name}.{tag}.{k}"].numpy(),
                np.asarray(jnp.asarray(want[k]).astype(jnp.float32)),
                rtol=REF_RTOL, atol=REF_RTOL)


def _ref_ties_on_port_mean(full, live):
    """The reference's TIES functions (ties_thresh_ref, ties_colmerge_ref,
    jitted) on the deviations from the port's live mean row. TIES is
    ill-conditioned: the reference's live mean (a tensordot with the live
    weights) is an ulp off the port's (the mean of the live rows) in some
    columns, and an ulp in a deviation at a trim threshold moves that
    column by the deviation's size, so both take the same mean row here."""
    from repro.kernels import ref as jref
    from repro_torch.core import panel
    out = {}
    for k, x in full.items():
        x32 = x.float()
        mu = panel.merged({k: x32}, live=live)[k]
        tau = jnp.asarray(((x32 - mu) * torch.as_tensor(
            live, dtype=torch.float32)[:, None]).numpy())
        dev = jax.jit(lambda t: jref.ties_colmerge_ref(
            t, jref.ties_thresh_ref(t, 0.2)))(tau)
        out[k] = np.asarray(dev) + mu.numpy()
    return out


def test_sharded_merge_panel_under_a_live_mask(merges):
    _, full, _, _ = _merge_inputs()
    s = merges[0]
    dead = [i for i, a in enumerate(MERGE_LIVE) if not a]
    for k in ("float32", "bfloat16"):
        for part in ("mix", "err"):
            key = f"merge_panel.{part}.{k}"
            assert bits_equal(s[key], s[f"single.{key}"]), key
            assert all(bits_equal(o[key], s[key]) for o in merges)
        mixed = s[f"merge_panel.mix.{k}"]
        live = [i for i, a in enumerate(MERGE_LIVE) if a]
        assert bits_equal(mixed[dead], full[k][dead])  # passed through
        assert bits_equal(mixed[live], mixed[live[:1]].expand(
            len(live), -1).contiguous())


def test_sharded_ties_thresholds_bit_for_bit(merges):
    s = merges[0]
    tau = s["tau"]
    for trim in (0.2, 0.5, 1.0):
        got, want = s[f"ties_thresh.{trim}"], ties_thresh_ref(tau, trim)
        assert bits_equal(got, want), (trim, got, want)
        assert all(bits_equal(o[f"ties_thresh.{trim}"], got) for o in merges)
    th = s["ties_thresh.0.2"][:, 0]
    assert torch.isnan(th[2]) and th[3] == 0.0
    assert th[1] in (1.0, 2.0)  # a tied magnitude, picked exactly


def test_native_draws_of_a_block_are_the_panels():
    """The kernel-drawn int8 quantize's plain twin on a block of a panel
    (row0, col0: a rank's shard) gives that block of the whole panel's
    quantize; a first column off the 512-column grid is refused."""
    from repro_torch.kernels import ref, wire_quant
    g = torch.Generator().manual_seed(4)
    x = torch.randn((6, 3000), generator=g)
    s = ref.int8_scale_ref(x)
    seed = torch.tensor([-77], dtype=torch.int32)
    whole = wire_quant.quantize_int8_native(x, s, seed)
    for r0, c0 in ((0, 1024), (3, 512), (5, 2560)):
        q = wire_quant.quantize_int8_native(x[r0:, c0:].contiguous(), s[r0:],
                                            seed, row0=r0, col0=c0)
        assert torch.equal(q, whole[r0:, c0:])
    with pytest.raises(ValueError, match="multiple of 512"):
        wire_quant.quantize_int8_native(x[:, 100:].contiguous(), s, seed,
                                        col0=100)


def _mesh_view(fsdp=2):
    """A (1, 2, fsdp, 1) mesh's rank-0 view, with no process group: the
    spec's layout logic alone."""
    from repro_torch.launch.mesh import AXES, Mesh
    return Mesh(shape=dict(zip(AXES, (1, 2, fsdp, 1))), axis_names=AXES,
                rank=0, coord=dict.fromkeys(AXES, 0),
                device=torch.device("cpu"), backend="gloo")


@pytest.mark.parametrize("wire,residency,width,refused", [
    (_codec("int8_ef native"), None, 2 * 1024, None),
    (_codec("int8_ef native"), None, 2 * 640, "multiple of 512"),
    ("int4", None, 2 * 640, None),
    ("int4", None, 2 * 700, "multiple of 128"),
    (None, "moments=int8g", 2 * 96, None),
    (None, "moments=int8", 2 * 96, "the moments storage 'int8'"),
    (None, "stats=int8r", 2 * 97, None),
])
def test_shard_spec_refuses_a_split_off_the_group_grid(wire, residency,
                                                        width, refused):
    """Each column shard must start on the kernel-drawn quantize's
    512-column grid and on a grouped codec's or storage's group grid; the
    per-row codecs and storages take any split."""
    from repro_torch.core import panel
    base = panel.make_spec({"w": torch.zeros((4, width))})
    spec = panel.with_residency(panel.with_wire(base, wire), residency)
    if refused is None:
        sh = panel.shard_spec(spec, _mesh_view()).shard("float32")
        assert sh.split and sh.cols == (0, width // 2) and sh.rows == (0, 2)
    else:
        with pytest.raises(ValueError, match=refused):
            panel.shard_spec(spec, _mesh_view())


@pytest.mark.parametrize("wire,refused", [
    ("int8", True), ("int8_ef", True), ("int4", True), ("int4_ef", True),
    (_codec("int8_ef native"), False), ("topk", False), ("bf16", False),
])
def test_launcher_refuses_a_draw_panel_over_the_rank_share(wire, refused):
    """On a mesh a generator-drawn codec's whole (m, D) float32 uniform
    panel (every rank draws it) may take a quarter of the rank's share of
    its device memory and no more; the kernel's draws, the codecs without
    draws and an unsharded spec are never refused."""
    from repro_torch.core import panel
    from repro_torch.launch.train import refuse_oversized_draws
    base = panel.with_wire(panel.make_spec({"w": torch.zeros((4, 2048))}),
                           wire)
    spec = panel.shard_spec(base, _mesh_view())
    need = 4 * 2048 * 4
    refuse_oversized_draws(spec, 4 * need)
    refuse_oversized_draws(base, 0)
    if refused:
        with pytest.raises(SystemExit, match=r"\(4, 2048\) float32 "
                                             r"uniform panel.*ROADMAP C"):
            refuse_oversized_draws(spec, 4 * need - 1)
    else:
        refuse_oversized_draws(spec, 0)


EXACT_METS = ("loss", "loss_agent", "live", "wire_bytes")
NORM_METS = ("grad_norm", "grad_norm_max", "consensus")
COL_METS = ("grad_norm_agent", "dist_to_mean")


@pytest.mark.parametrize("label", list(OPTION_CASES))
def test_sharded_options_segment_equals_single_process(tmp_path, label):
    wire, merger, res, fused, plan, tele = OPTION_CASES[label]
    ranks = _load_options(tmp_path, label)
    s = ranks[0]
    sh, one = f"{label}.shard.", f"{label}.single."
    state = [k[len(sh):] for k in s if k.startswith(sh)
             and not k.startswith(sh + "met.")]
    assert {"panel.float32.", "step_count"} <= set(state)
    stored = res and "moments=int8" in res
    assert ("m.float32.q" in state) == bool(stored), state
    if wire in ("int8_ef", "native", "topk", "int4_ef"):
        assert any(k.startswith("wire_err.") for k in state)
    if merger in ("var", "fisher", "swa"):
        assert any(k.startswith("stat.") for k in state)
    for k in state:
        got, ref = s[sh + k], s[one + k]
        assert all(bits_equal(o[sh + k], got) for o in ranks), k
        if merger == "weighted" and k.startswith("panel."):
            np.testing.assert_allclose(got.numpy(), ref.numpy(),
                                       rtol=WEIGHTED_RTOL, atol=1e-7)
        else:
            assert bits_equal(got, ref), k
    mets = {k[len(sh) + 4:] for k in s if k.startswith(sh + "met.")}
    assert mets == set(NORM_METS) | {"loss"} | (
        set(EXACT_METS) | set(COL_METS) if tele else set())
    for k in mets:
        got, ref = s[f"{sh}met.{k}"], s[f"{one}met.{k}"]
        if k in EXACT_METS:
            assert bits_equal(got, ref), k
        else:
            rtol = COL_RTOL if k in COL_METS else XI_RTOL
            np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=rtol,
                                       atol=1e-7)
    assert float(s[f"{sh}met.consensus"][-1]) == 0.0
    # after the merge every live agent holds the merged row (a rejoining
    # one takes the live rows' mean, an ulp off it in some columns)
    x = s[sh + "panel.float32."]
    live = _option_inputs(plan)[2]
    rows = x if live is None else x[torch.as_tensor(live[-1] == 1)]
    assert bits_equal(rows, rows[:1].expand(rows.shape).contiguous())


def _load_options(tmp, label):
    spawn(4, "options", tmp, args=[label], timeout=120)
    return _load(tmp, 4)


ARGS = ["--rounds", "3", "--segment", "3", "--agents", "4", "--local-steps",
        "2", "--batch", "2", "--seq", "16", "--device", "cpu"]
# each flag a sharded run takes since ROADMAP A16b (the cases
# test_torch_sharded.py's refusals held until then)
LAUNCH_CASES = [["--wire", "int8"], ["--wire", "int8_ef"],
                ["--wire", "int4_ef"], ["--wire", "topk"],
                ["--merge", "ties"], ["--merge", "var"],
                ["--residency", "moments=int8"], ["--faults", "1@1-2"],
                ["--telemetry"]]


def _history(out):
    (path,) = list(out.glob("*.json"))
    return json.loads(path.read_text())["history"]


def _rounds(events):
    return [json.loads(line) for line in events.read_text().splitlines()
            if json.loads(line).get("type") == "round"]


@pytest.mark.parametrize("extra", LAUNCH_CASES, ids=lambda e: " ".join(e))
def test_launcher_on_debug_mesh_takes_the_flag(tmp_path, extra):
    ranks = spawn(8, "launch", tmp_path, ARGS + extra + [
        "--mesh", "debug", "--out", str(tmp_path / "mesh"),
        "--events", str(tmp_path / "mesh.jsonl")], timeout=150)
    spawn(1, "launch", tmp_path / "one", ARGS + extra + [
        "--out", str(tmp_path / "one"),
        "--events", str(tmp_path / "one.jsonl")], timeout=120)
    assert "panel sharded on mesh" in ranks[0].stdout
    assert all(r.stdout == "" for r in ranks[1:])  # rank 0's console only
    a, b = _history(tmp_path / "mesh"), _history(tmp_path / "one")
    assert len(a) == len(b) == 3
    for x, y in zip(a, b):
        for k in ("round", "train_loss", "merged_eval", "local_eval",
                  "comm_cost_P"):
            assert x[k] == y[k], (k, x, y)
        for k in ("grad_norm", "consensus"):
            np.testing.assert_allclose(x[k], y[k], rtol=XI_RTOL)
    assert a[-1]["consensus"] == 0.0
    assert a[-1]["merged_eval"] == a[-1]["local_eval"]
    ea, eb = _rounds(tmp_path / "mesh.jsonl"), _rounds(tmp_path / "one.jsonl")
    assert len(ea) == len(eb) == 3
    for x, y in zip(ea, eb):
        assert x.keys() == y.keys()
        for k in ("loss", "resident_bytes", "transient_bytes", "loss_agent",
                  "live", "wire_bytes"):
            assert x.get(k) == y.get(k), k
        for k in COL_METS if "--telemetry" in extra else ():
            assert len(x[k]) == 4
            np.testing.assert_allclose(x[k], y[k], rtol=COL_RTOL, atol=1e-7)
