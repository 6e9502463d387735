"""The panel sharded over ranks (torch.distributed, gloo on the CPU) against
the port's single-process route and the JAX package's replicated functions.

Every multi-rank run is a set of subprocesses (``tests/_torch_dist.py``:
a ``file://`` rendezvous in the test's tmp dir, one intra-op thread a rank,
its own timeout). On the (1, 2, 2, 1) mesh of 4 ranks (agents over 2 ranks,
columns over 2):

* the sharded mix, the mix with the folded mean, Xi from it, merged,
  consensus_distance, the global merge (f32 and bf16 wires) and
  ``gossip.global_merge_allreduce`` on a float32 group (102 columns, split
  in two) and a bfloat16 group of 33 columns (odd: replicated along fsdp),
  gathered, equal the single-process results bit for bit, Xi too (at this
  size the sums meet in the same order; it is held to 1e-6 relative, the
  bound the design gives); and the reference's replicated functions
  (jitted) within float32 tolerance (1e-6; a bfloat16 group's rows within
  one bfloat16 ulp);
* a sharded reduced() olmo-1b segment with an unused 5-column bfloat16
  leaf (a bf16 group that does not divide by fsdp): the final panel and
  both moments bit for bit, the losses bit for bit, the grad norms and Xi
  within 1e-6 relative, against the segment on one process.

On the (1, 2, 2, 2) ``--mesh debug`` mesh of 8 ranks the launcher with
``--device cpu`` writes the history of the launcher without a mesh: losses
and evals bit for bit, grad norms and Xi within 1e-6 relative (summed over
ranks in another order), the last Xi 0.0. The refusals: ``--agents`` not
divisible by the mesh's agent ranks, a world size other than the mesh's,
and a ``--mesh`` that names no mesh, by name. The other options on a mesh:
test_torch_sharded_options.py; checkpoints on a mesh:
test_torch_sharded_checkpoint.py.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401
from _torch_dist import _mixed_panel, spawn
from repro.core import panel as ref_panel
from repro_torch.core.topology import random_matching
from repro_torch.launch import train

XI_RTOL = 1e-6


def _load(tmp, world):
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


@pytest.fixture(scope="module")
def ops(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ops")
    spawn(4, "ops", tmp, timeout=120)
    return _load(tmp, 4)


OPS = ["mix", "mixm", "gm", "gm_bf16", "mix_bf16"]


@pytest.mark.parametrize("op", OPS)
def test_sharded_ops_equal_single_process(ops, op):
    s = ops[0]
    for k in ("float32", "bfloat16"):
        got, want = s[f"{op}.{k}"], s[f"single.{op}"][k]
        assert got.dtype == want.dtype and torch.equal(got, want)
        assert all(torch.equal(o[f"{op}.{k}"], got) for o in ops)


def test_sharded_means_and_xi_equal_single_process(ops):
    s = ops[0]
    for k in ("float32", "bfloat16"):
        assert torch.equal(s[f"mean.{k}"], s["single.mean"][k])
        assert torch.equal(s[f"merged.{k}"], s["single.merged"][k])
    for name in ("xi", "xi_mean"):
        np.testing.assert_allclose(float(s[name]), float(s[f"single.{name}"]),
                                   rtol=XI_RTOL)
        assert all(float(o[name]) == float(s[name]) for o in ops)
    # rows 0-1 and 2-3 over the agent ranks; the float32 group's 102
    # columns in two, the bfloat16 group's 33 whole
    assert s["spec"].tolist() == [[0, 2, 0, 33], [0, 2, 0, 51]]
    assert ops[1]["spec"].tolist() == [[0, 2, 0, 33], [0, 2, 51, 102]]
    assert ops[2]["spec"].tolist() == [[2, 4, 0, 33], [2, 4, 0, 51]]


def _bf16_ulp(v):
    _, e = np.frexp(np.abs(np.asarray(v, np.float32)))
    return np.ldexp(np.float32(1.0), e - 8)


def test_sharded_ops_match_reference_replicated(ops):
    tree = _mixed_panel()
    jt = {k: jnp.asarray(v.float().numpy()).astype(
        jnp.bfloat16 if v.dtype == torch.bfloat16 else jnp.float32)
        for k, v in tree.items()}
    rspec = ref_panel.make_spec(jt)
    rpan = ref_panel.to_panel(jt, rspec)
    W = jnp.asarray(random_matching(4, 0.9, np.random.default_rng(1))
                    .astype(np.float32))
    ref = {"mix": jax.jit(ref_panel.mix_dense)(rpan, W),
           "gm": jax.jit(ref_panel.global_merge)(rpan)}
    r_mixed, r_mean, _ = jax.jit(ref_panel.mix_dense_mean)(rpan, W)
    ref["mixm"] = r_mixed
    s = ops[0]
    for op, want in ref.items():
        for k in want:
            got = s[f"{op}.{k}"].to(torch.float32).numpy()
            w = np.asarray(jnp.asarray(want[k]).astype(jnp.float32))
            if k == "bfloat16":
                assert np.all(np.abs(got - w) <= _bf16_ulp(w) + 1e-6)
            else:
                np.testing.assert_allclose(got, w, rtol=1e-6, atol=1e-6)
    for k in r_mean:
        np.testing.assert_allclose(s[f"mean.{k}"].numpy(),
                                   np.asarray(r_mean[k]), rtol=1e-6,
                                   atol=1e-6)
    np.testing.assert_allclose(
        float(s["xi_mean"]),
        float(ref_panel.consensus_from_mean(r_mixed, r_mean)), rtol=1e-5)
    np.testing.assert_allclose(
        float(s["xi"]), float(jax.jit(ref_panel.consensus_distance)(rpan)),
        rtol=1e-5)
    r_merged = jax.jit(ref_panel.merged)(rpan)
    for k in r_merged:
        np.testing.assert_allclose(s[f"merged.{k}"].numpy(),
                                   np.asarray(r_merged[k]), rtol=1e-6,
                                   atol=1e-6)
    # the all-reduce merge of the agent-stacked leaves, on every rank
    from repro.core import gossip as ref_gossip
    want = jax.jit(ref_gossip.global_merge)(jt)
    for o in ops:
        for k in ("w", "emb"):
            got = o[f"gmar.{k}"].to(torch.float32).numpy()
            w = np.asarray(jnp.asarray(want[k]).astype(jnp.float32))[:2]
            if k == "emb":
                assert np.all(np.abs(got - w) <= _bf16_ulp(w) + 1e-6)
            else:
                np.testing.assert_allclose(got, w, rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def segment(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("segment")
    spawn(4, "segment", tmp, timeout=180)
    return _load(tmp, 4)


def test_sharded_segment_equals_single_process(segment):
    s = segment[0]
    assert "('bfloat16', (('pod', 'agent'), None))" in s["pspecs"]
    for name in ("panel", "m", "v"):
        for k in ("float32", "bfloat16"):
            got, want = s[f"{name}.{k}"], s[f"single.{name}.{k}"]
            assert got.dtype == want.dtype and torch.equal(got, want), \
                (name, k)
            assert all(torch.equal(o[f"{name}.{k}"], got) for o in segment)
    assert torch.equal(s["met.loss"], s["single.met.loss"])
    for k in ("grad_norm", "grad_norm_max", "consensus"):
        np.testing.assert_allclose(s[f"met.{k}"].numpy(),
                                   s[f"single.met.{k}"].numpy(),
                                   rtol=XI_RTOL)
    x = s["panel.float32"]
    assert torch.equal(x, x[:1].expand(x.shape))  # the final merge


ARGS = ["--rounds", "6", "--segment", "3", "--agents", "4", "--local-steps",
        "2", "--batch", "4", "--seq", "32", "--device", "cpu"]
TAG = "olmo-1b_final_merge_a0.1.json"


def test_launcher_on_debug_mesh_equals_launcher_without(tmp_path):
    ranks = spawn(8, "launch", tmp_path, ARGS + [
        "--mesh", "debug", "--out", str(tmp_path / "mesh"),
        "--save-merged", str(tmp_path / "mesh.ckpt")], timeout=180)
    spawn(1, "launch", tmp_path / "one", ARGS + [
        "--out", str(tmp_path / "one"),
        "--save-merged", str(tmp_path / "one.ckpt")], timeout=120)
    assert ("panel sharded on mesh {'pod': 1, 'agent': 2, 'fsdp': 2, "
            "'model': 2}") in ranks[0].stdout
    assert all(r.stdout == "" for r in ranks[1:])  # rank 0's console only
    a = json.loads((tmp_path / "mesh" / TAG).read_text())["history"]
    b = json.loads((tmp_path / "one" / TAG).read_text())["history"]
    assert len(a) == len(b) == 6
    for x, y in zip(a, b):
        for k in ("round", "train_loss", "merged_eval", "local_eval",
                  "comm_cost_P"):
            assert x[k] == y[k], (k, x, y)
        for k in ("grad_norm", "consensus"):
            np.testing.assert_allclose(x[k], y[k], rtol=XI_RTOL)
    assert a[-1]["consensus"] == 0.0
    assert a[-1]["merged_eval"] == a[-1]["local_eval"]
    # the merged model rank 0 saved: the no-mesh launcher's bytes
    assert (tmp_path / "mesh.ckpt").read_bytes() == \
        (tmp_path / "one.ckpt").read_bytes()


def test_launcher_refuses_indivisible_agents_and_wrong_world(tmp_path):
    ranks = spawn(8, "launch", tmp_path / "a", ARGS + [
        "--mesh", "debug", "--agents", "3", "--out", str(tmp_path)],
        timeout=120, check=False)
    assert all(r.returncode != 0 for r in ranks)
    assert "--agents 3 must be divisible by the mesh's pod*agent = 2" in \
        ranks[0].stderr
    ranks = spawn(4, "launch", tmp_path / "b", ARGS + [
        "--mesh", "debug", "--out", str(tmp_path)], timeout=120, check=False)
    assert all(r.returncode != 0 for r in ranks)
    assert all("needs 8 ranks but the world size is 4" in r.stderr
               for r in ranks)


@pytest.mark.parametrize("kind", ["1,2", "1,0,1,1", "mesh"])
def test_launcher_refuses_a_mesh_it_cannot_read(tmp_path, kind):
    with pytest.raises(SystemExit) as e:
        train.main(ARGS + ["--mesh", kind, "--out", str(tmp_path)])
    assert f"--mesh {kind!r}" in str(e.value) and "P,A,F,M" in str(e.value)
    import torch.distributed as dist
    assert not dist.is_initialized()  # refused before any process group
