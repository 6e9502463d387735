"""The port's checkpoints (``repro_torch.checkpoint``) against the JAX
package's (``repro.checkpoint``): the same blob, byte for byte, for the
same tree and meta; a blob saved by either package restores in the other
bit for bit; and mirrors of ``tests/test_checkpoint.py``'s blob-format and
``Checkpointer`` tests (round trip, writable results, atomic writes, the
PCG64 meta, errors naming the key, corrupt and torn files, the legacy
format, retention, async saves, the corrupt-latest fallback, orphans, the
fingerprint guard). Every comparison is exact: a checkpoint moves bits."""
import json
import os

import jax.numpy as jnp
import ml_dtypes
import msgpack
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401
from repro.checkpoint import io as ref_io
from repro_torch.checkpoint import (CheckpointCorruptError, Checkpointer,
                                    restore, save)
from repro_torch.checkpoint import _msgpack
from repro_torch.checkpoint import io as ckpt_io
from repro_torch.configs import get_config
from repro_torch.core import dsgd
from repro_torch.launch.train import build_cpu_preset
from repro_torch.models import build_model
from repro_torch.optim import make_optimizer
from repro_torch.utils.tree import tree_map


def _arrays(seed=0):
    """A nested tree of numpy arrays: float32 (one leaf over 64 KiB, so its
    data is a bin32), bfloat16, int8, int32, a 0-d leaf and an empty
    subtree."""
    rng = np.random.default_rng(seed)
    return {
        "decoder": {"main": {"p0": {"wq": rng.normal(size=(2, 8, 6)).astype(
            np.float32), "norm1": {}}}},
        "embed": {"table": rng.normal(size=(160, 128)).astype(np.float32)},
        "e": rng.normal(size=(5, 3)).astype(ml_dtypes.bfloat16),
        "q": rng.integers(-127, 128, size=(3, 7)).astype(np.int8),
        "step": np.asarray(7, np.int32),
        "b": np.zeros(3, np.float32),
    }


def _to_torch(a):
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _torch_tree(tree):
    return tree_map(_to_torch, tree)


def _bits(x):
    """The leaf's bytes and dtype name, on either side."""
    if isinstance(x, torch.Tensor):
        name = ckpt_io._NAMES[x.dtype]
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return name, tuple(x.shape), x.cpu().numpy().tobytes()
    x = np.asarray(x)
    return x.dtype.name, x.shape, x.tobytes()


def _pcg64_meta():
    rng = np.random.default_rng(123)
    rng.normal(size=17)
    return {"rng": rng.bit_generator.state, "round": 7}


# ---------------------------------------------------------- the two packages


@pytest.mark.parametrize("meta", [None, {"round": 3, "name": "a" * 40},
                                  _pcg64_meta()],
                         ids=["no-meta", "meta", "pcg64"])
def test_blob_byte_identical_to_reference(meta):
    tree = _arrays()
    ref_blob, ref_crc = ref_io._pack_blob(ref_io._flatten_to_host(tree),
                                          meta)
    pieces, n, crc = ckpt_io._blob_pieces(
        ckpt_io._flatten_to_host(_torch_tree(tree)), meta)
    assert crc == ref_crc and n == len(ref_blob)
    assert b"".join(pieces) == ref_blob


def test_msgpack_subset_byte_identical_to_msgpack():
    """Every encoding width of the subset: fix/8/16/32-bit str, bin 8/16/32,
    the integer forms at their edges, fix and 16-bit arrays and maps."""
    ints = [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
            2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769,
            -2 ** 31, -2 ** 31 - 1, -2 ** 63]
    obj = {"ints": ints, "strs": ["", "x" * 31, "y" * 32, "z" * 256,
                                  "é" * 40000],
           "bins": [b"", b"a" * 255, b"b" * 256, b"c" * 65536],
           "arr16": list(range(16)), "map16": {f"k{i}": i for i in range(16)}}
    packed = _msgpack.packb(obj)
    assert packed == msgpack.packb(obj)
    back = _msgpack.unpackb(packed)
    back["bins"] = [bytes(b) for b in back["bins"]]
    assert back == msgpack.unpackb(packed)
    with pytest.raises(ValueError, match="extra data"):
        _msgpack.unpackb(packed + b"\x00")
    with pytest.raises(ValueError, match="truncated"):
        _msgpack.unpackb(packed[:-3])


def test_port_blob_restores_in_reference(tmp_path):
    tree = _arrays(seed=1)
    path = str(tmp_path / "port.ckpt")
    save(path, _torch_tree(tree), meta=_pcg64_meta())
    back, meta = ref_io.restore(path, tree, with_meta=True)
    assert meta["round"] == 7
    for key in ("e", "q", "step", "b"):
        assert _bits(back[key]) == _bits(tree[key])
    assert _bits(back["embed"]["table"]) == _bits(tree["embed"]["table"])
    assert _bits(back["decoder"]["main"]["p0"]["wq"]) == _bits(
        tree["decoder"]["main"]["p0"]["wq"])


def test_reference_blob_restores_in_port(tmp_path):
    tree = _arrays(seed=2)
    path = str(tmp_path / "ref.ckpt")
    ref_io.save(path, {k: (jnp.asarray(v) if not isinstance(v, dict) else v)
                       for k, v in tree.items()}, meta={"round": 2})
    like = _torch_tree(_arrays(seed=9))
    back, meta = restore(path, like, with_meta=True)
    assert meta == {"round": 2}
    assert back["e"].dtype == torch.bfloat16
    for key in ("e", "q", "step", "b"):
        assert _bits(back[key]) == _bits(tree[key])
    assert _bits(back["embed"]["table"]) == _bits(tree["embed"]["table"])
    assert back["decoder"]["main"]["p0"]["norm1"] == {}


def test_restore_puts_tensors_on_the_like_device_and_numpy_stays_numpy(
        tmp_path):
    tree = _torch_tree(_arrays(seed=3))
    path = str(tmp_path / "s.ckpt")
    save(path, tree)
    like = dict(_torch_tree(_arrays(seed=4)))
    like["b"] = np.ones(3, np.float32)
    back = restore(path, like)
    assert isinstance(back["b"], np.ndarray) and back["b"].flags.writeable
    assert back["embed"]["table"].device == like["embed"]["table"].device
    assert torch.equal(back["embed"]["table"], tree["embed"]["table"])


# ------------------------------------------------------------ blob format


def _mixed_state(m=4, seed=0):
    """A full panel train state of the port (int8_ef residuals and fisher
    statistics panels included; the port's panel engine holds float32
    parameters), every leaf filled with fresh values, plus bf16 and int8
    leaves riding along."""
    cfg = build_cpu_preset(get_config("olmo-1b"), m).reduced(
        d_model=64, layers=1, vocab=64)
    gen = torch.Generator().manual_seed(seed)
    state, _ = dsgd.init_panel_state(
        build_model(cfg).init_params, make_optimizer("adamw", 1e-2), m, gen,
        device="cpu", wire="int8_ef", merger="fisher")
    rng = np.random.default_rng(seed + 1)

    def fresh(x):
        if not isinstance(x, torch.Tensor):
            return x
        vals = rng.normal(size=tuple(x.shape)).astype(np.float32)
        return torch.from_numpy(vals).to(x.dtype)
    state = tree_map(fresh, state)
    state["extra"] = {"bf16": torch.from_numpy(
        rng.normal(size=(5,)).astype(np.float32)).to(torch.bfloat16),
        "i8": torch.arange(-3, 3, dtype=torch.int8)}
    return state


def test_roundtrip_full_state_bit_exact(tmp_path):
    state = _mixed_state()
    path = str(tmp_path / "s.ckpt")
    save(path, state)
    back = restore(path, state)
    want = list(ckpt_io._leaves_with_path(state))
    got = list(ckpt_io._leaves_with_path(back))
    assert [k for k, _ in got] == [k for k, _ in want]
    for (kp, a), (_, b) in zip(want, got):
        assert _bits(a) == _bits(b), kp


def test_restore_returns_writable_tensors_not_views(tmp_path):
    state = _mixed_state()
    path = str(tmp_path / "s.ckpt")
    save(path, state)
    back = restore(path, state)
    ptrs = set()
    for _, leaf in ckpt_io._leaves_with_path(back):
        if isinstance(leaf, torch.Tensor) and leaf.numel():
            leaf.view(-1)[0] = leaf.view(-1)[0]  # must not raise
            ptrs.add(leaf.data_ptr())
    # every leaf owns its memory (no two share the file's buffer)
    assert len(ptrs) == sum(1 for _, x in ckpt_io._leaves_with_path(back)
                            if isinstance(x, torch.Tensor) and x.numel())


def test_save_snapshots_cpu_tensors(tmp_path):
    """The host snapshot is a copy: a CPU tensor updated in place after
    ``Checkpointer.save(block=False)`` returns does not change the blob."""
    x = torch.arange(8, dtype=torch.float32)
    ck = Checkpointer(str(tmp_path), keep=1)
    ck.save(1, {"x": x}, block=False)
    x.fill_(-1.0)
    step, tree, _ = ck.restore_latest({"x": torch.zeros(8)})
    assert step == 1
    assert torch.equal(tree["x"], torch.arange(8, dtype=torch.float32))


def test_save_is_atomic_no_stray_tmp(tmp_path):
    save(str(tmp_path / "s.ckpt"), _mixed_state())
    assert sorted(os.listdir(tmp_path)) == ["s.ckpt"]


def test_meta_round_trips_pcg64_state(tmp_path):
    rng = np.random.default_rng(123)
    rng.normal(size=17)
    path = str(tmp_path / "s.ckpt")
    save(path, {"x": torch.zeros(3)},
         meta={"rng": rng.bit_generator.state, "round": 7})
    _, meta = restore(path, {"x": torch.zeros(3)}, with_meta=True)
    assert meta["round"] == 7
    rng2 = np.random.default_rng(0)
    rng2.bit_generator.state = meta["rng"]
    np.testing.assert_array_equal(rng.normal(size=5), rng2.normal(size=5))


def test_restore_errors_name_the_offending_key(tmp_path):
    like = {"a": torch.zeros((2, 3)), "b": torch.zeros(4,
                                                      dtype=torch.bfloat16)}
    path = str(tmp_path / "s.ckpt")
    save(path, like)
    with pytest.raises(KeyError, match="missing key '.*c'"):
        restore(path, {**like, "c": torch.zeros(1)})
    with pytest.raises(ValueError, match="keys the reference tree does "
                                         "not.*'b'"):
        restore(path, {"a": like["a"]})
    with pytest.raises(ValueError, match="'a' has shape"):
        restore(path, {**like, "a": torch.zeros((3, 2))})
    with pytest.raises(ValueError, match="'b' has dtype"):
        restore(path, {**like, "b": torch.zeros(4, dtype=torch.float16)})


def test_corrupt_and_torn_files_detected(tmp_path):
    state = {"x": torch.arange(64, dtype=torch.float32)}
    path = str(tmp_path / "s.ckpt")
    save(path, state)
    blob = open(path, "rb").read()
    with open(path, "wb") as f:  # torn write: truncated tail
        f.write(blob[: len(blob) // 2])
    with pytest.raises(CheckpointCorruptError):
        restore(path, state)
    flipped = bytearray(blob)
    flipped[-8] ^= 0xFF  # bit rot: the checksum must catch it
    with open(path, "wb") as f:
        f.write(bytes(flipped))
    with pytest.raises(CheckpointCorruptError, match="checksum"):
        restore(path, state)


@pytest.mark.parametrize("packer", ["msgpack", "port"])
def test_legacy_flat_format_still_restores(tmp_path, packer):
    state = _mixed_state(seed=3)
    flat = ckpt_io._flatten_to_host(state)
    table = {k: {"dtype": name, "shape": list(a.shape), "data": a.tobytes()}
             for k, (name, a) in flat.items()}
    legacy = (msgpack.packb(table) if packer == "msgpack"
              else _msgpack.packb(table))
    path = str(tmp_path / "legacy.ckpt")
    with open(path, "wb") as f:
        f.write(legacy)
    back, meta = restore(path, state, with_meta=True)
    assert meta == {}
    for (_, a), (_, b) in zip(ckpt_io._leaves_with_path(state),
                              ckpt_io._leaves_with_path(back)):
        assert _bits(a) == _bits(b)


def test_residency_stamp_guards_restore(tmp_path):
    path = str(tmp_path / "s.ckpt")
    save(path, {"x": torch.zeros(2)}, residency={"moments": "int8"})
    restore(path, {"x": torch.zeros(2)}, expect_residency={"moments":
                                                           "int8"})
    with pytest.raises(ValueError, match="moments: checkpoint stores "
                                         "'int8', engine configured 'f32'"):
        restore(path, {"x": torch.zeros(2)}, expect_residency={})
    # the reference reads the same stamp
    with pytest.raises(ValueError, match="moments"):
        ref_io.restore(path, {"x": np.zeros(2, np.float32)},
                       expect_residency={"moments": "bf16"})


# ------------------------------------------------------------ Checkpointer


def test_checkpointer_retention_and_manifest(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2, fingerprint={"run": "a"})
    like = {"x": torch.zeros(8)}
    for step in (1, 2, 3):
        ck.save(step, {"x": torch.full((8,), float(step))})
    assert ck.latest_step() == 3
    files = sorted(f for f in os.listdir(tmp_path) if f.endswith(".ckpt"))
    assert files == ["step_00000002.ckpt", "step_00000003.ckpt"]
    man = json.load(open(tmp_path / "MANIFEST.json"))
    assert [c["step"] for c in man["checkpoints"]] == [2, 3]
    assert man["fingerprint"] == {"run": "a"}
    assert all(c["bytes"] > 0 and "crc" in c for c in man["checkpoints"])
    step, tree, _ = ck.restore_latest(like)
    assert step == 3
    assert torch.equal(tree["x"], torch.full((8,), 3.0))


def test_checkpointer_async_save(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=3)
    ck.save(5, {"x": torch.arange(4.0)}, meta={"round": 5}, block=False)
    ck.wait()
    step, tree, meta = ck.restore_latest({"x": torch.zeros(4)})
    assert step == 5 and meta["round"] == 5
    assert torch.equal(tree["x"], torch.arange(4.0))


def test_checkpointer_corrupt_latest_falls_back(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=3)
    ck.save(1, {"x": torch.full((4,), 1.0)})
    ck.save(2, {"x": torch.full((4,), 2.0)})
    latest = tmp_path / "step_00000002.ckpt"
    blob = latest.read_bytes()
    latest.write_bytes(blob[: len(blob) // 2])
    with pytest.warns(RuntimeWarning, match="corrupt"):
        step, tree, _ = ck.restore_latest({"x": torch.zeros(4)})
    assert step == 1
    assert torch.equal(tree["x"], torch.full((4,), 1.0))


def test_checkpointer_finds_orphan_checkpoints(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=3)
    ck.save(1, {"x": torch.full((4,), 1.0)})
    save(str(tmp_path / "step_00000009.ckpt"), {"x": torch.full((4,), 9.0)})
    step, tree, _ = ck.restore_latest({"x": torch.zeros(4)})
    assert step == 9
    assert torch.equal(tree["x"], torch.full((4,), 9.0))


def test_checkpointer_fingerprint_guard(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2,
                      fingerprint={"seed": 0, "wire": "int8_ef"})
    ck.save(1, {"x": torch.zeros(2)})
    Checkpointer(str(tmp_path), keep=2,
                 fingerprint={"seed": 0, "wire": "int8_ef"})
    with pytest.raises(ValueError, match="seed"):
        Checkpointer(str(tmp_path), keep=2,
                     fingerprint={"seed": 1, "wire": "int8_ef"})


def test_checkpointer_directory_readable_by_reference(tmp_path):
    """The manifest and step files of the port's Checkpointer are the
    reference Checkpointer's: it reopens the directory and restores the
    newest step."""
    ck = Checkpointer(str(tmp_path), keep=2, fingerprint={"run": "a"})
    ck.save(4, {"x": torch.full((3,), 4.0)}, meta={"round": 4})
    step, tree, meta = ref_io.Checkpointer(
        str(tmp_path), keep=2, fingerprint={"run": "a"}).restore_latest(
            {"x": np.zeros(3, np.float32)})
    assert (step, meta) == (4, {"round": 4})
    np.testing.assert_array_equal(tree["x"], np.full(3, 4.0, np.float32))
