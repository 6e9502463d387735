"""Versioned, manifest-based checkpoints of parameter and train-state trees
(counterpart of ``repro/checkpoint/io.py``; the same blob format, byte for
byte).

Blob format (``FORMAT_VERSION`` 2, msgpack): a map with

* ``version`` — this format version,
* ``meta``    — a JSON-encoded bytes blob of host-side metadata (JSON,
  because a numpy PCG64 bit-generator state carries 128-bit integers that
  msgpack cannot represent),
* ``payload`` — the msgpack-encoded flat array table
  ``{key-path: {dtype: name, shape, data}}``, the keys ``/``-joined dict
  keys in sorted order (the order ``jax.tree_util`` flattens a dict in), the
  dtype by its numpy NAME (``bfloat16`` stored as its 16-bit pattern),
* ``crc``     — CRC-32 over ``meta`` + ``payload``; a torn or corrupted
  file fails the checksum and raises :class:`CheckpointCorruptError`.

So a blob saved by this package restores in the JAX package and the other
way round, bit for bit. msgpack itself is written and read by
``checkpoint/_msgpack.py`` (the subset this format uses), not by the
``msgpack`` package.

Writes are atomic (tmp file + fsync + ``os.replace``). The legacy
pre-versioned format (a bare flat array table) still restores, as do
version-1 blobs. Version 2 marks the blobs that may carry residency storage
panels: a quantized state leaf is a nested ``{q, scale}`` dict whose int8
codes and float32 scales land in the table as ordinary keyed arrays.

A tree is nested dicts (lists and tuples by index) whose leaves are
tensors, numpy arrays or Python numbers; ``None`` and empty dicts hold no
leaf. :func:`restore` rebuilds ``like``'s structure: a tensor leaf comes back
as a tensor on that leaf's device, any other leaf as a writable numpy array.

:class:`Checkpointer` manages a DIRECTORY of ``step_*.ckpt`` files plus a
``MANIFEST.json`` (fingerprint of the run configuration + the ordered
checkpoint list): retention of the last ``keep`` checkpoints, background-
thread commits off a host snapshot taken on the caller's thread (so the
caller may update its tensors in place as soon as ``save`` returns), and
:meth:`Checkpointer.restore_latest` with fallback to the previous good
checkpoint when the newest one is corrupt.
"""
from __future__ import annotations

import json
import os
import re
import threading
import time
import warnings
import zlib

import numpy as np
import torch

from repro_torch.checkpoint import _msgpack

FORMAT_VERSION = 2
# every blob version this build restores (2 = residency storage panels;
# the array-table schema is identical)
READABLE_VERSIONS = (1, 2)
MANIFEST_NAME = "MANIFEST.json"
# the array table is ONE msgpack bin (bin 32): its bytes, headers included,
# cannot exceed this, in both packages' format
MAX_PAYLOAD_BYTES = (1 << 32) - 1
_STEP_FILE = re.compile(r"step_(\d+)\.ckpt$")

# torch dtype -> the numpy name stored in the blob (bfloat16 by its bits)
_NAMES = {torch.float32: "float32", torch.float64: "float64",
          torch.float16: "float16", torch.bfloat16: "bfloat16",
          torch.int8: "int8", torch.uint8: "uint8", torch.int16: "int16",
          torch.int32: "int32", torch.int64: "int64", torch.bool: "bool"}
_TORCH = {name: dt for dt, name in _NAMES.items()}


class CheckpointCorruptError(RuntimeError):
    """A checkpoint file failed its checksum or could not be decoded."""


def _key_str(path) -> str:
    return "/".join(str(p) for p in path)


def _children(node):
    """[(key, child)] of an inner node in flatten order, or None for a
    leaf. ``None`` is a node with no children, as in ``jax.tree_util``."""
    if node is None:
        return []
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def _leaves_with_path(tree, path=()):
    kids = _children(tree)
    if kids is None:
        yield path, tree
        return
    for k, child in kids:
        yield from _leaves_with_path(child, path + (k,))


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype not in _NAMES:
            raise TypeError(f"checkpoints do not store {leaf.dtype} tensors")
        return _NAMES[leaf.dtype]
    return np.asarray(leaf).dtype.name


def _host(leaf):
    """(dtype name, host ndarray COPY of the leaf's bits). A CPU tensor is
    copied too, so the snapshot survives in-place updates of the live
    state."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return "bfloat16", t.view(torch.int16).numpy()
        return _dtype_name(t), t.numpy()
    a = np.array(leaf, copy=True)
    return a.dtype.name, a


def _flatten_to_host(tree) -> dict:
    """{key-path: (dtype name, host ndarray)} in flatten order."""
    return {_key_str(kp): _host(leaf) for kp, leaf in _leaves_with_path(tree)}


def payload_bytes(tree) -> int:
    """Bytes of the array table :func:`save` would write for ``tree`` (the
    blob's ``payload``), from the leaves' dtypes and shapes, without a copy
    of their data; above :data:`MAX_PAYLOAD_BYTES` the format cannot hold
    the tree."""
    table, data = {}, 0
    for kp, leaf in _leaves_with_path(tree):
        if isinstance(leaf, torch.Tensor):
            shape, n = list(leaf.shape), leaf.numel() * leaf.element_size()
        else:
            a = np.asarray(leaf)
            shape, n = list(a.shape), a.nbytes
        table[_key_str(kp)] = {"dtype": _dtype_name(leaf), "shape": shape,
                               "data": b""}
        # the bin header of n bytes in place of the empty bin's 2
        data += n + (0 if n < (1 << 8) else 1 if n < (1 << 16) else 3)
    return len(_msgpack.packb(table)) + data


def _pack_blob(flat: dict, meta) -> tuple:
    """(blob bytes, crc). The payload is one join of the table's pieces
    (the arrays' buffers included), so it is the only copy of the data
    before the blob itself."""
    payload = _msgpack.packb(
        {k: {"dtype": name, "shape": list(a.shape),
             "data": memoryview(np.ascontiguousarray(a)).cast("B")}
         for k, (name, a) in flat.items()})
    meta_bytes = json.dumps(meta if meta is not None else {}).encode()
    crc = zlib.crc32(payload, zlib.crc32(meta_bytes)) & 0xFFFFFFFF
    blob = _msgpack.packb({"version": FORMAT_VERSION, "meta": meta_bytes,
                           "crc": crc, "payload": payload})
    return blob, crc


def _unpack_blob(raw) -> tuple:
    """(flat array table, meta dict); CheckpointCorruptError on any
    decode/checksum failure. A map without a 'version' key is the legacy
    flat format (no meta, no checksum). The table's ``data`` are views of
    ``raw``."""
    try:
        obj = _msgpack.unpackb(raw)
    except Exception as exc:
        raise CheckpointCorruptError(
            f"undecodable checkpoint: {exc}") from None
    if not isinstance(obj, dict):
        raise CheckpointCorruptError("checkpoint is not a msgpack map")
    if "version" not in obj:
        return obj, {}
    if obj["version"] not in READABLE_VERSIONS:
        raise CheckpointCorruptError(
            f"unsupported checkpoint format version {obj['version']!r} "
            f"(this build reads {list(READABLE_VERSIONS)})")
    try:
        meta_bytes, payload = obj["meta"], obj["payload"]
    except KeyError as exc:
        raise CheckpointCorruptError(
            f"checkpoint missing section {exc}") from None
    try:
        crc = zlib.crc32(payload, zlib.crc32(meta_bytes)) & 0xFFFFFFFF
    except TypeError as exc:
        raise CheckpointCorruptError(
            f"undecodable checkpoint sections: {exc}") from None
    if crc != obj.get("crc"):
        raise CheckpointCorruptError(
            "checksum mismatch (torn or corrupted write)")
    try:
        return _msgpack.unpackb(payload), json.loads(bytes(meta_bytes))
    except Exception as exc:
        raise CheckpointCorruptError(
            f"undecodable checkpoint sections: {exc}") from None


def _leaf_from(rec, key, ref):
    """The stored array of ``key`` as ``ref``'s kind of leaf: a tensor on
    ``ref``'s device, else a writable numpy array."""
    name, shape = rec["dtype"], tuple(rec["shape"])
    ref_shape = tuple(ref.shape) if isinstance(ref, torch.Tensor) \
        else tuple(np.shape(ref))
    ref_name = _dtype_name(ref)
    if shape != ref_shape:
        raise ValueError(
            f"checkpoint key '{key}' has shape {shape}, the reference tree "
            f"expects {ref_shape}")
    if name != ref_name:
        raise ValueError(
            f"checkpoint key '{key}' has dtype {name}, the reference tree "
            f"expects {ref_name}")
    bits = np.int16 if name == "bfloat16" else np.dtype(name)
    a = np.frombuffer(rec["data"], dtype=bits).reshape(shape)
    if not isinstance(ref, torch.Tensor):
        return a.copy()
    t = torch.from_numpy(a)
    if name == "bfloat16":
        t = t.view(torch.bfloat16)
    # copy=True: the restored leaf owns its memory (never a view of the
    # file's buffer), so it is writable and in-place updates are safe
    return t.to(ref.device, copy=True)


def _rebuild(flat: dict, like):
    """``like``'s structure filled from the table; errors name the
    offending key on missing/extra keys and shape/dtype drift."""
    used = set()

    def build(node, path):
        kids = _children(node)
        if kids is None:
            key = _key_str(path)
            if key not in flat:
                raise KeyError(f"checkpoint missing key '{key}'")
            used.add(key)
            return _leaf_from(flat[key], key, node)
        if node is None:
            return None
        built = {k: build(child, path + (k,)) for k, child in kids}
        if isinstance(node, dict):
            return {k: built[k] for k in node}
        return type(node)(built[i] for i in range(len(node)))

    out = build(like, ())
    extra = sorted(set(flat) - used)
    if extra:
        raise ValueError(
            f"checkpoint carries keys the reference tree does not: "
            f"{extra} (stale or mismatched checkpoint?)")
    return out


def _atomic_write(path: str, blob) -> None:
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(blob)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _read(path: str) -> bytearray:
    """The whole file in one writable buffer (restored leaves are copied
    out of it)."""
    with open(path, "rb") as f:
        raw = bytearray(os.fstat(f.fileno()).st_size)
        n = f.readinto(raw)
    return raw[:n] if n != len(raw) else raw


# reserved meta key recording the residency policy whose stored-layout
# panels the blob carries ({kind: storage name}); written only when the
# caller passes residency=, so user meta dicts round-trip untouched
RESIDENCY_META_KEY = "_residency_policy"


def _stamp_residency(meta, residency):
    if residency is None:
        return meta
    meta = dict(meta) if meta else {}
    meta[RESIDENCY_META_KEY] = {str(k): str(v)
                                for k, v in dict(residency).items()}
    return meta


def check_residency(meta, expected) -> None:
    """Refuse a stored-layout restore under the wrong residency policy.

    Compares the blob's recorded policy against ``expected`` ({kind:
    storage name}) over the union of kinds (a kind absent from a policy is
    the f32 identity) and raises ValueError naming every mismatched kind.
    Blobs without a recorded policy pass (structure drift still trips
    :func:`_rebuild`'s keyed errors)."""
    if expected is None:
        return
    recorded = (meta or {}).get(RESIDENCY_META_KEY)
    if recorded is None:
        return
    expected = {str(k): str(v) for k, v in dict(expected).items()}
    bad = []
    for kind in sorted(set(recorded) | set(expected)):
        got = recorded.get(kind, "f32")
        want = expected.get(kind, "f32")
        if got != want:
            bad.append(f"{kind}: checkpoint stores '{got}', engine "
                       f"configured '{want}'")
    if bad:
        raise ValueError(
            "checkpoint residency policy does not match the engine's "
            "--residency; restoring would decode stored panels with the "
            "wrong codec (" + "; ".join(bad) + ")")


def save(path: str, tree, meta=None, residency=None) -> None:
    """Atomic single-file save (versioned format; ``meta`` is any
    JSON-serializable host-side dict riding next to the arrays).
    ``residency`` ({kind: storage name}) stamps the policy whose
    stored-layout panels the blob carries (:func:`check_residency`)."""
    blob, _ = _pack_blob(_flatten_to_host(tree),
                         _stamp_residency(meta, residency))
    _atomic_write(path, blob)


def restore(path: str, like, with_meta: bool = False,
            expect_residency=None):
    """Rebuild ``like``'s structure from a checkpoint file: tensors on the
    devices of ``like``'s tensors, writable. Raises CheckpointCorruptError
    on torn/corrupt files, KeyError/ValueError naming the offending key on
    structure drift; ``expect_residency`` ({kind: storage name}) refuses a
    blob stamped with a different residency policy."""
    flat, meta = _unpack_blob(_read(path))
    check_residency(meta, expect_residency)
    tree = _rebuild(flat, like)
    return (tree, meta) if with_meta else tree


class Checkpointer:
    """Retention + manifest + async commit over a checkpoint directory.

    ``fingerprint`` (a flat JSON-serializable dict describing the run
    configuration) guards resumes: reopening a non-empty directory with a
    different fingerprint raises, naming the differing keys.

    ``save(step, tree, meta, block=True)`` snapshots the state to host ON
    THE CALLER THREAD (so the caller may update the live tensors in place
    at once) and, with ``block=False``, packs and writes on a background
    thread; the next ``save``/``wait``/``restore_latest`` joins it and
    re-raises any stored error.

    ``events`` may be an :class:`repro_torch.telemetry.EventLog`; saves then
    record operational ``checkpoint_save`` lines (step, bytes, wall time) in
    its wall-clock sidecar, never in the deterministic stream.
    """

    def __init__(self, directory: str, keep: int = 3, fingerprint=None,
                 events=None, residency=None):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.keep = int(keep)
        if self.keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self.fingerprint = fingerprint
        self.events = events
        # {kind: storage name} of the run's residency policy: stamped into
        # every save's meta and enforced by restore_latest
        self.residency = dict(residency) if residency else None
        self._thread = None
        self._error = None
        self._manifest = self._load_manifest()
        if fingerprint is not None and self._manifest["checkpoints"]:
            old = self._manifest.get("fingerprint") or {}
            diff = sorted(k for k in set(old) | set(fingerprint)
                          if old.get(k) != fingerprint.get(k))
            if diff:
                raise ValueError(
                    f"checkpoint directory {self.directory} belongs to a "
                    f"different run configuration; differing keys: {diff}")

    def _manifest_path(self) -> str:
        return os.path.join(self.directory, MANIFEST_NAME)

    def _load_manifest(self) -> dict:
        try:
            with open(self._manifest_path(), "r") as f:
                man = json.load(f)
            if isinstance(man, dict) and isinstance(
                    man.get("checkpoints"), list):
                return man
        except (OSError, ValueError):
            pass
        return {"version": FORMAT_VERSION, "fingerprint": None,
                "checkpoints": []}

    def save(self, step: int, tree, meta=None, block: bool = True) -> None:
        self.wait()
        flat = _flatten_to_host(tree)
        if block:
            self._commit(int(step), flat, meta)
            return
        self._thread = threading.Thread(
            target=self._commit_guarded, args=(int(step), flat, meta),
            daemon=True)
        self._thread.start()

    def _commit_guarded(self, step, flat, meta):
        try:
            self._commit(step, flat, meta)
        except BaseException as exc:  # re-raised from wait()
            self._error = exc

    def _commit(self, step, flat, meta):
        t0 = time.perf_counter()
        blob, crc = _pack_blob(flat, _stamp_residency(meta, self.residency))
        fname = f"step_{step:08d}.ckpt"
        _atomic_write(os.path.join(self.directory, fname), blob)
        if self.events is not None:  # sidecar only (emit_op is thread-safe)
            self.events.emit_op("checkpoint_save", step=int(step),
                                bytes=len(blob),
                                dt=time.perf_counter() - t0)
        ckpts = [c for c in self._manifest["checkpoints"]
                 if c["step"] != step]
        ckpts.append({"step": step, "file": fname, "bytes": len(blob),
                      "crc": crc})
        ckpts.sort(key=lambda c: c["step"])
        while len(ckpts) > self.keep:
            old = ckpts.pop(0)
            try:
                os.remove(os.path.join(self.directory, old["file"]))
            except OSError:
                pass
        self._manifest["checkpoints"] = ckpts
        if self.fingerprint is not None:
            self._manifest["fingerprint"] = self.fingerprint
        _atomic_write(self._manifest_path(),
                      json.dumps(self._manifest, indent=1).encode())

    def wait(self) -> None:
        """Join a pending async commit; re-raise its error, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            exc, self._error = self._error, None
            raise exc

    def latest_step(self):
        cks = self._manifest["checkpoints"]
        return cks[-1]["step"] if cks else None

    def restore_latest(self, like):
        """(step, tree, meta) from the newest GOOD checkpoint, or None.

        Scans the manifest plus any on-disk ``step_*.ckpt`` orphans (a
        checkpoint whose manifest update was lost), newest first; a
        corrupt/torn file warns (RuntimeWarning) and falls back to the
        previous one. A residency-policy mismatch raises instead of falling
        back: every sibling checkpoint carries the same stamp."""
        self.wait()
        cands = {c["file"]: c["step"]
                 for c in self._manifest["checkpoints"]}
        try:
            names = os.listdir(self.directory)
        except OSError:
            names = []
        for fn in names:
            mobj = _STEP_FILE.fullmatch(fn)
            if mobj and fn not in cands:
                cands[fn] = int(mobj.group(1))
        for fn, step in sorted(cands.items(), key=lambda kv: -kv[1]):
            path = os.path.join(self.directory, fn)
            try:
                tree, meta = restore(path, like, with_meta=True,
                                     expect_residency=self.residency)
            except FileNotFoundError:
                continue
            except CheckpointCorruptError as exc:
                warnings.warn(
                    f"checkpoint {fn} is corrupt ({exc}); falling back to "
                    "the previous good checkpoint", RuntimeWarning,
                    stacklevel=2)
                continue
            return step, tree, meta
        return None
