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

A sharded run (``launch/mesh.py``) saves through
:class:`ShardedCheckpointer`: each rank writes its blocks of the state
(``core.dsgd.panel_state_layout``) as blobs of this same format, in parts
whose payloads stay under the one-bin limit, so a state of any size can be
saved (22.8 GB at olmo-1b's full width and m = 8, where one blob cannot
hold it); a step is committed once every rank's parts are on disk.
:func:`restore_latest` restores a directory's newest good step into any
layout: the same mesh, another mesh, or one process, from a sharded step
or from a whole blob (the port's one-process blob or the reference's).
:func:`assemble` writes the whole-state blob of a sharded step, which the
reference's ``checkpoint.io.restore`` reads. A sharded directory itself is
NOT a directory the reference reads (its manifest names parts, not one
file a step): hand the reference an assembled blob.
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


def _table(flat: dict):
    """The array table of ``flat`` ({key: (dtype name, array)}) as
    unjoined pieces (``_msgpack.Pieces``: its ``nbytes`` is the payload's
    size); the arrays' buffers are pieces of their own, not copied."""
    return _msgpack.Pieces(_msgpack.pack_pieces(
        {k: {"dtype": name, "shape": list(a.shape),
             "data": memoryview(np.ascontiguousarray(a)).cast("B")}
         for k, (name, a) in flat.items()}))


def _blob_pieces(flat: dict, meta, table=None) -> tuple:
    """(pieces, bytes, crc) of the blob of ``flat``'s table (or of
    ``table``, :func:`_table`'s) and ``meta``: the pieces whose
    concatenation is the blob, written by :func:`_write_pieces` without
    joining them, so the host snapshot is the only copy of the data."""
    table = _table(flat) if table is None else table
    meta_bytes = json.dumps(meta if meta is not None else {}).encode()
    crc = zlib.crc32(meta_bytes)
    for p in table.parts:
        crc = zlib.crc32(p, crc)
    crc &= 0xFFFFFFFF
    pieces = _msgpack.pack_pieces({"version": FORMAT_VERSION,
                                   "meta": meta_bytes, "crc": crc,
                                   "payload": table})
    return pieces, sum(memoryview(p).nbytes for p in pieces), crc


def _unpack_blob(raw, crc=None) -> tuple:
    """(flat array table, meta dict); CheckpointCorruptError on any
    decode/checksum failure, or when ``crc`` is given and the blob's is
    another (a part left by another save). A map without a 'version' key
    is the legacy flat format (no meta, no checksum). The table's ``data``
    are views of ``raw``."""
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
    want = crc
    try:
        crc = zlib.crc32(payload, zlib.crc32(meta_bytes)) & 0xFFFFFFFF
    except TypeError as exc:
        raise CheckpointCorruptError(
            f"undecodable checkpoint sections: {exc}") from None
    if crc != obj.get("crc"):
        raise CheckpointCorruptError(
            "checksum mismatch (torn or corrupted write)")
    if want is not None and want != crc:
        raise CheckpointCorruptError(
            f"checksum {crc} where the manifest names {want} (a part of "
            "another save)")
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


def _map_like(node, leaf, path=()):
    """``node``'s structure (dicts in their own key order, lists and tuples
    by index), each leaf replaced by ``leaf(key, node)``. A module-level
    recursion: a recursive closure would be a reference cycle holding what
    it closes over (a restore's table or tensors) until the garbage
    collector runs."""
    kids = _children(node)
    if kids is None:
        return leaf(_key_str(path), node)
    if node is None:
        return None
    built = {k: _map_like(child, leaf, path + (k,)) for k, child in kids}
    if isinstance(node, dict):
        return {k: built[k] for k in node}
    return type(node)(built[i] for i in range(len(node)))


def _rebuild(flat: dict, like):
    """``like``'s structure filled from the table; errors name the
    offending key on missing/extra keys and shape/dtype drift."""
    used = set()

    def leaf(key, node):
        if key not in flat:
            raise KeyError(f"checkpoint missing key '{key}'")
        used.add(key)
        return _leaf_from(flat[key], key, node)

    out = _map_like(like, leaf)
    extra = sorted(set(flat) - used)
    if extra:
        raise ValueError(
            f"checkpoint carries keys the reference tree does not: "
            f"{extra} (stale or mismatched checkpoint?)")
    return out


def _write_pieces(path: str, pieces) -> None:
    """Atomic write of a file given as pieces (tmp file + fsync +
    os.replace), with no join of the pieces."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        for p in pieces:
            f.write(p)
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
    pieces, _, _ = _blob_pieces(_flatten_to_host(tree),
                                _stamp_residency(meta, residency))
    _write_pieces(path, pieces)


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
        self._manifest = _load_manifest(self.directory)
        _guard(self._manifest, fingerprint, self.directory)

    def _manifest_path(self) -> str:
        return os.path.join(self.directory, MANIFEST_NAME)

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
        pieces, nbytes, crc = _blob_pieces(
            flat, _stamp_residency(meta, self.residency))
        fname = f"step_{step:08d}.ckpt"
        _write_pieces(os.path.join(self.directory, fname), pieces)
        del pieces
        if self.events is not None:  # sidecar only (emit_op is thread-safe)
            self.events.emit_op("checkpoint_save", step=int(step),
                                bytes=nbytes,
                                dt=time.perf_counter() - t0)
        ckpts = [c for c in self._manifest["checkpoints"]
                 if c["step"] != step]
        ckpts.append({"step": step, "file": fname, "bytes": nbytes,
                      "crc": crc})
        ckpts.sort(key=lambda c: c["step"])
        while len(ckpts) > self.keep:
            _drop(self.directory, ckpts.pop(0))
        self._manifest["checkpoints"] = ckpts
        if self.fingerprint is not None:
            self._manifest["fingerprint"] = self.fingerprint
        _write_pieces(self._manifest_path(),
                      [json.dumps(self._manifest, indent=1).encode()])

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
        """(step, tree, meta) from the newest GOOD checkpoint, or None
        (:func:`restore_latest`, one process: the manifest's entries and
        any on-disk ``step_*.ckpt`` orphan, newest first; a missing,
        corrupt or torn file warns (RuntimeWarning) and falls back to the
        previous one; a residency-policy mismatch or a leaf of another
        shape raises instead: every sibling checkpoint carries the same)."""
        self.wait()
        return restore_latest(self.directory, like, residency=self.residency)


# ------------------------------------------------------ sharded checkpoints
#
# A sharded run (launch/mesh.py) saves each rank's blocks of its state
# (``core.dsgd.panel_state_layout``) as version-2 blobs of the format
# above, one or more PARTS a rank, a part's payload under
# MAX_PAYLOAD_BYTES, in a directory a step:
#
#   DIR/MANIFEST.json                  rank 0's: the committed steps
#   DIR/step_00000002/r00000_p000.ckpt rank 0's part 0 (its leaves under
#                                      1 MiB: the scalar and replicated
#                                      ones every rank reads)
#   DIR/step_00000002/r00003.done      rank 3's done marker: its parts,
#                                      their CRCs and pieces
#
# A part's ``meta`` carries the run's meta and, under SHARDED_META_KEY, the
# mesh, the rank's coordinate, the part's PIECES ({key: [[lo, hi], ...]},
# each a block of the whole leaf) and every leaf's whole shape in the whole
# tree's flatten order. A step enters the manifest only after every rank's
# parts are fsynced and its marker names them; rank 0's commit thread waits
# for the markers (no collective leaves the caller's thread). A restore
# cuts each rank's blocks of ANY layout (the same mesh, another, or one
# process) out of the pieces that overlap them, and every rank takes the
# same step: the newest that every rank reads whole.

SHARDED_META_KEY = "_sharded"
# seconds rank 0's commit thread waits for every rank's marker of a step
COMMIT_TIMEOUT = 1800.0
# a rank's done marker of a step, in the step's directory
_DONE = "r{rank:05d}.done"


def _drop(directory: str, entry) -> None:
    """Remove a retired checkpoint: a whole blob's file, or a sharded
    step's directory."""
    import shutil
    try:
        if "parts" in entry:
            shutil.rmtree(os.path.join(directory, entry["dir"]))
        else:
            os.remove(os.path.join(directory, entry["file"]))
    except OSError:
        pass


def _entry_bytes(key: str, name: str, shape) -> int:
    """Bytes of one array-table entry but its data: what a part pays for a
    leaf beside the leaf's bytes."""
    return len(_msgpack.packb({key: {"dtype": name, "shape": list(shape),
                                     "data": b""}})) + 4


def _split(a, index, budget):
    """A block too large for one part, as [(index, array)] pieces of at
    most ``budget`` bytes: runs of whole rows (of a 2-D block, runs of
    columns of one row when a row alone is over)."""
    if a.nbytes <= budget or a.ndim == 0:
        return [(index, a)]
    if a.ndim == 1:
        step = max(1, budget // a.itemsize)
        return [(((index[0][0] + lo, index[0][0] + min(lo + step,
                                                         a.shape[0])),),
                 a[lo:lo + step]) for lo in range(0, a.shape[0], step)]
    row = a[0].nbytes
    if row > budget:
        out = []
        for r in range(a.shape[0]):
            r_idx = ((index[0][0] + r, index[0][0] + r + 1),)
            for (c_idx,), sub in _split(a[r], index[1:], budget):
                out.append((r_idx + (c_idx,), sub[None]))
        return out
    step = max(1, budget // row)
    return [(((index[0][0] + lo, index[0][0] + min(lo + step, a.shape[0])),)
             + tuple(index[1:]), a[lo:lo + step])
            for lo in range(0, a.shape[0], step)]


def _parts(flat: dict, part_bytes: int) -> list:
    """The rank's owned pieces packed into parts, each a {key: (name,
    array, index)} whose payload stays under ``part_bytes``: the leaves
    under 1 MiB (the scalars and the replicated leaves every rank reads)
    in part 0 alone, then the blocks in flatten order, a block larger than
    a part in pieces of parts of their own."""
    small = {k: v for k, v in flat.items() if v[1].nbytes < (1 << 20)}
    big = [(k, v) for k, v in flat.items() if k not in small]
    parts = [small] if small and big else []
    cur, used = ({}, 0) if parts else (dict(small), sum(
        _entry_bytes(k, n, a.shape) + a.nbytes for k, (n, a, _) in
        small.items()))
    part_bytes -= 64  # the table's own map header, with room to spare
    for k, (name, a, index) in big:
        over = _entry_bytes(k, name, a.shape)
        need = over + a.nbytes
        if used + need > part_bytes and cur:
            parts.append(cur)
            cur, used = {}, 0
        if need <= part_bytes:
            cur[k] = (name, a, index)
            used += need
            continue
        for idx, sub in _split(a, index, part_bytes - over):
            if cur:
                parts.append(cur)
            cur, used = {k: (name, sub, idx)}, over + sub.nbytes
    if cur or not parts:
        parts.append(cur)
    return parts


def _layout_leaves(like, layout):
    """[(key, like leaf, Block)] in flatten order; ``layout`` None: every
    leaf whole."""
    from repro_torch.core.panel import whole_block
    leaves = list(_leaves_with_path(like))
    blocks = ([b for _, b in _leaves_with_path(layout)] if layout is not None
              else [whole_block(_shape(leaf)) for _, leaf in leaves])
    if len(blocks) != len(leaves):
        raise ValueError(f"the layout has {len(blocks)} leaves, the tree "
                         f"{len(leaves)}")
    return [(_key_str(kp), leaf, b) for (kp, leaf), b in zip(leaves, blocks)]


def _shape(leaf):
    return tuple(leaf.shape) if isinstance(leaf, torch.Tensor) \
        else np.shape(leaf)


def _mesh_meta(mesh) -> dict:
    if mesh is None:
        return {"rank": 0, "world": 1, "mesh": None, "coord": None}
    return {"rank": mesh.rank, "world": int(np.prod(list(
        mesh.shape.values()))), "mesh": dict(mesh.shape),
        "coord": dict(mesh.coord)}


class ShardedCheckpointer:
    """Retention + manifest + async commit of a sharded run's checkpoints
    (see the section comment above): every rank of ``mesh`` makes one, on
    the same directory (a file system the ranks share).

    ``save(step, tree, layout, meta, block=True)`` snapshots this rank's
    owned blocks (``layout``: a tree of ``panel.Block`` over ``tree``'s
    leaves, whose local shapes the leaves have) to host on the caller's
    thread, after one collective there (rank 0's token for the step, so a
    marker left by an earlier attempt at the same step is never taken for
    this one); the parts are written, fsynced and named in the rank's
    marker on a background thread (``block=False``), and rank 0's thread
    then waits up to COMMIT_TIMEOUT seconds for every rank's marker
    before it names the step in ``MANIFEST.json`` and retires the steps
    past the newest ``keep``. A part's payload is at most ``part_bytes``.

    ``fingerprint`` guards resumes as :class:`Checkpointer`'s does;
    ``residency`` stamps every part; ``events`` records
    ``checkpoint_save`` lines in the event log's wall-clock sidecar.
    :func:`restore_latest` reads the directory back."""

    def __init__(self, directory: str, mesh, keep: int = 3,
                 fingerprint=None, events=None, residency=None,
                 part_bytes: int = MAX_PAYLOAD_BYTES):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.mesh = mesh
        self.keep = int(keep)
        if self.keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        if not 0 < part_bytes <= MAX_PAYLOAD_BYTES:
            raise ValueError(f"part_bytes must be in (0, "
                             f"{MAX_PAYLOAD_BYTES}], got {part_bytes}")
        self.part_bytes = int(part_bytes)
        self.fingerprint = fingerprint
        self.events = events
        self.residency = dict(residency) if residency else None
        self.rank = 0 if mesh is None else mesh.rank
        self._thread = None
        self._error = None
        self._manifest = _load_manifest(self.directory)
        _guard(self._manifest, fingerprint, self.directory)

    def save(self, step: int, tree, layout, meta=None,
             block: bool = True) -> None:
        from repro_torch.launch import mesh as mesh_mod
        self.wait()
        token = mesh_mod.broadcast_json(self.mesh, os.urandom(8).hex())
        flat, keys = {}, []
        for key, leaf, b in _layout_leaves(tree, layout):
            keys.append((key, list(b.shape)))
            if b.owner:
                name, a = _host(leaf)
                if tuple(a.shape) != b.local_shape:
                    raise ValueError(f"leaf '{key}' has shape {a.shape}, "
                                     f"its block {b.local_shape}")
                flat[key] = (name, a, b.index)
        args = (int(step), flat, keys, meta, token)
        if block:
            self._commit(*args)
            return
        self._thread = threading.Thread(target=self._commit_guarded,
                                        args=args, daemon=True)
        self._thread.start()

    def _commit_guarded(self, *args):
        try:
            self._commit(*args)
        except BaseException as exc:  # re-raised from wait()
            self._error = exc

    def _commit(self, step, flat, keys, meta, token):
        t0 = time.perf_counter()
        sdir = f"step_{step:08d}"
        where = _mesh_meta(self.mesh)
        meta = _stamp_residency(meta, self.residency)
        entries = []
        for i, part in enumerate(_parts(flat, self.part_bytes)):
            fname = f"{sdir}/r{self.rank:05d}_p{i:03d}.ckpt"
            pieces = {k: [list(ix) for ix in idx]
                      for k, (_, _, idx) in part.items()}
            pmeta = dict(meta or {})
            pmeta[SHARDED_META_KEY] = {**where, "step": step, "part": i,
                                       "pieces": pieces, "keys": keys}
            table = _table({k: (name, a) for k, (name, a, _) in
                            part.items()})
            if table.nbytes > MAX_PAYLOAD_BYTES:
                raise ValueError(f"part {fname}'s payload is {table.nbytes}"
                                 f" B, over {MAX_PAYLOAD_BYTES} B")
            blob, nbytes, crc = _blob_pieces(None, pmeta, table)
            _write_pieces(os.path.join(self.directory, fname), blob)
            del blob
            entries.append({"file": fname, "rank": self.rank,
                            "bytes": nbytes, "crc": crc, "pieces": pieces})
        _write_pieces(os.path.join(self.directory, sdir,
                                   _DONE.format(rank=self.rank)),
                      [json.dumps({"token": token,
                                   "parts": entries}).encode()])
        if self.events is not None:
            self.events.emit_op("checkpoint_save", step=int(step),
                                bytes=sum(e["bytes"] for e in entries),
                                dt=time.perf_counter() - t0)
        if self.rank != 0:
            return
        parts = self._await_markers(sdir, where["world"], token)
        entry = {"step": step, "dir": sdir, "mesh": where["mesh"],
                 "world": where["world"], "keys": keys, "parts": parts}
        ckpts = [c for c in self._manifest["checkpoints"]
                 if c["step"] != step]
        ckpts.append(entry)
        ckpts.sort(key=lambda c: c["step"])
        while len(ckpts) > self.keep:
            _drop(self.directory, ckpts.pop(0))
        self._manifest["checkpoints"] = ckpts
        if self.fingerprint is not None:
            self._manifest["fingerprint"] = self.fingerprint
        _write_pieces(os.path.join(self.directory, MANIFEST_NAME),
                      [json.dumps(self._manifest, indent=1).encode()])

    def _await_markers(self, sdir, world, token):
        """Every rank's parts of this step, once all ``world`` markers
        carrying ``token`` are on disk (rank 0's commit thread)."""
        deadline = time.monotonic() + COMMIT_TIMEOUT
        parts = {}
        while len(parts) < world:
            for r in range(world):
                if r in parts:
                    continue
                try:
                    with open(os.path.join(self.directory, sdir,
                                           _DONE.format(rank=r))) as f:
                        mark = json.load(f)
                except (OSError, ValueError):
                    continue
                if mark.get("token") == token:
                    parts[r] = mark["parts"]
            if len(parts) < world:
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"checkpoint {sdir}: ranks "
                        f"{sorted(set(range(world)) - set(parts))} wrote no "
                        f"marker in {COMMIT_TIMEOUT} s; the step is "
                        "not committed")
                time.sleep(0.02)
        return [p for r in range(world) for p in parts[r]]

    def wait(self) -> None:
        """Join a pending async commit; re-raise its error, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            exc, self._error = self._error, None
            raise exc


def _load_manifest(directory: str) -> dict:
    try:
        with open(os.path.join(directory, MANIFEST_NAME), "r") as f:
            man = json.load(f)
        if isinstance(man, dict) and isinstance(man.get("checkpoints"),
                                                list):
            return man
    except (OSError, ValueError):
        pass
    return {"version": FORMAT_VERSION, "fingerprint": None,
            "checkpoints": []}


def _guard(manifest, fingerprint, directory) -> None:
    """ValueError when a non-empty directory belongs to another run
    configuration (naming the differing keys)."""
    if fingerprint is None or not manifest["checkpoints"]:
        return
    old = manifest.get("fingerprint") or {}
    diff = sorted(k for k in set(old) | set(fingerprint)
                  if old.get(k) != fingerprint.get(k))
    if diff:
        raise ValueError(
            f"checkpoint directory {directory} belongs to a different run "
            f"configuration; differing keys: {diff}")


def _candidates(directory: str) -> list:
    """[(step, entry)] newest first: the manifest's entries (whole blobs
    and sharded steps) and any on-disk ``step_*.ckpt`` orphan (a whole
    blob whose manifest update was lost)."""
    man = _load_manifest(directory)
    cands = {}
    for c in man["checkpoints"]:
        cands[c.get("dir") or c["file"]] = (c["step"], c)
    try:
        names = os.listdir(directory)
    except OSError:
        names = []
    for fn in names:
        mobj = _STEP_FILE.fullmatch(fn)
        if mobj and fn not in cands:
            cands[fn] = (int(mobj.group(1)), {"step": int(mobj.group(1)),
                                               "file": fn})
    return sorted(cands.values(), key=lambda se: -se[0])


# integer counters a reference blob stores as int32 scalars ('step', the
# optimizer's shared 'step_count'); the port's tree holds them as int64,
# the count per agent
_COUNTERS = ("state/step", "state/opt/step_count")


def _whole_pieces(flat: dict, targets: dict) -> dict:
    """{key: [(index, array)]} of a whole blob's table, each leaf one piece
    of its full index. A reference launcher's blob is taken too: its int32
    counters widened (a shared step count broadcast to the agents), and
    its 'key' (a jax.random key, which the port's generator cannot take
    up) leaves 'wire_gen' as the caller's."""
    out = {}
    for key, rec in flat.items():
        name, shape = rec["dtype"], tuple(rec["shape"])
        bits = np.int16 if name == "bfloat16" else np.dtype(name)
        a = np.frombuffer(rec["data"], dtype=bits).reshape(shape)
        if key in _COUNTERS and key in targets:
            want = targets[key][1].shape
            if np.issubdtype(a.dtype, np.integer) and shape != want \
                    and a.ndim == 0:
                a = np.broadcast_to(a, want)
            a = a.astype(np.int64)
            name = "int64"
        if key in targets:
            _check_shape(key, a.shape, targets[key][1].shape)
        out[key] = (name, [(tuple((0, s) for s in a.shape), a)])
    if "wire_gen" in targets and "wire_gen" not in out and "key" in out:
        del out["key"]
    return out


def _check_shape(key, shape, want) -> None:
    """ValueError naming ``key`` when a checkpoint's whole leaf has another
    shape than the tree's (structure drift: no older step of the same run
    holds another, so it raises instead of falling back)."""
    if tuple(shape) != tuple(want):
        raise ValueError(f"checkpoint key '{key}' has shape {tuple(shape)}"
                         f", the reference tree expects {tuple(want)}")


def _fill(targets, key, name, pieces, got) -> None:
    """Cut ``pieces`` of leaf ``key`` into its target block; ``got``
    counts the elements each target has received."""
    from repro_torch.core.panel import cut_into
    if key not in targets:
        raise ValueError(
            f"checkpoint carries key '{key}' the reference tree does not "
            "(stale or mismatched checkpoint?)")
    leaf, b, out = targets[key]
    want = _dtype_name(leaf)
    if name != want:
        raise ValueError(f"checkpoint key '{key}' has dtype {name}, the "
                         f"reference tree expects {want}")
    for idx, a in pieces:
        if len(idx) != len(b.shape) or any(
                hi > s for (_, hi), s in zip(idx, b.shape)):
            raise ValueError(f"checkpoint key '{key}' holds {idx}, outside "
                             f"the leaf's shape {b.shape}")
        got[key] += cut_into(out, b.index, a, tuple(map(tuple, idx)))


def _read_entry(directory, entry, targets, residency, rank):
    """Fill ``targets`` ({key: (like leaf, Block, out)}) from one
    checkpoint: the parts whose pieces overlap a target block (always
    every part holding a leaf the rank needs whole). Returns the run's
    meta. CheckpointCorruptError on a missing, torn or corrupt part."""
    from repro_torch.core.panel import overlap
    got = dict.fromkeys(targets, 0)
    meta = None
    if "parts" not in entry:
        try:
            flat, meta = _unpack_blob(_read(os.path.join(directory,
                                                         entry["file"])))
        except FileNotFoundError as exc:
            raise CheckpointCorruptError(f"missing file: {exc}") from None
        check_residency(meta, residency)
        # a reference launcher's blob: its jax.random 'key' in place of
        # the port's generator, which stays the caller's
        gen = "wire_gen" in targets and "wire_gen" not in flat \
            and "key" in flat
        pieces = _whole_pieces(flat, targets)
        for key in targets:
            if key not in pieces and not (gen and key == "wire_gen"):
                raise KeyError(f"checkpoint missing key '{key}'")
        for key, (name, ps) in pieces.items():
            _fill(targets, key, name, ps, got)
        if gen:
            leaf, b, out = targets["wire_gen"]  # the caller's generator
            out.copy_(leaf)
            got["wire_gen"] = b.size
    else:
        for key in sorted(set(targets) - {k for k, _ in entry["keys"]}):
            raise KeyError(f"checkpoint missing key '{key}'")
        for key, shape in entry["keys"]:
            if key not in targets:
                raise ValueError(
                    f"checkpoint carries key '{key}' the reference tree "
                    "does not (stale or mismatched checkpoint?)")
            _check_shape(key, shape, targets[key][1].shape)
        for part in entry["parts"]:
            if not any(overlap(targets[k][1].index, tuple(map(tuple, ix)))
                       is not None for k, ix in part["pieces"].items()):
                continue
            path = os.path.join(directory, part["file"])
            try:
                raw = _read(path)
            except FileNotFoundError:
                raise CheckpointCorruptError(
                    f"part {part['file']} is missing") from None
            flat, pmeta = _unpack_blob(raw, crc=part["crc"])
            sh = pmeta.pop(SHARDED_META_KEY, None)
            if sh is None or sh.get("step") != entry["step"]:
                raise CheckpointCorruptError(
                    f"part {part['file']} is not a part of step "
                    f"{entry['step']}")
            check_residency(pmeta, residency)
            if meta is None:
                meta = pmeta
            for key, rec in flat.items():
                name, shape = rec["dtype"], tuple(rec["shape"])
                bits = np.int16 if name == "bfloat16" else np.dtype(name)
                a = np.frombuffer(rec["data"], dtype=bits).reshape(shape)
                _fill(targets, key, name,
                      [(tuple(map(tuple, sh["pieces"][key])), a)], got)
            del flat, raw
    short = [k for k, (_, b, _) in targets.items() if got[k] != b.size]
    if short:
        raise CheckpointCorruptError(
            f"checkpoint step {entry['step']} does not hold rank {rank}'s "
            f"blocks of {short}")
    return meta or {}


def restore_latest(directory: str, like, layout=None, mesh=None,
                   residency=None):
    """(step, tree, meta) of the newest checkpoint of ``directory`` that
    this rank reads whole, or None: ``like``'s structure, each leaf this
    rank's block of it (``layout``, a tree of ``panel.Block``; None: every
    leaf whole, one process), cut from a checkpoint of ANY layout: a
    sharded step saved on any mesh (only the parts that overlap the
    rank's blocks are read), or a whole blob (the port's one-process blob
    or the reference's). Tensors land on the devices of ``like``'s
    tensors; other leaves come back as numpy arrays.

    On a ``mesh`` every rank takes the same step: rank 0's list of
    candidates is broadcast, and a step counts only when every rank read
    its blocks of it (an all-reduce of the minimum of a success flag), so
    a torn or corrupt part on one rank sends every rank back to the
    previous good step (each rank that read it whole warns that another
    did not). A residency-policy mismatch raises on every rank."""
    from repro_torch.launch import mesh as mesh_mod
    cands = mesh_mod.broadcast_json(mesh, _candidates(directory))
    rank = 0 if mesh is None else mesh.rank
    leaves = _layout_leaves(like, layout)
    for step, entry in cands:
        targets = {}
        for key, leaf, b in leaves:
            if isinstance(leaf, torch.Tensor):
                out = torch.empty(b.local_shape, dtype=leaf.dtype,
                                  device=leaf.device)
            else:
                out = np.empty(b.local_shape, dtype=np.asarray(leaf).dtype)
            targets[key] = (leaf, b, out)
        err = None
        try:
            meta = _read_entry(directory, entry, targets, residency, rank)
        except CheckpointCorruptError as exc:
            err = str(exc)
        if not mesh_mod.agree_min(mesh, 0 if err else 1):
            warnings.warn(
                f"checkpoint step {step} is "
                + (f"corrupt on rank {rank} ({err})" if err else
                   "torn on another rank")
                + "; falling back to the previous good checkpoint",
                RuntimeWarning, stacklevel=2)
            continue
        return step, _map_like(like, lambda key, _: targets[key][2]), meta
    return None


def assemble(directory: str, step: int, path: str = None) -> str:
    """Write the whole-state blob of a sharded ``step`` of ``directory``:
    the array table a one-process run saves at that step, byte for byte
    (every leaf whole, in the whole tree's flatten order), with the run's
    meta, to ``path`` (default ``DIR/assembled_step_<step>.ckpt``).
    Returns the path. The reference package's ``checkpoint.io.restore``
    reads it; a sharded directory itself is not one it reads. ValueError
    when the step is not a committed sharded step, or when the whole
    state's payload passes MAX_PAYLOAD_BYTES (the one-bin limit that
    splits a large state into parts)."""
    entry = next((c for s, c in _candidates(directory)
                  if s == step and "parts" in c), None)
    if entry is None:
        raise ValueError(f"{directory} has no committed sharded step {step}")
    shapes = dict((k, tuple(s)) for k, s in entry["keys"])
    whole, meta, names = {}, None, {}
    for part in entry["parts"]:
        flat, pmeta = _unpack_blob(_read(os.path.join(directory,
                                                      part["file"])))
        sh = pmeta.pop(SHARDED_META_KEY)
        if meta is None or sh["rank"] == 0 and sh["part"] == 0:
            meta = pmeta
        for key, rec in flat.items():
            name = rec["dtype"]
            bits = np.int16 if name == "bfloat16" else np.dtype(name)
            a = np.frombuffer(rec["data"], dtype=bits).reshape(rec["shape"])
            if key not in whole:
                whole[key] = np.empty(shapes[key], dtype=bits)
                names[key] = name
            idx = tuple(slice(lo, hi) for lo, hi in sh["pieces"][key])
            whole[key][idx] = a
        del flat
    flat = {k: (names[k], whole[k]) for k, _ in entry["keys"]}
    table = _table(flat)
    if table.nbytes > MAX_PAYLOAD_BYTES:
        raise ValueError(
            f"step {step}'s whole state is a payload of {table.nbytes} B, "
            f"over the blob's {MAX_PAYLOAD_BYTES} B (one msgpack bin): it "
            "exists only as parts")
    path = path or os.path.join(directory, f"assembled_step_{step:08d}.ckpt")
    pieces, _, _ = _blob_pieces(flat, meta, table)
    _write_pieces(path, pieces)
    return path
