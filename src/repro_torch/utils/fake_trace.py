"""Shapes-only traces of the port's own code, on the CPU, with no allocation
(the dry run's instrument, ``launch/dryrun.py``).

:func:`trace` runs a function under ``FakeTensorMode`` (every tensor a
shape, a dtype and a device, no storage) and records:

* **memory**: the peak of the bytes of live tensor storages (each storage
  counted once, however many views share it; a storage is live until its
  last reference goes, autograd's saved tensors included; an indexing
  read's backward accumulates in place, as it does on real tensors), and
  the live bytes at any mark the traced function sets (:meth:`Trace.mark`);
* **FLOPs**: ``torch.utils.flop_counter.FlopCounterMode``'s count (matmuls,
  convolutions, attention) and the bytes the operations read and write
  (each non-view operation's tensor inputs and outputs);
* **collectives**: through a :class:`RecordingMesh`, whose ``all_gather``
  and ``all_reduce`` give tensors of the right shapes and log their calls
  and bytes by kind and line (every line of ``launch.mesh.LINES``: the
  split route's ``model`` and ``block`` beside ``rows`` and ``fsdp``; the
  counts ``launch.mesh.Mesh.stats`` keeps for the same transport) instead
  of communicating.

The CUDA kernels: on the CPU a kernel's wrapper runs its plain version.
Inside a trace each plain version of ``repro_torch.kernels`` is a KERNEL
SCOPE: its intermediate tensors are not counted (the card's kernel makes
none) and only what it returns is; a value it reads on the host (a seed
the kernel reads on the card) gets a placeholder 0. The mix and the reduce
give their outputs' shapes without running their plain versions (loops
over the panel's rows); the elementwise arithmetic of any plain version
adds no FLOPs to ``FlopCounterMode``'s count, which counts matmuls.
Outside a kernel scope a host read of a traced value raises
(``DataDependentOutputException`` from the fake mode), so a host read in
the traced code path itself shows;
:class:`Trace` counts the host reads of each kind. Nothing in the traced
code changes for the trace: the patched names are the kernel modules'
references to their plain versions, restored when the trace ends.
"""
from __future__ import annotations

import contextlib
import weakref
from dataclasses import dataclass, field
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.launch.mesh import Mesh

# the wrapper modules whose plain versions are kernel scopes
_KERNEL_MODULES = ("gossip_mix", "panel_reduce", "wire_quant", "merge_ops",
                   "opt_fused", "flash_attention")


class _Tracker(TorchDispatchMode):
    """Counts the live bytes of the storages the operations make (their
    peak), the bytes the operations read and write, and the host reads."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self.bytes_accessed = 0
        self.scope = 0
        self.lenient = False
        self.host_reads = {"kernel": 0, "allowed": 0, "traced": 0}
        self._seen: Dict[int, int] = {}

    def track(self, out):
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = id(st)
            if key in self._seen:
                continue
            n = st.nbytes()
            self._seen[key] = n
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key, n)

    def _free(self, key, n):
        if self._seen.pop(key, None) is not None:
            self.live -= n

    @staticmethod
    def _nbytes(ts):
        return sum(t.numel() * t.element_size() for t in tree_leaves(ts)
                   if isinstance(t, torch.Tensor))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.ops.aten._local_scalar_dense.default:
            if self.scope or self.lenient:
                self.host_reads["kernel" if self.scope else "allowed"] += 1
                dt = args[0].dtype
                return (False if dt == torch.bool else 0.0
                        if dt.is_floating_point else 0)
            self.host_reads["traced"] += 1
        if func is torch.ops.aten.index_put.default and (
                args[3] if len(args) > 3 else kwargs.get("accumulate")):
            # autograd's backward of an indexing read calls the
            # out-of-place index_put on a fresh zeros tensor for a tensor
            # subclass (a fake) and the in-place one for a real tensor:
            # counted as the card runs it, one tensor, not two
            func = torch.ops.aten.index_put_.default
        out = func(*args, **kwargs)
        if not self.scope:
            self.track(out)
            if not func.is_view:
                self.bytes_accessed += self._nbytes((args, kwargs)) \
                    + self._nbytes(out)
        return out

    @contextlib.contextmanager
    def kernel(self):
        self.scope += 1
        try:
            yield
        finally:
            self.scope -= 1


def _mix_out(W, theta):
    return torch.empty((W.shape[0], theta.shape[1]), dtype=torch.float32,
                       device=theta.device)


def _reduce_out(theta):
    return (torch.empty((theta.shape[1],), dtype=torch.float32,
                        device=theta.device),
            torch.empty((), dtype=torch.float32, device=theta.device))


# kernels whose outputs a trace makes directly, by their shapes: their plain
# versions loop over the panel's rows, an operation a row, which would
# take most of a trace's time for nothing it counts
_OUTPUTS = {"gossip_mix_ref": _mix_out,
            "panel_mean_consensus_ref": _reduce_out}


def _scoped(tracker, fn):
    def run(*args, **kwargs):
        with tracker.kernel():
            out = fn(*args, **kwargs)
        tracker.track(out)
        tracker.bytes_accessed += tracker._nbytes((args, kwargs)) \
            + tracker._nbytes(out)
        return out
    return run


@dataclass
class Trace:
    """What :func:`trace` recorded: ``peak`` (bytes), ``marks`` ({name:
    live bytes when the traced function called ``mark(name)``}),
    ``flops``, ``bytes_accessed``, ``host_reads`` ({"kernel": placeholder
    reads inside plain versions, "allowed": inside
    :meth:`host_reads_allowed`, "traced": any other}) and the value the
    function returned."""
    peak: int = 0
    marks: Dict[str, int] = field(default_factory=dict)
    flops: int = 0
    bytes_accessed: int = 0
    host_reads: Dict[str, int] = field(default_factory=dict)
    value: object = None
    _tracker: object = None
    _flop: object = None

    @contextlib.contextmanager
    def host_reads_allowed(self):
        """Within: a host read of a traced value gets the placeholder 0 (for
        reads whose value nothing traced after them depends on, as an
        eval's final float)."""
        self._tracker.lenient = True
        try:
            yield
        finally:
            self._tracker.lenient = False

    def flops_now(self) -> int:
        """The FLOPs counted so far."""
        return self._flop.get_total_flops()

    def mark(self, name: str) -> None:
        """Record the live bytes, the peak and the FLOPs so far under
        ``name``, ``name.peak`` and ``name.flops``."""
        self.marks[name] = self._tracker.live
        self.marks[name + ".flops"] = self.flops_now()
        self.marks[name + ".peak"] = self._tracker.peak


def trace(fn, *args, **kwargs) -> Trace:
    """Run ``fn(rec, *args, **kwargs)`` (``rec`` the :class:`Trace` being
    filled, for its ``mark``) under ``FakeTensorMode`` with the counters of
    the module docstring; tensors that ``fn`` makes are fakes on their
    devices (make them on the CPU)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    import repro_torch.kernels as kernels
    tracker = _Tracker()
    rec = Trace(_tracker=tracker)
    patched = []
    for name in _KERNEL_MODULES:
        mod = getattr(kernels, "_" + name)
        for attr in dir(mod):
            obj = getattr(mod, attr)
            if attr.endswith("_ref") and callable(obj):
                patched.append((mod, attr, obj))
                setattr(mod, attr, _scoped(tracker, _OUTPUTS.get(attr, obj)))
    try:
        with FakeTensorMode(allow_non_fake_inputs=True), \
                FlopCounterMode(display=False) as flop, tracker:
            rec._flop = flop
            rec.value = fn(rec, *args, **kwargs)
            rec.flops = flop.get_total_flops()
    finally:
        for mod, attr, obj in patched:
            setattr(mod, attr, obj)
    rec.peak = tracker.peak
    rec.bytes_accessed = tracker.bytes_accessed
    rec.host_reads = dict(tracker.host_reads)
    rec._tracker = rec._flop = None
    return rec


@dataclass(eq=False)
class RecordingMesh(Mesh):
    """A :class:`launch.mesh.Mesh` of shape only (``mesh.mesh_of_shape``)
    whose collectives return tensors of the right shapes (under a trace:
    fakes) and record, instead of communicating, what ``Mesh.stats``
    counts for ``route`` ('nccl', 'gloo', 'gloo (host staged)' or 'cuda
    ipc') into ``stats`` and, by (line, kind), into ``log``: the calls and
    temporaries of ``Mesh.plan``, the route's own."""
    route: str = "nccl"
    log: Dict[tuple, Dict[str, int]] = field(default_factory=dict)

    @classmethod
    def of(cls, mesh: Mesh, route: str = "nccl") -> "RecordingMesh":
        return cls(shape=dict(mesh.shape), axis_names=mesh.axis_names,
                   rank=mesh.rank, coord=dict(mesh.coord),
                   device=mesh.device, backend="none",
                   members={k: list(v) for k, v in mesh.members.items()},
                   route=route)

    @property
    def transport(self) -> str:
        return self.route

    def _via_ipc(self, x) -> bool:
        return self.route == "cuda ipc"

    def reset(self) -> None:
        self.stats.update(dict.fromkeys(self.stats, 0))
        self.log.clear()

    def _note(self, line, kind, x, plan):
        calls = len(plan.parts)
        nbytes = sum(hi - lo for lo, hi in plan.parts) * x.element_size()
        self.stats["calls"] += calls
        self.stats["bytes"] += nbytes
        rec = self.log.setdefault((line, kind), {"calls": 0, "bytes": 0})
        rec["calls"] += calls
        rec["bytes"] += nbytes

    def all_gather(self, x, line):
        n = len(self.members[line])
        self._note(line, "all_gather", x, self.plan(x, "all_gather", line))
        return torch.empty((n * x.shape[0],) + tuple(x.shape[1:]),
                           dtype=x.dtype, device=x.device)

    def all_reduce(self, x, line, op="sum"):
        plan = self.plan(x, "all_reduce", line)
        # the route's temporaries, alive together (the trace's peak)
        temps = [torch.empty(s, dtype=x.dtype, device=x.device)
                 for s in plan.temps]
        del temps
        self._note(line, f"all_reduce_{op}", x, plan)
        return x
