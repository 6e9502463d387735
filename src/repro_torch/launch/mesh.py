"""Training meshes over ``torch.distributed`` (counterpart of
``repro/launch/mesh.py``).

A :class:`Mesh` names the ranks of one process group along the reference's
axes ``("pod", "agent", "fsdp", "model")``: rank r sits at the row-major
coordinate of r in ``shape`` (as ``jax.make_mesh`` lays the devices out).
For decentralized training the panel rows (one per agent) are spread over
``("pod", "agent")``, the paper's communication graph, and the flat
parameter columns over ``"fsdp"``; ``"model"`` holds replicas of the
panel (``models/sharding.py``). By default every rank of an agent computes
its whole local step; on the ``param_shardings`` route
(``core.dsgd.make_panel_segment``, ``models/tensor_parallel.py``) the
agent's ranks split it: its batch rows over ``fsdp``, its heads, d_ff
columns and vocabulary over ``model``. Each rank owns one process group
per line of the mesh it lies on (``LINES``): ``rows`` (the ranks that
differ from it in pod and agent only: the gossip partners of its column
shard), ``fsdp`` (the ranks that differ from it in fsdp only: the other
column shards of its agents), ``model`` (those that differ in model only:
the tensor-parallel ranks of the split step) and ``block`` (those that
differ in fsdp and model: the ranks sharing one agent's step).

The ranks come from the environment ``torchrun`` sets (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, with ``MASTER_ADDR``/``MASTER_PORT`` for
the default ``env://`` rendezvous); ``REPRO_TORCH_INIT_METHOD`` replaces the
rendezvous (e.g. ``file:///tmp/rdv``: no TCP port). Rank r computes on
``cuda:LOCAL_RANK`` (modulo the cards present: several ranks may share one
card), or on the CPU when the caller asks for it. The backend is NCCL when
every rank of the host has a card of its own, gloo otherwise (the CPU, or
ranks sharing a card; NCCL refuses two ranks on one device). Under gloo a
CUDA tensor travels one route a layout (``Mesh.transport`` names it):
- ranks that all share ONE card exchange their CUDA tensors through CUDA
  IPC: each rank holds an exchange buffer (``csrc/ipc_buffer.cu``,
  ``IPC_BYTES``) that every other rank maps, and a collective is, a
  buffer's worth of bytes at a time, a device copy into it, a barrier,
  device copies out of the members' buffers and a barrier (an all-reduce
  sums or takes the max of the gathered parts in member order). A rank
  that cannot build, allocate or map the buffers is a RuntimeError on
  every rank, never another route;
- ranks sharing the cards of a host of several (gloo on CUDA) stage
  their tensors through host memory, so the result is the same bits
  either way.
:meth:`Mesh.all_reduce` sums or takes the max (gloo and NCCL both have
``ReduceOp.MAX``).

Shapes: ``make_training_mesh`` gives the reference's (1 or 2, agents per
pod, 16 / agents per pod, 16), 256 or 512 ranks; :func:`serve_shape` its
production mesh, ((pod,) data, model) mapped to (1, 1, (2 x) 16, 16): the
data axes on ``fsdp``; ``make_debug_mesh`` a small
(1, agents, fsdp, model) mesh, the launcher's ``--mesh debug`` (1, 2, 2,
2). A world size other than the mesh's product is a SystemExit that names
both. :func:`mesh_of_shape` places one rank on a mesh of any shape with no
process group (the dry run's meshes). :func:`agree_min` and
:func:`broadcast_json` are the world's control messages (the sharded
checkpoints' agreement on a step); on ranks sharing one card they travel
over gloo as tiny host tensors, the CUDA tensors of the collectives above
staying on the IPC route. :meth:`Mesh.plan` is each route's plan of a
collective's calls and temporaries, which the dry run's recording mesh
counts from too. Importing this module touches no process group.
"""
from __future__ import annotations

import ctypes
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.sharding import PANEL_COL_AXES as COL_AXES
from repro_torch.models.sharding import PANEL_ROW_AXES as ROW_AXES

AXES = ("pod", "agent", "fsdp", "model")
# each line's axes: the ranks of a line differ in these only
LINES = {"rows": ROW_AXES, "fsdp": COL_AXES, "model": ("model",),
         "block": COL_AXES + ("model",)}
MODEL_AXIS = 16
DATA_AXIS = 16
PODS = 2


@dataclass(frozen=True)
class Plan:
    """How one collective on a tensor travels on a route: ``parts``, the
    (lo, hi) ranges of the flat tensor's elements that each call
    ``Mesh.stats`` counts moves; ``temps``, the shapes of the device
    tensors (of the tensor's dtype) the route makes beside its result,
    alive together."""
    parts: Tuple[Tuple[int, int], ...]
    temps: Tuple[Tuple[int, ...], ...]


@dataclass(eq=False)
class Mesh:
    """This rank's view of a mesh of processes. ``shape`` maps each axis
    name to its size (in ``axis_names`` order), ``coord`` this rank's index
    on each; ``groups[name]`` is the process group of this rank's line
    ``name`` (``LINES``) and ``members[name]`` its global ranks in line
    order."""
    shape: Dict[str, int]
    axis_names: Tuple[str, ...]
    rank: int
    coord: Dict[str, int]
    device: torch.device
    backend: str
    groups: Dict[str, object] = field(default_factory=dict)
    members: Dict[str, List[int]] = field(default_factory=dict)
    # host seconds in the collectives: "stage" copying CUDA tensors to and
    # from host memory (gloo), "wire" inside the collective calls; "calls"
    # and "bytes" (this rank's payload); read and reset by the caller
    stats: Dict[str, float] = field(default_factory=lambda: dict.fromkeys(
        ("stage", "wire", "calls", "bytes"), 0))
    # the CUDA IPC exchange buffers of ranks sharing one card (or None)
    ipc: object = None

    @property
    def transport(self) -> str:
        """How CUDA tensors travel: 'nccl', 'cuda ipc' (ranks sharing one
        card), 'gloo (host staged)' (ranks sharing the cards of a host of
        several), or 'gloo' (CPU tensors)."""
        if self.backend == "nccl":
            return "nccl"
        if self.ipc is not None:
            return "cuda ipc"
        return "gloo (host staged)" if self.device.type == "cuda" else "gloo"

    def axis_index(self, axes) -> int:
        """This rank's row-major index along ``axes`` (a name, a tuple of
        names, or None: 0)."""
        idx = 0
        for a in _names(axes):
            idx = idx * self.shape[a] + self.coord[a]
        return idx

    def axis_size(self, axes) -> int:
        """The number of ranks along ``axes`` (a name, a tuple of names,
        or None: 1)."""
        return int(np.prod([self.shape[a] for a in _names(axes)]))

    def plan(self, x: torch.Tensor, kind: str, line: str) -> Plan:
        """The calls and device temporaries of the collective ``kind``
        ('all_gather' or 'all_reduce') of ``x`` over ``line`` on this
        mesh's route: one call of the whole tensor, but for an all-reduce
        through the CUDA IPC buffers, a call a buffer's worth of elements,
        each gathering the members' parts ((members, part) elements) for a
        flat result. The collectives below and the dry run's recording
        mesh (``utils/fake_trace.py``) both count from it."""
        n = x.numel()
        if kind != "all_reduce" or not self._via_ipc(x):
            return Plan(((0, n),), ())
        nbytes = IPC_BYTES if self.ipc is None else self.ipc.nbytes
        step = max(1, nbytes // x.element_size())
        parts = tuple((lo, min(n, lo + step)) for lo in range(0, n, step))
        return Plan(parts, ((n,), (len(self.members[line]), min(step, n))))

    def _staged(self, x: torch.Tensor) -> bool:
        """Whether a collective on ``x`` goes through host memory (gloo
        with a CUDA tensor)."""
        return self.backend == "gloo" and x.device.type == "cuda"

    def all_gather(self, x: torch.Tensor, line: str) -> torch.Tensor:
        """The ``line`` group's tensors like ``x`` concatenated along dim 0
        in line order (every member gets the same result)."""
        import torch.distributed as dist
        n = len(self.members[line])
        if self._via_ipc(x):
            return self._ipc_gather(x, line)
        t0 = time.perf_counter()
        src = x.contiguous()
        if self._staged(src):
            src = src.cpu()
        out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]),
                          dtype=src.dtype, device=src.device)
        t1 = time.perf_counter()
        dist.all_gather(list(out.chunk(n)), src, group=self.groups[line])
        t2 = time.perf_counter()
        out = out.to(x.device)
        self._count(x, t0, t1, t2)
        return out

    def all_reduce(self, x: torch.Tensor, line: str,
                   op: str = "sum") -> torch.Tensor:
        """The elementwise ``op`` ("sum" or "max") of the ``line`` group's
        tensors like ``x``, in place (through host memory when staged);
        returns ``x``. A max is exact in any order, so a row's amax taken
        over its column shards is the whole row's bit for bit."""
        import torch.distributed as dist
        rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        if self._via_ipc(x):
            # a buffer's worth of elements at a time: the gathered parts
            # reduced in line order
            flat = x.reshape(-1)
            out = torch.empty_like(flat)
            for lo, hi in self.plan(x, "all_reduce", line).parts:
                g = self._ipc_gather(flat[lo:hi].reshape(1, -1), line)
                acc = out[lo:hi]
                acc.copy_(g[0])
                for j in range(1, len(g)):
                    if op == "sum":
                        acc += g[j]
                    else:
                        torch.maximum(acc, g[j], out=acc)
                # freed before the next part's are gathered: one part's
                # gather alive at a time (Mesh.plan's temporaries)
                del g
            x.copy_(out.view(x.shape))
            return x
        t0 = time.perf_counter()
        if self._staged(x):
            h = x.cpu()
            t1 = time.perf_counter()
            dist.all_reduce(h, op=rop, group=self.groups[line])
            t2 = time.perf_counter()
            x.copy_(h)
        else:
            t1 = t0
            dist.all_reduce(x, op=rop, group=self.groups[line])
            t2 = time.perf_counter()
        self._count(x, t0, t1, t2)
        return x

    def _via_ipc(self, x) -> bool:
        return self.ipc is not None and x.device.type == "cuda"

    def _ipc_gather(self, x, line):
        """all_gather through the members' CUDA IPC exchange buffers, a
        buffer's worth of bytes at a time: this rank's bytes into its own
        buffer, a barrier, every member's bytes copied out in line order, a
        barrier (so no buffer is written again before every member has
        read it)."""
        import torch.distributed as dist
        t0 = time.perf_counter()
        members, group = self.members[line], self.groups[line]
        src = x.contiguous()
        nb = src.numel() * src.element_size()
        stream = torch.cuda.current_stream(self.device)
        raw = src.view(-1).view(torch.uint8)
        out = torch.empty((len(members) * src.shape[0],)
                          + tuple(src.shape[1:]), dtype=src.dtype,
                          device=src.device)
        ob = out.view(-1).view(torch.uint8)
        for lo in range(0, nb, self.ipc.nbytes):
            hi = min(nb, lo + self.ipc.nbytes)
            self.ipc.views[self.rank][:hi - lo].copy_(raw[lo:hi])
            stream.synchronize()
            dist.barrier(group=group)
            for j, r in enumerate(members):
                ob[j * nb + lo:j * nb + hi].copy_(
                    raw[lo:hi] if r == self.rank
                    else self.ipc.views[r][:hi - lo])
            stream.synchronize()
            dist.barrier(group=group)
        t1 = time.perf_counter()
        self._count(x, t0, t0, t1, t1)
        return out

    def _count(self, x, t0, t1, t2, now=None):
        """Add one collective to ``stats`` (t0 start, t1 staged in, t2 the
        call done, ``now`` (default: now) the result back)."""
        now = time.perf_counter() if now is None else now
        st = self.stats
        st["stage"] += (t1 - t0) + (now - t2)
        st["wire"] += t2 - t1
        st["calls"] += 1
        st["bytes"] += x.numel() * x.element_size()


def _names(axes) -> Tuple[str, ...]:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def num_agents(mesh) -> int:
    """Panel row blocks of ``mesh``: the product of its pod and agent axes
    (the reference's ``num_agents``)."""
    m = 1
    for ax in ROW_AXES:
        if ax in mesh.axis_names:
            m *= mesh.shape[ax]
    return m


def training_shape(agents_per_pod: int, multi_pod: bool = False):
    """The reference's training mesh shape: (pods, agents_per_pod, 16 /
    agents_per_pod, 16)."""
    if DATA_AXIS % agents_per_pod:
        raise ValueError(f"agents_per_pod={agents_per_pod} must divide 16")
    return (PODS if multi_pod else 1, agents_per_pod,
            DATA_AXIS // agents_per_pod, MODEL_AXIS)


def serve_shape(multi_pod: bool = False):
    """The reference's production (serving) mesh, (16, 16) over ('data',
    'model') or (2, 16, 16) over ('pod', 'data', 'model'), on the port's
    AXES: (1, 1, data, 16) with the pod and data axes flattened, row-major
    as ``jax.make_mesh`` lays them out, onto ``fsdp`` (32 with two pods).
    A data rank is then a coordinate of the fsdp line and its model ranks
    its model line; ``models.sharding.serve_rules`` reads 'fsdp' as the
    data axes there."""
    return (1, 1, DATA_AXIS * (PODS if multi_pod else 1), MODEL_AXIS)


def make_training_mesh(agents_per_pod: int, *, multi_pod: bool = False,
                       device=None) -> Mesh:
    """The reference's training mesh (256 ranks, 512 with ``multi_pod``)."""
    return make_mesh(training_shape(agents_per_pod, multi_pod),
                     device=device)


def make_debug_mesh(agents: int = 2, fsdp: int = 1, model: int = 2,
                    device=None) -> Mesh:
    """A small (1, agents, fsdp, model) mesh for tests and ``--mesh
    debug``."""
    return make_mesh((1, agents, fsdp, model), device=device)


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return default if v in (None, "") else int(v)


def _rank_device(device) -> torch.device:
    """The rank's device: the caller's CPU, or ``cuda:LOCAL_RANK`` modulo
    the cards present."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (--device cpu) "
            "to run the mesh on the CPU")
    if device is not None and torch.device(device).index is not None:
        return torch.device(device)
    local = _env_int("LOCAL_RANK", 0)
    return torch.device("cuda", local % torch.cuda.device_count())


def _backend(device: torch.device) -> str:
    if device.type != "cuda":
        return "gloo"
    local_world = _env_int("LOCAL_WORLD_SIZE", _env_int("WORLD_SIZE", 1))
    return "nccl" if local_world <= torch.cuda.device_count() else "gloo"


def _init_process_group(device: torch.device, world: int, rank: int) -> str:
    import torch.distributed as dist
    if dist.is_initialized():
        return dist.get_backend()
    backend = _backend(device)
    init = os.environ.get("REPRO_TORCH_INIT_METHOD") or "env://"
    if backend == "nccl":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=rank)
    return backend


def make_mesh(shape, axis_names=AXES, *, device=None) -> Mesh:
    """This rank's :class:`Mesh` of ``shape`` over ``axis_names``; starts
    the process group (from the environment) if none is running, and
    makes every line's group (each rank makes all of them, in one order)."""
    import torch.distributed as dist
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape))
    world = (dist.get_world_size() if dist.is_initialized()
             else _env_int("WORLD_SIZE", 1))
    if world != n:
        raise SystemExit(
            f"the mesh {dict(zip(axis_names, shape))} needs {n} ranks but "
            f"the world size is {world} (torchrun --nproc-per-node {n})")
    rank = dist.get_rank() if dist.is_initialized() else _env_int("RANK", 0)
    dev = _rank_device(device)
    backend = _init_process_group(dev, world, rank)
    coords = np.array(np.unravel_index(np.arange(n), shape)).T
    me = dict(zip(axis_names, (int(c) for c in coords[rank])))
    mesh = Mesh(shape=dict(zip(axis_names, shape)),
                axis_names=tuple(axis_names), rank=rank, coord=me,
                device=dev, backend=backend)
    for name, axes in LINES.items():
        fixed = [i for i, a in enumerate(axis_names) if a not in axes]
        lines: Dict[tuple, List[int]] = {}
        for r in range(n):
            lines.setdefault(tuple(coords[r][fixed]), []).append(r)
        for key in sorted(lines):
            ranks = lines[key]
            group = dist.new_group(ranks)
            if rank in ranks:
                mesh.groups[name] = group
                mesh.members[name] = ranks
    if backend == "gloo" and dev.type == "cuda" \
            and torch.cuda.device_count() == 1:
        # every rank on the one card: device copies through CUDA IPC
        mesh.ipc = _open_ipc(mesh, IPC_BYTES)
    return mesh


# bytes of each rank's CUDA IPC exchange buffer: a collective's tensor up
# to this size (olmo-1b's row shard at 2-way fsdp, 475 MB) takes one
# exchange, a larger one a buffer's worth at a time
IPC_BYTES = 512 << 20
_IPC_SIGNATURES = {
    "ipc_alloc": (ctypes.c_int, [ctypes.c_longlong,
                                 ctypes.POINTER(ctypes.c_void_p)]),
    "ipc_handle": (ctypes.c_int, [ctypes.c_void_p, ctypes.c_void_p]),
    "ipc_open": (ctypes.c_int, [ctypes.c_void_p,
                                ctypes.POINTER(ctypes.c_void_p)]),
    "ipc_handle_bytes": (ctypes.c_int, []),
}


class _DeviceBytes:
    """A (n,) uint8 view of raw device memory for torch.as_tensor."""

    def __init__(self, ptr: int, n: int):
        self.__cuda_array_interface__ = {"shape": (n,), "typestr": "|u1",
                                         "data": (ptr, False), "version": 2}


@dataclass(eq=False)
class _IpcBuffers:
    """Every rank's exchange buffer as a uint8 device tensor of this
    process (its own, and the others' mapped through CUDA IPC)."""
    nbytes: int
    views: Dict[int, torch.Tensor]


def _open_ipc(mesh: Mesh, nbytes: int) -> _IpcBuffers:
    """Every rank allocates its exchange buffer and maps every other
    rank's (a collective over the world). A rank that cannot is a
    RuntimeError on every rank (the ranks agree before each step, so none
    waits on another that has given up)."""
    import torch.distributed as dist
    from repro_torch.kernels import build
    err, ptr, hb = "", ctypes.c_void_p(), 64
    handle = (ctypes.c_uint8 * hb)()
    try:
        with torch.cuda.device(mesh.device):
            lib = build.load("ipc_buffer", _IPC_SIGNATURES)
            hb = lib.ipc_handle_bytes()
            handle = (ctypes.c_uint8 * hb)()
            rc = (lib.ipc_alloc(nbytes, ctypes.byref(ptr))
                  or lib.ipc_handle(ptr, handle))
            if rc:
                err = f"cudaError {rc} allocating or exporting its buffer"
    except (OSError, RuntimeError) as e:
        err = f"ipc_buffer did not build or load: {e}"
    _agree(mesh, err)
    mine = torch.tensor(list(handle), dtype=torch.uint8)
    every = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(every, mine)
    views = {}
    with torch.cuda.device(mesh.device):
        views[mesh.rank] = torch.as_tensor(_DeviceBytes(ptr.value, nbytes),
                                           device=mesh.device)
        for r, h in enumerate(every):
            if r == mesh.rank:
                continue
            p = ctypes.c_void_p()
            rc = lib.ipc_open((ctypes.c_uint8 * hb)(*h.tolist()),
                              ctypes.byref(p))
            if rc:
                err = f"cudaError {rc} mapping rank {r}'s buffer"
                break
            views[r] = torch.as_tensor(_DeviceBytes(p.value, nbytes),
                                       device=mesh.device)
    _agree(mesh, err)
    return _IpcBuffers(nbytes=nbytes, views=views)


def _agree(mesh: Mesh, err: str):
    """RuntimeError on every rank when any rank reports ``err`` (this
    rank's own, or that another failed)."""
    import torch.distributed as dist
    flag = torch.tensor([0 if err else 1], dtype=torch.int64)
    dist.all_reduce(flag, op=dist.ReduceOp.MIN)
    if int(flag) == 0:
        raise RuntimeError(
            "the ranks sharing one card exchange CUDA tensors through CUDA "
            f"IPC buffers (launch/mesh.py), and rank {mesh.rank} "
            f"{'found ' + err if err else 'saw another rank fail'}")


def rank_share_bytes(mesh: Mesh) -> int:
    """This rank's share of its device's memory: the card's over the host's
    ranks that compute on it (``cuda:LOCAL_RANK`` modulo the cards), or the
    host's memory over the host's ranks on the CPU."""
    local = _env_int("LOCAL_WORLD_SIZE", _env_int("WORLD_SIZE", 1))
    if mesh.device.type == "cuda":
        on_card = -(-local // torch.cuda.device_count())
        total = torch.cuda.get_device_properties(mesh.device).total_memory
        return total // on_card
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES") // local


def _control(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """``t`` where the world group's collectives take it: on the host for
    gloo, on the rank's card for NCCL."""
    return t if mesh.backend == "gloo" else t.to(mesh.device)


def agree_min(mesh: Optional[Mesh], value: int) -> int:
    """The minimum of ``value`` over every rank of the world (``value``
    itself without a mesh): e.g. a success flag, 1 only where every rank
    succeeded."""
    if mesh is None:
        return int(value)
    import torch.distributed as dist
    t = _control(mesh, torch.tensor([int(value)], dtype=torch.int64))
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return int(t.cpu()[0])


def broadcast_json(mesh: Optional[Mesh], obj):
    """Rank 0's ``obj`` (anything JSON takes) on every rank (``obj``
    itself without a mesh)."""
    if mesh is None:
        return obj
    import json

    import torch.distributed as dist
    raw = json.dumps(obj).encode() if mesh.rank == 0 else b""
    n = _control(mesh, torch.tensor([len(raw)], dtype=torch.int64))
    dist.broadcast(n, src=0)
    buf = torch.zeros(int(n.cpu()[0]), dtype=torch.uint8)
    if mesh.rank == 0:
        buf.copy_(torch.frombuffer(bytearray(raw), dtype=torch.uint8))
    buf = _control(mesh, buf)
    dist.broadcast(buf, src=0)
    return json.loads(bytes(buf.cpu().numpy()))


def mesh_of_shape(shape, rank: int = 0, axis_names=AXES,
                  device="cpu") -> Mesh:
    """Rank ``rank``'s :class:`Mesh` of ``shape`` with no process group
    (backend ``"none"``): its coordinate, each line's members and every
    size are those :func:`make_mesh` gives, so ``models.sharding`` and
    ``panel.shard_spec`` read it as they read a live one (e.g. the dry
    run's ``mesh_of_shape(training_shape(16))``, 256 ranks); its
    collectives raise."""
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape))
    if not 0 <= rank < n:
        raise ValueError(f"rank {rank} is not on a mesh of {n} ranks")
    coords = np.array(np.unravel_index(np.arange(n), shape)).T
    mesh = Mesh(shape=dict(zip(axis_names, shape)),
                axis_names=tuple(axis_names), rank=rank,
                coord=dict(zip(axis_names, (int(c) for c in coords[rank]))),
                device=torch.device(device), backend="none")
    for name, axes in LINES.items():
        fixed = [i for i, a in enumerate(axis_names) if a not in axes]
        mesh.members[name] = [r for r in range(n) if np.array_equal(
            coords[r][fixed], coords[rank][fixed])]
    return mesh


def is_primary(mesh: Optional[Mesh]) -> bool:
    """Whether this process writes the run's files (rank 0, or no mesh)."""
    return mesh is None or mesh.rank == 0
