"""Training meshes over ``torch.distributed`` (counterpart of
``repro/launch/mesh.py``).

A :class:`Mesh` names the ranks of one process group along the reference's
axes ``("pod", "agent", "fsdp", "model")``: rank r sits at the row-major
coordinate of r in ``shape`` (as ``jax.make_mesh`` lays the devices out).
For decentralized training the panel rows (one per agent) are spread over
``("pod", "agent")``, the paper's communication graph, and the flat
parameter columns over ``"fsdp"``; ``"model"`` holds replicas
(``models/sharding.py``). Each rank owns one process group per line of the
mesh it lies on: ``rows`` (the ranks that differ from it in pod and agent
only: the gossip partners of its column shard) and ``fsdp`` (the ranks
that differ from it in fsdp only: the other column shards of its agents).

The ranks come from the environment ``torchrun`` sets (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, with ``MASTER_ADDR``/``MASTER_PORT`` for
the default ``env://`` rendezvous); ``REPRO_TORCH_INIT_METHOD`` replaces the
rendezvous (e.g. ``file:///tmp/rdv``: no TCP port). Rank r computes on
``cuda:LOCAL_RANK`` (modulo the cards present: several ranks may share one
card), or on the CPU when the caller asks for it. The backend is NCCL when
every rank of the host has a card of its own, gloo otherwise (the CPU, or
ranks sharing a card; NCCL refuses two ranks on one device). Under gloo a
CUDA tensor travels through host memory: :meth:`Mesh.all_gather` and
:meth:`Mesh.all_reduce` stage it there, so the result is the same bits
either way.

Shapes: ``make_training_mesh`` gives the reference's (1 or 2, agents per
pod, 16 / agents per pod, 16), 256 or 512 ranks; ``make_debug_mesh`` a small
(1, agents, fsdp, model) mesh, the launcher's ``--mesh debug`` (1, 2, 2,
2). A world size other than the mesh's product is a SystemExit that names
both. Importing this module touches no process group.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.sharding import PANEL_COL_AXES as COL_AXES
from repro_torch.models.sharding import PANEL_ROW_AXES as ROW_AXES

AXES = ("pod", "agent", "fsdp", "model")
MODEL_AXIS = 16
DATA_AXIS = 16
PODS = 2


@dataclass(eq=False)
class Mesh:
    """This rank's view of a mesh of processes. ``shape`` maps each axis
    name to its size (in ``axis_names`` order), ``coord`` this rank's index
    on each; ``groups[name]`` is the process group of this rank's ``rows``
    or ``fsdp`` line and ``members[name]`` its global ranks in line order."""
    shape: Dict[str, int]
    axis_names: Tuple[str, ...]
    rank: int
    coord: Dict[str, int]
    device: torch.device
    backend: str
    groups: Dict[str, object] = field(default_factory=dict)
    members: Dict[str, List[int]] = field(default_factory=dict)

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

    def _staged(self, x: torch.Tensor) -> bool:
        """Whether a collective on ``x`` goes through host memory (gloo
        with a CUDA tensor)."""
        return self.backend == "gloo" and x.device.type == "cuda"

    def all_gather(self, x: torch.Tensor, line: str) -> torch.Tensor:
        """The ``line`` group's tensors like ``x`` concatenated along dim 0
        in line order (every member gets the same result)."""
        import torch.distributed as dist
        n = len(self.members[line])
        src = x.contiguous()
        if self._staged(src):
            src = src.cpu()
        out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]),
                          dtype=src.dtype, device=src.device)
        dist.all_gather(list(out.chunk(n)), src, group=self.groups[line])
        return out.to(x.device)

    def all_reduce(self, x: torch.Tensor, line: str) -> torch.Tensor:
        """The sum of the ``line`` group's tensors like ``x`` (in place
        when no staging is needed; returns the result)."""
        import torch.distributed as dist
        if self._staged(x):
            h = x.cpu()
            dist.all_reduce(h, group=self.groups[line])
            x.copy_(h)
            return x
        dist.all_reduce(x, group=self.groups[line])
        return x


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
    line_axes = {"rows": tuple(a for a in ROW_AXES if a in axis_names),
                 "fsdp": tuple(a for a in COL_AXES if a in axis_names)}
    for name, axes in line_axes.items():
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
    return mesh


def is_primary(mesh: Optional[Mesh]) -> bool:
    """Whether this process writes the run's files (rank 0, or no mesh)."""
    return mesh is None or mesh.rank == 0
