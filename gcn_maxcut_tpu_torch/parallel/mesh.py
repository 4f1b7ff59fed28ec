"""Device meshes and multi-process initialisation.

Port of ``gcn_maxcut_tpu/parallel/mesh.py``.  The JAX programs are single-
controller: one ``shard_map`` drives every shard.  Here likewise one Python
process drives every shard it holds, and a 1-D mesh (``Mesh``) is the list
of torch devices the shards live on, one per shard in ring order: shard c
holds tensors on ``mesh.devices[c]``, and its ring neighbours are shards
c - 1 and c + 1 mod the mesh size.  A device may repeat:
``make_mesh(devices=["cuda:0"] * 4)`` is a ring of four shards on one card,
which runs the sharded kernels across real shard boundaries (the
counterpart of the JAX tests' virtual CPU devices), and
``devices=["cpu"] * 4`` is the same ring on the CPU, where the ops take
their plain versions.

A 2-D mesh (``Mesh2D``, ``make_mesh(("data", "graph"), shape=(R, D))``) is
R rows, each a graph ring of D shards, the 1-D ``Mesh`` that the sharded
SpMM and the giant trainers take unchanged; the hybrid trainer
(``parallel/hybrid.py``) puts each graph of a batch on one row.

Across processes (``multi_host_init`` over ``torch.distributed``, one rank
per card): a mesh is the rank's own part.  The data axis spans the ranks,
and the graph axis stays inside a process: with W ranks, rank p of a mesh
of R rows holds rows p·R/W … (p+1)·R/W − 1 on the devices it names, and a
1-D data mesh of E entries on each rank is a data axis of W·E entries.
The JAX ``multi_host_init`` names no backend (XLA picks its own); here the
caller may pass ``backend="gloo"`` to run ranks on the CPU, and NCCL is the
default.  A ring across cards of several processes is not supported.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from gcn_maxcut_tpu_torch.device import resolve_device
from gcn_maxcut_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One device per shard, in ring order, along one named axis."""

    devices: tuple[torch.device, ...]
    axis_name: str = "graph"

    @property
    def size(self) -> int:
        return len(self.devices)


@dataclasses.dataclass(frozen=True)
class Mesh2D:
    """A (data, graph) mesh: ``shape`` = (R, D) over every rank; this
    process holds rows ``first_row`` … ``first_row + len(rows) − 1``, each
    a graph ring of D devices."""

    shape: tuple[int, int]
    axis_names: tuple[str, str]
    rows: tuple[Mesh, ...]
    first_row: int = 0

    def axis_size(self, name: str) -> int:
        if name not in self.axis_names:
            raise ValueError(f"no axis {name!r} in mesh axes {self.axis_names}")
        return self.shape[self.axis_names.index(name)]

    def row(self, r: int) -> Mesh:
        """The graph ring of global row ``r`` (held by this process)."""
        if not self.first_row <= r < self.first_row + len(self.rows):
            raise ValueError(f"row {r} is not on this process (rows {self.first_row}"
                             f"..{self.first_row + len(self.rows) - 1})")
        return self.rows[r - self.first_row]

    @property
    def devices(self) -> tuple[torch.device, ...]:
        """This process's devices, row by row."""
        return tuple(d for row in self.rows for d in row.devices)


def device_count() -> int:
    """The number of CUDA devices."""
    return torch.cuda.device_count()


def process_group() -> tuple[int, int]:
    """(world size, rank) of the default process group; (1, 0) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def local_devices(
    devices: Optional[Sequence[str | torch.device]] = None,
) -> list[torch.device]:
    """The named devices, or every CUDA device of this process (the rank's
    own card under a process group).  Raises without CUDA unless
    ``devices`` names no CUDA device; it never falls back to the CPU."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass devices=['cpu'] * D for a CPU ring"
            )
        if process_group()[0] > 1:
            devices = [torch.device("cuda", torch.cuda.current_device())]
        else:
            devices = [torch.device("cuda", i) for i in range(device_count())]
    devs = []
    for d in devices:
        dev = resolve_device(d)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        devs.append(dev)
    if not devs:
        raise ValueError("a mesh needs at least one device")
    return devs


def make_mesh(
    axis_names: Sequence[str] = ("graph",),
    shape: Optional[Sequence[int]] = None,
    devices: Optional[Sequence[str | torch.device]] = None,
) -> Mesh | Mesh2D:
    """A 1-D mesh over every CUDA device, or over ``devices`` (which may
    repeat a device); with two axes, e.g. ``("data", "graph")`` and
    ``shape=(R, D)``, a ``Mesh2D`` whose rows are graph rings of D devices
    taken in order.  Under a process group of W ranks ``devices`` are this
    rank's, ``shape`` counts every rank's, and R must divide by W."""
    devs = local_devices(devices)
    if len(axis_names) == 1:
        if shape is not None and tuple(shape) != (len(devs),):
            raise ValueError(f"mesh shape {tuple(shape)} != ({len(devs)},) devices")
        return Mesh(tuple(devs), axis_names[0])
    if len(axis_names) != 2:
        raise ValueError(f"meshes of 1 or 2 axes, got {tuple(axis_names)}")
    if shape is None:
        raise ValueError("shape required for multi-axis meshes")
    world, rank = process_group()
    if math.prod(shape) != world * len(devs):
        raise ValueError(f"mesh shape {tuple(shape)} != {world * len(devs)} devices")
    rows, d = int(shape[0]), int(shape[1])
    if rows % world:
        raise ValueError(f"{rows} data rows do not divide over {world} processes")
    local = rows // world
    return Mesh2D((rows, d), tuple(axis_names),
                  tuple(Mesh(tuple(devs[i * d:(i + 1) * d]), axis_names[1])
                        for i in range(local)),
                  rank * local)


def data_axis_sum(tensors: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """Each tensor summed over the ranks of the default process group: one
    ``all_reduce`` of their concatenation (one dtype, one device).  Without
    a group, copies of the tensors."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    if dist.is_available() and dist.is_initialized():
        dist.all_reduce(flat)
    return [part.view_as(t) for part, t in zip(flat.split([t.numel() for t in tensors]),
                                                 tensors)]


_LAUNCH_ENV = ("MASTER_ADDR", "WORLD_SIZE", "RANK")


def multi_host_init(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> None:
    """``torch.distributed.init_process_group`` for one rank per card.

    A no-op when the default group exists, and a single-process run (logged)
    when there is neither a coordinator address nor a launch environment
    (``MASTER_ADDR``, ``WORLD_SIZE``, ``RANK``).  ``coordinator_address``:
    ``host:port`` (a TCP store) or an init-method URL such as
    ``file:///path``; without one the launch environment is read
    (``env://``).  The process count and id come from the arguments, else
    from ``WORLD_SIZE`` and ``RANK``; a count without an id, or an id out
    of range, raises.  ``backend``: NCCL unless given; NCCL sets this
    rank's card to ``LOCAL_RANK``, else ``process_id`` mod the card count,
    and raises without CUDA (pass ``backend="gloo"`` for CPU ranks).  A
    failed ``init_process_group`` is logged and re-raised.
    """
    if dist.is_initialized():
        logger.info("multi_host_init: torch.distributed already initialized")
        return
    env = {k: os.environ[k] for k in _LAUNCH_ENV if k in os.environ}
    if coordinator_address is None and not env and num_processes is None \
            and process_id is None:
        logger.info("multi_host_init: no multi-host environment detected, "
                    "continuing single-process")
        return
    world = num_processes if num_processes is not None else env.get("WORLD_SIZE")
    rank = process_id if process_id is not None else env.get("RANK")
    if world is None or rank is None:
        raise ValueError(f"multi_host_init: a launch needs both a process count and an id, "
                         f"got num_processes={world}, process_id={rank}")
    world, rank = int(world), int(rank)
    if world < 1 or not 0 <= rank < world:
        raise ValueError(f"multi_host_init: process_id {rank} out of range for "
                         f"{world} processes")
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    backend = backend or "nccl"
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("multi_host_init: NCCL needs CUDA, which is not available; "
                               "pass backend='gloo' for ranks on the CPU")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank % device_count())))
    try:
        dist.init_process_group(backend, init_method=init_method, world_size=world,
                                rank=rank)
    except Exception as e:   # noqa: BLE001 -- logged and re-raised
        logger.error("multi_host_init failed: %s", e)
        raise
    logger.info("multi_host_init: rank %d of %d (%s, %s)", rank, world, backend, init_method)
