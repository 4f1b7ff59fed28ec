"""The device ring that sharded ops and trainers run on.

Port of ``gcn_maxcut_tpu/parallel/mesh.py``.  The JAX programs are single-
controller: one ``shard_map`` drives every shard.  Here likewise one Python
process drives every shard, and a mesh is the list of torch devices the
shards live on, one per shard in ring order: shard c holds tensors on
``mesh.devices[c]``, and its ring neighbours are shards c - 1 and c + 1 mod
the mesh size.  A device may repeat: ``make_mesh(devices=["cuda:0"] * 4)``
is a ring of four shards on one card, which runs the sharded kernels across
real shard boundaries (the counterpart of the JAX tests' virtual CPU
devices), and ``devices=["cpu"] * 4`` is the same ring on the CPU, where
the ops take their plain versions.  Meshes of several axes and multi-host
initialisation are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from gcn_maxcut_tpu_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One device per shard, in ring order, along one named axis."""

    devices: tuple[torch.device, ...]
    axis_name: str = "graph"

    @property
    def size(self) -> int:
        return len(self.devices)


def device_count() -> int:
    """The number of CUDA devices."""
    return torch.cuda.device_count()


def make_mesh(
    axis_names: Sequence[str] = ("graph",),
    shape: Optional[Sequence[int]] = None,
    devices: Optional[Sequence[str | torch.device]] = None,
) -> Mesh:
    """A 1-D mesh over every CUDA device, or over ``devices`` (which may
    repeat a device).  Raises without CUDA unless ``devices`` names no CUDA
    device; it never falls back to the CPU."""
    if len(axis_names) != 1:
        raise ValueError(f"only 1-D meshes are ported, got axes {tuple(axis_names)}")
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass devices=['cpu'] * D for a CPU ring"
            )
        devices = [torch.device("cuda", i) for i in range(device_count())]
    devs = []
    for d in devices:
        dev = resolve_device(d)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        devs.append(dev)
    if not devs:
        raise ValueError("a mesh needs at least one device")
    if shape is not None and tuple(shape) != (len(devs),):
        raise ValueError(f"mesh shape {tuple(shape)} != ({len(devs)},) devices")
    return Mesh(tuple(devs), axis_names[0])
