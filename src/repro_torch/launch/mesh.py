"""Host meshes over the ranks of a ``torch.distributed`` process group, as
the JAX package's ``launch/mesh.py`` builds them over devices.

A mesh is a ``("data", "model")`` grid of the default group's ranks, laid
out row-major (rank = data index * model size + model index, the order of
``jax.make_mesh``'s devices).  Each rank holds its coordinates and one
process group per axis: the ranks that share its other coordinate, over
which that axis's collectives run.  A size-1 axis is a group of one rank.

The port has a mesh class of its own rather than ``DeviceMesh``:
``init_device_mesh`` makes its groups with the default group's backend
and binds each rank to a card by rank; this one takes the default group
as the caller started it (gloo with CUDA tensors, two processes sharing
one card, is how the epoch path runs across ranks on one H100) and binds
nothing.  ``launch.sharding.placements`` turns a partition spec into
DTensor placements over the same axes.

Where no default group exists, the mesh starts a one-rank group over an
in-process ``HashStore``: NCCL for a CUDA device, gloo for the CPU.  A
group the caller started is used as it is, its backend included.

The production meshes (16 x 16 and 2 x 16 x 16) and the hardware
constants of the roofline analysis come with the dry-run tooling
(ROADMAP item 15b).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch import resolve_device

AXES = ("data", "model")


class Mesh:
    """A grid of ranks with named axes.  ``coords`` is this rank's
    coordinate on each axis, None where the rank lies outside the mesh
    (the default group has more ranks than the mesh uses)."""

    def __init__(self, shape: Tuple[int, ...], axis_names: Tuple[str, ...],
                 coords: Optional[Tuple[int, ...]],
                 groups: Dict[str, object], ranks: Dict[str, List[int]],
                 device: torch.device):
        self.shape = tuple(shape)
        self.axis_names = tuple(axis_names)
        self.coords = coords
        self._groups = groups
        self._ranks = ranks
        self.device = device

    def __repr__(self) -> str:
        return (f"Mesh({dict(zip(self.axis_names, self.shape))}, "
                f"coords={self.coords}, device={self.device})")

    @property
    def sizes(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.shape))

    def size(self, axis: str) -> int:
        return self.sizes[axis]

    def _member(self) -> None:
        if self.coords is None:
            raise RuntimeError(f"rank {dist.get_rank()} is not in {self}")

    def coord(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        self._member()
        return self.coords[self.axis_names.index(axis)]

    def group(self, axis: str):
        """The process group of this rank's line along ``axis``."""
        self._member()
        return self._groups[axis]

    def ranks(self, axis: str) -> List[int]:
        """The global ranks of ``group(axis)``, in axis order."""
        self._member()
        return self._ranks[axis]


def _default_group(dev: torch.device) -> None:
    """Start a one-rank default group when there is none; check that an
    existing one can carry tensors of ``dev``."""
    if not dist.is_initialized():
        backend = "nccl" if dev.type == "cuda" else "gloo"
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    elif dev.type == "cpu" and dist.get_backend() == "nccl":
        raise ValueError("the default process group is NCCL, which carries "
                         "no CPU tensors: start a gloo group for a CPU mesh")


def make_host_mesh(data: int = 1, model: int = 1, *,
                   device="cuda") -> Mesh:
    """A (data, model) mesh over the default group's ranks, clamped as the
    reference clamps to the devices there are: ``data`` to the world
    size, ``model`` to what is left.  Every rank of the default group
    must call it (making a group is collective)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    _default_group(dev)
    n, rank = dist.get_world_size(), dist.get_rank()
    data = min(data, n)
    model = max(1, min(model, n // max(data, 1)))
    lines = {   # axis -> the rank lists of its groups
        "data": [[d * model + m for d in range(data)] for m in range(model)],
        "model": [[d * model + m for m in range(model)]
                  for d in range(data)],
    }
    groups, ranks = {}, {}
    for axis in AXES:               # one order on every rank
        for line in lines[axis]:
            g = dist.new_group(line)
            if rank in line:
                groups[axis], ranks[axis] = g, line
    coords = (rank // model, rank % model) if rank < data * model else None
    return Mesh((data, model), AXES, coords, groups, ranks, dev)


def make_data_mesh(*, device="cuda") -> Mesh:
    """A mesh whose "data" axis spans every rank of the default group (a
    trailing size-1 "model" axis, so the shared rules resolve): the layout
    the fused epoch step shards its participants over.  With one rank it
    is the identity mesh, and every result is the unsharded path's."""
    dev = resolve_device(device)
    _default_group(dev)
    return make_host_mesh(data=dist.get_world_size(), model=1, device=dev)
