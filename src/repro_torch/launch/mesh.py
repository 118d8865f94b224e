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

The dry-run's meshes are ``torch.distributed.device_mesh.DeviceMesh``es
instead: ``make_production_mesh`` lays the reference's (16, 16) ("data",
"model") or (2, 16, 16) ("pod", "data", "model") grid over a fake
process group of 256 or 512 ranks, which this process starts itself
(the ``"fake"`` backend over a ``FakeStore``: every collective returns
at once and moves nothing).  The process plays rank 0 and traces its
program on meta tensors, so a dry-run touches no card.
``Mesh.from_device_mesh`` gives the port's own mesh over the same
groups, for the FL round and expert-parallel MoE, which take one.

The hardware constants of the roofline analysis are an H100's: the
H100 SXM5 80GB HBM3 data sheet at its 700 W limit, the card the port is
measured on ("NVIDIA H100 80GB HBM3, 700.00 W" from ``nvidia-smi
--query-gpu=name,power.limit``), where the reference has the TPU v5e's.
NVLink stands in for ICI: 18 links a GPU.  Eight GPUs share one NVLink
domain, so the 16-wide "model" axis spans two of them, and its
collectives cross the slower network between nodes, which these
constants do not describe.
"""
from __future__ import annotations

import math
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

    @classmethod
    def from_device_mesh(cls, dm, device="meta") -> "Mesh":
        """The port's mesh over a ``DeviceMesh``'s axes and groups (this
        rank's lines of the grid), with tensors on ``device``."""
        names = tuple(dm.mesh_dim_names)
        coords = dm.get_coordinate()
        groups, ranks = {}, {}
        for axis in names:
            groups[axis] = dm.get_group(axis)
            ranks[axis] = dist.get_process_group_ranks(groups[axis])
        return cls(tuple(dm.shape), names,
                   None if coords is None else tuple(coords), groups, ranks,
                   torch.device(device))

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


# ---- the production meshes of the dry-run ----------------------------------

def start_fake_world(world_size: int) -> None:
    """Make a fake process group of ``world_size`` ranks this process's
    default group, with this process as rank 0.  A fake group already up
    is replaced; a real one is refused: a dry-run never mixes with a live
    world."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(
                f"a {dist.get_backend()} process group of "
                f"{dist.get_world_size()} ranks is up: a dry-run starts a "
                "fake world of its own, in a process without a live one")
        if dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def make_fake_mesh(shape: Tuple[int, ...], axis_names: Tuple[str, ...]):
    """A ``DeviceMesh`` of ``shape`` over a fake world of its size (see
    ``start_fake_world``).  Its device type is "cuda", so DTensor picks
    the collectives it would issue on the cards (an all-to-all where it
    would fall back to an all-gather on the CPU); the fake backend sets no
    device and nothing touches CUDA."""
    from torch.distributed.device_mesh import DeviceMesh
    shape, axis_names = tuple(shape), tuple(axis_names)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh {shape} with axes {axis_names}")
    n = math.prod(shape)
    start_fake_world(n)
    return DeviceMesh("cuda", torch.arange(n).view(shape),
                      mesh_dim_names=axis_names)


def make_production_mesh(*, multi_pod: bool = False):
    """Single pod: (16, 16) = 256 ranks, axes ("data", "model").
    Multi-pod:  (2, 16, 16) = 512 ranks, axes ("pod", "data", "model") —
    the "pod" axis carries the HAP-ring / data-parallel replication across
    pods (DESIGN.md §3).  Over a fake world this process starts."""
    if multi_pod:
        return make_fake_mesh((2, 16, 16), ("pod", "data", "model"))
    return make_fake_mesh((16, 16), ("data", "model"))


# H100 SXM5 80GB HBM3 at 700 W ("NVIDIA H100 80GB HBM3, 700.00 W"), per
# GPU, from its data sheet: the roofline's constants.
PEAK_FLOPS_BF16 = 989e12        # FLOP/s, bf16 tensor cores, dense
PEAK_FLOPS_TF32 = 495e12        # FLOP/s, TF32 tensor cores, dense
PEAK_FLOPS_F32 = 67e12          # FLOP/s, f32 outside the tensor cores
HBM_BW = 3.35e12                # B/s, HBM3
NVLINK_BW_PER_LINK = 25e9       # B/s per link and direction (NVLink 4)
NVLINK_LINKS = 18               # links a GPU, 450 GB/s each way in all
