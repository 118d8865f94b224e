"""Collective accounting of a traced step: the counterpart of the JAX
package's ``launch/hlo_analysis.py``.

The reference compiles its step and parses the optimised HLO for every
all-gather / all-reduce / reduce-scatter / all-to-all /
collective-permute, summing each one's output bytes.  The port has no
compiled program: the dry-run runs its step on meta tensors, and
``StepTrace`` (a ``TorchDispatchMode``) records every operation that this
rank issues while it runs:

  * collectives: the ``_c10d_functional`` ops that DTensor emits when it
    redistributes, and the ``c10d`` ops that ``torch.distributed`` calls
    make (``fl/sharded.py``'s all-reduce, ``models/moe_ep.py``'s
    all-to-alls, all-gathers and broadcast), each with its output bytes
    on this rank, the reference's convention (``hlo_analysis.py:39-56``);
  * the FLOPs of this rank's local operations, by ``FlopCounterMode``'s
    formulas (``torch.utils.flop_counter``), and its matrix products;
  * the live bytes of this rank's storages: every tensor an operation
    makes is tracked until its storage dies, each storage rounded up to
    the CUDA caching allocator's 512-byte unit, so the trace's peak is
    what ``torch.cuda.max_memory_allocated`` would read for the same
    program.

An operation on DTensors is not recorded itself: the mode declines it, so
DTensor runs it, and the local operations and collectives it issues come
back through the mode.  Operations DTensor runs under its own fake-tensor
mode, to propagate shapes, are run but not recorded.

``collective_bytes(records)`` returns the reference's dict; a kind the
reference's HLO has no name for (``broadcast``, which ``moe_ep`` uses
to hand every rank data row 0's aux loss) is counted under its own key.
"""
from __future__ import annotations

import dataclasses
import weakref
from collections import defaultdict
from typing import Dict, Iterable, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

# op (namespace.name) -> kind.  c10d ops take their output tensors as the
# first argument; the functional ones (DTensor's) return them.
_KINDS = {
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional.all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional.all_reduce": "all-reduce",
    "_c10d_functional.all_reduce_": "all-reduce",
    "_c10d_functional.all_reduce_coalesced": "all-reduce",
    "_c10d_functional.all_reduce_coalesced_": "all-reduce",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional.reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional.all_to_all_single": "all-to-all",
    "_c10d_functional.broadcast": "broadcast",
    "_c10d_functional.broadcast_": "broadcast",
    "c10d.allreduce_": "all-reduce",
    "c10d.allreduce_coalesced_": "all-reduce",
    "c10d.allgather_": "all-gather",
    "c10d._allgather_base_": "all-gather",
    "c10d.allgather_coalesced_": "all-gather",
    "c10d.allgather_into_tensor_coalesced_": "all-gather",
    "c10d.reduce_scatter_": "reduce-scatter",
    "c10d._reduce_scatter_base_": "reduce-scatter",
    "c10d.reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "c10d.alltoall_": "all-to-all",
    "c10d.alltoall_base_": "all-to-all",
    "c10d.broadcast_": "broadcast",
    "_dtensor.shard_dim_alltoall": "all-to-all",
    "c10d.send": "collective-permute",
    "c10d.recv_": "collective-permute",
}

MATMULS = ("mm", "bmm", "addmm", "baddbmm")

ALLOC_UNIT = 512        # bytes: the CUDA caching allocator rounds up to it


def alloc_bytes(nbytes: int) -> int:
    """The bytes the caching allocator hands out for ``nbytes``."""
    return -(-int(nbytes) // ALLOC_UNIT) * ALLOC_UNIT


@dataclasses.dataclass(frozen=True)
class Collective:
    kind: str           # the reference's HLO name, or "broadcast"
    op: str             # the operation, e.g. "c10d.allreduce_"
    nbytes: int         # its output bytes on this rank


def _tensors(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for y in x for t in _tensors(y)]
    return []


def _nbytes(tensors: Iterable[torch.Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _fake_mode_active() -> bool:
    return torch._C._get_dispatch_mode(
        torch._C._TorchDispatchModeKey.FAKE) is not None


def _is_dtensor_op(types) -> bool:
    from torch.distributed.tensor import DTensor
    return any(issubclass(t, DTensor) for t in types)


class StepTrace(TorchDispatchMode):
    """Records this rank's collectives, FLOPs, matrix products and live
    storage bytes while it is active (see the module docstring).

    ``hold(tensors)`` counts tensors made before the trace (a step's
    arguments) as live from the start; ``peak_bytes`` is the most bytes
    live at once, ``live_bytes`` those live now.  Only storages on
    ``device`` (a device type) are tracked: "meta" in a dry-run, where
    host tensors are not the card's memory."""

    def __init__(self, device: str = "meta"):
        super().__init__()
        self.device = device
        self.collectives: List[Collective] = []
        self.flops = 0
        self.matmuls = 0
        self.bytes_accessed = 0
        self.ops = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self.replicated: List[str] = []
        self._live: Dict[int, int] = {}     # storage key -> bytes
        self._in_dtensor = False
        self._paused = False

    # ---- storages -----------------------------------------------------
    def _track(self, t: torch.Tensor) -> int:
        """Start tracking ``t``'s storage if it is new; its bytes."""
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return 0
        n = alloc_bytes(st.nbytes())
        self._live[key] = n
        self.live_bytes += n
        weakref.finalize(st, self._free, key)
        return n

    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key)

    def hold(self, tensors) -> int:
        """Track the storages of ``tensors`` (nested lists or dicts of
        tensors, or DTensors, whose local shards count); the bytes of
        those newly tracked."""
        n = 0
        for t in map(_local, _leaf_tensors(tensors)):
            if t.device.type == self.device:
                n += self._track(t)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        return n

    # ---- dispatch -----------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _is_dtensor_op(types):
            if self._in_dtensor:
                return NotImplemented       # DTensor runs it; see above
            return self._dtensor_op(func, args, kwargs)
        out = func(*args, **kwargs)
        if self._paused or _fake_mode_active():
            return out
        self.ops += 1
        packet = func._overloadpacket
        name = f"{packet._qualified_op_name.replace('::', '.')}"
        kind = _KINDS.get(name)
        if kind is not None:
            result = args[0] if name.startswith("c10d.") else out
            self.collectives.append(
                Collective(kind, name, _nbytes(_tensors(result))))
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
        if packet.__name__ in MATMULS:
            self.matmuls += 1
        if not func.is_view:
            self.bytes_accessed += sum(
                _nbytes([t]) for t in _tensors(list(args) + [out])
                if t.device.type == self.device)
        for t in _tensors(out):
            if t.device.type == self.device:
                self._track(t)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        return out

    def _dtensor_op(self, func, args, kwargs):
        """Run an operation on DTensors with this mode active inside it,
        so that its local operations are recorded.  Where DTensor has no
        sharding for it (no strategy, or a view it cannot take without
        redistributing), the least redistribution to ``Replicate`` found
        is made and the operation runs again (its collectives are
        recorded); ``replicated`` names each such operation and what was
        replicated.  See ``_resolve``."""
        self._in_dtensor = True
        try:
            with self:
                try:
                    return func(*args, **kwargs)
                except Exception as e:          # no sharding: see _resolve
                    why = str(e).strip().splitlines()[0][:160]
                return self._resolve(func, args, kwargs, why)
        finally:
            self._in_dtensor = False

    def _resolve(self, func, args, kwargs, why: str):
        """First, one mesh axis of one DTensor argument replicated, the
        innermost axes first, each tried with recording paused and the
        first that works made again recorded; else every DTensor argument
        replicated whole and the operation run on the local tensors, its
        outputs replicated.  An operation that writes into its first
        argument never has that argument redistributed, and falls back
        only where it is replicated already."""
        from torch.distributed.tensor import DTensor, Replicate
        from torch.utils._pytree import tree_flatten, tree_unflatten
        flat, spec = tree_flatten((args, kwargs))
        mutable = func._schema.is_mutable
        slots = [(i, m) for i, t in enumerate(flat)
                 if isinstance(t, DTensor) and not (mutable and i == 0)
                 for m in reversed(range(t.device_mesh.ndim))
                 if not t.placements[m].is_replicate()]

        def one_axis(t, m):
            pl = list(t.placements)
            pl[m] = Replicate()
            return t.redistribute(t.device_mesh, pl)

        for i, m in slots:
            self._paused = True
            try:
                trial = list(flat)
                trial[i] = one_axis(flat[i], m)
                a, k = tree_unflatten(trial, spec)
                func(*a, **k)
            except Exception:
                continue
            finally:
                self._paused = False
            self.replicated.append(f"{func}: {why} [argument {i}, mesh "
                                   f"axis {m} replicated]")
            flat = list(flat)
            flat[i] = one_axis(flat[i], m)
            a, k = tree_unflatten(flat, spec)
            return func(*a, **k)

        self.replicated.append(f"{func}: {why} [every argument replicated]")
        first = flat[0]
        if mutable and not (isinstance(first, DTensor) and all(
                p.is_replicate() for p in first.placements)):
            raise RuntimeError(f"{func} writes into a sharded DTensor that "
                               f"has no sharding for it: {why}")
        meshes = [t.device_mesh for t in flat if isinstance(t, DTensor)]
        local = [(t.redistribute(t.device_mesh,
                                 [Replicate()] * t.device_mesh.ndim)
                  .to_local() if isinstance(t, DTensor) else t)
                 for t in flat]
        if mutable:
            local[0] = first._local_tensor
        a, k = tree_unflatten(local, spec)
        out = func(*a, **k)
        return first if mutable else _as_replicated(out, meshes[0])


def _as_replicated(x, mesh):
    """The tensors of ``x`` as DTensors replicated over ``mesh``."""
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(x, torch.Tensor):
        return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                                  run_check=False)
    if isinstance(x, (list, tuple)):
        return type(x)(_as_replicated(y, mesh) for y in x)
    return x


def _leaf_tensors(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaf_tensors(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _local(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor
    return t._local_tensor if isinstance(t, DTensor) else t


def collective_bytes(records: Iterable[Collective]) -> Dict[str, int]:
    """Per-kind total bytes (output sizes on this rank) + op counts: the
    reference's ``collective_bytes(hlo_text)`` of the same program."""
    out: Dict[str, int] = defaultdict(int)
    counts: Dict[str, int] = defaultdict(int)
    for r in records:
        out[r.kind] += r.nbytes
        counts[r.kind] += 1
    result = dict(out)
    result["_counts"] = dict(counts)
    result["total"] = int(sum(out.values()))
    return result


def remat_duplication(trace: StepTrace) -> float:
    """Crude remat indicator, as the reference's: the number of matrix
    products (``mm``, ``bmm``, ``addmm``, ``baddbmm``) in the trace,
    where it counts ``dot(`` in the HLO."""
    return float(trace.matmuls)
