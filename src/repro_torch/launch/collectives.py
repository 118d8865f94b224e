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
    on this rank, the reference's convention (``hlo_analysis.py:39-56``),
    its outputs' types, its group's size and where it was issued
    (``collective_site``);
  * the FLOPs of this rank's local operations, by ``FlopCounterMode``'s
    formulas (``torch.utils.flop_counter``), and its matrix products;
    ``global_flops``, those of the whole program: each DTensor operation
    at its global shapes, and each local operation outside one times the
    ranks that share its work (``local_region``, which the model's local
    regions enter, ``models/spmd.py``; one otherwise);
  * the live bytes of this rank's storages: every tensor an operation
    makes is tracked until its storage dies, each storage rounded up to
    the CUDA caching allocator's 512-byte unit, so the trace's peak is
    what ``torch.cuda.max_memory_allocated`` would read for the same
    program; ``holders`` names what holds the bytes live at the peak:
    the storages made at one site (the operation that made them and the
    model's line that called it), largest total first.

An operation on DTensors is not recorded itself: the mode declines it, so
DTensor runs it, and the local operations and collectives it issues come
back through the mode.  Operations DTensor runs under its own fake-tensor
mode, to propagate shapes, are run but not recorded.

``collective_bytes(records)`` returns the reference's dict; a kind the
reference's HLO has no name for (``broadcast``, which ``moe_ep`` uses
to hand every rank data row 0's aux loss) is counted under its own key.
``pair_with_reference`` pairs a row's collectives with the reference
program's (``scripts/dryrun_reference_row.py``) by kind and type, and
gates those of at least ``residual_bytes``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import heapq
import math
import sys
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
HOLDERS = 12            # the sites holding most bytes at the peak, kept
# a new snapshot of the holders when the live bytes pass the last one's
# by this share: the holders are those of a moment within it of the peak
HOLDERS_STEP = 0.01
# a storage counts while it is reachable: before the live bytes set a peak
# more than this share above those after the last collection, garbage in
# reference cycles is collected (torch 2.11's DTensor leaves the MoE
# dispatch's buffers in such cycles, and the peak moved run to run by up
# to 4x with the collector's timing)
GC_STEP = 0.01
MODELS_DIR = "repro_torch/models/"


def alloc_bytes(nbytes: int) -> int:
    """The bytes the caching allocator hands out for ``nbytes``."""
    return -(-int(nbytes) // ALLOC_UNIT) * ALLOC_UNIT


def saved_bytes(fn, *args, **kwargs):
    """(the bytes of the distinct storages that autograd saves for the
    backward while ``fn(*args, **kwargs)`` runs, its result)."""
    seen = {}

    def pack(t):
        st = t.untyped_storage()
        seen[st._cdata] = st.nbytes()
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn(*args, **kwargs)
    return sum(seen.values()), out


@dataclasses.dataclass(frozen=True)
class Collective:
    kind: str           # the reference's HLO name, or "broadcast"
    op: str             # the operation, e.g. "c10d.allreduce_"
    nbytes: int         # its output bytes on this rank
    # each output's type on this rank in HLO's notation, "bf16[16,4096,2560]"
    shapes: tuple = ()
    ranks: int = 0      # the group's size (0: not read)
    site: str = ""      # ``collective_site()`` where it was issued

    def row(self) -> dict:
        """The record as a row of ``dryrun_one``'s ``collectives``."""
        return {"kind": self.kind, "shapes": list(self.shapes),
                "bytes": self.nbytes, "ranks": self.ranks, "site": self.site}


# torch dtype -> HLO's name of it
_HLO_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16",
               torch.float16: "f16", torch.float64: "f64",
               torch.int32: "s32", torch.int64: "s64", torch.int16: "s16",
               torch.int8: "s8", torch.uint8: "u8", torch.bool: "pred",
               torch.complex64: "c64"}
_HLO_BYTES = {"pred": 1, "s8": 1, "u8": 1, "s16": 2, "f16": 2, "bf16": 2,
              "s32": 4, "f32": 4, "s64": 8, "f64": 8, "c64": 8}


def type_bytes(hlo: str) -> int:
    """The bytes of a type in HLO's notation (``bf16[16,4096,2560]``)."""
    name, dims = hlo.rstrip("]").split("[")
    return math.prod(int(d) for d in dims.split(",") if d) * _HLO_BYTES.get(
        name, 4)


def hlo_type(t: torch.Tensor) -> str:
    """``t``'s dtype and shape as HLO prints them: ``bf16[16,4096,2560]``."""
    name = _HLO_DTYPES.get(t.dtype, str(t.dtype).replace("torch.", ""))
    return f"{name}[{','.join(str(n) for n in t.shape)}]"


def _group_size(args) -> int:
    """The size of the process group a collective's arguments name (a
    functional collective's group name, a c10d op's group), 0 if none."""
    from torch.distributed import ProcessGroup
    from torch.distributed import distributed_c10d as c10d
    for a in args:
        if isinstance(a, ProcessGroup):
            return a.size()
        if isinstance(a, str):
            try:
                return c10d._resolve_process_group(a).size()
            except (KeyError, RuntimeError, ValueError):
                continue
    return 0


def _tensors(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for y in x for t in _tensors(y)]
    return []


def _nbytes(tensors: Iterable[torch.Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def call_site() -> str:
    """``file:line`` of the innermost frame of the model code
    (``repro_torch/models/``) on the stack, or "" outside it."""
    f = sys._getframe(1)
    while f is not None:
        path = f.f_code.co_filename.replace("\\", "/")
        at = path.rfind(MODELS_DIR)
        if at >= 0:
            return f"{path[at + len('repro_torch/'):]}:{f.f_lineno}"
        f = f.f_back
    return ""


def _site() -> str:
    return call_site() or "no model frame (autograd's backward)"


def collective_site() -> str:
    """Where a collective is issued: the innermost model line on the stack
    outside ``models/spmd.py`` ("via" that module's line where it is the
    innermost), or else the innermost line of the port (the optimizer's);
    in autograd's backward, the node it runs (``in MmBackward0``), whose
    forward's model line a custom Function of ``models/spmd.py`` keeps as
    ``ctx.site``."""
    model = helper = other = None
    f = sys._getframe(1)
    while f is not None and model is None:
        path = f.f_code.co_filename.replace("\\", "/")
        at = path.rfind("repro_torch/")
        if at >= 0 and not path.endswith("launch/collectives.py"):
            where = f"{path[at + len('repro_torch/'):]}:{f.f_lineno}"
            if where.startswith("models/spmd.py"):
                helper = helper or where
            elif where.startswith("models/"):
                model = where
            else:
                other = other or where
        f = f.f_back
    node = torch._C._current_autograd_node()
    site = getattr(node, "site", None) or model or other or "no port line"
    if helper and site is model:
        site += f" via {helper}"
    return site + (f" in {node.name()}" if node is not None else "")


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
    host tensors are not the card's memory.  A storage counts while it is
    reachable (``GC_STEP``): the objects made before the trace are frozen
    out of the collector (``gc.freeze``) so that a collection is quick.

    ``holders``: the ``HOLDERS`` sites whose storages hold the most bytes
    live at (within ``HOLDERS_STEP`` of) the peak, ``(bytes, "op at
    file:line xN")`` each, N storages (the op's name alone where no model
    code is on the stack, as in autograd's backward; "argument" for those
    ``hold`` counts).
    Each entry of ``replicated`` ends with the model's line that issued
    the operation."""

    def __init__(self, device: str = "meta"):
        super().__init__()
        self.device = device
        self.collectives: List[Collective] = []
        self.flops = 0
        self.global_flops = 0
        self.matmuls = 0
        self.bytes_accessed = 0
        self.ops = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self.replicated: List[str] = []
        self.holders: List[tuple] = []
        self._holders_at = 0
        self._live: Dict[int, int] = {}     # storage key -> bytes
        self._made: Dict[int, str] = {}     # storage key -> op at file:line
        self._in_dtensor = False
        self._paused = False
        self._depth = 0                     # nested ``with self``
        self._scale = [1]                   # ranks sharing the local work
        self._collected_at = 0

    def __enter__(self):
        if self._depth == 0:
            gc.collect()
            gc.freeze()
        self._depth += 1
        return super().__enter__()

    def __exit__(self, *exc):
        self._depth -= 1
        if self._depth == 0:
            gc.unfreeze()
        return super().__exit__(*exc)

    @contextlib.contextmanager
    def local_region(self, scale: int):
        """The local operations in this block are one rank's share of
        work split ``scale`` ways (``global_flops`` counts them so)."""
        self._scale.append(scale)
        try:
            yield
        finally:
            self._scale.pop()

    # ---- storages -----------------------------------------------------
    def _track(self, t: torch.Tensor, made_by: str = "argument") -> int:
        """Start tracking ``t``'s storage if it is new; its bytes."""
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return 0
        n = alloc_bytes(st.nbytes())
        self._live[key] = n
        self._made[key] = made_by
        self.live_bytes += n
        weakref.finalize(st, self._free, key)
        return n

    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key)
        del self._made[key]

    def _new_peak(self) -> None:
        if self.live_bytes <= self.peak_bytes:
            return
        if self.live_bytes > self._collected_at * (1 + GC_STEP):
            gc.collect()            # unreachable storages' finalizers free
            self._collected_at = self.live_bytes
            if self.live_bytes <= self.peak_bytes:
                return
        self.peak_bytes = self.live_bytes
        if self.live_bytes > self._holders_at * (1 + HOLDERS_STEP):
            self._holders_at = self.live_bytes
            sites = defaultdict(lambda: [0, 0])
            for k, n in self._live.items():
                site = sites[self._made[k]]
                site[0] += n
                site[1] += 1
            self.holders = [(n, f"{what} x{count}") for what, (n, count)
                            in heapq.nlargest(HOLDERS, sites.items(),
                                              key=lambda kv: kv[1][0])]

    def hold(self, tensors) -> int:
        """Track the storages of ``tensors`` (nested lists or dicts of
        tensors, or DTensors, whose local shards count); the bytes of
        those newly tracked."""
        n = 0
        for t in map(_local, _leaf_tensors(tensors)):
            if t.device.type == self.device:
                n += self._track(t)
        self._new_peak()
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
            result = _tensors(args[0] if name.startswith("c10d.") else out)
            self.collectives.append(Collective(
                kind, name, _nbytes(result),
                tuple(hlo_type(t) for t in result),
                _group_size(list(args) + list(kwargs.values())),
                collective_site()))
        if packet in flop_registry:
            n = int(flop_registry[packet](*args, **kwargs, out_val=out))
            self.flops += n
            if not self._in_dtensor:        # a rank's share of local work
                self.global_flops += n * self._scale[-1]
        if packet.__name__ in MATMULS:
            self.matmuls += 1
        if not func.is_view:
            self.bytes_accessed += sum(
                _nbytes([t]) for t in _tensors(list(args) + [out])
                if t.device.type == self.device)
        made = [t for t in _tensors(out) if t.device.type == self.device]
        if made:
            site = call_site()
            site = f"{name} at {site}" if site else name
            for t in made:
                self._track(t, site)
        self._new_peak()
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
                    out = func(*args, **kwargs)
                except Exception as e:          # no sharding: see _resolve
                    why = str(e).strip().splitlines()[0][:160]
                    out = self._resolve(func, args, kwargs, why)
        finally:
            self._in_dtensor = False
        packet = func._overloadpacket
        if packet in flop_registry:             # at the global shapes
            self.global_flops += int(flop_registry[packet](
                *args, **kwargs, out_val=out))
        return out

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
                                   f"axis {m} replicated; {_site()}]")
            flat = list(flat)
            flat[i] = one_axis(flat[i], m)
            a, k = tree_unflatten(flat, spec)
            return func(*a, **k)

        self.replicated.append(f"{func}: {why} [every argument replicated; "
                               f"{_site()}]")
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


def residual_bytes(cfg, shape) -> int:
    """The residual stream's bytes a rank in bf16 (B/16 x S x d, over the
    production mesh's 16 "data" ranks): the least a collective that
    ``pair_with_reference`` gates moves."""
    return shape.global_batch // 16 * shape.seq_len * cfg.d_model * 2


def pair_with_reference(port: List[dict], reference: List[dict],
                        min_bytes: int) -> List[dict]:
    """Each result of each of the port's collectives (``dryrun_one``'s
    ``collectives``) paired with an unused result of one of the
    reference's (a row of ``scripts/dryrun_reference_row.py``) of the same
    kind and type at the reference program's dtype (``program_shapes``),
    in the order of each list: ``kind``, ``shape``, ``bytes``, ``ranks``,
    ``site``, ``gated`` (``bytes`` >= ``min_bytes``) and ``ref`` (the
    reference's ``op_name`` and ``ranks``, or None where none is left).
    The reference's results come from XLA's tuples one by one.  Among the
    candidates, one on the same side of the step (the backward: an
    autograd node in the port's site, ``transpose(`` in the reference's
    op_name) and over as many ranks comes first, then one on the same
    side: the pairs read as the ops they follow where the types alone
    leave a choice."""
    pool = [dict(kind=r["kind"], shape=s, op_name=r.get("op_name", ""),
                 ranks=r.get("ranks", 0))
            for r in reference for s in r.get("program_shapes", r["shapes"])]
    rows = []
    for c in port:
        back = " in " in c.get("site", "")

        def rank(p):
            side = ("transpose(" in p["op_name"]) == back
            return (not side, p["ranks"] != c.get("ranks", 0))
        for shape in c["shapes"]:
            match = min((p for p in pool if p["kind"] == c["kind"]
                         and p["shape"] == shape), key=rank, default=None)
            if match is not None:
                pool.remove(match)
            n = type_bytes(shape)
            rows.append(dict(kind=c["kind"], shape=shape, bytes=n,
                             ranks=c.get("ranks", 0), site=c.get("site", ""),
                             gated=n >= min_bytes,
                             ref=match and {"op_name": match["op_name"],
                                            "ranks": match["ranks"]}))
    return rows


def remat_duplication(trace: StepTrace) -> float:
    """Crude remat indicator, as the reference's: the number of matrix
    products (``mm``, ``bmm``, ``addmm``, ``baddbmm``) in the trace,
    where it counts ``dot(`` in the HLO."""
    return float(trace.matmuls)
