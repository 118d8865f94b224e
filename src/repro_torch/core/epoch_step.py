"""One epoch's device work behind one call (DESIGN.md §6).

``EpochStepProgram.step`` runs an epoch of the fused path:

    in :  w_flat (N,) [updated in place], carry (L, N) stragglers, the
          participants' batch inputs, participant ids, epoch seed,
          aggregation weight vectors over bank/carry rows, base weight,
          new-orbit partial-model row weights + segment ids, grouping
          reference (N,)
    out:  new w_flat (N,), bank stack (C, N), new-orbit distances (kpad,),
          per-participant losses (C,)

Inside: the pool trains every participant from ``w_flat``; the trained
stack is formed; eq. 14 is one ``fed_agg`` launch over the bank and the
carry together, folding in ``base_w * w_flat`` and writing into ``w_flat``
(the JAX package runs it as a bank pass and a carry pass onto its output);
and the distances of new orbits
to w0 are ``|| segment_sum(w_row * rows) - ref ||`` over the same stack.
Every per-model weight is host metadata math (eqs. 13/14 need sizes and
staleness, not tensors), so the weight vectors are inputs.  The one case
where they depend on a tensor result (a new orbit arriving while stale
models are pending) runs the step with zero weights and aggregates
afterwards, counted in ``fallback_dispatches``.

The JAX package donates ``w_flat`` to its jitted program, which writes the
new global model into the same buffer.  Here the update is in place for
the same reason: the caller must not expect ``w_flat``'s old values after
the call.  A ``DispatchProfiler`` (``obs/profile``) attached as
``profiler`` times each ``step`` on the host.

``batched_step`` runs B scenarios' epochs as one physical step for the
sweep engine (``sweep/batch.py``, DESIGN.md §13): by default each row of
a fresh (B, N) stack goes through the same ``_step`` as a solo call, so
every scenario's result is bit-identical to its solo step.

Mesh: with a ``launch.mesh.Mesh`` whose "data" axis has more than one
rank and divides the participant count C, the step is sharded, as the
reference's is over devices (DESIGN.md §6).  Every rank of the data axis
calls ``step`` with the same arguments; each trains its own contiguous
C/n participant rows (the pools draw one generator a participant, so a
row's model does not depend on which rank trains it), contracts them in
one ``fed_agg`` launch (rank 0 also folds in ``base_w * w_flat`` and the
carry, the other ranks neither), and forms its partial grouping sums.
One all-reduce over the data axis then sums the bank term, the grouping
partials, the participants' losses and the bank rows the caller reads
after the step (``late_rows``; each rank zero-fills the rows it does not
own).  Every rank ends with the same bits of the new model, distances,
losses and late rows: the all-reduce hands every rank one result.  The
returned stack is a ``ShardedStack``; ``stack_rows`` and ``combine_stack``
read it on any path.  Otherwise, or with ``mesh=None``, the step is the
single-device one.  The sharded step sums in another order than the
unsharded one (agreeing to f32 rounding), as the reference's does.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import aggregation as agg
from repro_torch.core.modelbank import FlatSpec, gather_rows
from repro_torch.kernels.fed_agg import fed_agg

# Straggler matrices are padded up to at least this many rows, as in the
# JAX package, where it keeps one trace across the common 0..4-straggler
# epochs; the port keeps it so the two packages' carry shapes agree.
CARRY_MIN_ROWS = 4


def next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def carry_capacity(n: int) -> int:
    """Row capacity for a carried-stragglers matrix of ``n`` live rows."""
    return max(CARRY_MIN_ROWS, next_pow2(max(n, 1)))


def _data_axis_size(mesh) -> int:
    if mesh is None or "data" not in mesh.axis_names:
        return 1
    return mesh.size("data")


def _all_reduce(t: torch.Tensor, mesh) -> torch.Tensor:
    torch.distributed.all_reduce(t, group=mesh.group("data"))
    return t


def bank_sharding(mesh):
    """The (C, N) bank layout: participants over "data", parameters
    replicated (the shared rule lives in ``launch/sharding.py``)."""
    from repro_torch.launch.sharding import bank_sharding as _bs
    return _bs(mesh)


def sharded_contract(w: torch.Tensor, stack: torch.Tensor,
                     mesh) -> torch.Tensor:
    """(C,) @ (C, N) with the C axis sharded over "data": each rank passes
    its own rows of ``w`` and ``stack``, contracts them in one ``fed_agg``
    launch, and one all-reduce sums the partials."""
    return _all_reduce(fed_agg(stack, w), mesh)


@dataclasses.dataclass
class ShardedStack:
    """A sharded step's bank as one rank holds it: its own rows
    ``[lo, lo + len(local))`` of the (C, N) stack, and the rows the step
    reduced across ranks for its caller (``late_rows``, in that order, as
    ``late``)."""
    local: torch.Tensor
    lo: int
    late_rows: Tuple[int, ...]
    late: torch.Tensor
    mesh: Any


def stack_rows(stack, rows) -> torch.Tensor:
    """Rows ``rows`` of a step's bank, a new (len(rows), N) tensor.  A
    ``ShardedStack`` holds the rows its step was given as ``late_rows``,
    and no others."""
    if not isinstance(stack, ShardedStack):
        return gather_rows(stack, rows)
    if tuple(int(k) for k in rows) != stack.late_rows:
        raise ValueError(f"a sharded step reduced rows {stack.late_rows}, "
                         f"not {list(rows)}: pass them as its late_rows")
    return stack.late


def combine_stack(stack, ws_bank, carry: Optional[torch.Tensor], ws_carry,
                  base: torch.Tensor, base_w: float) -> torch.Tensor:
    """``base_w * base + ws_bank @ stack + ws_carry @ carry`` (host weight
    vectors; ``carry=None`` drops its term) through
    ``aggregation.combine_stacked``.  On a ``ShardedStack`` each rank
    combines its own rows, rank 0 also the base and the carry, and one
    all-reduce sums them."""
    if not isinstance(stack, ShardedStack):
        out = agg.combine_stacked([(stack, ws_bank), (carry, ws_carry)],
                                  base, base_w)
        return base if out is None else out
    head = stack.mesh.coord("data") == 0
    hi = stack.lo + int(stack.local.shape[0])
    terms = [(stack.local, np.asarray(ws_bank)[stack.lo:hi])]
    if head:
        terms.append((carry, ws_carry))
    out = agg.combine_stacked(terms, base if head else None,
                              base_w if head else 0.0)
    if out is None:
        out = torch.zeros_like(base)
    return _all_reduce(out, stack.mesh)


def _rows(inputs, lo: int, hi: int):
    """Rows ``[lo, hi)`` of every leaf of step inputs: None, a tensor, or
    tuples, lists and dicts of them."""
    if inputs is None:
        return None
    if isinstance(inputs, dict):
        return {k: _rows(v, lo, hi) for k, v in inputs.items()}
    if isinstance(inputs, (tuple, list)):
        return type(inputs)(_rows(x, lo, hi) for x in inputs)
    return inputs[lo:hi]


@dataclasses.dataclass
class EpochStepProgram:
    """The per-epoch step for one (FlatSpec, trainer) pair.

    ``train_fn(params, inputs, ids_np, seed) -> (stacked, losses)``;
    ``stacked`` is a dict whose tensors carry a leading participant axis,
    or already a flat (C, N) stack.  ``mesh``: a ``launch.mesh.Mesh``
    whose "data" axis the step shards over (module docstring), or None.
    """
    spec: FlatSpec
    train_fn: Callable[..., Tuple[Any, torch.Tensor]]
    mesh: Optional[Any] = None

    dispatches: int = 0                # one-step epochs
    fallback_dispatches: int = 0       # epochs that needed train + agg split
    batched_dispatches: int = 0        # scenario-batched physical steps
    # obs/profile.DispatchProfiler, set by FLSimulation._init_run on every
    # run (None detaches the previous run's); None skips the hook
    profiler: Optional[Any] = None

    def step(self, w_flat: torch.Tensor, carry: torch.Tensor, inputs,
             ids_np: np.ndarray, seed: int, wv_bank: np.ndarray,
             wv_carry: np.ndarray, base_w: float, dw_row: np.ndarray,
             dw_seg: np.ndarray, kpad: int, blocked_m: int,
             dw_carry: np.ndarray, ref: torch.Tensor,
             *, fallback: bool = False, late_rows=()):
        """Run one epoch.  ``w_flat`` is updated in place and returned as
        the new global model.  ``wv_*`` / ``dw_*`` / ``base_w`` are host
        metadata (numpy); ``ids_np`` is the padded participant id vector.
        ``dw_row``/``dw_seg`` give each bank row its partial-model weight
        and its new-orbit segment (``kpad`` = dump id); ``blocked_m`` > 0
        asserts segment k owns exactly rows [k*m, (k+1)*m) and selects the
        blocked einsum.  The returned distances carry ``kpad`` entries of
        which the first K are real.  ``late_rows``: the bank rows the
        caller reads after the step (``stack_rows``), which a sharded step
        reduces across ranks with the rest; an unsharded stack holds every
        row.
        """
        if fallback:
            self.fallback_dispatches += 1
        else:
            self.dispatches += 1
        args = (w_flat, carry, inputs, ids_np, seed, wv_bank, wv_carry,
                base_w, dw_row, dw_seg, kpad, blocked_m, dw_carry, ref)
        n = _data_axis_size(self.mesh)
        if n > 1 and len(ids_np) % n == 0:
            step = functools.partial(self._sharded_step,
                                     late_rows=tuple(late_rows))
        else:
            step = self._step
        prof = self.profiler
        if prof is None:
            return step(*args)
        # the reference's static dispatch signature: the shapes and static
        # arguments that force a new jit trace there (carry rows,
        # participant count, kpad, blocked_m) and the fallback split
        sig = (int(carry.shape[0]), int(len(ids_np)), int(kpad),
               int(blocked_m), bool(fallback))
        t0 = prof.timer()
        out = step(*args)
        if prof.block and w_flat.device.type == "cuda":
            torch.cuda.synchronize(w_flat.device)
        prof.record(sig, bool(fallback), prof.timer() - t0)
        return out

    # ---- scenario batch axis (DESIGN.md §13) -------------------------------

    def batched_step(self, w_stack: torch.Tensor, carry: torch.Tensor,
                     inputs, ids: np.ndarray, seeds: np.ndarray,
                     wv_bank: np.ndarray, wv_carry: np.ndarray,
                     base_w: np.ndarray, dw_row: np.ndarray,
                     dw_seg: np.ndarray, kpad: int, blocked_m: int,
                     dw_carry: np.ndarray, ref: torch.Tensor, *,
                     mode: str = "exact", fallback: bool = False):
        """Run B scenarios' epochs as one physical step.

        Every argument but ``kpad``/``blocked_m`` (shared: the batcher
        groups only requests with equal static signatures) carries a
        leading scenario axis B: ``w_stack`` (B, N) and ``carry`` (B, L, N)
        and ``ref`` (B, N) are tensors, the batch leaves of ``inputs``
        too (``inputs=None`` stays None), the rest host arrays.
        ``w_stack`` is a fresh stack the batcher built: row b is updated in
        place and becomes scenario b's new global model.  Returns B
        per-scenario ``(new w_flat, stack, dists, losses)`` tuples.

        ``mode="exact"`` runs each row through ``_step``, the solo call's
        own code, so each scenario's result is bit-identical to its solo
        step.  ``mode="vmap"`` trains the B scenarios in one
        ``torch.func.vmap`` call over the trainer's train function (which
        must be plain tensor math that vmap can trace, as the sweep
        testbed's is), then runs each scenario's eq. 14 contraction and
        distances as ``_step`` does: opt-in, not required to be exact.
        The reference refuses scenario batching for its Pallas-kernel
        switch; the port has no such switch, and both modes launch
        ``fed_agg`` once a scenario, exactly as the solo step does.
        """
        if self.mesh is not None:
            raise ValueError("scenario batching supports mesh=None only: "
                             "a mesh program runs solo")
        if mode not in ("exact", "vmap"):
            raise ValueError(f"unknown scenario batch mode {mode!r}")
        self.batched_dispatches += 1
        prof = self.profiler
        t0 = prof.timer() if prof is not None else 0.0
        B = int(w_stack.shape[0])
        if mode == "exact":
            out = [self._step(w_stack[b], carry[b], _select(inputs, b),
                              ids[b], int(seeds[b]), wv_bank[b], wv_carry[b],
                              float(base_w[b]), dw_row[b], dw_seg[b], kpad,
                              blocked_m, dw_carry[b], ref[b])
                   for b in range(B)]
        else:
            dev = w_stack.device
            stacks, losses = torch.func.vmap(
                self._train, in_dims=(0, None if inputs is None else 0, 0, 0))(
                    w_stack, inputs,
                    torch.as_tensor(np.asarray(ids), device=dev),
                    torch.as_tensor(np.asarray(seeds, np.int64), device=dev))
            out = [self._aggregate(w_stack[b], carry[b], stacks[b].contiguous(),
                                   losses[b], wv_bank[b], wv_carry[b],
                                   float(base_w[b]), dw_row[b], dw_seg[b],
                                   kpad, blocked_m, dw_carry[b], ref[b])
                   for b in range(B)]
        if prof is not None:
            sig = ("batched", mode, B, int(carry.shape[1]),
                   int(np.shape(ids)[1]), int(kpad), int(blocked_m),
                   bool(fallback))
            if prof.block and w_stack.device.type == "cuda":
                torch.cuda.synchronize(w_stack.device)
            prof.record(sig, bool(fallback), prof.timer() - t0)
        return out

    # ---- one epoch ---------------------------------------------------------

    def _train(self, w_flat, inputs, ids, seed):
        """Every participant trained from ``w_flat``: ((C, N) stack, (C,)
        losses)."""
        stacked, losses = self.train_fn(self.spec.unflatten(w_flat), inputs,
                                        ids, seed)
        stack = (stacked if isinstance(stacked, torch.Tensor)
                 else self.spec.flatten_stacked(stacked))
        return stack, losses

    def _step(self, w_flat, carry, inputs, ids_np, seed, wv_bank, wv_carry,
              base_w, dw_row, dw_seg, kpad, blocked_m, dw_carry, ref):
        stack, losses = self._train(w_flat, inputs, ids_np, seed)
        return self._aggregate(w_flat, carry, stack, losses, wv_bank,
                               wv_carry, base_w, dw_row, dw_seg, kpad,
                               blocked_m, dw_carry, ref)

    def _aggregate(self, w_flat, carry, stack, losses, wv_bank, wv_carry,
                   base_w, dw_row, dw_seg, kpad, blocked_m, dw_carry, ref):
        """Eq. 14 into ``w_flat`` (one ``fed_agg`` launch over the bank and
        the carry) and the new-orbit distances over ``stack``."""
        dev = w_flat.device

        def host(a, dtype=torch.float32):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

        fed_agg(stack, host(wv_bank), w_flat, float(base_w), out=w_flat,
                stack2=carry, gamma2=host(wv_carry))
        if kpad:
            c, n = stack.shape
            dw = host(dw_row)
            if blocked_m:
                # new orbits own contiguous equal row blocks (the common
                # full-participation layout): one O(C*N) blocked einsum
                pm = torch.einsum("km,kmn->kn", dw.reshape(kpad, blocked_m),
                                  stack.reshape(kpad, blocked_m, n))
            else:
                # general layout: one-hot the segment ids into a dense
                # (kpad+1, C) weight matrix (row kpad is the dump) and GEMM
                seg = host(dw_seg, torch.int64)
                w_mat = (torch.nn.functional.one_hot(seg, kpad + 1).T
                         .to(torch.float32) * dw[None, :])
                pm = (w_mat @ stack)[:kpad]
            pm = pm + host(dw_carry) @ carry
            dists = torch.linalg.norm(pm - ref[None, :], dim=1)
        else:
            dists = torch.zeros((0,), dtype=torch.float32, device=dev)
        return w_flat, stack, dists, losses

    def _sharded_step(self, w_flat, carry, inputs, ids_np, seed, wv_bank,
                      wv_carry, base_w, dw_row, dw_seg, kpad, blocked_m,
                      dw_carry, ref, *, late_rows):
        """``_step`` with the participants sharded over the mesh's "data"
        axis (module docstring): this rank's rows, then one all-reduce of
        [new model | grouping partials | late rows | losses]."""
        mesh = self.mesh
        n, r = mesh.size("data"), mesh.coord("data")
        C = len(ids_np)
        lo, hi = r * (C // n), (r + 1) * (C // n)
        dev = w_flat.device

        def host(a, dtype=torch.float32):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

        stack, losses = self._train(w_flat, _rows(inputs, lo, hi),
                                    np.asarray(ids_np)[lo:hi], seed)
        N, L = stack.shape[1], len(late_rows)
        buf = torch.zeros(N * (1 + kpad + L) + C, dtype=torch.float32,
                          device=dev)
        head = r == 0
        carry_seg = (dict(stack2=carry, gamma2=host(wv_carry)) if head
                     else {})
        fed_agg(stack, host(np.asarray(wv_bank)[lo:hi]),
                w_flat if head else None, float(base_w) if head else 0.0,
                out=buf[:N], **carry_seg)
        if kpad:
            # this rank's rows of the segment sums; in the blocked layout
            # row i belongs to block i // blocked_m
            seg = (torch.arange(lo, hi, device=dev) // blocked_m
                   if blocked_m else host(np.asarray(dw_seg)[lo:hi],
                                          torch.int64))
            w_mat = (torch.nn.functional.one_hot(seg, kpad + 1).T
                     .to(torch.float32)
                     * host(np.asarray(dw_row)[lo:hi])[None, :])
            pm = (w_mat @ stack)[:kpad]
            if head:
                pm = pm + host(dw_carry) @ carry
            buf[N:N * (1 + kpad)] = pm.reshape(-1)
        late = buf[N * (1 + kpad):N * (1 + kpad + L)].view(L, N)
        own = [(j, k - lo) for j, k in enumerate(late_rows) if lo <= k < hi]
        if own:             # the late rows this rank trained; zeros elsewhere
            js, ks = zip(*own)
            late[list(js)] = stack[list(ks)]
        buf[N * (1 + kpad + L) + lo:N * (1 + kpad + L) + hi] = losses
        _all_reduce(buf, mesh)

        w_flat.copy_(buf[:N])
        if kpad:
            pm = buf[N:N * (1 + kpad)].view(kpad, N)
            dists = torch.linalg.norm(pm - ref[None, :], dim=1)
        else:
            dists = torch.zeros((0,), dtype=torch.float32, device=dev)
        sharded = ShardedStack(stack, lo, tuple(late_rows), late.clone(),
                               mesh)
        return w_flat, sharded, dists, buf[N * (1 + kpad + L):].clone()


def _select(inputs, b: int):
    """Scenario ``b``'s slice of batched step inputs: None, a tensor, or
    tuples, lists and dicts of them."""
    if inputs is None:
        return None
    if isinstance(inputs, dict):
        return {k: _select(v, b) for k, v in inputs.items()}
    if isinstance(inputs, (tuple, list)):
        return type(inputs)(_select(x, b) for x in inputs)
    return inputs[b]


def make_epoch_program(trainer, params, mesh: Optional[object] = None
                       ) -> Optional[EpochStepProgram]:
    """The step for a trainer exposing the fused-epoch protocol
    (``epoch_train_fn`` + ``epoch_inputs``); None otherwise.  Programs are
    cached on the trainer, so repeated simulations share their counters:
    under the FlatSpec, or under (FlatSpec, mesh) for a mesh."""
    fn = getattr(trainer, "epoch_train_fn", None)
    if fn is None or not hasattr(trainer, "epoch_inputs"):
        return None
    spec = FlatSpec.of(params)
    cache = trainer.__dict__.setdefault("_epoch_programs", {})
    key = spec if mesh is None else (spec, mesh)
    prog = cache.get(key)
    if prog is None:
        prog = cache[key] = EpochStepProgram(spec, fn(), mesh=mesh)
    return prog
