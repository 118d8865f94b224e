"""Multiplexing per-scenario epoch steps into shared physical steps, as the
JAX package's ``repro.sweep.batch``.

The event-driven runtime is host logic — contact plans, priority queues,
channel reservations differ per scenario and stay per-scenario.  What IS
shared is the device work: every committed epoch funnels through
``EpochStepProgram.step``.  The sweep engine therefore runs each
scenario's full runtime on its own worker thread and intercepts that one
choke point with a ``BatchedProgram`` proxy: instead of stepping, the
worker enqueues a *step request* (host arrays and the tensors it already
holds) and blocks.  When every live scenario is either blocked on a
request or finished, the driver thread flushes: requests with identical
static signatures (same program spec, participant count, carry rows,
kpad/blocked_m, fallback split, batch structure and the trainer's
``scenario_batch_key``) become ONE physical ``batched_step``; singletons
and trainers without a batch key run solo through their own ``step`` —
trivially bit-exact, as do programs with a mesh (``_batchable``, the
reference's rule).  Every device step of a batched sweep runs on the
driver thread; each scenario gets back its own outputs.

A batched step updates a fresh (B, N) stack of the group's global
models in place, and each scenario's new global model is its row of that
stack: the next flush stacks the models anew, so no scenario's step ever
writes another scenario's model.

Deadlock-freedom: workers block only inside ``submit``; the driver
flushes exactly when no worker can make progress without it; every value
a worker reads after waking was produced by that flush.  The driver counts
the workers it releases as running, under the lock, before it wakes them:
a worker that wakes, steps and submits again before its group-mates have
run can then never make the barrier hold with them still asleep, which
would flush it alone.

Parity contract (DESIGN.md §13): per-scenario histories, weights and
*logical* step counts from a batched run are bit-identical to running
each scenario sequentially — ``mode="exact"`` runs each scenario's row
through the solo step's own code.  ``mode="vmap"`` trains the group in
one ``torch.func.vmap`` call instead (not required to be exact; opt-in).
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, List, Optional, Tuple

import numpy as np
import torch


def _normalize_step_args(w_flat, carry, inputs, ids_np, seed, wv_bank,
                         wv_carry, base_w, dw_row, dw_seg, kpad, blocked_m,
                         dw_carry, ref):
    """The host arguments of ``EpochStepProgram.step`` in the dtypes the
    step uses, converted once at enqueue time so grouping and stacking see
    settled arrays.  The result re-passes through ``step`` unchanged
    (every conversion is idempotent), so a solo step stays bit-identical.
    Tensors pass through untouched."""
    return (w_flat, carry, inputs,
            np.asarray(ids_np, np.int32), int(seed),
            np.asarray(wv_bank, np.float32),
            np.asarray(wv_carry, np.float32),
            float(np.float32(base_w)),
            np.asarray(dw_row, np.float32),
            np.asarray(dw_seg, np.int32),
            int(kpad), int(blocked_m),
            np.asarray(dw_carry, np.float32),
            ref)


def _inputs_sig(inputs) -> Optional[Tuple]:
    """The structure, shapes and dtypes of a step's batch inputs (None, a
    tensor or array, or tuples, lists and dicts of them)."""
    if inputs is None:
        return None
    if isinstance(inputs, dict):
        return ("dict",) + tuple((k, _inputs_sig(v))
                                 for k, v in sorted(inputs.items()))
    if isinstance(inputs, (tuple, list)):
        return (type(inputs).__name__,) + tuple(_inputs_sig(x)
                                               for x in inputs)
    return (tuple(inputs.shape), str(inputs.dtype))


def _stack_inputs(parts):
    """The per-scenario batch inputs ``parts`` stacked along a new leading
    scenario axis, structure kept."""
    first = parts[0]
    if isinstance(first, dict):
        return {k: _stack_inputs([p[k] for p in parts]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_stack_inputs(list(xs)) for xs in zip(*parts))
    if isinstance(first, torch.Tensor):
        return torch.stack(parts)
    return np.stack(parts)


@dataclasses.dataclass
class _Request:
    """One scenario's pending epoch step."""
    prog: Any                          # the scenario's own EpochStepProgram
    args: Tuple                        # normalized step-order args (14)
    fallback: bool
    sig: Tuple                         # grouping signature
    late_rows: Tuple = ()              # step(late_rows=...) of a solo step
    event: threading.Event = dataclasses.field(default_factory=threading.Event)
    out: Optional[Tuple] = None
    error: Optional[BaseException] = None


class BatchedProgram:
    """Drop-in ``EpochStepProgram`` facade handed to one scenario's
    simulator/runtime: same ``spec``/``profiler``/``step`` surface, same
    *logical* step counters (``dispatches``/``fallback_dispatches``
    advance exactly as a sequential run's would — a parity invariant),
    but ``step`` routes through the shared :class:`DispatchBatcher`."""

    def __init__(self, batcher: "DispatchBatcher", inner, key=None):
        self._batcher = batcher
        self._inner = inner
        self._key = key
        self.dispatches = 0
        self.fallback_dispatches = 0

    @property
    def spec(self):
        return self._inner.spec

    @property
    def profiler(self):
        return self._inner.profiler

    @profiler.setter
    def profiler(self, value):
        self._inner.profiler = value

    def _batchable(self) -> bool:
        """A program batches with others only under a batch key and
        without a mesh (its steps hold collectives: it runs solo)."""
        return self._key is not None and self._inner.mesh is None

    def step(self, w_flat, carry, inputs, ids_np, seed, wv_bank, wv_carry,
             base_w, dw_row, dw_seg, kpad, blocked_m, dw_carry, ref,
             *, fallback: bool = False, late_rows=()):
        if fallback:
            self.fallback_dispatches += 1
        else:
            self.dispatches += 1
        args = _normalize_step_args(w_flat, carry, inputs, ids_np, seed,
                                    wv_bank, wv_carry, base_w, dw_row,
                                    dw_seg, kpad, blocked_m, dw_carry, ref)
        sig = (self._key if self._batchable() else None,
               self._inner.spec, int(args[1].shape[0]),
               int(args[3].shape[0]), int(kpad), int(blocked_m),
               bool(fallback), _inputs_sig(inputs))
        return self._batcher.submit(
            _Request(self._inner, args, bool(fallback), sig,
                     tuple(late_rows)))


class DispatchBatcher:
    """The barrier + flush engine shared by one sweep's scenarios.

    Lifecycle: the driver ``register()``s each scenario before starting
    its worker thread, then loops in ``drain()`` on the main thread;
    workers go through ``wrap()``ed programs whose ``step`` calls
    ``submit()`` and blocks; ``finish()`` retires a worker.  Every epoch
    step runs on the driver thread inside ``drain``.
    """

    def __init__(self, mode: str = "exact", profiler=None):
        if mode not in ("exact", "vmap"):
            raise ValueError(f"unknown scenario batch mode {mode!r}")
        self.mode = mode
        self.profiler = profiler       # obs.DispatchProfiler for *physical*
        self._cv = threading.Condition()
        self._pending: List[_Request] = []
        self._live = 0                 # registered, not yet finished
        self._running = 0              # live and not blocked in submit()
        # telemetry — physical accounting (logical lives on the proxies)
        self.flushes = 0
        self.physical_dispatches = 0   # steps actually run
        self.batched_dispatches = 0    # ... of which multi-scenario
        self.solo_dispatches = 0       # ... of which single-scenario
        self.max_group = 0

    # ---- worker side -------------------------------------------------------

    def register(self) -> None:
        with self._cv:
            self._live += 1
            self._running += 1

    def wrap(self, prog, key=None):
        """Proxy ``prog`` for one scenario; ``key`` is the trainer's
        ``scenario_batch_key`` (None -> every step runs solo)."""
        if prog is None:
            return None
        return BatchedProgram(self, prog, key=key)

    def submit(self, req: _Request):
        with self._cv:
            self._pending.append(req)
            self._running -= 1
            self._cv.notify_all()
        req.event.wait()        # drain() counted this worker running again
        if req.error is not None:
            raise req.error
        return req.out

    def finish(self) -> None:
        with self._cv:
            self._live -= 1
            self._running -= 1
            self._cv.notify_all()

    # ---- driver side -------------------------------------------------------

    def drain(self) -> None:
        """Run on the driver thread until every registered scenario has
        finished: wait for the barrier (no runnable worker), flush."""
        while True:
            with self._cv:
                self._cv.wait_for(
                    lambda: self._running == 0 and (self._pending
                                                    or self._live == 0))
                if not self._pending and self._live == 0:
                    return
                batch, self._pending = self._pending, []
                # the released workers run from here on: counted before
                # any wakes, so none can make the barrier hold alone
                self._running += len(batch)
            self._flush(batch)

    def _flush(self, batch: List[_Request]) -> None:
        groups: dict = {}
        for req in batch:
            groups.setdefault(req.sig, []).append(req)
        self.flushes += 1
        for reqs in groups.values():
            try:
                self._execute(reqs)
            except BaseException as e:   # propagate into every blocked worker
                for r in reqs:
                    r.error = e
            finally:
                for r in reqs:
                    r.event.set()

    def _execute(self, reqs: List[_Request]) -> None:
        prof = self.profiler
        t0 = prof.timer() if prof is not None else 0.0
        if len(reqs) == 1 or reqs[0].sig[0] is None:
            # singleton or no batch key: the scenario's own program, its
            # own step() — bit-exact by construction
            for r in reqs:
                r.out = r.prog.step(*r.args, fallback=r.fallback,
                                    late_rows=r.late_rows)
                self.physical_dispatches += 1
                self.solo_dispatches += 1
            self.max_group = max(self.max_group, 1)
            if prof is not None:
                prof.record(("solo-group",) + reqs[0].sig[2:7],
                            reqs[0].fallback, prof.timer() - t0)
            return
        prog = reqs[0].prog            # the batch key certifies equivalence
        cols = list(zip(*(r.args for r in reqs)))
        inputs = None if cols[2][0] is None else _stack_inputs(cols[2])
        kpad, blocked_m = reqs[0].args[10], reqs[0].args[11]
        # a fresh (B, N) stack: each row is updated in place and becomes
        # its scenario's model, never aliasing another scenario's
        outs = prog.batched_step(
            torch.stack(cols[0]), torch.stack(cols[1]), inputs,
            np.stack(cols[3]), np.asarray(cols[4], np.int64),
            np.stack(cols[5]), np.stack(cols[6]),
            np.asarray(cols[7], np.float32),
            np.stack(cols[8]), np.stack(cols[9]), kpad, blocked_m,
            np.stack(cols[12]), torch.stack(cols[13]),
            mode=self.mode, fallback=reqs[0].fallback)
        for r, out in zip(reqs, outs):
            r.out = out
        self.physical_dispatches += 1
        self.batched_dispatches += 1
        self.max_group = max(self.max_group, len(reqs))
        if prof is not None:
            prof.record(("batched-group", self.mode, len(reqs))
                        + reqs[0].sig[2:7],
                        reqs[0].fallback, prof.timer() - t0)

    def summary(self) -> dict:
        return {"flushes": self.flushes,
                "physical_dispatches": self.physical_dispatches,
                "batched_dispatches": self.batched_dispatches,
                "solo_dispatches": self.solo_dispatches,
                "max_group": self.max_group,
                "mode": self.mode}
