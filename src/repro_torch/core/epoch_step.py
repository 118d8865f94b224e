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
every scenario's result is bit-identical to its solo step.  The JAX
package's mesh-sharded path comes with a later slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.modelbank import FlatSpec
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


@dataclasses.dataclass
class EpochStepProgram:
    """The per-epoch step for one (FlatSpec, trainer) pair.

    ``train_fn(params, inputs, ids_np, seed) -> (stacked, losses)``;
    ``stacked`` is a dict whose tensors carry a leading participant axis,
    or already a flat (C, N) stack.
    """
    spec: FlatSpec
    train_fn: Callable[..., Tuple[Any, torch.Tensor]]

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
             *, fallback: bool = False):
        """Run one epoch.  ``w_flat`` is updated in place and returned as
        the new global model.  ``wv_*`` / ``dw_*`` / ``base_w`` are host
        metadata (numpy); ``ids_np`` is the padded participant id vector.
        ``dw_row``/``dw_seg`` give each bank row its partial-model weight
        and its new-orbit segment (``kpad`` = dump id); ``blocked_m`` > 0
        asserts segment k owns exactly rows [k*m, (k+1)*m) and selects the
        blocked einsum.  The returned distances carry ``kpad`` entries of
        which the first K are real.
        """
        if fallback:
            self.fallback_dispatches += 1
        else:
            self.dispatches += 1
        args = (w_flat, carry, inputs, ids_np, seed, wv_bank, wv_carry,
                base_w, dw_row, dw_seg, kpad, blocked_m, dw_carry, ref)
        prof = self.profiler
        if prof is None:
            return self._step(*args)
        # the reference's static dispatch signature: the shapes and static
        # arguments that force a new jit trace there (carry rows,
        # participant count, kpad, blocked_m) and the fallback split
        sig = (int(carry.shape[0]), int(len(ids_np)), int(kpad),
               int(blocked_m), bool(fallback))
        t0 = prof.timer()
        out = self._step(*args)
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
    cached on the trainer, so repeated simulations share their counters."""
    if mesh is not None:
        raise NotImplementedError(
            "a device mesh is not ported yet: the mesh-sharded epoch step "
            "comes with ROADMAP queue A item 15 (mesh- and pod-shaped code)")
    fn = getattr(trainer, "epoch_train_fn", None)
    if fn is None or not hasattr(trainer, "epoch_inputs"):
        return None
    spec = FlatSpec.of(params)
    cache = trainer.__dict__.setdefault("_epoch_programs", {})
    prog = cache.get(spec)
    if prog is None:
        prog = cache[spec] = EpochStepProgram(spec, fn())
    return prog
