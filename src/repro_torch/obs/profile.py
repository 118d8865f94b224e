"""Host-side dispatch profiling for the fused epoch step, as the JAX
package's ``repro.obs.profile``.

`core/epoch_step.EpochStepProgram` counts dispatches but says nothing
about where the host wall-clock went.  A :class:`DispatchProfiler`
attached as ``program.profiler`` (or via ``SimConfig.profiler``, which
`core/simulator._init_run` forwards) receives a callback around every
``step()`` dispatch:

* **cold vs steady**: a dispatch whose static signature — (carry rows,
  participant count, ``kpad``, ``blocked_m``, fallback) — this profiler
  has not seen lands in ``compile_s``; repeats land in ``dispatch_s``.
  There is no jit here, so nothing is traced or compiled: a cold call's
  extra time is first-use work at a new shape — cuDNN choosing its
  convolution algorithms, the caching allocator growing its pools.
  ``compile_s`` keeps the reference's name for that share.  CUDA launches
  are asynchronous, so by default these are *host dispatch* times; pass
  ``block=True`` to synchronise the outputs' device inside the timed
  region for device-inclusive numbers (it changes what is measured, never
  the results; a CPU step has nothing to wait for).
* **dispatches per trigger**: the event runtime calls ``trigger()``
  once per commit, so ``summary()`` can report how many step dispatches
  the aggregation triggers consumed: one a commit that trains (the
  fallback split's aggregation runs after its step, outside it), none a
  commit that only aggregates carried stragglers.

``profiler=None`` (the default everywhere) skips the hook entirely —
the program's ``step`` takes the exact pre-existing path.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Set, Tuple


class DispatchProfiler:
    """Wall-clock accounting of fused-epoch dispatches.

    One profiler per run: it keys cold-ness on signatures *it* has seen.
    When the trainer was used before, its shapes are already warm, so a
    first-seen signature may cost no more than a steady one.
    """

    def __init__(self, block: bool = False):
        self.block = bool(block)
        self.dispatches = 0                # total step() calls
        self.cold_dispatches = 0           # first-seen static signatures
        self.fallback_dispatches = 0       # steps of the fallback split
        self.compile_s = 0.0               # host seconds in cold calls
        self.dispatch_s = 0.0              # host seconds in warm calls
        self.triggers = 0                  # runtime commits observed
        self._seen: Set[Tuple] = set()
        # a sweep engine shares one profiler across worker threads whose
        # commits race on trigger() (the reference's does; the port's
        # comes with ROADMAP queue A item 12); record() stays on the
        # driving thread so the timing path is uncontended
        self._trigger_lock = threading.Lock()

    # ---- hooks (called by EpochStepProgram.step / the runtime) -------------

    def record(self, signature: Tuple, fallback: bool,
               wall_s: float) -> None:
        """One dispatch completed: ``signature`` is the static shape key,
        ``wall_s`` the host seconds spent in the dispatch call."""
        self.dispatches += 1
        if fallback:
            self.fallback_dispatches += 1
        if signature in self._seen:
            self.dispatch_s += wall_s
        else:
            self._seen.add(signature)
            self.cold_dispatches += 1
            self.compile_s += wall_s

    def trigger(self) -> None:
        """One aggregation trigger committed (runtime hook)."""
        with self._trigger_lock:
            self.triggers += 1

    # ---- reading -----------------------------------------------------------

    def timer(self) -> float:
        return time.perf_counter()

    def summary(self) -> Dict:
        """JSON-serializable wall-clock attribution for bench rows."""
        warm = self.dispatches - self.cold_dispatches
        return {
            "dispatches": self.dispatches,
            "cold_dispatches": self.cold_dispatches,
            "fallback_dispatches": self.fallback_dispatches,
            "compile_s": self.compile_s,
            "dispatch_s": self.dispatch_s,
            "dispatch_mean_s": (self.dispatch_s / warm) if warm else None,
            "triggers": self.triggers,
            "dispatches_per_trigger": ((self.dispatches / self.triggers)
                                       if self.triggers else None),
            "blocking": self.block,
        }

    def reset(self) -> None:
        self.__init__(block=self.block)
