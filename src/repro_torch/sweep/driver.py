"""The batched sweep driver: N scenarios, a handful of physical steps, as
the JAX package's ``repro.sweep.driver``.

``run_scenarios(specs)`` builds one full simulation per
:class:`~repro_torch.sweep.scenario.ScenarioSpec` (strategy table lookup
+ overrides, WalkerDelta geometry or the paper constellation, LinkModel
at the swept rate, seeded SimConfig), then runs them either

* **sequentially** (``batched=False``) — the event-driven runtime, one
  scenario after another; or
* **batched** (the default) — every scenario's runtime on its own worker
  thread, all fused epoch steps multiplexed through one shared
  :class:`~repro_torch.sweep.batch.DispatchBatcher` on the calling
  thread.

The two are bit-identical per scenario (histories, weights, logical step
counts, runtime stats) under ``mode="exact"``.  Results come back in
spec order.  The run's device is ``w0``'s (``device``, default
``"cuda"``, when ``w0`` is None).
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.constellation import WalkerDelta
from repro_torch.core.epoch_step import make_epoch_program
from repro_torch.core.links import LinkModel
from repro_torch.core.simulator import (FLSimulation, SimConfig,
                                        convergence_time)
from repro_torch.fl.strategies import get_strategy
from repro_torch.sched.runtime import EventDrivenRuntime
from repro_torch.sweep.batch import DispatchBatcher
from repro_torch.sweep.scenario import ScenarioSpec
from repro_torch.sweep.testbed import (ConvergingTrainer,
                                       MeanDistanceEvaluator, make_model)


@dataclasses.dataclass
class ScenarioResult:
    spec: ScenarioSpec
    history: list                       # EpochRecord rows
    final_weights: np.ndarray           # the flat global model, on the host
    dispatches: int                     # logical fused steps
    fallback_dispatches: int
    convergence_delay_s: Optional[float]
    final_accuracy: Optional[float]
    epochs: int
    stats: Dict


def _build(spec: ScenarioSpec, trainer, evaluator, dispatcher,
           const_cache: Dict):
    strat = get_strategy(spec.strategy)
    kw = {}
    if spec.staleness_fn is not None:
        kw["staleness_fn"] = spec.staleness_fn
    if spec.ps_channels is not None:
        kw["ps_channels"] = spec.ps_channels
    if spec.max_in_flight is not None:
        kw["max_in_flight"] = spec.max_in_flight
    if kw:
        strat = dataclasses.replace(strat, **kw)
    const = None
    if spec.num_orbits is not None:
        gkey = spec.geometry_key()
        const = const_cache.get(gkey)
        if const is None:
            const = const_cache[gkey] = WalkerDelta(
                num_orbits=spec.num_orbits,
                sats_per_orbit=spec.sats_per_orbit or 8,
                altitude_m=spec.altitude_m,
                inclination_deg=spec.inclination_deg)
    sim = SimConfig(duration_s=spec.duration_s, dt_s=spec.dt_s,
                    train_time_s=spec.train_time_s,
                    agg_timeout_s=spec.agg_timeout_s, seed=spec.seed,
                    link=LinkModel(rate_bps=spec.rate_bps),
                    event_driven=True, dispatcher=dispatcher)
    fls = FLSimulation(strat, trainer, evaluator, sim, constellation=const)
    return fls, EventDrivenRuntime(fls)


def run_scenarios(specs: Sequence[ScenarioSpec], w0=None, *,
                  batched: bool = True, mode: str = "exact",
                  max_epochs: int = 30,
                  target_accuracy: Optional[float] = None,
                  trainer_factory: Optional[Callable] = None,
                  evaluator_factory: Optional[Callable] = None,
                  profiler=None,
                  batcher: Optional[DispatchBatcher] = None,
                  device="cuda") -> List[ScenarioResult]:
    """Run every scenario; return :class:`ScenarioResult` in spec order.

    ``w0`` defaults to the testbed's ``make_model()`` on ``device``.
    ``trainer_factory(w0)`` / ``evaluator_factory()`` default to ONE
    shared ``ConvergingTrainer`` / ``MeanDistanceEvaluator`` — sharing
    the (stateless) trainer shares its program cache across scenarios,
    and its ``scenario_batch_key`` is what lets the batcher group them.
    Pass ``batcher`` to inspect physical-step telemetry after the run
    (``batcher.summary()``); ``profiler`` (an ``obs.DispatchProfiler``)
    records each physical step's timing.
    """
    w0 = w0 if w0 is not None else make_model(device=device)
    if trainer_factory is None:
        shared = ConvergingTrainer(w0)
        trainer_factory = lambda _w0: shared        # noqa: E731
    if evaluator_factory is None:
        evaluator_factory = MeanDistanceEvaluator
    if batcher is None and batched:
        batcher = DispatchBatcher(mode=mode, profiler=profiler)
    const_cache: Dict = {}
    builds = [_build(s, trainer_factory(w0), evaluator_factory(),
                     batcher if batched else None, const_cache)
              for s in specs]
    # on this thread, before any worker starts: fill the trainers' program
    # caches and load the kernel library (neither table has a lock)
    for fls, _rt in builds:
        make_epoch_program(fls.trainer, w0, mesh=fls.sim.mesh)
    if next(iter(w0.values())).device.type == "cuda":
        from repro_torch.kernels.fed_agg import ops as fed_agg_ops
        fed_agg_ops.load()

    histories: List = [None] * len(specs)
    errors: List = [None] * len(specs)
    counts: List = [None] * len(specs)  # sequential per-scenario deltas

    def _finish(i: int) -> ScenarioResult:
        fls, rt = builds[i]
        hist = histories[i] or []
        conv = (convergence_time(hist, target_accuracy)
                if target_accuracy is not None else None)
        if counts[i] is not None:
            disp, fb = counts[i]
        else:                           # batched: the proxy counts
            prog = fls._fused_prog      # per-scenario logical steps
            disp = int(getattr(prog, "dispatches", 0))
            fb = int(getattr(prog, "fallback_dispatches", 0))
        return ScenarioResult(
            spec=specs[i], history=hist,
            final_weights=fls._w_flat.detach().cpu().numpy(),
            dispatches=disp, fallback_dispatches=fb,
            convergence_delay_s=conv,
            final_accuracy=(float(hist[-1].accuracy) if hist else None),
            epochs=len(hist), stats=dict(rt.stats))

    if not batched:
        # a shared trainer shares one program (and its counters) across
        # scenarios, so per-scenario step counts are deltas
        for i, (fls, rt) in enumerate(builds):
            prog = make_epoch_program(fls.trainer, w0, mesh=fls.sim.mesh)
            d0 = ((prog.dispatches, prog.fallback_dispatches)
                  if prog is not None else (0, 0))
            histories[i] = rt.run(w0, max_epochs=max_epochs,
                                  target_accuracy=target_accuracy)
            counts[i] = ((prog.dispatches - d0[0],
                          prog.fallback_dispatches - d0[1])
                         if prog is not None else (0, 0))
        return [_finish(i) for i in range(len(specs))]

    def _worker(i: int) -> None:
        try:
            histories[i] = builds[i][1].run(
                w0, max_epochs=max_epochs,
                target_accuracy=target_accuracy)
        except BaseException as e:      # surfaced after drain
            errors[i] = e
        finally:
            batcher.finish()

    threads = []
    for i in range(len(specs)):
        batcher.register()
        threads.append(threading.Thread(target=_worker, args=(i,),
                                        name=f"scenario-{i}", daemon=True))
    for t in threads:
        t.start()
    batcher.drain()
    for t in threads:
        t.join()
    for i, err in enumerate(errors):
        if err is not None:
            raise RuntimeError(
                f"scenario {i} ({specs[i]!r}) failed") from err
    return [_finish(i) for i in range(len(specs))]
