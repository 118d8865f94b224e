"""The port's dispatch profiler (``repro_torch.obs.profile``) against the JAX
package's (``repro.obs.profile``).

* The reference's cold-versus-steady unit case on the port's class, and
  the same summary keys.
* On one event-driven run per side (asyncfleo-twohap pipelined, as
  ``tests/test_obs.py`` runs it, at the TINY width of
  ``tests/test_torch_sched.py``): dispatches, cold and fallback
  dispatches, triggers and dispatches per trigger equal the reference's.
  These are host counts.  On the epoch loop nothing triggers.
* Read-only: with a profiler attached, blocking or not, the history and
  the final model are bit-identical to a run without one, and a run
  without one detaches the previous run's from the cached epoch program.
"""
import dataclasses
import json

import pytest
import torch

from repro.obs import DispatchProfiler as JProfiler
from repro_torch.core.simulator import FLSimulation, SimConfig
from repro_torch.fl.strategies import get_strategy
from repro_torch.obs import DispatchProfiler
from test_torch_sched import (DAYS, assert_same_run,  # noqa: F401
                              one_torch_thread, run_pair, setup)

PIPE = dict(max_in_flight=3, handoff_policy="next_contact")
COUNTS = ("dispatches", "cold_dispatches", "fallback_dispatches",
          "triggers", "dispatches_per_trigger")


def test_cold_vs_steady_unit():
    p = DispatchProfiler()
    p.trigger()
    p.record((4, 2, 2, 0, False), False, 0.50)   # cold: new signature
    p.record((4, 2, 2, 0, False), False, 0.01)   # steady: seen before
    p.record((4, 3, 4, 0, True), True, 0.40)     # cold again + fallback
    s = p.summary()
    assert s["dispatches"] == 3 and s["cold_dispatches"] == 2
    assert s["fallback_dispatches"] == 1
    assert s["compile_s"] == pytest.approx(0.90)
    assert s["dispatch_s"] == pytest.approx(0.01)
    assert s["dispatch_mean_s"] == pytest.approx(0.01)
    assert s["dispatches_per_trigger"] == 3.0
    assert s["blocking"] is False
    assert set(s) == set(JProfiler().summary())
    json.dumps(s)
    p = DispatchProfiler(block=True)
    p.record((4, 2, 2, 0, False), False, 0.5)
    p.reset()
    assert p.block and p.summary() == DispatchProfiler(block=True).summary()
    assert p.summary()["dispatch_mean_s"] is None
    assert p.summary()["dispatches_per_trigger"] is None


@pytest.mark.parametrize("scheme,epochs,spec_kw", [
    ("asyncfleo-twohap", 6, PIPE), ("asyncfleo-pipelined", 8, None)])
def test_counts_equal_reference_on_the_runtime(setup, scheme, epochs,
                                               spec_kw):
    jprof, tprof = JProfiler(), DispatchProfiler()
    jrun, trun = run_pair(setup, scheme, epochs, spec_kw=spec_kw,
                          sim_kw=dict(profiler=tprof),
                          jsim_kw=dict(profiler=jprof))
    assert_same_run(jrun, trun)
    js, ts = jprof.summary(), tprof.summary()
    assert {k: ts[k] for k in COUNTS} == {k: js[k] for k in COUNTS}
    assert ts["triggers"] == len(trun[1])
    assert sum(trun[2]) == ts["dispatches"]
    assert 0 < ts["cold_dispatches"] <= ts["dispatches"]
    assert ts["compile_s"] + ts["dispatch_s"] > 0.0


def test_counts_equal_reference_on_the_epoch_loop(setup):
    from repro.core import FLSimulation as JSim, SimConfig as JSimConfig
    from repro.fl import get_strategy as jget
    jpool, jevl, w0, work = setup
    jprof, tprof = JProfiler(), DispatchProfiler()
    JSim(jget("asyncfleo-hap"), jpool, jevl,
         JSimConfig(duration_s=DAYS * 86400.0, profiler=jprof)).run(
             w0, max_epochs=3)
    FLSimulation(get_strategy("asyncfleo-hap"), work.pool, work.evaluator,
                 SimConfig(duration_s=DAYS * 86400.0, profiler=tprof)).run(
                     work.w0, max_epochs=3)
    js, ts = jprof.summary(), tprof.summary()
    assert {k: ts[k] for k in COUNTS} == {k: js[k] for k in COUNTS}
    assert ts["triggers"] == 0 and ts["dispatches_per_trigger"] is None
    assert ts["dispatches"] == 3


def _run(work, profiler, event_driven):
    spec = dataclasses.replace(get_strategy("asyncfleo-twohap"), **PIPE)
    sim = FLSimulation(spec, work.pool, work.evaluator,
                       SimConfig(duration_s=DAYS * 86400.0,
                                 event_driven=event_driven,
                                 profiler=profiler))
    return sim, sim.run(work.w0, max_epochs=4)


@pytest.mark.parametrize("event_driven", [True, False])
def test_profiler_is_read_only(setup, event_driven):
    *_, work = setup
    base, hist = _run(work, None, event_driven)
    prog = work.pool._epoch_programs[base._spec]
    assert prog.profiler is None
    for block in (False, True):
        prof = DispatchProfiler(block=block)
        sim, h = _run(work, prof, event_driven)
        assert prog.profiler is prof
        assert [vars(r) for r in h] == [vars(r) for r in hist]
        assert torch.equal(sim._w_flat, base._w_flat)
        assert prof.summary()["dispatches"] >= len(h)
    # a run without a profiler detaches the previous run's
    _run(work, None, event_driven)
    assert prog.profiler is None
