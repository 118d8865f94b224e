"""The port's scenario sweep engine against the JAX package's, and its own
differential contract.

Two contracts, as the reference's ``tests/test_sweep.py``:
- against the JAX package: the same scenario lists from ``grid`` and
  ``draw``, the same percentile bands, and per scenario of
  ``run_scenarios`` the same host history, logical step counts and
  runtime stats, accuracy within 1e-6 and the final weights within 1e-5;
- batched against sequential, in the port: histories, stats, logical
  step counts and weights (``torch.equal``) bit-identical per scenario in
  the exact mode; within 1e-4 in the vmap mode.
"""
import dataclasses
import os
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

import repro.sweep as J
import repro_torch.sweep as T
from repro_torch.core.modelbank import flatten_tree
from repro_torch.core.simulator import FLSimulation, SimConfig
from repro_torch.fl.strategies import get_strategy
from repro_torch.obs import DispatchProfiler
from repro_torch.sweep import (ConvergingTrainer, DispatchBatcher,
                               MeanDistanceEvaluator, ScenarioSpec, draw,
                               draw_spec, grid, make_model,
                               percentile_bands, reduce_results,
                               run_scenarios)

# small-but-real default: 8 sats over 2 orbits, a 4 h horizon
GEOM = dict(num_orbits=2, sats_per_orbit=4, duration_s=4 * 3600.0,
            dt_s=60.0, train_time_s=300.0)
BASE = ScenarioSpec(**GEOM)
JBASE = J.ScenarioSpec(**GEOM)
W0 = make_model(device="cpu")
HETERO = {
    "seed": [0, 3],
    "num_orbits": [2, 3],
    "rate_bps": [16e6, 1e5],
    "strategy": ["asyncfleo-gs", "fedisl", "asyncfleo-pipelined"],
    "staleness_fn": ["eq13", "poly"],
}
KNOBS = [dict(GEOM, seed=1, strategy="asyncfleo-pipelined", ps_channels=1,
              max_in_flight=2, staleness_fn="hinge", rate_bps=1e5),
         dict(GEOM, seed=2, strategy="asyncfleo-gs", ps_channels=2)]


def spec_sets(sw):
    """The named scenario batches, built by either package's sweep module
    ``sw``: {name: (specs, max_epochs)}."""
    base = sw.ScenarioSpec(**GEOM)
    return {
        "seeds": (sw.grid(base, seed=[0, 1, 2, 3]), 3),
        "heterogeneous": (sw.draw(6, HETERO, seed=11, base=base), 3),
        "fedasync": (sw.grid(base, seed=[0, 1], strategy=["fedasync"]), 6),
        "knobs": ([sw.ScenarioSpec(**k) for k in KNOBS], 3),
    }


SETS, JSETS = spec_sets(T), spec_sets(J)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for these small CPU runs (as
    ``tests/test_torch_sched.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _host(hist):
    return [(r.epoch, r.time_s, r.num_models, r.gamma, r.stale_groups)
            for r in hist]


def _hist_key(hist):
    return [(r.epoch, r.time_s, r.accuracy, r.num_models, r.gamma,
             r.stale_groups) for r in hist]


def assert_bit_identical(seq, bat):
    for s, b in zip(seq, bat):
        assert _hist_key(s.history) == _hist_key(b.history), s.spec
        assert torch.equal(torch.from_numpy(s.final_weights),
                           torch.from_numpy(b.final_weights)), s.spec
        assert (s.dispatches, s.fallback_dispatches) == \
            (b.dispatches, b.fallback_dispatches), s.spec
        assert s.convergence_delay_s == b.convergence_delay_s, s.spec
        assert s.stats == b.stats, s.spec


# ---- the scenario compiler and the bands, against the reference ----------

def test_grid_and_draw_equal_reference():
    for name in SETS:
        port, ref = SETS[name][0], JSETS[name][0]
        assert ([dataclasses.asdict(s) for s in port]
                == [dataclasses.asdict(s) for s in ref]), name
    axes = {"seed": [0, 1, 2, 3], "rate_bps": [16e6, 1e5],
            "strategy": ["asyncfleo-gs", "fedasync"]}
    for seed in (7, 8):
        assert ([dataclasses.asdict(s) for s in draw(6, axes, seed=seed)]
                == [dataclasses.asdict(s)
                    for s in J.draw(6, axes, seed=seed)])
    assert draw_spec(axes, 7, 6) == J.draw_spec(axes, 7, 6)
    assert [dataclasses.asdict(s) for s in grid(seed=[0, 1])] == \
        [dataclasses.asdict(s) for s in J.grid(seed=[0, 1])]


@pytest.mark.parametrize("bad", [dict(not_a_field=[1]), dict(seed=[])])
def test_grid_and_draw_reject_like_reference(bad):
    for port_fn, ref_fn in ((lambda: grid(BASE, **bad),
                             lambda: J.grid(JBASE, **bad)),
                            (lambda: draw(2, bad), lambda: J.draw(2, bad))):
        with pytest.raises(ValueError) as port:
            port_fn()
        with pytest.raises(ValueError) as ref:
            ref_fn()
        assert str(port.value) == str(ref.value)
    with pytest.raises(ValueError, match="n >= 1"):
        draw(0, {"seed": [1]})


@pytest.mark.parametrize("values", [
    [10.0, 20.0, 30.0, None], [None, None], [], [3.5], [1.0, 2.0, 4.0, 8.0]])
def test_percentile_bands_equal_reference(values):
    assert percentile_bands(values) == J.percentile_bands(values)


def test_reduce_results_equal_reference():
    rows = [types.SimpleNamespace(convergence_delay_s=c, epochs=e,
                                  final_accuracy=a)
            for c, e, a in [(3600.0, 3, 0.91), (None, 5, 0.7),
                            (7200.5, 4, 0.93), (1800.0, 2, None)]]
    assert reduce_results(rows) == J.reduce_results(rows)


# ---- run_scenarios against the reference ----------------------------------

@pytest.mark.parametrize("name", list(SETS))
def test_run_scenarios_matches_reference(name):
    """Width 8: equal host histories, logical step counts and stats;
    accuracy within 1e-6, final weights within 1e-5."""
    (specs, epochs), (jspecs, _) = SETS[name], JSETS[name]
    port = run_scenarios(specs, make_model(width=8, device="cpu"),
                         batched=False, max_epochs=epochs,
                         target_accuracy=0.9)
    ref = J.run_scenarios(jspecs, J.make_model(width=8), batched=False,
                          max_epochs=epochs, target_accuracy=0.9)
    assert len(port) == len(ref) == len(specs)
    for p, r in zip(port, ref):
        assert _host(p.history) == _host(r.history), p.spec
        for a, b in zip(p.history, r.history):
            assert a.accuracy == pytest.approx(b.accuracy, abs=1e-6)
        np.testing.assert_allclose(p.final_weights, r.final_weights,
                                   atol=1e-5)
        assert (p.dispatches, p.fallback_dispatches) == \
            (r.dispatches, r.fallback_dispatches), p.spec
        assert p.stats == r.stats, p.spec
        assert p.epochs == r.epochs and p.epochs > 0


# ---- the differential contract: batched == sequential ---------------------

@pytest.mark.parametrize("name", list(SETS))
def test_batched_equals_sequential(name):
    specs, epochs = SETS[name]
    seq = run_scenarios(specs, W0, batched=False, max_epochs=epochs,
                        target_accuracy=0.9)
    batcher = DispatchBatcher()
    bat = run_scenarios(specs, W0, batched=True, max_epochs=epochs,
                        target_accuracy=0.9, batcher=batcher)
    assert_bit_identical(seq, bat)
    logical = sum(r.dispatches + r.fallback_dispatches for r in bat)
    assert batcher.physical_dispatches < logical
    assert batcher.summary() == dict(
        flushes=batcher.flushes,
        physical_dispatches=batcher.physical_dispatches,
        batched_dispatches=batcher.batched_dispatches,
        solo_dispatches=batcher.solo_dispatches,
        max_group=batcher.max_group, mode="exact")
    if name == "seeds":
        # homogeneous scenarios share every step: one a flush
        assert batcher.max_group == 4 and batcher.solo_dispatches == 0


def test_vmap_mode_is_close_not_required_exact():
    specs = grid(BASE, seed=[0, 1, 2])
    seq = run_scenarios(specs, W0, batched=False, max_epochs=3,
                        target_accuracy=0.9)
    batcher = DispatchBatcher(mode="vmap")
    bat = run_scenarios(specs, W0, batched=True, max_epochs=3,
                        target_accuracy=0.9, batcher=batcher)
    assert batcher.batched_dispatches > 0
    for s, b in zip(seq, bat):
        assert _host(s.history) == _host(b.history)
        np.testing.assert_allclose(s.final_weights, b.final_weights,
                                   atol=1e-4)


def test_trainer_without_batch_key_runs_solo():
    class KeylessTrainer(ConvergingTrainer):
        def __init__(self, w0):
            super().__init__(w0)
            del self.scenario_batch_key

    specs = grid(BASE, seed=[0, 1])
    seq = run_scenarios(specs, W0, batched=False, max_epochs=3,
                        target_accuracy=0.9,
                        trainer_factory=lambda w0: KeylessTrainer(w0))
    batcher = DispatchBatcher()
    bat = run_scenarios(specs, W0, batched=True, max_epochs=3,
                        target_accuracy=0.9,
                        trainer_factory=lambda w0: KeylessTrainer(w0),
                        batcher=batcher)
    assert_bit_identical(seq, bat)
    assert batcher.batched_dispatches == 0
    assert batcher.solo_dispatches == batcher.physical_dispatches > 0


def test_worker_error_reaches_the_caller():
    class ExplodingEvaluator(MeanDistanceEvaluator):
        def __call__(self, params):
            raise RuntimeError("boom")

    with pytest.raises(RuntimeError, match="scenario") as err:
        run_scenarios(grid(BASE, seed=[0, 1]), W0, batched=True,
                      max_epochs=2, target_accuracy=0.9,
                      evaluator_factory=ExplodingEvaluator)
    assert "boom" in str(err.value.__cause__)


def _span(params):
    lo = min(v.data_ptr() for v in params.values())
    return lo, max(v.data_ptr() + v.numel() * v.element_size()
                   for v in params.values())


def test_no_two_scenarios_share_a_model_buffer():
    """Each scenario's global model is its own memory after every flush:
    the evaluator sees views into ``w_flat``; at each evaluation they must
    not overlap any other scenario's latest model (held alive here, so
    its memory cannot be reused), and no scenario's last model may be
    written after its own last evaluation."""
    latest, overlaps = {}, []

    class SpanEvaluator(MeanDistanceEvaluator):
        def __call__(self, params):
            lo, hi = _span(params)
            for other, (p, _snap) in list(latest.items()):
                o_lo, o_hi = _span(p)
                if other is not self and lo < o_hi and o_lo < hi:
                    overlaps.append((lo, hi, o_lo, o_hi))
            latest[self] = (params, flatten_tree(params).clone())
            return super().__call__(params)

    specs = grid(BASE, seed=[0, 1, 2, 3])
    batcher = DispatchBatcher()
    seq = run_scenarios(specs, W0, batched=False, max_epochs=3,
                        target_accuracy=0.9)
    bat = run_scenarios(specs, W0, batched=True, max_epochs=3,
                        target_accuracy=0.9, batcher=batcher,
                        evaluator_factory=SpanEvaluator)
    assert_bit_identical(seq, bat)
    assert batcher.max_group == 4 and len(latest) == 4
    assert not overlaps, "two scenarios share w_flat"
    for params, snap in latest.values():
        assert torch.equal(flatten_tree(params), snap)


def test_batcher_stress_short_switch_interval():
    """More scenario threads than cores, the interpreter switching threads
    every 10 us: the batched sweep ends, stays bit-identical to the
    sequential one, and every proxy's logical step count is exact."""
    specs = grid(BASE, seed=list(range(max(12, 2 * (os.cpu_count() or 1)))))
    seq = run_scenarios(specs, W0, batched=False, max_epochs=3,
                        target_accuracy=0.9)
    out = {}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        t = threading.Thread(target=lambda: out.update(bat=run_scenarios(
            specs, W0, batched=True, max_epochs=3, target_accuracy=0.9)))
        t.start()
        t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not t.is_alive(), "the batched sweep did not end"
    assert_bit_identical(seq, out["bat"])


def test_profiler_counts_physical_steps_and_every_trigger():
    prof = DispatchProfiler()
    batcher = DispatchBatcher(profiler=prof)
    specs = grid(BASE, seed=[0, 1, 2], strategy=["asyncfleo-gs", "fedisl"])
    bat = run_scenarios(specs, W0, batched=True, max_epochs=3,
                        target_accuracy=0.9, batcher=batcher)
    logical = sum(r.dispatches + r.fallback_dispatches for r in bat)
    assert prof.dispatches == batcher.physical_dispatches < logical
    assert prof.triggers == sum(r.epochs for r in bat)
    assert batcher.max_group >= 3


def test_simulation_accepts_a_dispatcher():
    """``SimConfig(dispatcher=...)`` wraps the fused program in the
    batcher's proxy; a stacked or legacy run has no program to wrap."""
    batcher = DispatchBatcher()
    trainer = ConvergingTrainer(W0)
    for kw, wrapped in ((dict(), True), (dict(use_fused_step=False), False),
                        (dict(use_model_bank=False), False)):
        fls = FLSimulation(get_strategy("asyncfleo-gs"), trainer, None,
                           SimConfig(duration_s=3600.0, dispatcher=batcher,
                                     **kw))
        _bits, fused, _stacked = fls._init_run(W0)
        assert (type(fused).__name__ == "BatchedProgram") is wrapped


def test_pool_sweep_runs_solo_bit_identical():
    """The CNN pool has no batch key: every step of a batched sweep runs
    solo on the driver thread, bit-identical to the sequential sweep; the
    evaluator runs on the worker threads."""
    from repro.data import class_conditional_images, iid_partition
    from repro_torch.core.modelbank import params_from_jax
    from repro_torch.fl.client import Evaluator, ImageClassifierPool
    from test_torch_cnn_client import TINY, _w0
    imgs, labs = class_conditional_images(0, 160, separation=0.8)
    ti, tl = class_conditional_images(99, 50, separation=0.8)
    pool = ImageClassifierPool(TINY, imgs, labs, iid_partition(labs, 8, 0),
                               local_iters=2, batch_size=8, device="cpu")
    ev = Evaluator(TINY, ti, tl, device="cpu")
    w0 = params_from_jax(_w0(TINY), device="cpu")
    specs = grid(BASE, seed=[0, 1, 2])
    kw = dict(max_epochs=2, trainer_factory=lambda _w0: pool,
              evaluator_factory=lambda: ev)
    seq = run_scenarios(specs, w0, batched=False, **kw)
    batcher = DispatchBatcher()
    bat = run_scenarios(specs, w0, batched=True, batcher=batcher, **kw)
    assert_bit_identical(seq, bat)
    assert batcher.batched_dispatches == 0
    assert batcher.solo_dispatches == sum(r.dispatches for r in bat) > 0


# ---- the barrier: released workers count as running before they wake ------

def _step_program():
    """A real ``EpochStepProgram`` over a 4-parameter model whose training
    leaves every participant at the global model."""
    from repro_torch.core.epoch_step import EpochStepProgram
    from repro_torch.core.modelbank import FlatSpec
    spec = FlatSpec.of({"w": torch.zeros(4)})

    def train(params, inputs, ids, seed):
        return (spec.flatten(params)[None, :].repeat(len(ids), 1),
                torch.zeros(len(ids)))
    return EpochStepProgram(spec, train)


STEP_ARGS = (None, np.arange(2, dtype=np.int32), 0,
             np.full(2, 0.5, np.float32), np.zeros(4, np.float32), 0.0,
             np.zeros(2, np.float32), np.zeros(2, np.int32), 0, 0,
             np.zeros((0, 4), np.float32))


def _run_workers(batcher, proxies, steps, **step_kw):
    """Each proxy stepped ``steps`` times on a worker thread of its own
    (named after its index) while this thread drains the batcher."""
    errors = []

    def work(proxy):
        try:
            for _ in range(steps):
                proxy.step(torch.zeros(4), torch.zeros(4, 4), *STEP_ARGS,
                           torch.zeros(4), **step_kw)
        except Exception as e:        # noqa: BLE001 — asserted below
            errors.append(e)
        finally:
            batcher.finish()

    threads = []
    for i, proxy in enumerate(proxies):
        batcher.register()
        threads.append(threading.Thread(target=work, args=(proxy,),
                                        name=str(i), daemon=True))
    for t in threads:
        t.start()
    drainer = threading.Thread(target=batcher.drain, daemon=True)
    drainer.start()
    for t in threads + [drainer]:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads + [drainer])
    assert not errors, errors


def test_barrier_counts_released_workers_before_waking_them():
    """The race that made ``[seeds]`` flaky, made certain.  Three scenarios
    step together; after the first flush worker 0 wakes and submits its
    second step at once, while workers 1 and 2 are held just after their
    wake-up, before a barrier that re-counted workers in ``submit`` would
    count them running again.  Such a barrier sees no runnable worker and
    one pending request and flushes it alone; the driver that counts the
    workers it releases before it wakes them waits for all three."""
    second = threading.Event()

    class HeldEvent(threading.Event):
        def wait(self, timeout=None):
            woke = super().wait(timeout)
            second.wait(10)          # worker 0 has submitted again
            deadline = time.monotonic() + 0.5
            while batcher.flushes < 2 and time.monotonic() < deadline:
                time.sleep(0.005)    # room for a barrier to flush it alone
            return woke

    class Batcher(DispatchBatcher):
        def submit(self, req):
            me = threading.current_thread().name
            calls[me] = calls.get(me, 0) + 1
            if me != "0" and calls[me] == 1:
                req.event = HeldEvent()
            if me == "0" and calls[me] == 2:
                second.set()
            return super().submit(req)

    calls = {}
    batcher = Batcher()
    prog = _step_program()
    _run_workers(batcher, [batcher.wrap(prog, key="k") for _ in range(3)],
                 steps=2)
    assert batcher.solo_dispatches == 0, batcher.summary()
    assert (batcher.flushes, batcher.batched_dispatches,
            batcher.max_group) == (2, 2, 3)


def test_mesh_program_runs_solo():
    """A program with a mesh never batches (the reference's ``_batchable``)
    and gets its ``late_rows`` through the proxy; without a mesh the same
    scenarios share one physical step a flush."""
    seen = []

    class Recorded:
        def __init__(self, inner, mesh):
            self.inner, self.mesh = inner, mesh
            self.spec, self.profiler = inner.spec, None

        def step(self, *args, late_rows=(), **kw):
            seen.append(late_rows)
            return self.inner.step(*args, **kw)

        def batched_step(self, *args, **kw):
            seen.append("batched")
            return self.inner.batched_step(*args, **kw)

    prog = _step_program()
    for mesh, solo in ((None, 0), (object(), 4)):
        batcher = DispatchBatcher()
        proxies = [batcher.wrap(Recorded(prog, mesh), key="k")
                   for _ in range(2)]
        assert [p._batchable() for p in proxies] == [mesh is None] * 2
        seen.clear()
        _run_workers(batcher, proxies, steps=2, late_rows=(1,))
        assert batcher.solo_dispatches == solo
        assert seen == ([(1,)] * 4 if mesh is not None else ["batched"] * 2)
