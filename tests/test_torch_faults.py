"""The port's fault layer (``repro_torch.sched.faults`` and the runtime's
§10/§11 branches) against the JAX package's (``repro.sched``).

* ``FaultModel``: the same construction errors; every seeded draw
  (``train_time_scale``, ``availability_mask``, ``sat_available_at``,
  ``outage_mask``, ``outage_intervals``, ``in_bad_window`` and
  ``transfer_fails``, i.i.d. and burst) exactly equal over seeds and
  keys: the draws are host numpy keyed on (seed, tag, ids), so nothing
  but equality is acceptable.
* ``OutageSchedule`` queries and ``EnergyState`` (drain, recharge,
  ``time_to_afford``, snapshot and restore) equal the reference's
  exactly.
* History parity with the JAX runtime under each fault axis, on the TINY
  CNN pools of ``tests/test_torch_sched.py`` with the JAX minibatch
  indices fed to the port (``run_pair`` / ``assert_same_run``): host
  fields (event order, trigger times, model counts, eq. 13 gamma, stale
  groups) exactly equal, ``dict(rt.stats)`` equal (every fault counter
  and the AIMD delay histogram), accuracy within one test sample, the
  final global model within atol 1e-4 (f32 reduction order over J SGD
  steps).  Each case also asserts that its recovery path ran.
* A traced lossy run's spans and instants equal the reference's.
* The off-switches: ``fault_model=None`` and an all-default
  ``FaultModel`` are bit-identical to the fault-free run, in the epoch
  loop and the event runtime.
* The epoch loop refuses loss, outages and energy with the reference's
  ``ValueError``.
* Properties (hypothesis, few examples): the conservation ledger of the
  port's runtime across every recovery path at once, and channel pools
  that never double-reserve an interval through snapshot and restore.
"""
import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import FLSimulation as JSim, SimConfig as JSimConfig
from repro.fl import get_strategy as jget
from repro.sched import EnergyState as JEnergy, FaultModel as JFault
from repro.sched import OutageSchedule as JOutage
from repro_torch.core.simulator import FLSimulation, SimConfig
from repro_torch.fl.strategies import get_strategy
from repro_torch.sched import (ContentionModel, EnergyState,
                               EventDrivenRuntime, FaultModel,
                               OutageSchedule)
from test_torch_sched import (DAYS, NUM_TEST, PIPE2, _host, _step_counts,
                              assert_same_run, one_torch_thread,
                              run_pair, setup)  # noqa: F401  (fixtures)


def _faults(**kw):
    """The same fault configuration in each package."""
    return dict(sim_kw=dict(fault_model=FaultModel(**kw)),
                jsim_kw=dict(fault_model=JFault(**kw)))


# ---- FaultModel: validation and draws ---------------------------------------

BAD_FAULTS = [
    dict(seed=-1), dict(loss_prob=1.5), dict(loss_prob=-0.1),
    dict(max_retries=-1), dict(retry_backoff_s=0.0),
    dict(eclipse_fraction=1.0), dict(eclipse_fraction=-0.2),
    dict(eclipse_period_s=0.0), dict(compute_rate_spread=-1.0),
    dict(compute_rates=()), dict(compute_rates=(1.0, 0.0)),
    dict(burst_len_s=-1.0), dict(loss_prob_bad=1.5),
    dict(loss_prob_good=-0.1),
    dict(ps_outages=((0, 10.0, 5.0),)), dict(ps_outages=((0, -1.0, 5.0),)),
    dict(ps_outages=((-1, 0.0, 5.0),)), dict(ps_outages=("bad",)),
    dict(ps_outage_fraction=1.0), dict(ps_outage_period_s=0.0),
    dict(battery_j=0.0), dict(train_energy_j=-1.0), dict(tx_energy_j=-1.0),
    dict(recharge_w=-0.5), dict(initial_charge=1.5),
    dict(retry_backoff_cap_s=10.0)]


@pytest.mark.parametrize("kw", BAD_FAULTS)
def test_fault_model_validation_matches_reference(kw):
    msgs = []
    for cls in (FaultModel, JFault):
        with pytest.raises(ValueError) as err:
            cls(**kw)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_fault_model_fields_and_flags_match_reference():
    assert ([f.name for f in dataclasses.fields(FaultModel)]
            == [f.name for f in dataclasses.fields(JFault)])
    for kw in ({}, dict(loss_prob=0.2), dict(burst_len_s=60.0),
               dict(ps_outage_fraction=0.1), dict(battery_j=5.0),
               dict(compute_rates=(1, 2)), dict(eclipse_fraction=0.3)):
        t, j = FaultModel(**kw), JFault(**kw)
        assert (t.is_null, t.has_burst, t.has_loss, t.has_outages,
                t.has_energy) == (j.is_null, j.has_burst, j.has_loss,
                                  j.has_outages, j.has_energy)
        assert dataclasses.astuple(t) == dataclasses.astuple(j)


@pytest.mark.parametrize("seed", [0, 3, 17])
def test_compute_and_eclipse_draws_equal_reference(seed):
    kw = dict(seed=seed, compute_rate_spread=1.5, eclipse_fraction=0.3,
              eclipse_period_s=4000.0)
    t, j = FaultModel(**kw), JFault(**kw)
    for S in (1, 40, 200):
        np.testing.assert_array_equal(t.train_time_scale(S),
                                      j.train_time_scale(S))
    times = np.arange(0.0, 20000.0, 10.0)
    np.testing.assert_array_equal(t.availability_mask(times, 40),
                                  j.availability_mask(times, 40))
    rng = np.random.default_rng(seed)
    for sat, tq in zip(rng.integers(0, 40, 60), rng.uniform(0, 9e4, 60)):
        assert (t.sat_available_at(int(sat), float(tq), 40)
                == j.sat_available_at(int(sat), float(tq), 40))
    ex = dict(compute_rates=(1.0, 2.5, 3.0))
    np.testing.assert_array_equal(FaultModel(**ex).train_time_scale(3),
                                  JFault(**ex).train_time_scale(3))
    for S in (2, 5):
        with pytest.raises(ValueError):
            FaultModel(**ex).train_time_scale(S)
    assert FaultModel().train_time_scale(40) is None
    assert FaultModel().availability_mask(times, 40) is None


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("burst", [0.0, 600.0, 1800.0])
@pytest.mark.parametrize("bad,good", [(1.0, 0.0), (0.7, 0.1)])
def test_transfer_fails_equals_reference(seed, burst, bad, good):
    kw = dict(seed=seed, loss_prob=0.35, burst_len_s=burst,
              loss_prob_bad=bad, loss_prob_good=good)
    t, j = FaultModel(**kw), JFault(**kw)
    rng = np.random.default_rng(100 + seed)
    keys = [(int(s), int(r), int(a), int(p), float(tq))
            for s, r, a, p, tq in zip(
                rng.integers(0, 40, 300), rng.integers(0, 6, 300),
                rng.integers(0, 4, 300), rng.integers(0, 3, 300),
                rng.uniform(0.0, 86400.0, 300))]
    got = [(t.transfer_fails(s, r, a, ps=p, t=tq), t.in_bad_window(s, p, tq))
           for s, r, a, p, tq in keys]
    want = [(j.transfer_fails(s, r, a, ps=p, t=tq),
             j.in_bad_window(s, p, tq)) for s, r, a, p, tq in keys]
    assert got == want
    assert any(g[0] for g in got) and not all(g[0] for g in got)
    assert [t.retry_delay_s(a) for a in range(6)] == \
        [j.retry_delay_s(a) for a in range(6)]
    for p in (0.0, 1.0):
        assert FaultModel(loss_prob=p).transfer_fails(3, 1, 0) is bool(p)


@pytest.mark.parametrize("kw", [
    dict(ps_outage_fraction=0.3),
    dict(seed=4, ps_outage_fraction=0.25, ps_outage_period_s=7200.0),
    dict(ps_outages=((0, 100.0, 200.0), (0, 150.0, 300.0),
                     (1, 120.0, 140.0), (2, 50000.0, 99999.0))),
    dict(ps_outages=((1, 0.0, 30000.0),), ps_outage_fraction=0.1)])
def test_outage_intervals_and_mask_equal_reference(kw):
    t, j = FaultModel(**kw), JFault(**kw)
    times = np.arange(0.0, 86400.0 + 10.0, 10.0)
    for dur in (86400.0, 110.0, 60000.0):
        assert t.outage_intervals(3, dur) == j.outage_intervals(3, dur)
        np.testing.assert_array_equal(t.outage_mask(times, 3, dur),
                                      j.outage_mask(times, 3, dur))
    if t.ps_outages:
        with pytest.raises(ValueError):
            t.outage_intervals(1, 1000.0)
    assert FaultModel().outage_mask(times, 3, 100.0) is None


def test_outage_schedule_queries_equal_reference():
    kw = dict(ps_outages=((0, 100.0, 200.0), (0, 150.0, 300.0),
                          (1, 120.0, 140.0)), ps_outage_fraction=0.05,
              ps_outage_period_s=5000.0)
    t_ivs = FaultModel(**kw).outage_intervals(3, 20000.0)
    j_ivs = JFault(**kw).outage_intervals(3, 20000.0)
    ts, js = OutageSchedule(t_ivs, 3), JOutage(j_ivs, 3)
    assert ts.events() == js.events()
    probe = sorted({x for _, s, e in ts.events() for x in (s, e)}
                   | set(np.linspace(0.0, 20000.0, 97).tolist())
                   | {99.9, 130.0, 299.9})
    for tq in probe:
        for ps in range(3):
            assert ts.down_at(ps, tq) == js.down_at(ps, tq)
            assert ts.next_up(ps, tq) == js.next_up(ps, tq)
        assert ts.all_down_at(tq) == js.all_down_at(tq)
        assert ts.next_any_up(tq) == js.next_any_up(tq)
        assert ts.down_set(tq) == js.down_set(tq)
    # the reference's worked example: merged, half-open, first recovery
    two = OutageSchedule(FaultModel(ps_outages=kw["ps_outages"])
                         .outage_intervals(2, 1000.0), 2)
    assert two.events() == [(0, 100.0, 300.0), (1, 120.0, 140.0)]
    assert two.down_at(0, 100.0) and not two.down_at(0, 300.0)
    assert two.all_down_at(130.0) and two.next_any_up(130.0) == 140.0


def test_energy_state_equals_reference():
    kw = dict(battery_j=100.0, train_energy_j=60.0, tx_energy_j=10.0,
              recharge_w=0.5, initial_charge=0.5, eclipse_fraction=0.2)
    t, j = EnergyState(FaultModel(**kw), 3), JEnergy(JFault(**kw), 3)
    ops = [("level", 0, 0.0, 0.0), ("drain", 0, 0.0, 60.0),
           ("afford", 0, 0.0, 60.0), ("drain", 0, 25.0, 60.0),
           ("level", 0, 25.0, 0.0), ("afford", 0, 25.0, 200.0),
           ("snap", 0, 0, 0), ("drain", 1, 500.0, 10.0),
           ("drain", 1, 500.0, 95.0), ("restore", 0, 0, 0),
           ("level", 1, 500.0, 0.0), ("drain", 2, 10.0, 45.0),
           ("afford", 2, 10.0, 40.0), ("level", 2, 1e6, 0.0)]
    seen = []
    for e in (t, j):
        out, snap = [], None
        for op, sat, tq, jl in ops:
            if op == "level":
                out.append(e.level(sat, tq))
            elif op == "drain":
                out.append(e.try_drain(sat, tq, jl))
            elif op == "afford":
                out.append(e.time_to_afford(sat, tq, jl))
            elif op == "snap":
                snap = e.snapshot()
            else:
                e.restore(snap)
        out.append((e.charge.tolist(), e.t_last.tolist(), e.drained_j,
                    e.drains, e.rate_w))
        seen.append(out)
    assert seen[0] == seen[1]
    assert seen[0][1] is False and seen[0][3] is True
    never = EnergyState(FaultModel(battery_j=100.0, recharge_w=0.0,
                                   initial_charge=0.0), 1)
    assert never.time_to_afford(0, 0.0, 5.0) is None


# ---- history parity with the JAX runtime under faults -----------------------

LOSS = dict(loss_prob=0.3, max_retries=5, retry_backoff_s=60.0)
# a round's training leaves 10 J, 600 s of recharge brings 6 J more: every
# uplink waits for its 20 J of transmit energy
TIGHT_ENERGY = dict(battery_j=60.0, train_energy_j=50.0, tx_energy_j=20.0,
                    recharge_w=0.01, initial_charge=1.0)


def _failed_total(st):
    return (st["transfer_retries"] + st["dropped_after_max_retries"]
            + st["dropped_unreachable"])


# (case, scheme, epochs, fault kwargs, spec fields, what must have run)
HISTORY_CASES = [
    ("iid_loss_retries", "asyncfleo-twohap", 5, LOSS, None,
     lambda st, h: st["transfers_failed"] and st["transfer_retries"]),
    ("total_loss_drops", "asyncfleo-twohap", 4,
     dict(loss_prob=1.0, max_retries=1, retry_backoff_s=60.0), None,
     lambda st, h: (st["dropped_after_max_retries"] and len(h) == 4
                    and all(r.num_models == 0 for r in h)
                    and st["transfers_failed"] == _failed_total(st))),
    ("sync_barrier_rescued", "fedisl", 3,
     dict(loss_prob=1.0, max_retries=0), None,
     lambda st, h: (st["dropped_after_max_retries"] and len(h) == 3
                    and all(r.num_models == 0 for r in h))),
    ("burst_loss", "asyncfleo-twohap", 4,
     dict(loss_prob=0.3, burst_len_s=1800.0, max_retries=4,
          retry_backoff_s=60.0), None,
     lambda st, h: st["transfers_failed"] and len(h) == 4),
    ("ps_outage_failover", "asyncfleo-twohap", 6,
     dict(ps_outages=((0, 2500.0, 27920.0),)), None,
     lambda st, h: st["sink_failovers"] and st["rerouted_arrivals"]),
    ("failover_next_contact", "asyncfleo-twohap", 6,
     dict(ps_outages=((1, 2500.0, 22500.0),)), PIPE2,
     lambda st, h: st["sink_failovers"] and st["rerouted_arrivals"]),
    ("outage_deferral_one_ps", "asyncfleo-pipelined", 6,
     dict(ps_outage_fraction=0.3, ps_outage_period_s=21600.0), None,
     lambda st, h: st["outage_deferrals"] and len(h) == 6),
    # every PS dark from 5000 s to the horizon: a trigger inside the
    # outage finds no recovery and commits anyway, and the run ends
    ("total_outage_clamp", "asyncfleo-twohap", 6,
     dict(ps_outages=((0, 5000.0, 86400.0), (1, 5000.0, 86400.0))), None,
     lambda st, h: (1 <= len(h) < 6 and h[-1].time_s > 5000.0
                    and all(np.isfinite(r.time_s) for r in h))),
    ("energy_deferral", "asyncfleo-twohap", 4, TIGHT_ENERGY, None,
     lambda st, h: st["energy_deferrals"] and st["energy_skipped_recruits"]),
    ("fault_aware_selection", "asyncfleo-twohap", 4,
     dict(eclipse_fraction=0.4), dict(fault_aware_selection=True),
     lambda st, h: st["fault_aware_skips"] and len(h) == 4),
    ("adaptive_backoff", "asyncfleo-twohap", 4,
     dict(loss_prob=0.6, max_retries=6, retry_backoff_s=60.0,
          adaptive_backoff=True, retry_backoff_cap_s=240.0), None,
     lambda st, h: (st["backoff_delays_s"]["count"]
                    and 60.0 <= st["backoff_delays_s"]["min"]
                    and st["backoff_delays_s"]["max"] <= 240.0)),
    ("compute_spread_eclipse", "asyncfleo-twohap", 4,
     dict(compute_rate_spread=1.5, eclipse_fraction=0.2), None,
     lambda st, h: len(h) == 4),
    ("all_axes_pipelined", "asyncfleo-pipelined", 4,
     dict(loss_prob=0.2, burst_len_s=900.0, max_retries=2,
          ps_outage_fraction=0.2, ps_outage_period_s=21600.0,
          battery_j=80.0, train_energy_j=30.0, tx_energy_j=10.0,
          recharge_w=0.05, adaptive_backoff=True,
          compute_rate_spread=0.5), dict(fault_aware_selection=True),
     lambda st, h: st["transfers_failed"] and len(h) == 4),
]


@pytest.mark.parametrize("case,scheme,epochs,fault,spec_kw,ran",
                         HISTORY_CASES, ids=[c[0] for c in HISTORY_CASES])
def test_fault_history_matches_jax_runtime(setup, case, scheme, epochs,
                                           fault, spec_kw, ran):
    jrun, trun = run_pair(setup, scheme, epochs, spec_kw=spec_kw,
                          **_faults(**fault))
    assert_same_run(jrun, trun)
    st, hist = trun[0].stats, trun[1]
    assert ran(st, hist), (case, dict(st))


def test_traced_lossy_run_matches_jax(setup):
    """A traced run with loss, outages and energy: the spans and the
    fault instants (TRANSFER_FAILED, TRANSFER_RETRY, FAILOVER, REROUTE,
    ENERGY_DEFERRAL, DROP, PS_DOWN, PS_UP) equal the reference's."""
    fault = dict(loss_prob=0.3, max_retries=1, retry_backoff_s=60.0,
                 ps_outages=((0, 2500.0, 27920.0),), battery_j=60.0,
                 train_energy_j=30.0, tx_energy_j=20.0, recharge_w=0.05)
    jrun, trun = run_pair(setup, "asyncfleo-twohap", 5, traced=True,
                          **_faults(**fault))
    assert_same_run(jrun, trun)
    jtr, ttr = jrun[0].tracer, trun[0].tracer
    names = {i.name for i in ttr.instants}
    assert {"TRANSFER_FAILED", "PS_DOWN", "FAILOVER"} <= names
    assert [dataclasses.astuple(s) for s in ttr.spans] == \
        [dataclasses.astuple(s) for s in jtr.spans]
    assert [dataclasses.astuple(i) for i in ttr.instants] == \
        [dataclasses.astuple(i) for i in jtr.instants]


def _loop_pair(setup, scheme, epochs, fault):
    """The JAX epoch loop and the port's under one fault model."""
    jpool, jevl, w0, work = setup
    out = []
    for sim_cls, cfg_cls, get, fm, pool, ev, w in (
            (JSim, JSimConfig, jget, JFault(**fault), jpool, jevl, w0),
            (FLSimulation, SimConfig, get_strategy, FaultModel(**fault),
             work.pool, work.evaluator, work.w0)):
        fls = sim_cls(get(scheme), pool, ev,
                      cfg_cls(duration_s=DAYS * 86400.0, fault_model=fm))
        out.append((fls, fls.run(w, max_epochs=epochs)))
    return out


@pytest.mark.parametrize("fault", [
    dict(compute_rate_spread=1.5), dict(eclipse_fraction=0.3),
    dict(compute_rate_spread=1.0, eclipse_fraction=0.2, seed=3)])
def test_epoch_loop_under_faults_matches_jax(setup, fault):
    """Compute spread and eclipse on the epoch loop: the same masked grid,
    the same stretched TRAIN_DONE instants, the same history."""
    (jfls, jhist), (tfls, thist) = _loop_pair(setup, "asyncfleo-twohap", 4,
                                              fault)
    np.testing.assert_array_equal(tfls.timeline.grid, jfls.timeline.grid)
    assert _host(thist) == _host(jhist) and len(thist) == 4
    for a, b in zip(thist, jhist):
        assert abs(a.accuracy - b.accuracy) <= 1.0 / NUM_TEST + 1e-6
    np.testing.assert_allclose(tfls._w_flat.numpy(),
                               np.asarray(jfls._w_flat), atol=1e-4)


def test_compute_spread_keeps_loop_runtime_parity(setup):
    """The epoch loop and the event runtime go through the one
    ``_train_times``: under a spread the epoch loop and the single-round
    event runtime still agree bit for bit, and the faults move the
    history."""
    *_, work = setup
    spec = dataclasses.replace(get_strategy("asyncfleo-pipelined"),
                               max_in_flight=1, handoff_policy="")
    fm = FaultModel(compute_rate_spread=1.5, eclipse_fraction=0.2)
    runs = []
    for event_driven, fault in ((False, fm), (True, fm), (True, None)):
        fls = FLSimulation(spec, work.pool, work.evaluator,
                           SimConfig(duration_s=DAYS * 86400.0,
                                     event_driven=event_driven,
                                     fault_model=fault))
        runs.append(([vars(r) for r in fls.run(work.w0, max_epochs=4)],
                     fls._w_flat))
    assert runs[0][0] == runs[1][0] and torch.equal(runs[0][1], runs[1][1])
    assert _host_rows(runs[1][0]) != _host_rows(runs[2][0])


def _host_rows(rows):
    return [(r["epoch"], r["time_s"], r["num_models"]) for r in rows]


# ---- off-switches -----------------------------------------------------------

@pytest.mark.parametrize("event_driven", [False, True])
def test_null_fault_models_are_bit_identical(setup, event_driven):
    *_, work = setup
    runs = []
    for fault in (None, FaultModel(), FaultModel(seed=9)):
        fls = FLSimulation(get_strategy("asyncfleo-twohap"), work.pool,
                           work.evaluator,
                           SimConfig(duration_s=DAYS * 86400.0,
                                     event_driven=event_driven,
                                     fault_model=fault))
        if fault is None:
            assert fls.fault is None and fls._train_scale is None
        assert fls._outages is None
        before = _step_counts(work.pool)
        hist = fls.run(work.w0, max_epochs=4)
        after = _step_counts(work.pool)
        stats = dict(fls.runtime.stats) if event_driven else None
        runs.append(([vars(r) for r in hist], fls._w_flat, stats,
                     (after[0] - before[0], after[1] - before[1])))
    assert FaultModel().is_null and len(runs[0][0]) == 4
    for other in runs[1:]:
        assert other[0] == runs[0][0] and torch.equal(other[1], runs[0][1])
        assert other[2:] == runs[0][2:]
    if event_driven:
        assert fls.runtime.energy is None


def test_ample_battery_changes_nothing(setup):
    """A never-binding budget drains and recharges but defers nothing:
    the history equals the fault-free run's."""
    *_, work = setup
    hists = []
    for fault in (None, FaultModel(battery_j=1e9)):
        fls = FLSimulation(get_strategy("asyncfleo-twohap"), work.pool,
                           work.evaluator,
                           SimConfig(duration_s=DAYS * 86400.0,
                                     event_driven=True, fault_model=fault))
        hists.append([vars(r) for r in fls.run(work.w0, max_epochs=3)])
    st = fls.runtime.stats
    assert hists[0] == hists[1]
    assert fls.runtime.energy.drains > 0
    assert (st["energy_deferrals"] + st["dropped_energy"]
            + st["energy_skipped_recruits"]) == 0


# ---- refusals ---------------------------------------------------------------

@pytest.mark.parametrize("kw,match", [
    (dict(loss_prob=0.2), "TRANSFER_FAILED retry chains"),
    (dict(burst_len_s=600.0), "TRANSFER_FAILED retry chains"),
    (dict(ps_outage_fraction=0.2), "ring failover"),
    (dict(battery_j=100.0), "ring failover")])
def test_epoch_loop_refuses_runtime_only_faults(setup, kw, match):
    jpool, jevl, w0, work = setup
    msgs = []
    for sim_cls, cfg_cls, get, fm, pool, ev, w in (
            (FLSimulation, SimConfig, get_strategy, FaultModel(**kw),
             work.pool, work.evaluator, work.w0),
            (JSim, JSimConfig, jget, JFault(**kw), jpool, jevl, w0)):
        fls = sim_cls(get("asyncfleo-twohap"), pool, ev,
                      cfg_cls(duration_s=3600.0, fault_model=fm))
        with pytest.raises(ValueError, match=match) as err:
            fls.run(w, max_epochs=2)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1] and "event-driven" in msgs[0]


# ---- properties -------------------------------------------------------------

@settings(max_examples=25, deadline=None)
@given(ops=st.lists(st.tuples(st.integers(0, 2), st.floats(0.0, 1000.0),
                              st.floats(0.1, 60.0)),
                    min_size=1, max_size=30),
       snap_at=st.integers(0, 29), restore_at=st.integers(0, 29),
       channels=st.integers(1, 3))
def test_retries_never_double_reserve(ops, snap_at, restore_at, channels):
    """However grants, snapshots and restores interleave (a lossy retry
    rolls back its grant and re-books after the backoff), every channel's
    busy intervals stay sorted and pairwise disjoint, and every grant
    honors its request time."""
    c = ContentionModel(3, channels)
    snap = None
    for i, (ps, t, d) in enumerate(ops):
        if i == snap_at:
            snap = c.snapshot()
        assert c.grant_rx(ps, t, d) >= t
        if i == restore_at and snap is not None:
            c.restore(snap)
            assert c.grant_rx(ps, t + d, d) >= t + d
    for ps in range(3):
        for ivs in c.rx.res[ps]:
            assert ivs == sorted(ivs)
            assert all(s < e for s, e in ivs)
            assert all(e0 <= s1 for (_, e0), (s1, _) in zip(ivs, ivs[1:]))


@settings(max_examples=4, deadline=None)
@given(seed=st.integers(0, 4), loss=st.sampled_from([0.0, 0.35]),
       burst=st.sampled_from([0.0, 1800.0]), outage=st.booleans(),
       energy=st.booleans(),
       strategy=st.sampled_from(["asyncfleo-twohap", "asyncfleo-pipelined"]))
def test_arrival_conservation_ledger(setup, seed, loss, burst, outage,
                                     energy, strategy):
    """Every arrival a round ever expected is committed (used or adopted
    from the carry), dropped into exactly one ``dropped_*`` bucket, or
    still pending when the run ends — across loss retries, burst fading,
    outage reroutes and failover, and energy deferrals at once."""
    *_, work = setup
    kw = dict(seed=seed, loss_prob=loss, burst_len_s=burst, max_retries=2,
              retry_backoff_s=120.0)
    if outage:
        kw["ps_outages"] = ((0, 2000.0, 20000.0),)
    if energy:
        kw.update(battery_j=80.0, train_energy_j=50.0, tx_energy_j=10.0,
                  recharge_w=0.1)
    fls = FLSimulation(get_strategy(strategy), work.pool, work.evaluator,
                       SimConfig(duration_s=DAYS * 86400.0,
                                 event_driven=True, train_time_s=300.0,
                                 fault_model=FaultModel(**kw)))
    rt = EventDrivenRuntime(fls)
    rt.run(work.w0, max_epochs=3)
    s = rt.stats
    dropped = (s["dropped_after_max_retries"] + s["dropped_unreachable"]
               + s["dropped_outage"] + s["dropped_energy"])
    leftover = len(fls._pend_meta) + sum(
        len(r.expected) for r in rt.rounds.values() if not r.committed)
    assert s["arrivals_expected"] == (s["arrivals_committed"] + dropped
                                      + leftover)


# ---- the entry point ------------------------------------------------------

def test_robustness_smoke_flags(setup, monkeypatch, capsys):
    """The README's robustness smoke: ``--dropout`` implies the event
    runtime, and the one FaultModel of the three fault flags reaches every
    scheme; the fault telemetry line is printed."""
    from repro_torch import fl_constellation_sim
    *_, work = setup
    monkeypatch.setattr(fl_constellation_sim, "build_workload",
                        lambda **kw: work)
    res = fl_constellation_sim.main(
        ["--schemes", "asyncfleo-gs", "fedasync", "--epochs", "2", "--iid",
         "--dropout", "0.2", "--compute-spread", "1.0", "--eclipse-fraction",
         "0.1", "--staleness-fn", "poly", "--days", "1", "--device", "cpu"])
    want = FaultModel(loss_prob=0.2, compute_rate_spread=1.0,
                      eclipse_fraction=0.1)
    fms = []
    for name, (fls, hist) in res.items():
        assert fls.sim.event_driven and len(hist) == 2
        assert fls.fault == want and fls.spec.staleness_fn == "poly"
        assert fls.runtime.fault is fls.fault
        fms.append(fls.fault)
    assert fms[0] is fms[1]
    out = capsys.readouterr().out
    assert "# asyncfleo-gs: faults — transfers failed " in out


def test_robustness_smoke_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: nothing to refuse")
    from repro_torch.fl_constellation_sim import main
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        main(["--schemes", "asyncfleo-gs", "--epochs", "2", "--iid",
              "--event-driven", "--dropout", "0.2", "--compute-spread",
              "1.0", "--staleness-fn", "poly", "--device", "cuda"])
