"""The port's event-driven scheduler (``repro_torch.sched``) against the JAX
package's (``repro.sched``).

* ``EventQueue``: randomised pushes with equal timestamps across all seven
  kinds pop in the same order, in the same ``pop_batch`` runs.
* The trigger policies: each ``on_arrival_batch`` equals its per-event
  loop (increment, ``on_arrival``, earliest trigger wins) and the
  reference's; ``on_expected_drop`` and policy selection equal the
  reference's.
* History parity with the JAX runtime on TINY CNN pools over the paper's
  40 satellites, from the same w0 and with the JAX minibatch indices fed
  to the port, as ``tests/test_torch_slice.py`` holds the epoch loop:
  host fields (event order, trigger times, model counts, eq. 13 gamma,
  stale groups) exactly equal, accuracy within one test sample, the final
  global model within atol 1e-4 (f32 reduction order over J SGD steps),
  ``dict(rt.stats)``, grouping, carried stragglers and step counts equal.
  A traced run's spans and instants equal the reference's.
* The off-switches, bit-identical: ``max_in_flight=1`` against the port's
  own epoch loop, ``tracer=None`` against a traced run, and the batched
  arrival path against the per-event one.
"""
import dataclasses
import random
import types

import numpy as np
import pytest
import torch

from repro.core import FLSimulation as JSim, SimConfig as JSimConfig
from repro.data import class_conditional_images, iid_partition
from repro.fl import Evaluator as JEvaluator, ImageClassifierPool as JPool
from repro.fl import STRATEGIES as JSTRATEGIES, get_strategy as jget
from repro.obs.trace import Tracer as JTracer
from repro.sched import EventDrivenRuntime as JRuntime
from repro.sched import events as jev
from repro.sched import policies as jpol
from repro.sched.runtime import RoundState as JRound
from repro_torch import fl_constellation_sim
from repro_torch.core.modelbank import params_from_jax
from repro_torch.core.simulator import FLSimulation, SimConfig
from repro_torch.fl.strategies import STRATEGIES, get_strategy
from repro_torch.fl_constellation_sim import build_workload, main
from repro_torch.obs.trace import Tracer
from repro_torch.sched import EventDrivenRuntime
from repro_torch.sched import events as tev
from repro_torch.sched import policies as tpol
from repro_torch.sched.runtime import RoundState
from test_torch_cnn_client import TINY, _w0, injected, jcfg

DAYS = 1.0
NUM_TEST = 100
KW = dict(local_iters=2, batch_size=8)
PIPE2 = dict(max_in_flight=2, handoff_policy="next_contact")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for these small CPU runs, restored after the
    module: under several pytest workers torch's spinning thread pools
    oversubscribe the cores and the runs take tens of times longer."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    imgs, labs = class_conditional_images(0, 400, separation=0.8)
    ti, tl = class_conditional_images(99, NUM_TEST, separation=0.8)
    shards = iid_partition(labs, 40, 0)
    jpool = JPool(jcfg(TINY), imgs, labs, shards, **KW)
    jevl = JEvaluator(jcfg(TINY), ti, tl)
    w0 = _w0(TINY)
    work = build_workload(iid=True, device="cpu", cfg=TINY, num_train=400,
                          num_test=NUM_TEST, w0=params_from_jax(w0,
                                                                device="cpu"),
                          batch_indices=injected(KW, shards), **KW)
    return jpool, jevl, w0, work


def _step_counts(pool):
    progs = getattr(pool, "_epoch_programs", {}).values()
    return (sum(p.dispatches for p in progs),
            sum(p.fallback_dispatches for p in progs))


def _host(hist):
    return [(r.epoch, r.time_s, r.num_models, r.gamma, r.stale_groups)
            for r in hist]


def run_pair(setup, scheme, epochs, *, spec_kw=None, sim_kw=None,
             jsim_kw=None, traced=False):
    """The JAX runtime and the port's on one configuration (``sim_kw``
    and ``jsim_kw``: more ``SimConfig`` fields of the port and of the
    reference).  Returns ((jax runtime, history, step counts), (port
    runtime, ...))."""
    jpool, jevl, w0, work = setup
    out = []
    for sim_cls, cfg_cls, get, rt_cls, tr_cls, pool, ev, w, kw in (
            (JSim, JSimConfig, jget, JRuntime, JTracer, jpool, jevl, w0,
             jsim_kw),
            (FLSimulation, SimConfig, get_strategy, EventDrivenRuntime,
             Tracer, work.pool, work.evaluator, work.w0, sim_kw)):
        spec = get(scheme)
        if spec_kw:
            spec = dataclasses.replace(spec, **spec_kw)
        kw = dict(kw or {})
        if traced:
            kw["tracer"] = tr_cls()
        fls = sim_cls(spec, pool, ev, cfg_cls(duration_s=DAYS * 86400.0,
                                              event_driven=True, **kw))
        rt = rt_cls(fls)
        before = _step_counts(pool)
        hist = rt.run(w, max_epochs=epochs)
        after = _step_counts(pool)
        out.append((rt, hist, (after[0] - before[0], after[1] - before[1])))
    return out


def assert_same_run(jrun, trun):
    (jrt, jhist, jsteps), (trt, thist, tsteps) = jrun, trun
    assert _host(thist) == _host(jhist)
    for a, b in zip(thist, jhist):
        assert abs(a.accuracy - b.accuracy) <= 1.0 / NUM_TEST + 1e-6
    jfls, tfls = jrt.fls, trt.fls
    np.testing.assert_allclose(tfls._w_flat.numpy(),
                               np.asarray(jfls._w_flat), atol=1e-4)
    assert dict(trt.stats) == dict(jrt.stats)
    assert tfls.grouping.groups == jfls.grouping.groups
    assert tfls._pend_meta == jfls._pend_meta
    assert tfls.last_epoch_included == jfls.last_epoch_included
    assert tsteps == jsteps
    assert trt.beta == jrt.beta and trt._round_seq == jrt._round_seq
    assert trt.events.counts == jrt.events.counts


# ---- EventQueue ------------------------------------------------------------

def _random_events(mods, seed, n=400):
    """The same random events built in each module: few distinct times
    and rounds, so runs of equal (time, kind, round) are common."""
    rng = random.Random(seed)
    specs = [(rng.choice([0.0, 1.0, 2.5, 2.5, 7.0]), rng.randrange(7),
              rng.randrange(3), rng.randrange(40), rng.randrange(64),
              rng.random() < 0.2) for _ in range(n)]
    return [[m.Event(t, m.EventKind(k), r, sat=s, row=w, pipelined=p)
             for (t, k, r, s, w, p) in specs] for m in mods]


def _key(ev):
    return (ev.time, int(ev.kind), ev.round_idx, ev.sat, ev.row,
            ev.pipelined, ev.attempt, ev.ps)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_event_queue_pops_and_batches_like_reference(seed):
    tevs, jevs = _random_events((tev, jev), seed)
    tq, jq = tev.EventQueue(), jev.EventQueue()
    # interleave single pushes, bulk pushes and pops, as the runtime does
    rng = random.Random(seed + 100)
    i, popped = 0, ([], [])
    while i < len(tevs):
        k = rng.randrange(1, 9)
        if rng.random() < 0.5:
            tq.push_many(tevs[i:i + k])
            jq.push_many(jevs[i:i + k])
        else:
            for a, b in zip(tevs[i:i + k], jevs[i:i + k]):
                tq.push(a)
                jq.push(b)
        i += k
        assert tq.peek_time() == jq.peek_time() and len(tq) == len(jq)
        if rng.random() < 0.3:
            popped[0].append([_key(tq.pop())])
            popped[1].append([_key(jq.pop())])
    assert tq.counts == jq.counts
    while jq:
        popped[0].append([_key(e) for e in tq.pop_batch()])
        popped[1].append([_key(e) for e in jq.pop_batch()])
    assert not tq and tq.peek_time() is None
    assert popped[0] == popped[1]
    batches = [b for b in popped[0] if len(b) > 1]
    assert batches and all(len({e[:3] for e in b}) == 1 for b in batches)


def test_event_kinds_and_nan_rejected():
    assert [(k.name, int(k)) for k in tev.EventKind] == \
        [(k.name, int(k)) for k in jev.EventKind]
    assert len(tev.EventKind) == 7
    with pytest.raises(ValueError, match="NaN"):
        tev.Event(float("nan"), tev.EventKind.TRAIN_DONE, 0)


# ---- policies ---------------------------------------------------------------

def _fake_rt(mod_contacts=None, backlog=0.0, groups=None):
    ctn = None
    if mod_contacts is not None:
        ctn = mod_contacts.ContentionModel(2, 1)
        ctn.grant_rx(1, 0.0, backlog)
    return types.SimpleNamespace(
        sim=types.SimpleNamespace(agg_timeout_s=1500.0, duration_s=86400.0,
                                  sync_stall_s=3600.0, min_models=2),
        plan=types.SimpleNamespace(contention=ctn), stats={}, tracer=None,
        group_of_sat=lambda s: (groups or {}).get(s % 5, -1))


def _round(cls, n_expected, trigger=None, arrived=0):
    rnd = cls(0, 0, 100.0, 0, 1, list(range(n_expected)),
              np.zeros(0, np.int32),
              [(200.0 + i, i, i) for i in range(n_expected)], {})
    rnd.trigger_scheduled = trigger
    rnd.arrived_count = arrived
    return rnd


def _sequential(policy, rt, rnd, t, sats):
    """The runtime's per-event path: increment, ``on_arrival``, and the
    earliest trigger wins the schedule."""
    out = []
    for s in sats:
        rnd.arrived_count += 1
        trig = policy.on_arrival(rt, rnd, t, sat=s)
        if trig is not None and (rnd.trigger_scheduled is None
                                 or trig < rnd.trigger_scheduled):
            rnd.trigger_scheduled = trig
        out.append(trig)
    return out


def _batched(policy, rt, rnd, t, sats):
    out = policy.on_arrival_batch(rt, rnd, t, sats)
    for trig in out:
        if trig is not None and (rnd.trigger_scheduled is None
                                 or trig < rnd.trigger_scheduled):
            rnd.trigger_scheduled = trig
    return out


POLICY_CASES = [
    ("asyncfleo", {}, None), ("asyncfleo", {}, 900.0),
    ("asyncfleo", dict(group_timeouts={0: 300.0, -1: 600.0}), None),
    ("asyncfleo", dict(rx_backlog_threshold_s=10.0), None),
    ("sync", {}, None), ("per_arrival", {}, None)]


@pytest.mark.parametrize("name,fields,trigger", POLICY_CASES)
@pytest.mark.parametrize("n_expected,base,n_run", [(8, 0, 3), (8, 5, 3),
                                                   (8, 7, 1), (4, 0, 4)])
def test_on_arrival_batch_equals_per_event_loop(name, fields, trigger,
                                                n_expected, base, n_run):
    """The batch contract: the policy does the ``arrived_count``
    increments and returns what the sequential loop would, for a run that
    completes the barrier, opens a window, or lands in an open one."""
    from repro.sched import contacts as jcon
    from repro_torch.sched import contacts as tcon
    sats = list(range(base, base + n_run))
    results = []
    for pol, cls, con in ((tpol, RoundState, tcon), (tpol, RoundState, tcon),
                          (jpol, JRound, jcon)):
        policy = dataclasses.replace(pol.POLICIES[name](), **fields)
        rt = _fake_rt(con, backlog=50.0, groups={0: 0, 1: 0, 2: 1})
        rnd = _round(cls, n_expected, trigger, arrived=base)
        if len(results) == 1:
            trigs = _sequential(policy, rt, rnd, 500.0, sats)
        else:
            trigs = _batched(policy, rt, rnd, 500.0, sats)
        results.append((trigs, rnd.arrived_count, rnd.trigger_scheduled,
                        dict(rnd.group_first), dict(rt.stats)))
    assert results[0] == results[1] == results[2]


@pytest.mark.parametrize("name", ["asyncfleo", "sync", "per_arrival"])
@pytest.mark.parametrize("n_expected,trigger,arrived", [
    (0, None, 0), (0, 50.0, 0), (3, None, 3), (3, None, 1), (3, 7.0, 3)])
def test_on_expected_drop_and_deadline_match_reference(name, n_expected,
                                                       trigger, arrived):
    rt = _fake_rt()
    got = []
    for pol, cls in ((tpol, RoundState), (jpol, JRound)):
        p = pol.POLICIES[name]()
        got.append((p.on_expected_drop(rt, _round(cls, n_expected, trigger,
                                                  arrived), 123.0),
                    p.round_deadline(rt, _round(cls, n_expected)),
                    p.round_complete(_round(cls, n_expected, trigger,
                                            arrived))))
    assert got[0] == got[1]


def test_policy_selection_matches_reference():
    assert sorted(STRATEGIES) == sorted(JSTRATEGIES)
    for name in STRATEGIES:
        t = tpol.make_policy(get_strategy(name))
        j = jpol.make_policy(jget(name))
        assert (type(t).__name__, dataclasses.asdict(t)) == \
            (type(j).__name__, dataclasses.asdict(j))
        th = tpol.make_handoff_policy(get_strategy(name))
        jh = jpol.make_handoff_policy(jget(name))
        assert type(th).__name__ == type(jh).__name__
    with pytest.raises(KeyError):
        tpol.make_policy(get_strategy("fedasync"), name="nope")
    with pytest.raises(KeyError):
        tpol.make_handoff_policy(get_strategy("fedasync"), name="nope")


# ---- history parity with the JAX runtime ------------------------------------

# asyncfleo-hap: one round in flight; asyncfleo-pipelined: 3 in flight
# through the next_contact handoff (8 epochs reach its stale-discounted
# commits); fedhap: the sync barrier; fedasync: per-arrival commits that
# drain the round's own carried rows; twohap at depth 2 runs long enough
# that arrivals land after their round closed and a later round adopts
# them (cross-round adoptions)
@pytest.mark.parametrize("scheme,epochs,spec_kw", [
    ("asyncfleo-hap", 3, None), ("asyncfleo-pipelined", 8, None),
    ("fedhap", 2, None), ("fedasync", 5, None),
    ("asyncfleo-twohap", 20, PIPE2)])
def test_history_matches_jax_runtime(setup, scheme, epochs, spec_kw):
    jrun, trun = run_pair(setup, scheme, epochs, spec_kw=spec_kw)
    assert len(trun[1]) == epochs
    assert_same_run(jrun, trun)
    st = trun[0].stats
    if scheme == "asyncfleo-pipelined":
        assert st["max_rounds_in_flight"] == 3 and st["pipelined_opens"]
        assert any(r.gamma < 1.0 for r in trun[1])
    if spec_kw is PIPE2:
        assert st["closed_round_arrivals"] and st["cross_round_adoptions"]


def test_traced_run_matches_jax_and_untraced(setup):
    """A traced pipelined run: the span and instant lists equal the
    reference's, and the history and model equal an untraced run's bit
    for bit (tracing is read-only; it takes the per-event arrival
    path)."""
    jrun, trun = run_pair(setup, "asyncfleo-pipelined", 6, traced=True)
    assert_same_run(jrun, trun)
    jtr, ttr = jrun[0].tracer, trun[0].tracer
    assert ttr.spans and ttr.instants
    assert [dataclasses.astuple(s) for s in ttr.spans] == \
        [dataclasses.astuple(s) for s in jtr.spans]
    assert [dataclasses.astuple(i) for i in ttr.instants] == \
        [dataclasses.astuple(i) for i in jtr.instants]
    assert ttr.tracks() == jtr.tracks()
    *_, work = setup
    fls = FLSimulation(get_strategy("asyncfleo-pipelined"), work.pool,
                       work.evaluator, SimConfig(duration_s=DAYS * 86400.0,
                                                 event_driven=True))
    plain = fls.run(work.w0, max_epochs=6)
    assert [vars(r) for r in plain] == [vars(r) for r in trun[1]]
    assert torch.equal(fls._w_flat, trun[0].fls._w_flat)


def test_max_in_flight_one_equals_the_epoch_loop(setup):
    """``max_in_flight=1`` with the ring handoff is the epoch loop, bit
    for bit: history (accuracy too), model and step counts."""
    *_, work = setup
    spec = dataclasses.replace(get_strategy("asyncfleo-pipelined"),
                               max_in_flight=1, handoff_policy="")
    out = []
    for event_driven in (False, True):
        fls = FLSimulation(spec, work.pool, work.evaluator,
                           SimConfig(duration_s=DAYS * 86400.0,
                                     event_driven=event_driven))
        before = _step_counts(work.pool)
        hist = fls.run(work.w0, max_epochs=5)
        after = _step_counts(work.pool)
        out.append(([vars(r) for r in hist], fls._w_flat,
                    (after[0] - before[0], after[1] - before[1])))
    assert len(out[0][0]) == 5 and out[0][0] == out[1][0]
    assert torch.equal(out[0][1], out[1][1]) and out[0][2] == out[1][2]


class _PerEventOnly:
    """A policy without the batch protocol: the runtime then takes the
    per-event arrival path for every run of arrivals."""

    def __init__(self, policy):
        self._policy = policy

    def __getattr__(self, name):
        if name == "on_arrival_batch":
            raise AttributeError(name)
        return getattr(self._policy, name)


@pytest.mark.parametrize("scheme,epochs", [("asyncfleo-pipelined", 6),
                                           ("fedhap", 2), ("fedasync", 5)])
def test_batched_arrivals_equal_per_event_runtime(setup, scheme, epochs):
    *_, work = setup
    runs = []
    for wrap in (False, True):
        fls = FLSimulation(get_strategy(scheme), work.pool, work.evaluator,
                           SimConfig(duration_s=DAYS * 86400.0,
                                     event_driven=True))
        policy = tpol.make_policy(fls.spec)
        rt = EventDrivenRuntime(fls, policy=_PerEventOnly(policy) if wrap
                                else policy)
        hist = rt.run(work.w0, max_epochs=epochs)
        runs.append(([vars(r) for r in hist], fls._w_flat, dict(rt.stats),
                     rt.events.counts))
    assert len(runs[0][0]) == epochs and runs[0][0] == runs[1][0]
    assert torch.equal(runs[0][1], runs[1][1])
    assert runs[0][2:] == runs[1][2:]


# ---- the entry point --------------------------------------------------------

def test_entry_point_flags(setup, monkeypatch, capsys):
    """``--max-in-flight 3`` implies the event runtime and ``--staleness-fn``
    reaches every scheme's spec; the contact-plan line is printed."""
    *_, work = setup
    monkeypatch.setattr(fl_constellation_sim, "build_workload",
                        lambda **kw: work)
    res = main(["--schemes", "asyncfleo-gs", "--epochs", "2", "--iid",
                "--max-in-flight", "3", "--staleness-fn", "poly",
                "--device", "cpu"])
    fls, hist = res["asyncfleo-gs"]
    assert fls.sim.event_driven and len(hist) == 2
    assert fls.spec.max_in_flight == 3 and fls.spec.staleness_fn == "poly"
    out = capsys.readouterr().out
    assert "# asyncfleo-gs: contact plan — " in out and "windows" in out


def test_event_driven_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        main(["--schemes", "asyncfleo-pipelined", "--epochs", "1", "--iid",
              "--event-driven", "--device", "cuda"])
