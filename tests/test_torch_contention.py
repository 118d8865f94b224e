"""Finite PS channels in the port (``ChannelPool`` / ``ContentionModel`` in
``repro_torch.sched.contacts``) against the JAX package's.

The pools are host numpy and Python: the same grant sequences give the
same start times, reservations, backlogs, stats and queue-wait
histograms, exactly, through snapshot/restore and reset.  The runtime
with ``ps_channels`` in {1, 2} (and the contention-aware window shrink)
gives the reference's history and ``contention_stats()``, under the
tolerances of ``tests/test_torch_sched.py``; ``ps_channels=None``
attaches no model.  The link is slowed to 3 kb/s so one TINY model
(217,408 bits) holds a channel for 72 s and a 40-satellite round queues.
"""
import copy
import dataclasses
import random

import pytest

from repro.core import FLSimulation as JSim, SimConfig as JSimConfig
from repro.core.links import LinkModel as JLink
from repro.fl import get_strategy as jget
from repro.sched import contacts as jcon
from repro_torch.core.links import LinkModel
from repro_torch.core.simulator import FLSimulation, SimConfig
from repro_torch.fl.strategies import get_strategy
from repro_torch.sched import EventDrivenRuntime
from repro_torch.sched import contacts as tcon
from test_torch_sched import (DAYS, _host, assert_same_run,  # noqa: F401
                              one_torch_thread, run_pair,
                              setup)  # (fixtures)

RATE_BPS = 3e3


def _pools_state(ctn):
    """A copy of everything the pools hold (grants mutate the lists in
    place)."""
    return copy.deepcopy((ctn.tx.res, ctn.rx.res, ctn.stats(86400.0),
                          ctn.tx.wait_hist.samples, ctn.rx.wait_hist.samples))


def _drive(mod, channels, seed, n=200):
    """One random sequence of grants, batch grants, backlog queries,
    snapshots and restores; returns everything it observed."""
    rng = random.Random(seed)
    ctn = mod.ContentionModel(3, channels)
    seen, snaps = [], []
    for _ in range(n):
        op = rng.randrange(8)
        ps, t, d = rng.randrange(3), rng.choice(
            [0.0, 5.0, rng.uniform(0, 200)]), rng.choice([0.0, 10.0, 7.5])
        if op == 0:
            seen.append(ctn.grant_tx(ps, t, d))
        elif op == 1:
            seen.append(ctn.grant_rx(ps, t, d))
        elif op in (2, 3):
            k = rng.randrange(1, 6)
            ids = [rng.randrange(3) for _ in range(k)]
            reqs = [rng.choice([t, t + 1.0, rng.uniform(0, 200)])
                    for _ in range(k)]
            fn = ctn.grant_tx_many if op == 2 else ctn.grant_rx_many
            seen.append(fn(ids, reqs, d).tolist())
        elif op == 4:
            seen.append(ctn.backlog(rng.choice(["tx", "rx"]), ps, t))
            seen.append(copy.deepcopy(ctn.rx.res[ps]))
        elif op == 5:
            snaps.append(ctn.snapshot())
        elif op == 6 and snaps:
            ctn.restore(rng.choice(snaps))
        elif op == 7 and rng.random() < 0.1:
            ctn.reset()
    seen.append(_pools_state(ctn))
    return seen


@pytest.mark.parametrize("channels", [None, 1, 2, 3])
@pytest.mark.parametrize("seed", [0, 1])
def test_grant_sequences_equal_reference(channels, seed):
    assert _drive(tcon, channels, seed) == _drive(jcon, channels, seed)


def test_fifo_backfill_and_rollback():
    """The pool's rules on a worked example, against the reference: one
    channel serializes FIFO by request time, a short transfer backfills
    the gap before a later reservation, a batch is granted in request
    order, and a snapshot restores (twice) to its own state."""
    out = []
    for mod in (tcon, jcon):
        c = mod.ContentionModel(2, 1)
        got = [c.grant_rx(0, 0.0, 10.0), c.grant_rx(0, 5.0, 10.0),
               c.grant_rx(0, 100.0, 10.0), c.grant_rx(0, 30.0, 20.0),
               c.grant_rx(0, 45.0, 60.0)]
        snap = c.snapshot()
        got.append(c.grant_tx_many([1, 1, 1], [9.0, 3.0, 3.0], 4.0).tolist())
        c.restore(snap)
        got.append((c.tx.grants, c.rx.grants, copy.deepcopy(c.rx.res[0])))
        got.append(c.grant_tx(1, 3.0, 4.0))
        c.restore(snap)
        got.append((copy.deepcopy(c.tx.res[1]), c.backlog("rx", 0, 50.0),
                    c.stats(1000.0)))
        out.append(got)
    assert out[0] == out[1]
    assert out[0][:5] == [0.0, 10.0, 100.0, 30.0, 110.0]
    assert out[0][5] == [11.0, 3.0, 7.0]


def test_pool_validation_matches():
    for mod in (tcon, jcon):
        with pytest.raises(AssertionError):
            mod.ChannelPool(2, 0)


CONTENTION_CASES = [dict(ps_channels=1), dict(ps_channels=2),
                    dict(ps_channels=1, rx_backlog_threshold_s=60.0)]


@pytest.mark.parametrize("spec_kw", CONTENTION_CASES)
def test_runtime_with_channels_matches_jax(setup, spec_kw):
    """Pipelined rounds over finite channels: the queued grants move the
    history (cross-round serialization, the next_contact handoff's
    least-busy tie-break, the shrunk trigger windows), and the port moves
    it exactly as the reference does."""
    link = dict(link=JLink(rate_bps=RATE_BPS))
    jrun, trun = run_pair(setup, "asyncfleo-pipelined", 6, spec_kw=spec_kw,
                          sim_kw=dict(link=LinkModel(rate_bps=RATE_BPS)),
                          jsim_kw=link)
    assert len(trun[1]) == 6
    assert_same_run(jrun, trun)
    cs = trun[0].contention_stats()
    assert cs == jrun[0].contention_stats()
    assert cs["ps_channels"] == spec_kw["ps_channels"]
    assert cs["rx"]["queue_wait_s"] > 0 and cs["rx"]["queue_wait_hist"][
        "count"] == cs["rx"]["grants"]
    if "rx_backlog_threshold_s" in spec_kw:
        assert trun[0].stats["shrunk_windows"] > 0


def test_no_channels_attaches_nothing(setup):
    """``ps_channels=None``: no model on the plan, no contention stats,
    and the history of a plain run."""
    *_, work = setup
    fls = FLSimulation(get_strategy("asyncfleo-pipelined"), work.pool,
                       work.evaluator, SimConfig(duration_s=DAYS * 86400.0,
                                                 event_driven=True))
    assert fls.plan.contention is None
    rt = EventDrivenRuntime(fls)
    hist = rt.run(work.w0, max_epochs=3)
    assert rt.contention_stats() is None and len(hist) == 3


def test_epoch_loop_with_channels_matches_jax_and_resets(setup):
    """The epoch loop times its transfers through the same pools: its
    history with one channel equals the reference's, and a second run of
    the same simulation starts from empty pools (``_init_run`` resets
    them), so it repeats the first."""
    jpool, jevl, w0, work = setup
    jspec = dataclasses.replace(jget("asyncfleo-gs"), ps_channels=1)
    tspec = dataclasses.replace(get_strategy("asyncfleo-gs"), ps_channels=1)
    jsim = JSim(jspec, jpool, jevl, JSimConfig(
        duration_s=DAYS * 86400.0, link=JLink(rate_bps=RATE_BPS)))
    tsim = FLSimulation(tspec, work.pool, work.evaluator, SimConfig(
        duration_s=DAYS * 86400.0, link=LinkModel(rate_bps=RATE_BPS)))
    jhist = jsim.run(w0, max_epochs=3)
    thist = tsim.run(work.w0, max_epochs=3)
    assert _host(thist) == _host(jhist)
    assert tsim.plan.contention.stats(86400.0) == \
        jsim.plan.contention.stats(86400.0)
    grants = tsim.plan.contention.rx.grants
    assert grants > 0
    again = tsim.run(work.w0, max_epochs=3)
    assert [vars(r) for r in again] == [vars(r) for r in thist]
    assert tsim.plan.contention.rx.grants == grants


def test_aborted_speculative_open_rolls_back_grants(setup):
    """A speculative open that recruits nobody (every satellite still
    training) leaves the pools exactly as it found them."""
    *_, work = setup
    spec = dataclasses.replace(get_strategy("asyncfleo-pipelined"),
                               ps_channels=1)
    fls = FLSimulation(spec, work.pool, work.evaluator,
                       SimConfig(duration_s=DAYS * 86400.0,
                                 event_driven=True,
                                 link=LinkModel(rate_bps=RATE_BPS)))
    rt = EventDrivenRuntime(fls)
    rt.bits, rt.prog = fls._init_run(work.w0)
    rt.max_epochs = 5
    ctn = fls.plan.contention
    assert rt._start_round(0.0, 0) is not None          # a real open
    before = _pools_state(ctn)
    assert before[2]["tx"]["grants"] > 0
    rt._busy_until[:] = 1e9
    assert rt._start_round(100.0, 1, pipelined=True) is None
    assert _pools_state(ctn) == before
