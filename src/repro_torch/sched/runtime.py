"""Event-driven asynchronous FL runtime (DESIGN.md §7; the pipelined
multi-round model is §8), as the JAX package's ``repro.sched.runtime``.

`core/simulator.py`'s epoch loop advances simulated time one aggregation
window at a time — enough to reproduce accuracy curves, but it hard-codes
*when* the server aggregates.  The paper's headline claim (22x lower
convergence delay than synchronous FL) is a statement about trigger
policy, so this module runs the same physics and the same fused device
program under a priority-queue event loop instead:

    SINK_HANDOFF -> round opens: the handoff policy (sched/policies.py)
      picks the source/sink PS pair — the ring role swap, or the
      contact-plan-driven earliest-next-contact HAP — and the contact
      plan + propagation model give every satellite its global-model
      receive time; TRAIN_DONE events are scheduled at receive +
      train_time.
    TRAIN_DONE -> the satellite's local model enters the uplink relay; a
      MODEL_ARRIVAL is scheduled at its sink arrival time.
    MODEL_ARRIVAL / TRIGGER_TIMEOUT -> the strategy's trigger policy
      (sched/policies.py) decides when to aggregate: AsyncFLEO's idle
      window (optionally one deadline per divergence group), the sync
      barrier, or FedAsync per-arrival.
    trigger -> ALL arrivals ready at the instant batch into ONE fused
      `core/epoch_step.py` step (training + grouping distances +
      aggregation contraction through the fed_agg kernel), so async
      semantics cost no extra device round-trips; stragglers carry over
      device-resident exactly as in the epoch loop.

**Pipelining** (DESIGN.md §8): with ``StrategySpec.max_in_flight > 1``
the runtime keeps a SET of in-flight rounds keyed by round id instead of
one.  While round k's models are still propagating, a *speculative*
SINK_HANDOFF (scheduled by the handoff policy's ``next_open_time``, by
default round k's first expected arrival) may open round k+1 from a
contact-plan-chosen source, recruiting only satellites that are not
still training for an earlier round (the overlap invariant).  Every
event carries its round id, so MODEL_ARRIVALs commit into the right
round; an arrival addressed to an already-closed round was carried over
at that round's commit and re-enters aggregation through the successor
round's stale set — `FLSimulation._fused_commit` stamps it with its
origin round's epoch, so eq. 13's staleness discount sees exactly the
paper's semantics.  A round trains at its commit, from the global model
as it stands then.  Commits land in event-time order against the single
global model; ``max_in_flight=1`` (the default) collapses to the
single-round loop bit-for-bit.

**Link contention** (DESIGN.md §9): with ``StrategySpec.ps_channels``
set, the contact plan carries a `ContentionModel` — per-PS transmit and
receive pools of that many parallel channels — and every round open
(downlink) and uplink the runtime times through the plan consults AND
updates the pools, so transfers at the same PS serialize across
overlapping rounds.  A speculative open that aborts rolls its grants
back (`ContentionModel.snapshot`/``restore``); ``contention_stats()``
exposes grants, queue-wait totals and per-PS utilization.
``ps_channels=None`` (default) attaches no model at all — bit-identical
to the uncontended runtime.

**Faults** (DESIGN.md §10): with ``SimConfig.fault_model`` set, each
sat->PS model transfer draws a deterministic Bernoulli loss
(`sched/faults.FaultModel.transfer_fails`, keyed on (seed, sat, round,
attempt)).  A lost transfer fires TRANSFER_FAILED at its would-be
arrival instant; the handler re-times the retransmission after an
exponential backoff through the contact plan — a fresh rx-channel grant,
so retries contend for the same finite ``ps_channels`` — and bounds the
chain at ``max_retries`` before dropping the update entirely
(``dropped_after_max_retries``).  A retry whose grant can never complete
(unreachable sink / past the horizon) is rolled back through the same
snapshot/restore machinery as aborted speculative opens.  Dropping
shrinks the round's expected set, and the trigger policy's
``on_expected_drop`` hook keeps barrier/window rounds from hanging on
transfers that will never land.  ``fault_model=None`` (default) skips
every check — bit-identical to the fault-free runtime.

**Degradation & recovery** (DESIGN.md §11): the FaultModel's §11 axes
extend the runtime with recovery semantics.  *PS outages*: the compiled
`OutageSchedule` (masked into the visibility grid at construction)
schedules a PS_DOWN/PS_UP event pair per dark window; PS_DOWN fails
over every open round sunk at the dead PS to the handoff policy's
replacement (ring-next-live by default), and an in-flight MODEL_ARRIVAL
that pops at a sink dark at its arrival instant re-routes along the HAP
ring to the next live PS — re-timed by the ring relay delay and charged
a fresh §9 rx grant (snapshot/restore rollback on infeasible re-times).
During a *total* outage, arrivals hold at the ring edge until the first
recovery, round opens and triggers defer to it, and a trigger with no
recovery inside the horizon commits anyway (the horizon clamp) so
starved rounds terminate instead of hanging.  *Energy budgets*: per-sat
`EnergyState` batteries drain at recruitment (training energy) and at
every transmit attempt; a depleted satellite defers its uplink to the
first affordable instant (or drops past the horizon), and retries pay
transmit energy too.  *Adaptive backoff*: with
``FaultModel.adaptive_backoff`` the retry delay is AIMD — additive
increase on each failure scaled by the sink rx pool's observed mean
queue wait (capped at ``retry_backoff_cap_s``), halved on a successful
retry — replacing the blind exponential; chosen delays land in the
bounded ``backoff_delays_s`` histogram (``stats["backoff_delays_s"]``
renders its count/sum/min/max/p50/p95/p99 summary).  A conservation
ledger
(``arrivals_expected`` / ``arrivals_committed`` + the ``dropped_*``
counters) pins that every expected arrival is committed, dropped, or
still pending — across reroutes, deferrals and retries
(tests/test_torch_faults.py).  Every §11 axis at its default attaches no
state and is bit-identical to the §10 runtime.

Each commit calls the attached ``DispatchProfiler``'s ``trigger()``
(``SimConfig.profiler``, through the epoch program), so its summary
reports dispatches per trigger; in a scenario-batched sweep
(``SimConfig.dispatcher``) it also calls the batcher's profiler, which
counts the sweep's physical steps.  The stats keep the
reference's whole key set, so ``dict(runtime.stats)`` equals the
reference's.

The runtime owns no model math: it drives `FLSimulation._fused_commit`
(the epoch loop's post-trigger tail), so under the AsyncFLEO policy its
aggregation instants, weights and step counts are *identical* to the
epoch loop, while the sync-barrier and per-arrival policies express the
baselines the epoch loop could only approximate.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.modelbank import gather_rows
from repro_torch.obs.metrics import MetricRegistry, StatsView
from repro_torch.obs.trace import (EV_ARRIVAL, EV_COMMIT, EV_DISPATCH,
                                   EV_DROP, EV_ENERGY_DEFER, EV_FAILOVER,
                                   EV_PS_DOWN, EV_PS_UP, EV_REROUTE,
                                   EV_TRANSFER_FAILED, EV_TRANSFER_RETRY,
                                   EV_TRIGGER, NULL_TRACER, SPAN_RECRUIT,
                                   SPAN_ROUND, SPAN_TRANSFERS, SPAN_TRIGGER)
from repro_torch.sched.events import Event, EventKind, EventQueue
from repro_torch.sched.faults import EnergyState
from repro_torch.sched.policies import make_handoff_policy, make_policy

# the ``runtime.stats`` key set, in its historical order — the StatsView
# compatibility contract: same keys, same values, same JSON shape as the
# reference's, backed by the obs/metrics registry (DESIGN.md §12)
STAT_COUNTER_KEYS = (
    "rounds_opened", "max_rounds_in_flight",
    "pipelined_opens", "cross_round_adoptions",
    "closed_round_arrivals",
    # fault/retry telemetry: failed attempts, rescheduled
    # retransmissions, updates dropped after max_retries, updates dropped
    # because the retry could never complete, and contention-shrunk
    # trigger windows
    "transfers_failed", "transfer_retries",
    "dropped_after_max_retries", "dropped_unreachable",
    "shrunk_windows",
    # outage / failover telemetry (DESIGN.md §11)
    "rerouted_arrivals", "sink_failovers",
    "dropped_outage", "outage_deferrals",
    # energy telemetry (§11)
    "energy_deferrals", "energy_skipped_recruits",
    "dropped_energy",
    # fault-aware participant selection skips (§11)
    "fault_aware_skips",
    # conservation ledger: every expected arrival ends up committed (used
    # or adopted-from-carry), in a dropped_* bucket, or still pending at
    # run end
    "arrivals_expected", "arrivals_committed")

# AIMD backoff delays actually applied (adaptive_backoff) — a bounded
# histogram (count/sum/min/max/p50/p95/p99 in the stats view)
STAT_HISTOGRAM_KEYS = ("backoff_delays_s",)


@dataclasses.dataclass
class RoundState:
    """Mutable per-round bookkeeping the event handlers share."""
    idx: int
    beta: int                       # global epoch counter at round start
    t_start: float
    source: int
    sink: int
    participants: List[int]
    ids_np: np.ndarray              # padded participant ids (bank order)
    expected: List[tuple]           # sorted finite (t_arr, sat, row)
    arr_time: Dict[int, float]      # bank row -> sink arrival time
    arrived_count: int = 0
    trigger_scheduled: Optional[float] = None
    committed: bool = False         # fused training step consumed
    closed: bool = False            # roles handed off; ignore stale events
    group_first: Dict[int, float] = dataclasses.field(default_factory=dict)
    # the sink the round's arrival times were computed against at open —
    # ``sink`` may fail over to a live PS mid-flight (DESIGN.md §11),
    # but already-timed arrivals stay addressed here and reroute lazily
    # at their pop instant when this PS is (still) dark
    open_sink: int = -1
    # open tracer span handle for the round's lifetime (obs/trace.py);
    # -1 when untraced
    span: int = -1


class EventDrivenRuntime:
    """Priority-queue event loop over an ``FLSimulation``'s compute machinery.

    ``fls`` supplies physics (contact plan, propagation), strategy spec and
    the fused-epoch commit path; ``policy`` defaults to the strategy's
    (`sched/policies.make_policy`), and the handoff policy + pipeline depth
    come from ``StrategySpec.handoff_policy`` / ``max_in_flight``.
    ``SimConfig.tracer`` records the round lifecycle.
    ``run`` returns the same ``EpochRecord`` history as ``FLSimulation.run``
    — one record per aggregation — so downstream analysis
    (``convergence_time``) is shared.  ``stats`` exposes pipeline
    telemetry: rounds opened, the peak number of rounds in flight,
    speculative opens, and carried-straggler adoptions across round
    boundaries.
    """

    def __init__(self, fls, policy=None):
        self.fls = fls
        self.sim = fls.sim
        self.spec = fls.spec
        # observability (DESIGN.md §12): the tracer records the round
        # lifecycle read-only — SimConfig.tracer, else the strict no-op
        # NULL_TRACER so every call site below is unconditional and
        # untraced runs pay nothing
        self.tracer = fls.sim.tracer or NULL_TRACER
        self.policy = policy or make_policy(fls.spec)
        self.handoff = make_handoff_policy(fls.spec)
        self.max_in_flight = max(1, int(fls.spec.max_in_flight))
        self.plan = fls.plan
        self.events = EventQueue()
        self.rounds: Dict[int, RoundState] = {}
        self.history: List = []
        self.beta = 0
        self._round_seq = 0
        self._stop = False
        # training occupancy per satellite (the §8 overlap invariant:
        # a satellite trains for at most one in-flight round at a time)
        self._busy_until = np.zeros(self.plan.num_sats)
        # fault layer (DESIGN.md §10): the FaultModel lives on the
        # simulation config; None short-circuits every check
        self.fault = fls.fault
        # compiled PS outage schedule (DESIGN.md §11); None without any
        # outage config — not a single query is made
        self._outages = fls._outages
        # per-sat battery state ((re)built in run()); None = energy off
        self.energy = None
        # AIMD retry-delay state for FaultModel.adaptive_backoff
        self._retry_delay_s = 0.0
        # telemetry: one metric registry per runtime is the single
        # backing store (DESIGN.md §12); ``stats`` is the historical dict
        # surface as a live MutableMapping view over it (policies write
        # ``stats[k]`` too)
        self.metrics = MetricRegistry()
        self.stats: StatsView = StatsView(
            self.metrics, counter_keys=STAT_COUNTER_KEYS,
            histogram_keys=STAT_HISTOGRAM_KEYS)

    # ---- lifecycle ---------------------------------------------------------

    def run(self, w0, max_epochs: int = 30,
            target_accuracy: Optional[float] = None):
        """Run from the global model ``w0`` (a parameter dict; the device
        of its tensors is the device of the run)."""
        fls = self.fls
        self.bits, prog, _stacked = fls._init_run(w0)
        if prog is None:
            raise ValueError(
                "the event-driven runtime reuses the fused epoch step as "
                "its compute engine; the trainer must expose the fused-epoch "
                "protocol (epoch_train_fn + epoch_inputs) and SimConfig must "
                "keep use_model_bank/use_fused_step enabled")
        self.prog = prog
        self.max_epochs = max_epochs
        self.target = target_accuracy
        self.lazy_eval = (target_accuracy is None
                          and hasattr(fls.evaluator, "eval_async"))
        self.history = []
        self.beta = 0
        self._stop = False
        self._busy_until[:] = 0.0
        self._retry_delay_s = (float(self.fault.retry_backoff_s)
                               if self.fault is not None else 0.0)
        if self.fault is not None and self.fault.has_energy:
            # fresh battery state per run (mirrors _init_run's pool reset)
            self.energy = EnergyState(self.fault, self.plan.num_sats)
        if self._outages is not None:
            # one PS_DOWN / PS_UP pair per dark window (DESIGN.md §11);
            # recovery decisions query the pure schedule, so these events
            # carry the *reactive* semantics (failover sweeps) + telemetry
            for p, s, e in self._outages.events():
                if s < self.sim.duration_s:
                    self.events.push(Event(s, EventKind.PS_DOWN, -1, ps=p))
                if e < self.sim.duration_s:
                    self.events.push(Event(e, EventKind.PS_UP, -1, ps=p))
        self._start_round(0.0, source=0)
        handlers = {
            EventKind.TRAIN_DONE: self._on_train_done,
            EventKind.MODEL_ARRIVAL: self._on_arrival,
            EventKind.TRIGGER_TIMEOUT: self._on_trigger,
            EventKind.SINK_HANDOFF: self._on_handoff,
            EventKind.TRANSFER_FAILED: self._on_transfer_failed,
            EventKind.PS_DOWN: self._on_ps_down,
            EventKind.PS_UP: self._on_ps_up,
        }
        tracer = self.tracer
        t_last = 0.0
        # batched pops (DESIGN.md §14): same-(time, kind, round) runs —
        # the MODEL_ARRIVAL floods a mega-constellation trigger produces —
        # drain as one batch through a vectorized handler tail instead of
        # one Python heap pop + handler dispatch per satellite.  The
        # run's events are exactly the pops the sequential loop would do
        # consecutively (nothing else can sort between them), and the
        # batch handlers reproduce the per-event push order, so sequence
        # numbers and histories stay bit-identical
        while self.events and not self._stop:
            evs = self.events.pop_batch()
            if tracer.enabled:
                t_last = max(t_last, evs[0].time)
            if len(evs) == 1:
                handlers[evs[0].kind](evs[0])
            elif evs[0].kind == EventKind.TRAIN_DONE:
                self._on_train_done_batch(evs)
            elif evs[0].kind == EventKind.MODEL_ARRIVAL:
                self._on_arrival_batch(evs)
            else:
                h = handlers[evs[0].kind]
                for ev in evs:
                    if self._stop:
                        break
                    h(ev)
        # finalize the timeline: rounds still alive at the horizon close
        # at the last processed instant so every opened span is recorded
        tracer.close_open_spans(t_last)
        fls._resolve_pending_dists()       # leave grouping state complete
        with fls._seg("eval"):
            for rec in self.history:       # block once, at finalize time
                rec.accuracy = float(rec.accuracy)
        return self.history

    # ---- round opening -----------------------------------------------------

    def _open_count(self) -> int:
        return sum(1 for r in self.rounds.values() if not r.closed)

    def contention_stats(self) -> Optional[Dict]:
        """Per-PS link-capacity telemetry (None without a ContentionModel,
        i.e. ``StrategySpec.ps_channels=None``): channel grants, FIFO
        queue-wait totals and per-PS utilization for the transmit and
        receive pools (DESIGN.md §9) — round opens and uplinks consult
        and update this occupancy through the shared contact plan."""
        ctn = self.plan.contention
        return None if ctn is None else ctn.stats(self.sim.duration_s)

    def group_of_sat(self, sat: int) -> int:
        """Divergence group of a satellite's orbit (-1 = not yet grouped)
        — the per-group deadline lookup (DESIGN.md §8)."""
        if sat < 0:
            return -1
        self.fls._resolve_pending_dists()       # grouping-state read next
        g = self.fls.grouping.group_of(int(self.fls.orbit_ids[sat]))
        return -1 if g is None else int(g)

    def _start_round(self, t: float, source: int, sink: Optional[int] = None,
                     *, pipelined: bool = False) -> Optional[RoundState]:
        fls, sim = self.fls, self.sim
        if t >= sim.duration_s or self.beta >= self.max_epochs:
            return None
        if sink is None:
            sink = fls.topo.sink_of(source)
        if self._outages is not None:
            # PS roles must be live at open (DESIGN.md §11): a dark
            # source/sink is replaced by the nearest live ring PS; with
            # EVERY PS dark the open defers to the first recovery (a
            # round_idx=-1 SINK_HANDOFF that _on_handoff restarts)
            if self._outages.down_at(source, t):
                alt = self._next_live_ps(source, t)
                if alt is None:
                    t_up = self._outages.next_any_up(t)
                    if t < t_up < sim.duration_s:
                        self.stats["outage_deferrals"] += 1
                        self.events.push(Event(t_up, EventKind.SINK_HANDOFF,
                                               -1, sat=source,
                                               pipelined=pipelined))
                    return None
                source = alt
            if self._outages.down_at(sink, t):
                alt = self._next_live_ps(sink, t)
                sink = alt if alt is not None else source
        # timing a round consumes channel grants when a ContentionModel is
        # attached (DESIGN.md §9); if the open aborts below, roll the
        # grants back so a round that never ran leaves no occupancy behind
        ctn = self.plan.contention
        snap = ctn.snapshot() if ctn is not None else None
        esnap = self.energy.snapshot() if self.energy is not None else None
        with fls._seg("timing"):
            recv = self.plan.downlink_times(t, self.bits, source)
        participants = [s for s in range(self.plan.num_sats)
                        if np.isfinite(recv[s])]
        if self.max_in_flight > 1:
            # §8 overlap invariant: a satellite still training for an
            # earlier in-flight round sits this downlink out and joins a
            # later round instead (single-round mode keeps the epoch
            # loop's recruit-everyone semantics for parity)
            participants = [s for s in participants
                            if self._busy_until[s] <= recv[s]]
        if (participants and self.fault is not None
                and getattr(self.spec, "fault_aware_selection", False)):
            # fault-aware participant selection (DESIGN.md §11): skip
            # satellites whose eclipse covers the expected uplink
            # instant, or whose uplink would land in a total PS outage —
            # the model would only wait out the dark window anyway
            fm = self.fault
            tt = np.broadcast_to(
                np.asarray(fls._train_times(participants), np.float64),
                (len(participants),))
            keep = []
            for k, s in enumerate(participants):
                t_up = float(recv[s]) + float(tt[k])
                ok = fm.sat_available_at(s, t_up, self.plan.num_sats)
                if ok and self._outages is not None:
                    ok = not self._outages.all_down_at(t_up)
                if ok:
                    keep.append(s)
                else:
                    self.stats["fault_aware_skips"] += 1
            participants = keep
        if self.energy is not None and participants:
            # training costs energy at the recruit's receive instant
            # (DESIGN.md §11): a satellite that cannot afford it sits the
            # round out and recharges instead
            keep = []
            for s in participants:
                if self.energy.try_drain(s, float(recv[s]),
                                         self.energy.train_j):
                    keep.append(s)
                else:
                    self.stats["energy_skipped_recruits"] += 1
            participants = keep
        ids_np = np.zeros(0, np.int32)
        expected: List[tuple] = []
        arr_time: Dict[int, float] = {}
        t_done = np.zeros(0)
        if participants:
            with fls._seg("timing"):
                # the SAME timing math as the epoch loop, by construction
                ids_np, t_done, t_arr, expected = fls._arrival_times(
                    participants, recv, self.bits, sink)
            arr_time = {k: float(t_arr[k])
                        for k in range(len(participants))}
        if pipelined and not expected:
            if snap is not None:
                ctn.restore(snap)
            if esnap is not None:
                self.energy.restore(esnap)
            return None     # nobody free to train: the retry in
            #                 _on_handoff (or the close handoff) covers it
        if not expected and not fls._pend_meta:
            if snap is not None:
                ctn.restore(snap)
            if esnap is not None:
                self.energy.restore(esnap)
            return None                     # constellation drained: halt
        rnd = RoundState(self._round_seq, self.beta, t, source, sink,
                         participants, ids_np, expected, arr_time)
        rnd.open_sink = sink
        self._round_seq += 1
        self.rounds[rnd.idx] = rnd
        self.stats["rounds_opened"] += 1
        self.stats["arrivals_expected"] += len(expected)
        self.stats["pipelined_opens"] += int(pipelined)
        self.stats["max_rounds_in_flight"] = max(
            self.stats["max_rounds_in_flight"], self._open_count())
        if self.tracer.enabled:
            # the round's lifecycle track (DESIGN.md §12): one open-ended
            # span for the whole round plus the two phase spans whose
            # bounds are known at open — recruit (downlink: open -> last
            # participant's receive) and transfers (uplink: first
            # TRAIN_DONE -> last expected sink arrival; retries and
            # reroutes that move arrivals show up as instants)
            track = f"round {rnd.idx}"
            rnd.span = self.tracer.begin(
                SPAN_ROUND, t, track=track, source=int(source),
                sink=int(sink), participants=len(participants),
                pipelined=bool(pipelined), epoch=int(rnd.beta))
            if participants:
                self.tracer.span(
                    SPAN_RECRUIT, t,
                    max(float(recv[s]) for s in participants), track=track,
                    participants=len(participants))
            if expected:
                self.tracer.span(
                    SPAN_TRANSFERS, float(np.min(t_done)),
                    float(expected[-1][0]), track=track,
                    expected=len(expected))
        for k, s in enumerate(participants):
            td = float(t_done[k])
            self._busy_until[s] = max(self._busy_until[s], td)
            self.events.push(Event(td, EventKind.TRAIN_DONE,
                                   rnd.idx, sat=s, row=k))
        deadline = self.policy.round_deadline(self, rnd)
        if deadline is not None:
            rnd.trigger_scheduled = deadline
            self.events.push(Event(deadline, EventKind.TRIGGER_TIMEOUT,
                                   rnd.idx))
        if self.max_in_flight > 1 and self._open_count() < self.max_in_flight:
            # speculatively extend the pipeline: the handoff policy says
            # when a successor may open while this round is in flight
            t_next = self.handoff.next_open_time(self, rnd)
            if t_next is not None and t < t_next < sim.duration_s:
                self.events.push(Event(t_next, EventKind.SINK_HANDOFF,
                                       rnd.idx, pipelined=True))
        return rnd

    # ---- handlers ----------------------------------------------------------

    def _on_train_done(self, ev: Event) -> None:
        # the model is transmitted regardless of whether its round is
        # still open — a closed round's arrival fires as an event and is
        # routed to the carried-straggler path in _on_arrival
        rnd = self.rounds[ev.round_idx]
        ta = rnd.arr_time.get(ev.row)
        if ta is None or not np.isfinite(ta):
            return
        if self.energy is not None and not self.energy.try_drain(
                ev.sat, ev.time, self.energy.tx_j):
            # depleted battery: the uplink defers to the first affordable
            # instant instead of transmitting now (DESIGN.md §11)
            self._defer_uplink(rnd, ev, ta)
            return
        fm = self.fault
        if (fm is not None and fm.has_loss
                and fm.transfer_fails(ev.sat, rnd.idx, 0,
                                      ps=rnd.open_sink, t=ta)):
            # the transfer is lost in flight: the failure surfaces at the
            # would-be arrival instant (the sink notices a missing /
            # corrupt update only when it was due), DESIGN.md §10
            self.events.push(Event(ta, EventKind.TRANSFER_FAILED, rnd.idx,
                                   sat=ev.sat, row=ev.row, ps=rnd.open_sink))
            return
        self.events.push(Event(ta, EventKind.MODEL_ARRIVAL, rnd.idx,
                               sat=ev.sat, row=ev.row, ps=rnd.open_sink))

    def _on_train_done_batch(self, evs: List[Event]) -> None:
        """Batched TRAIN_DONE run (same time + round, DESIGN.md §14).
        With energy or loss faults active the per-event handler runs
        one-at-a-time (those paths draw per-sat state in event order);
        otherwise every member just converts to its MODEL_ARRIVAL push —
        one bulk ``push_many`` with per-event order preserved, which is
        exactly the sequential loop's push sequence."""
        if self.energy is not None or (self.fault is not None
                                       and self.fault.has_loss):
            for ev in evs:
                self._on_train_done(ev)
            return
        rnd = self.rounds[evs[0].round_idx]
        out = []
        for ev in evs:
            ta = rnd.arr_time.get(ev.row)
            if ta is None or not np.isfinite(ta):
                continue
            out.append(Event(ta, EventKind.MODEL_ARRIVAL, rnd.idx,
                             sat=ev.sat, row=ev.row, ps=rnd.open_sink))
        self.events.push_many(out)

    def _on_arrival_batch(self, evs: List[Event]) -> None:
        """Batched MODEL_ARRIVAL run (same time + round, DESIGN.md §14):
        one closed-round check, one ``policy.on_arrival_batch`` call, one
        trigger-application tail — instead of one handler call per
        arrival.  Outage reroutes, tracing, and adaptive backoff keep
        the per-event path (they mutate per-event state mid-run)."""
        if (self._outages is not None or self.tracer.enabled
                or (self.fault is not None and self.fault.adaptive_backoff)):
            for ev in evs:
                self._on_arrival(ev)
            return
        rnd = self.rounds[evs[0].round_idx]
        if rnd.closed:
            self.stats["closed_round_arrivals"] += len(evs)
            return
        t = evs[0].time
        batch_fn = getattr(self.policy, "on_arrival_batch", None)
        if batch_fn is None:
            # custom policy without the batch protocol: stay exactly
            # sequential (its on_arrival may read trigger_scheduled
            # between arrivals)
            for ev in evs:
                self._on_arrival(ev)
            return
        trigs = batch_fn(self, rnd, t, [ev.sat for ev in evs])
        # the sequential loop's per-arrival tail, applied in run order:
        # the earliest trigger wins the schedule, every non-None trigger
        # still pushes (identical TRIGGER_TIMEOUT sequence numbers)
        for trig in trigs:
            if trig is not None:
                if (rnd.trigger_scheduled is None
                        or trig < rnd.trigger_scheduled):
                    rnd.trigger_scheduled = trig
                self.events.push(Event(trig, EventKind.TRIGGER_TIMEOUT,
                                       rnd.idx))

    def _on_arrival(self, ev: Event) -> None:
        rnd = self.rounds[ev.round_idx]
        if (self._outages is not None and ev.ps >= 0
                and self._outages.down_at(ev.ps, ev.time)):
            # the sink this arrival was timed against is dark at the
            # arrival instant: ring failover (DESIGN.md §11)
            self._reroute_arrival(rnd, ev)
            return
        fm = self.fault
        if ev.attempt > 0 and fm is not None and fm.adaptive_backoff:
            # AIMD multiplicative decrease: a retry landed, halve the
            # delay back toward the base (DESIGN.md §11)
            self._retry_delay_s = max(fm.retry_backoff_s,
                                      self._retry_delay_s / 2.0)
        if self.tracer.enabled:
            self.tracer.instant(EV_ARRIVAL, ev.time,
                                track=f"round {ev.round_idx}",
                                sat=int(ev.sat), ps=int(ev.ps),
                                attempt=int(ev.attempt),
                                closed_round=rnd.closed)
        if rnd.closed:
            # the round committed before this model landed: its row was
            # carried over (device-resident) at commit time and re-enters
            # through a successor round's stale set (DESIGN.md §8)
            self.stats["closed_round_arrivals"] += 1
            return
        rnd.arrived_count += 1
        trig = self.policy.on_arrival(self, rnd, ev.time, sat=ev.sat)
        if trig is not None:
            if rnd.trigger_scheduled is None or trig < rnd.trigger_scheduled:
                rnd.trigger_scheduled = trig
            self.events.push(Event(trig, EventKind.TRIGGER_TIMEOUT, rnd.idx))

    def _on_trigger(self, ev: Event) -> None:
        rnd = self.rounds[ev.round_idx]
        if rnd.closed:
            return              # duplicate deadline (barrier already fired)
        if self._outages is not None and self._outages.all_down_at(ev.time):
            # no PS can aggregate right now: push the trigger to the
            # first recovery — or, when no PS recovers inside the
            # horizon, fall through and commit anyway so a starved round
            # terminates (the total-outage horizon clamp, DESIGN.md §11)
            t_up = self._outages.next_any_up(ev.time)
            if ev.time < t_up < self.sim.duration_s:
                self.stats["outage_deferrals"] += 1
                rnd.trigger_scheduled = t_up
                self.events.push(Event(t_up, EventKind.TRIGGER_TIMEOUT,
                                       rnd.idx))
                return
        t_agg, used, late = self.policy.split(self, rnd, ev.time)
        pend = [ta for (ta, _s, _ep) in self.fls._pend_meta]
        if not used and not any(ta <= t_agg for ta in pend):
            if not rnd.committed and rnd.participants:
                # sync stall with EVERY arrival late: commit the training
                # step anyway — all rows carry over as stragglers and a
                # 0-model epoch is recorded, exactly as the epoch loop
                # does for the same configuration
                self._commit(rnd, t_agg, used, late)
                return
            t_next = min(pend) if pend else None
            if (t_next is not None and not rnd.committed
                    and not rnd.expected
                    and t_next < self.sim.duration_s
                    and t_next > ev.time):
                # idle round: nothing trains and every carried straggler
                # is still in flight — re-open the round at the earliest
                # landing so the next trigger's window covers it (the
                # epoch loop instead busy-waits timeout-sized epochs).
                # Stragglers past the horizon are dropped, like the epoch
                # loop's `t >= duration` break, so this always terminates.
                rnd.t_start = t_next
                self.events.push(Event(t_next, EventKind.TRIGGER_TIMEOUT,
                                       rnd.idx))
                return
            self._maybe_close(rnd, ev.time)    # spurious: nothing to commit
            return
        self._commit(rnd, t_agg, used, late)

    # ---- outages, failover & energy (DESIGN.md §11) ------------------------

    def _next_live_ps(self, ps: int, t: float) -> Optional[int]:
        """Nearest live PS on the HAP ring at instant ``t``, by ring
        distance from ``ps`` (ties toward increasing id, matching
        ``Topology.ring_path``); None when every PS is dark."""
        H = self.fls.topo.num_ps
        for d in sorted(range(1, H), key=lambda d: (min(d, H - d), d)):
            cand = (ps + d) % H
            if not self._outages.down_at(cand, t):
                return cand
        return None

    def _on_ps_down(self, ev: Event) -> None:
        # reactive failover sweep: every open round sunk at the dead PS
        # asks its handoff policy for a live replacement sink; arrivals
        # already timed against the old sink reroute lazily at pop time
        if self.tracer.enabled:
            self.tracer.instant(EV_PS_DOWN, ev.time, track=f"ps {ev.ps}",
                                ps=int(ev.ps))
        for rnd in self.rounds.values():
            if rnd.closed or rnd.sink != ev.ps:
                continue
            new_sink = self.handoff.failover_sink(self, rnd, ev.time)
            if new_sink is not None and new_sink != rnd.sink:
                old_sink = rnd.sink
                rnd.sink = new_sink
                self.stats["sink_failovers"] += 1
                if self.tracer.enabled:
                    self.tracer.instant(EV_FAILOVER, ev.time,
                                        track=f"round {rnd.idx}",
                                        old_sink=int(old_sink),
                                        new_sink=int(new_sink))

    def _on_ps_up(self, ev: Event) -> None:
        # recovery needs no sweep: deferred opens/triggers/arrivals were
        # re-scheduled at this instant when they hit the outage, and
        # every outage decision queries the pure OutageSchedule — the
        # event marks the trace-visible recovery boundary
        if self.tracer.enabled:
            self.tracer.instant(EV_PS_UP, ev.time, track=f"ps {ev.ps}",
                                ps=int(ev.ps))

    def _reroute_arrival(self, rnd: RoundState, ev: Event) -> None:
        """An arrival popped at a sink that is dark at its arrival
        instant: relay it along the HAP ring to the next live PS
        (DESIGN.md §11) — re-timed by the ring relay delay and charged a
        fresh §9 rx grant — or hold it at the ring edge until the first
        recovery when EVERY PS is dark (dropping only when none recovers
        inside the horizon)."""
        o = self._outages
        loc = self._locate_transfer(rnd, ev.row, ev.sat, ev.time)
        if loc is None:
            return          # adopted by a same-instant commit: moot
        if not o.down_at(rnd.sink, ev.time):
            target = rnd.sink       # the round already failed over there
        else:
            target = self._next_live_ps(ev.ps, ev.time)
        if target is None:
            # total outage: hold until the first recovery, then re-check
            t_up = o.next_any_up(ev.time)
            if not ev.time < t_up < self.sim.duration_s:
                self.stats["dropped_outage"] += 1
                self._retire_transfer(rnd, loc, ev.row, ev.time,
                                      reason="outage")
                return
            self.stats["outage_deferrals"] += 1
            self._move_transfer(rnd, loc, ev.row, ev.sat, t_up)
            self.events.push(Event(t_up, EventKind.MODEL_ARRIVAL, rnd.idx,
                                   sat=ev.sat, row=ev.row,
                                   attempt=ev.attempt, ps=ev.ps))
            return
        ctn = self.plan.contention
        snap = ctn.snapshot() if ctn is not None else None
        with self.fls._seg("timing"):
            new_ta = self.plan.reroute_times(
                ev.ps, target, ev.time, self.bits,
                avoid=o.down_set(ev.time) - {ev.ps, target})
        if not np.isfinite(new_ta) or new_ta >= self.sim.duration_s:
            # both ring arcs blocked by other dark PSs, or the relay
            # lands past the horizon: roll the grant back and drop
            if snap is not None:
                ctn.restore(snap)
            self.stats["dropped_outage"] += 1
            self._retire_transfer(rnd, loc, ev.row, ev.time,
                                  reason="outage")
            return
        self.stats["rerouted_arrivals"] += 1
        if self.tracer.enabled:
            self.tracer.instant(EV_REROUTE, ev.time,
                                track=f"round {rnd.idx}", sat=int(ev.sat),
                                ps_from=int(ev.ps), ps_to=int(target),
                                t_arrival=float(new_ta))
        self._move_transfer(rnd, loc, ev.row, ev.sat, new_ta)
        self.events.push(Event(new_ta, EventKind.MODEL_ARRIVAL, rnd.idx,
                               sat=ev.sat, row=ev.row,
                               attempt=ev.attempt, ps=target))

    def _defer_uplink(self, rnd: RoundState, ev: Event,
                      ta_old: float) -> None:
        """A depleted satellite's uplink waits for its battery: re-time
        the transfer from the first instant the transmit energy is
        affordable, or drop it when that never happens inside the
        horizon (DESIGN.md §11)."""
        en = self.energy
        loc = self._locate_transfer(rnd, ev.row, ev.sat, ta_old)
        if loc is None:
            return
        t_aff = en.time_to_afford(ev.sat, ev.time, en.tx_j)
        if t_aff is None or t_aff >= self.sim.duration_s:
            self.stats["dropped_energy"] += 1
            self._retire_transfer(rnd, loc, ev.row, ev.time,
                                  reason="energy")
            return
        ctn = self.plan.contention
        snap = ctn.snapshot() if ctn is not None else None
        with self.fls._seg("timing"):
            t_arr, _haps = self.plan.uplink_times(
                [ev.sat], [t_aff], self.bits, rnd.sink)
        new_ta = float(t_arr[0])
        if not np.isfinite(new_ta) or new_ta >= self.sim.duration_s:
            if snap is not None:
                ctn.restore(snap)
            self.stats["dropped_energy"] += 1
            self._retire_transfer(rnd, loc, ev.row, ev.time,
                                  reason="energy")
            return
        en.try_drain(ev.sat, t_aff, en.tx_j)    # affordable by construction
        self.stats["energy_deferrals"] += 1
        if self.tracer.enabled:
            self.tracer.instant(EV_ENERGY_DEFER, ev.time,
                                track=f"round {rnd.idx}", sat=int(ev.sat),
                                t_affordable=float(t_aff),
                                t_arrival=float(new_ta))
        self._move_transfer(rnd, loc, ev.row, ev.sat, new_ta)
        fm = self.fault
        kind = (EventKind.TRANSFER_FAILED
                if (fm.has_loss
                    and fm.transfer_fails(ev.sat, rnd.idx, 0,
                                          ps=rnd.sink, t=new_ta))
                else EventKind.MODEL_ARRIVAL)
        self.events.push(Event(new_ta, kind, rnd.idx, sat=ev.sat,
                               row=ev.row, ps=rnd.sink))

    # ---- lossy transfers: retry / backoff / drop (DESIGN.md §10) -----------

    def _locate_transfer(self, rnd: RoundState, row: int, sat: int,
                         ta: float):
        """Where an in-flight transfer's bookkeeping lives at failure
        time: ("expected", i) while its round is uncommitted, ("pend", i)
        after a commit carried it as a straggler, or None when a commit
        tied at exactly the failure instant already adopted it (the model
        made it into an aggregation — the failure is moot)."""
        if not rnd.committed:
            for i, a in enumerate(rnd.expected):
                if a[2] == row:
                    return ("expected", i)
            return None
        for i, (pta, ps, _ep) in enumerate(self.fls._pend_meta):
            if ps == sat and pta == ta:
                return ("pend", i)
        return None

    def _move_transfer(self, rnd: RoundState, loc, row: int, sat: int,
                       new_ta: float) -> None:
        """Re-time a pending transfer to its retry arrival instant."""
        kind, i = loc
        if kind == "expected":
            rnd.expected[i] = (new_ta, sat, row)
            rnd.expected.sort(key=lambda a: a[0])
            rnd.arr_time[row] = new_ta
        else:
            pta, ps, ep = self.fls._pend_meta[i]
            self.fls._pend_meta[i] = (new_ta, ps, ep)

    def _retire_transfer(self, rnd: RoundState, loc, row: int,
                         t: float, reason: str = "") -> None:
        """Drop an update whose transfer can never complete: remove its
        bookkeeping (the carried device row too — _pend_dev rows are
        indexed parallel to _pend_meta) and let the trigger policy rescue
        a round that now waits on nothing."""
        fls = self.fls
        if self.tracer.enabled:
            self.tracer.instant(EV_DROP, t, track=f"round {rnd.idx}",
                                row=int(row), reason=reason)
        kind, i = loc
        if kind == "pend":
            keep = [j for j in range(len(fls._pend_meta)) if j != i]
            fls._pend_meta = [fls._pend_meta[j] for j in keep]
            fls._pend_dev = (gather_rows(fls._pend_dev, keep)
                             if keep else None)
        rnd.expected = [a for a in rnd.expected if a[2] != row]
        rnd.arr_time.pop(row, None)
        hook = getattr(self.policy, "on_expected_drop", None)
        trig = hook(self, rnd, t) if hook is not None else None
        if trig is not None and not rnd.closed:
            if rnd.trigger_scheduled is None or trig < rnd.trigger_scheduled:
                rnd.trigger_scheduled = trig
            self.events.push(Event(trig, EventKind.TRIGGER_TIMEOUT, rnd.idx))
        self._maybe_close(rnd, t)

    def _on_transfer_failed(self, ev: Event) -> None:
        fm = self.fault
        rnd = self.rounds[ev.round_idx]
        self.stats["transfers_failed"] += 1
        if self.tracer.enabled:
            self.tracer.instant(EV_TRANSFER_FAILED, ev.time,
                                track=f"round {ev.round_idx}",
                                sat=int(ev.sat), attempt=int(ev.attempt),
                                ps=int(ev.ps))
        loc = self._locate_transfer(rnd, ev.row, ev.sat, ev.time)
        if loc is None:
            return          # adopted by a same-instant commit: chain ends
        attempt = ev.attempt + 1
        new_ta = np.inf
        snap = None
        ctn = self.plan.contention
        if attempt <= fm.max_retries:
            if fm.adaptive_backoff:
                # AIMD additive increase (DESIGN.md §11): the step is the
                # sink rx pool's observed mean queue wait (at least the
                # configured base), capped at retry_backoff_cap_s; the
                # applied delays land in stats["backoff_delays_s"]
                delay = self._retry_delay_s
                wait = 0.0
                if ctn is not None and ctn.rx.grants:
                    wait = ctn.rx.queue_wait_s / ctn.rx.grants
                self._retry_delay_s = min(
                    fm.retry_backoff_cap_s,
                    self._retry_delay_s + max(fm.retry_backoff_s, wait))
                # bounded histogram, not an unbounded list: the compat
                # view renders count/sum/min/max/p50/p95/p99
                self.metrics.observe("backoff_delays_s", float(delay))
            else:
                delay = fm.retry_delay_s(ev.attempt)
            t_retry = ev.time + delay
            if self.energy is not None:
                # retransmissions pay transmit energy too: wait for the
                # battery when depleted, drop when it never recovers
                t_aff = self.energy.time_to_afford(ev.sat, t_retry,
                                                   self.energy.tx_j)
                if t_aff is None:
                    self.stats["dropped_energy"] += 1
                    self._retire_transfer(rnd, loc, ev.row, ev.time,
                                          reason="energy")
                    return
                t_retry = max(t_retry, t_aff)
            if t_retry < self.sim.duration_s:
                # the retransmission re-enters the shared channel pools: a
                # fresh uplink (and rx grant) from the backoff instant
                snap = ctn.snapshot() if ctn is not None else None
                with self.fls._seg("timing"):
                    t_arr, _haps = self.plan.uplink_times(
                        [ev.sat], [t_retry], self.bits, rnd.sink)
                new_ta = float(t_arr[0])
        else:
            self.stats["dropped_after_max_retries"] += 1
            self._retire_transfer(rnd, loc, ev.row, ev.time,
                                  reason="max_retries")
            return
        if not np.isfinite(new_ta) or new_ta >= self.sim.duration_s:
            # unreachable sink or a landing past the horizon: the transfer
            # will never happen, so its channel grant is rolled back (no
            # occupancy ghosts — the same contract as aborted speculative
            # opens) and the update is dropped
            if snap is not None:
                ctn.restore(snap)
            self.stats["dropped_unreachable"] += 1
            self._retire_transfer(rnd, loc, ev.row, ev.time,
                                  reason="unreachable")
            return
        self.stats["transfer_retries"] += 1
        if self.tracer.enabled:
            self.tracer.instant(EV_TRANSFER_RETRY, ev.time,
                                track=f"round {rnd.idx}", sat=int(ev.sat),
                                attempt=int(attempt),
                                delay_s=float(delay),
                                t_arrival=float(new_ta))
        if self.energy is not None:
            self.energy.try_drain(ev.sat, t_retry, self.energy.tx_j)
        self._move_transfer(rnd, loc, ev.row, ev.sat, new_ta)
        kind = (EventKind.TRANSFER_FAILED
                if fm.transfer_fails(ev.sat, rnd.idx, attempt,
                                     ps=rnd.sink, t=new_ta)
                else EventKind.MODEL_ARRIVAL)
        self.events.push(Event(new_ta, kind, rnd.idx, sat=ev.sat,
                               row=ev.row, attempt=attempt, ps=rnd.sink))

    def _on_handoff(self, ev: Event) -> None:
        # the round stays registered: stale TRAIN_DONE / MODEL_ARRIVAL
        # events for it may still be queued and look their round up
        rnd = self.rounds.get(ev.round_idx)
        if rnd is None:
            # a round open deferred through a total PS outage
            # (DESIGN.md §11, round_idx=-1): restart it from the recorded
            # source at the recovery instant
            if self._open_count() < self.max_in_flight:
                self._start_round(ev.time, max(ev.sat, 0),
                                  pipelined=ev.pipelined)
            return
        if self._open_count() >= self.max_in_flight:
            return              # pipeline full; a close will refill it
        source, sink = self.handoff.next_round(self, rnd, ev.time)
        opened = self._start_round(ev.time, source, sink,
                                   pipelined=ev.pipelined)
        if opened is None and ev.pipelined:
            # every eligible satellite is busy: retry when the next one
            # frees up (strictly later + horizon-guarded, so this
            # terminates)
            busy = self._busy_until[self._busy_until > ev.time]
            if busy.size:
                t_retry = float(busy.min())
                if ev.time < t_retry < self.sim.duration_s:
                    self.events.push(Event(t_retry, EventKind.SINK_HANDOFF,
                                           ev.round_idx, pipelined=True))

    # ---- commit ------------------------------------------------------------

    def _commit(self, rnd: RoundState, t_agg: float, used, late) -> None:
        fls, spec = self.fls, self.spec
        participants = rnd.participants if not rnd.committed else []
        ids_np = rnd.ids_np if not rnd.committed else np.zeros(0, np.int32)
        # adoption telemetry: cross_round counts only stragglers that
        # originated in ANOTHER round (FedAsync drains its own round's
        # carried rows — epoch stamp equal to rnd.beta — which is not a
        # round boundary); the total adopted count feeds the
        # conservation ledger alongside the rows used directly
        adopted = cross = 0
        for (ta, _s, ep) in fls._pend_meta:
            if ta <= t_agg:
                adopted += 1
                cross += int(ep != rnd.beta)
        self.stats["cross_round_adoptions"] += cross
        self.stats["arrivals_committed"] += len(used) + adopted
        prof = getattr(self.prog, "profiler", None)
        if prof is not None:
            # dispatches-per-trigger attribution (obs/profile.py): the
            # fused commit below runs one step for this trigger (none when
            # the commit has nothing to train)
            prof.trigger()
        # scenario-batched sweeps (DESIGN.md §13): this runtime is one of
        # several whose steps multiplex through a shared DispatchBatcher;
        # its profiler counts *physical* steps, so every scenario's
        # trigger feeds the shared denominator
        bprof = getattr(self.sim.dispatcher, "profiler", None)
        if bprof is not None:
            bprof.trigger()
        t_trigger = t_agg
        # the round trains here, from the global model as it stands at
        # commit time; its models are stamped with the round's own epoch
        out = fls._fused_commit(self.prog, self.beta, ids_np, participants,
                                t_agg, used, late, train_epoch=rnd.beta)
        rnd.committed = True
        t_agg, metas, info, _losses = out
        if spec.agg_mode == "interval":
            t_agg = max(t_agg, rnd.t_start + spec.interval_s)
        if self.tracer.enabled:
            # the trigger/collection window: first used arrival -> the
            # aggregation instant, then the commit boundary instants
            track = f"round {rnd.idx}"
            t0 = min((a[0] for a in used), default=t_trigger)
            self.tracer.span(SPAN_TRIGGER, t0, t_agg, track=track,
                             used=len(used), late=len(late),
                             adopted=adopted)
            self.tracer.instant(EV_TRIGGER, t_trigger, track=track,
                                epoch=int(self.beta))
            self.tracer.instant(EV_DISPATCH, t_agg, track=track,
                                epoch=int(self.beta),
                                participants=len(participants))
            self.tracer.instant(EV_COMMIT, t_agg, track=track,
                                epoch=int(self.beta), used=len(used),
                                late=len(late), adopted=adopted)
        # views into w_flat: stream order runs the evaluation before the
        # next commit updates w_flat in place
        w_tree = (fls._spec.unflatten(fls._w_flat)
                  if fls.evaluator is not None else None)
        acc = fls._record_epoch(self.history, self.beta, t_agg, metas, info,
                                self.lazy_eval, w_tree)
        self.beta += 1
        if self.target is not None and acc >= self.target:
            self._stop = True
            return
        if self.beta >= self.max_epochs:
            self._stop = True
            return
        self._maybe_close(rnd, t_agg)

    def _maybe_close(self, rnd: RoundState, t: float) -> None:
        if not rnd.closed and rnd.committed and \
                self.policy.round_complete(rnd):
            rnd.closed = True
            if rnd.span >= 0:
                self.tracer.end(rnd.span, t)
            self.events.push(Event(t, EventKind.SINK_HANDOFF, rnd.idx))
