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

Not ported yet: the reference's fault handling (DESIGN.md §10-§11: lossy
transfers and their retries, PS outages and ring failover, energy
budgets, fault-aware selection) comes with ROADMAP queue A item 10, and
its dispatch profiler and scenario-batching hooks with items 11 and 12;
``FLSimulation`` refuses those options.  The stats keep the reference's
whole key set, so ``dict(runtime.stats)`` equals the reference's.

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

from repro_torch.obs.metrics import MetricRegistry, StatsView
from repro_torch.obs.trace import (EV_ARRIVAL, EV_COMMIT, EV_DISPATCH,
                                   EV_TRIGGER, NULL_TRACER, SPAN_RECRUIT,
                                   SPAN_ROUND, SPAN_TRANSFERS, SPAN_TRIGGER)
from repro_torch.sched.events import Event, EventKind, EventQueue
from repro_torch.sched.policies import make_handoff_policy, make_policy

# the ``runtime.stats`` key set, in its historical order — the StatsView
# compatibility contract: same keys, same values, same JSON shape as the
# reference's, backed by the obs/metrics registry (DESIGN.md §12).  The
# fault counters stay at 0 until the fault runtime (item 10) is ported
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

# AIMD backoff delays of the fault runtime — a bounded histogram
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
    # the sink the round's arrival times were computed against at open
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
        self.bits, self.prog = fls._init_run(w0)
        self.max_epochs = max_epochs
        self.target = target_accuracy
        self.lazy_eval = (target_accuracy is None
                          and hasattr(fls.evaluator, "eval_async"))
        self.history = []
        self.beta = 0
        self._stop = False
        self._busy_until[:] = 0.0
        self._start_round(0.0, source=0)
        handlers = {
            EventKind.TRAIN_DONE: self._on_train_done,
            EventKind.MODEL_ARRIVAL: self._on_arrival,
            EventKind.TRIGGER_TIMEOUT: self._on_trigger,
            EventKind.SINK_HANDOFF: self._on_handoff,
        }
        tracer = self.tracer
        t_last = 0.0
        # batched pops (DESIGN.md §14): same-(time, kind, round) runs
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
        # timing a round consumes channel grants when a ContentionModel is
        # attached (DESIGN.md §9); if the open aborts below, roll the
        # grants back so a round that never ran leaves no occupancy behind
        ctn = self.plan.contention
        snap = ctn.snapshot() if ctn is not None else None
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
            return None     # nobody free to train: the retry in
            #                 _on_handoff (or the close handoff) covers it
        if not expected and not fls._pend_meta:
            if snap is not None:
                ctn.restore(snap)
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
            # TRAIN_DONE -> last expected sink arrival)
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
        self.events.push(Event(ta, EventKind.MODEL_ARRIVAL, rnd.idx,
                               sat=ev.sat, row=ev.row, ps=rnd.open_sink))

    def _on_train_done_batch(self, evs: List[Event]) -> None:
        """Batched TRAIN_DONE run (same time + round, DESIGN.md §14):
        every member converts to its MODEL_ARRIVAL push — one bulk
        ``push_many`` with per-event order preserved, which is exactly
        the sequential loop's push sequence."""
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
        arrival.  Tracing keeps the per-event path (one instant per
        arrival)."""
        if self.tracer.enabled:
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

    def _on_handoff(self, ev: Event) -> None:
        # the round stays registered: stale TRAIN_DONE / MODEL_ARRIVAL
        # events for it may still be queued and look their round up
        rnd = self.rounds[ev.round_idx]
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
