"""Pluggable trigger + handoff policies for the event runtime
(DESIGN.md §7; the per-group deadlines and the handoff contract are §8),
as the JAX package's ``repro.sched.policies``.

A *trigger* policy decides WHEN the sink PS aggregates; WHAT the update
computes (eqs. 4/13/14, the per-arrival EMA, the interval emulation) stays
with the strategy's ``agg_mode`` (`core/aggregation.epoch_weight_vector`),
so a policy is pure scheduling logic over a round's expected/observed
arrivals:

* ``round_deadline``  — absolute TRIGGER_TIMEOUT to schedule when a round
  opens (the sync barrier's straggler stall; the idle timeout of a round
  that only drains carried stragglers), or None;
* ``on_arrival``      — absolute trigger time a MODEL_ARRIVAL should
  schedule (AsyncFLEO schedules first-arrival + idle timeout — or, with
  ``group_timeouts`` set, one deadline per divergence group of the
  arriving satellite, DESIGN.md §8; the sync barrier fires when the last
  expected model lands; FedAsync fires on every arrival), or None;
* ``split``           — at trigger time, the (t_agg, used, late) partition
  of the round's arrivals.  AsyncFLEO and the sync barrier delegate to
  ``FLSimulation._trigger`` so the event runtime reproduces the epoch
  loop's aggregation instants *exactly* (the parity contract in
  tests/test_sched.py);
* ``round_complete``  — whether a commit closes the round (PS roles swap).

A *handoff* policy decides WHERE the next round runs when a SINK_HANDOFF
fires (DESIGN.md §8 handoff contract):

* ``next_round(rt, rnd, t) -> (source, sink)`` — the PS that broadcasts
  the next global model and the PS that collects its arrivals.
  ``RingHandoff`` reproduces the paper's §IV-B3 role swap (the previous
  sink becomes the source, the farthest ring HAP the sink) and is the
  ``max_in_flight=1`` parity default; ``NextContactHandoff`` consults the
  compiled ``ContactPlan`` (``next_contact_by_node``) and picks the PS
  with the earliest upcoming satellite contact as source (and, with >1
  PS, the next-earliest as sink) — the contact-plan-driven downlink
  scheduling of arXiv:2302.13447.
* ``next_open_time(rt, rnd) -> float | None`` — when a *pipelined*
  successor round may open while ``rnd`` is still in flight (None =
  never).  The default is the round's first expected arrival: by then
  the fastest satellites are done training and the constellation can
  absorb the next downlink while the current collection window runs.
* ``failover_sink(rt, rnd, t) -> int | None`` — the replacement sink for
  an open round whose sink PS just went dark (a PS_DOWN event,
  DESIGN.md §11).  ``RingHandoff`` picks the nearest live ring PS;
  ``NextContactHandoff`` prefers the live PS with the earliest upcoming
  satellite contact (least-rx-busy tiebreak).  None = every PS is dark;
  the round keeps its sink and its arrivals hold at the ring edge until
  a recovery.

Policies are selected from the strategy table (`fl/strategies.py`):
``StrategySpec.sched_policy`` names the trigger policy (sync strategies
default to the barrier, ``per_arrival`` aggregation to FedAsync,
everything else to the AsyncFLEO window), ``StrategySpec.handoff_policy``
names the handoff policy ("" -> ring swap), and
``StrategySpec.group_timeouts`` feeds the AsyncFLEO policy's per-group
deadlines.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.simulator import split_min_models
from repro_torch.obs.trace import EV_WINDOW_SHRUNK

Arrival = Tuple[float, int, int]                 # (t_arrival, sat, bank row)


@dataclasses.dataclass
class AsyncFLEOPolicy:
    """AsyncFLEO (Alg. 2 trigger): the first arrival of a round opens a
    collection window of ``agg_timeout_s``; everything that lands inside
    aggregates in ONE fused dispatch, later arrivals carry over as
    stragglers.  ``min_models`` backstop handled by ``_trigger``.

    ``group_timeouts`` (group id -> window seconds; -1 = not-yet-grouped
    orbits) turns the single window into per-divergence-group deadlines
    (DESIGN.md §8): the first arrival FROM EACH GROUP opens that group's
    window and the round commits at the earliest group deadline.  Empty
    (the default) keeps the single global window — bit-identical to the
    epoch loop, which the parity tests pin.

    ``rx_backlog_threshold_s`` (from ``StrategySpec``, DESIGN.md §10)
    makes the windows contention-aware: when the sink PS's pending
    rx-channel backlog exceeds the threshold at window-open time, the
    window is multiplied by ``rx_backlog_window_scale`` — a congested
    sink commits sooner instead of idling for arrivals that are stuck in
    the rx queue anyway.  None (the default) never scales and keeps the
    ``split`` delegation to ``_trigger`` — bit-identical windows."""
    name: str = "asyncfleo"
    group_timeouts: Dict[int, float] = dataclasses.field(
        default_factory=dict)
    rx_backlog_threshold_s: Optional[float] = None
    rx_backlog_window_scale: float = 0.5

    def window_s(self, rt, group: int) -> float:
        return float(self.group_timeouts.get(group, rt.sim.agg_timeout_s))

    def _scaled(self, rt, rnd, t: float, window: float) -> float:
        """Contention-aware shrink of an idle window (no-op when the
        threshold is off or the sink's rx pool is under it)."""
        thr = self.rx_backlog_threshold_s
        if thr is None:
            return window
        ctn = getattr(rt.plan, "contention", None)
        if ctn is None or ctn.backlog("rx", rnd.sink, t) <= thr:
            return window
        stats = getattr(rt, "stats", None)
        if stats is not None:
            stats["shrunk_windows"] = stats.get("shrunk_windows", 0) + 1
        tracer = getattr(rt, "tracer", None)
        if tracer is not None and tracer.enabled:
            tracer.instant(EV_WINDOW_SHRUNK, t, track=f"round {rnd.idx}",
                           window_s=float(window),
                           scale=float(self.rx_backlog_window_scale))
        return window * self.rx_backlog_window_scale

    def round_deadline(self, rt, rnd) -> Optional[float]:
        if rnd.expected:                 # first arrival opens the window
            return None
        return min(rnd.t_start + rt.sim.agg_timeout_s, rt.sim.duration_s)

    def on_arrival(self, rt, rnd, t: float, sat: int = -1
                   ) -> Optional[float]:
        if not self.group_timeouts:
            if rnd.trigger_scheduled is None:
                return min(t + self._scaled(rt, rnd, t, rt.sim.agg_timeout_s),
                           rt.sim.duration_s)
            return None
        g = rt.group_of_sat(sat)
        if g in rnd.group_first:         # group window already open
            return None
        rnd.group_first[g] = t
        return min(t + self._scaled(rt, rnd, t, self.window_s(rt, g)),
                   rt.sim.duration_s)

    def on_arrival_batch(self, rt, rnd, t: float, sats) -> List[
            Optional[float]]:
        """Batched ``on_arrival`` for a same-instant arrival run
        (DESIGN.md §14).  Contract shared by every policy: the policy
        performs the per-arrival ``rnd.arrived_count`` increments itself
        and returns one trigger (or None) per arrival, exactly what the
        sequential increment-then-call loop would have produced — in
        particular it must account for the runtime's between-arrival
        ``trigger_scheduled`` updates.  Here: without group deadlines
        only the FIRST arrival of the run can open the window (the
        sequential loop sets ``trigger_scheduled`` before the second
        call); with groups, per-arrival calls are already independent of
        ``trigger_scheduled`` and delegate unchanged."""
        if not self.group_timeouts:
            rnd.arrived_count += len(sats)
            out: List[Optional[float]] = [None] * len(sats)
            if rnd.trigger_scheduled is None:
                out[0] = min(
                    t + self._scaled(rt, rnd, t, rt.sim.agg_timeout_s),
                    rt.sim.duration_s)
            return out
        out = []
        for s in sats:
            rnd.arrived_count += 1
            out.append(self.on_arrival(rt, rnd, t, sat=s))
        return out

    def split(self, rt, rnd, t_fired: float):
        if not self.group_timeouts and self.rx_backlog_threshold_s is None:
            # delegate to the epoch loop's trigger: identical aggregation
            # instants (the parity contract)
            return rt.fls._trigger(rnd.expected, rnd.t_start)
        # per-group / contention-aware mode: the fired deadline IS the
        # aggregation instant (with shrink active, `_trigger` would
        # recompute the unshrunk window); the min_models backstop is the
        # SAME helper `_trigger`'s async branch uses, so the two can't
        # drift (and tied arrivals at the backstop instant are carried,
        # not dropped)
        t_agg = min(t_fired, rt.sim.duration_s)
        return split_min_models(rnd.expected, t_agg, rt.sim.min_models)

    def round_complete(self, rnd) -> bool:
        return True

    def on_expected_drop(self, rt, rnd, t: float) -> Optional[float]:
        """A lossy transfer was dropped from ``rnd.expected`` after max
        retries (DESIGN.md §10).  When nothing is left in flight and no
        window is pending the round can never resolve on its own —
        trigger now (a 0-model commit / carried-straggler drain) instead
        of hanging until the event queue drains."""
        if not rnd.expected and rnd.trigger_scheduled is None:
            return t
        return None


@dataclasses.dataclass
class SyncBarrierPolicy:
    """Synchronous FedAvg barrier: aggregate when every expected model has
    arrived, or at the straggler stall ``sync_stall_s`` — whichever comes
    first (the GS-FedAvg baselines: fedisl / fedhap / Razmi-style
    ground-station FL)."""
    name: str = "sync"

    def round_deadline(self, rt, rnd) -> Optional[float]:
        if not rnd.expected:
            return rnd.t_start               # nothing to wait for
        # horizon-clamped like the AsyncFLEO / FedAsync deadlines: a
        # barrier stall must not fire (and commit an epoch) past the end
        # of the simulation
        return min(rnd.t_start + rt.sim.sync_stall_s, rt.sim.duration_s)

    def on_arrival(self, rt, rnd, t: float, sat: int = -1
                   ) -> Optional[float]:
        if rnd.arrived_count == len(rnd.expected):
            return t                         # barrier complete: fire now
        return None

    def on_arrival_batch(self, rt, rnd, t: float, sats) -> List[
            Optional[float]]:
        """Sequential semantics: the count walks base+1 .. base+n and the
        barrier fires at the single index where it equals the expected
        size — a naive increment-all-then-test would fire every arrival
        of the completing run (duplicate TRIGGER pushes, sequence-number
        drift, broken bit-parity)."""
        base = rnd.arrived_count
        n_exp = len(rnd.expected)
        rnd.arrived_count = base + len(sats)
        return [t if base + i + 1 == n_exp else None
                for i in range(len(sats))]

    def split(self, rt, rnd, t_fired: float):
        return rt.fls._trigger(rnd.expected, rnd.t_start)

    def round_complete(self, rnd) -> bool:
        return True

    def on_expected_drop(self, rt, rnd, t: float) -> Optional[float]:
        """A dropped transfer shrinks the barrier: when every *surviving*
        expected model has already arrived the barrier is complete now —
        fire instead of stalling until ``sync_stall_s``."""
        if rnd.arrived_count >= len(rnd.expected):
            return t
        return None


@dataclasses.dataclass
class FedAsyncPolicy:
    """FedAsync-style immediate aggregation: every MODEL_ARRIVAL triggers
    its own (small) aggregation — the first one of a round consumes the
    fused training dispatch (remaining rows carry over as pending
    stragglers), later ones drain the carried matrix as they land.  The
    round closes after its last expected arrival."""
    name: str = "per_arrival"

    def round_deadline(self, rt, rnd) -> Optional[float]:
        if rnd.expected:
            return None
        return min(rnd.t_start + rt.sim.agg_timeout_s, rt.sim.duration_s)

    def on_arrival(self, rt, rnd, t: float, sat: int = -1
                   ) -> Optional[float]:
        return t

    def on_arrival_batch(self, rt, rnd, t: float, sats) -> List[
            Optional[float]]:
        # every arrival fires: n triggers at t, pushed in arrival order
        # by the runtime's batch tail — same sequence numbers as the
        # sequential loop's per-arrival pushes
        rnd.arrived_count += len(sats)
        return [t] * len(sats)

    def split(self, rt, rnd, t_fired: float):
        if not rnd.committed:
            used = [a for a in rnd.expected if a[0] <= t_fired]
            late = [a for a in rnd.expected if a[0] > t_fired]
            return t_fired, used, late
        return t_fired, [], []               # drain carried arrivals only

    def round_complete(self, rnd) -> bool:
        return rnd.arrived_count >= len(rnd.expected)

    def on_expected_drop(self, rt, rnd, t: float) -> Optional[float]:
        """Same rescue as the AsyncFLEO window: an uncommitted round whose
        every transfer was dropped must still resolve (``round_complete``
        is re-checked by the runtime after the drop either way)."""
        if not rnd.expected and rnd.trigger_scheduled is None:
            return t
        return None


POLICIES = {
    "asyncfleo": AsyncFLEOPolicy,
    "sync": SyncBarrierPolicy,
    "per_arrival": FedAsyncPolicy,
}


def make_policy(spec, name: str = ""):
    """Policy for a strategy spec: the explicit ``spec.sched_policy`` when
    set, else derived — sync strategies get the barrier, ``per_arrival``
    aggregation gets FedAsync, everything else the AsyncFLEO window.
    ``spec.group_timeouts`` pairs feed the AsyncFLEO policy's per-group
    deadlines (DESIGN.md §8)."""
    key = name or getattr(spec, "sched_policy", "")
    if not key:
        if spec.sync:
            key = "sync"
        elif spec.agg_mode == "per_arrival":
            key = "per_arrival"
        else:
            key = "asyncfleo"
    if key not in POLICIES:
        raise KeyError(f"unknown scheduler policy {key!r}; "
                       f"available: {sorted(POLICIES)}")
    policy = POLICIES[key]()
    gt = dict(getattr(spec, "group_timeouts", ()) or ())
    if gt and isinstance(policy, AsyncFLEOPolicy):
        policy.group_timeouts = gt
    if isinstance(policy, AsyncFLEOPolicy):
        policy.rx_backlog_threshold_s = getattr(
            spec, "rx_backlog_threshold_s", None)
        policy.rx_backlog_window_scale = float(getattr(
            spec, "rx_backlog_window_scale", 0.5))
    return policy


# ---- sink handoff (where the next round runs, DESIGN.md §8) ----------------


@dataclasses.dataclass
class RingHandoff:
    """The paper's §IV-B3 role swap: the previous round's sink becomes
    the next source, and the sink is the ring HAP farthest from it
    (`topology.sink_of`).  This is the ``max_in_flight=1`` parity
    default — the epoch loop hard-codes exactly this rotation."""
    name: str = "ring"

    def next_round(self, rt, rnd, t: float) -> Tuple[int, int]:
        source = rnd.sink
        return source, rt.fls.topo.sink_of(source)

    def next_open_time(self, rt, rnd) -> Optional[float]:
        # pipeline a successor at the round's first expected arrival:
        # the fastest satellites are free again and the sink's collection
        # window runs concurrently with the next downlink
        return rnd.expected[0][0] if rnd.expected else None

    def failover_sink(self, rt, rnd, t: float) -> Optional[int]:
        # PS outage failover (DESIGN.md §11): the nearest live ring PS
        # takes over collection; None when every PS is dark
        return rt._next_live_ps(rnd.sink, t)


@dataclasses.dataclass
class NextContactHandoff(RingHandoff):
    """Contact-plan-driven handoff: the next round's source is the PS
    with the *earliest upcoming satellite contact* at handoff time
    (``ContactPlan.next_contact_by_node``), so the new global model
    starts moving as soon as any link exists; with more than one PS the
    sink is the next-earliest-contact PS (it can start collecting
    soonest).  Ties on contact time break toward the PS with the lowest
    channel occupancy (pending tx backlog for the source, rx backlog for
    the sink — `ContentionModel.backlog`, DESIGN.md §9), so under finite
    ``ps_channels`` overlapping rounds spread across the least-loaded
    HAPs, the FedHAP-style collaborative-transfer effect.  Without a
    contention model every backlog is 0 and the lowest PS id wins —
    identical to the historical ``argmin``.  Falls back to the ring swap
    when the plan is exhausted."""
    name: str = "next_contact"

    @staticmethod
    def _least_busy(rt, candidates: List[int], t: float, kind: str) -> int:
        ctn = getattr(rt.plan, "contention", None)
        if ctn is None or len(candidates) == 1:
            return candidates[0]
        return min(candidates, key=lambda p: (ctn.backlog(kind, p, t), p))

    def next_round(self, rt, rnd, t: float) -> Tuple[int, int]:
        tv = rt.plan.next_contact_by_node(t)
        if not np.isfinite(tv).any():
            return RingHandoff.next_round(self, rt, rnd, t)
        cands = [int(p) for p in np.flatnonzero(tv == tv.min())]
        source = self._least_busy(rt, cands, t, "tx")
        if len(tv) > 1:
            rest = tv.copy()
            rest[source] = np.inf
            if np.isfinite(rest).any():
                sc = [int(p) for p in np.flatnonzero(rest == rest.min())]
                sink = self._least_busy(rt, sc, t, "rx")
            else:
                sink = rt.fls.topo.sink_of(source)
        else:
            sink = source
        return source, sink

    def failover_sink(self, rt, rnd, t: float) -> Optional[int]:
        # among LIVE PSs (excluding the dead sink), prefer the one whose
        # next satellite contact comes earliest — it can resume
        # collecting soonest — with the §9 least-rx-busy tiebreak; falls
        # back to the ring nearest-live rule when no live PS has a
        # finite upcoming contact
        o = rt._outages
        tv = rt.plan.next_contact_by_node(t)
        live = [p for p in range(len(tv))
                if p != rnd.sink and not o.down_at(p, t)
                and np.isfinite(tv[p])]
        if not live:
            return RingHandoff.failover_sink(self, rt, rnd, t)
        best = min(tv[p] for p in live)
        cands = [p for p in live if tv[p] == best]
        return self._least_busy(rt, cands, t, "rx")


HANDOFF_POLICIES = {
    "ring": RingHandoff,
    "next_contact": NextContactHandoff,
}


def make_handoff_policy(spec, name: str = ""):
    """Handoff policy for a strategy spec ("" -> the ring role swap)."""
    key = name or getattr(spec, "handoff_policy", "") or "ring"
    if key not in HANDOFF_POLICIES:
        raise KeyError(f"unknown handoff policy {key!r}; "
                       f"available: {sorted(HANDOFF_POLICIES)}")
    return HANDOFF_POLICIES[key]()
