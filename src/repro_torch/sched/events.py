"""Discrete-event primitives for the async FL runtime (DESIGN.md §7-§8),
as the JAX package's ``repro.sched.events``.

Seven event kinds drive a federated round (FLGo's ``system_simulator``
separates virtual-clock state the same way):

* ``TRAIN_DONE``     — a satellite finished its J local iterations;
* ``MODEL_ARRIVAL``  — a local model reached the sink PS (after the
  uplink relay chain);
* ``TRIGGER_TIMEOUT``— a policy-scheduled aggregation deadline fired
  (AsyncFLEO's idle timeout, the sync barrier's straggler stall, a
  per-divergence-group deadline — DESIGN.md §8);
* ``SINK_HANDOFF``   — open the next round.  Pushed when a round closes
  (PS roles swap, §IV-B3) and, in pipelined mode, *speculatively* while
  a round is still in flight (``pipelined=True``) so up to
  ``max_in_flight`` rounds overlap (DESIGN.md §8);
* ``TRANSFER_FAILED``— a sat->PS model transfer was lost in flight
  (FaultModel Bernoulli draw, DESIGN.md §10).  Fires at the would-be
  arrival instant; the handler re-times the retransmission with
  exponential backoff through the contact plan (a fresh rx-channel
  grant) up to ``FaultModel.max_retries`` attempts, then drops the
  update.  ``attempt`` counts the failures so far in the chain;
* ``PS_DOWN`` / ``PS_UP`` — a parameter server enters / leaves a
  FaultModel outage window (DESIGN.md §11).  ``ps`` names the server;
  ``round_idx`` is -1 (outages are not addressed to a round).  PS_DOWN
  triggers ring failover of every open round sunk at the dead PS; the
  schedule itself is queried purely (``OutageSchedule``), so PS_UP is
  telemetry plus a wake-up point for deferred work.

The kind ids, and with them every tie order, equal the reference's.

Every event carries the ``round_idx`` it is addressed to, so with
several rounds in flight a ``MODEL_ARRIVAL`` always commits into the
round that scheduled it; arrivals addressed to an already-closed round
are ignored here and reach the successor round through the simulator's
carried-straggler set instead (§8 late-arrival semantics).

``EventQueue`` is a plain binary heap keyed on (time, sequence) — the
sequence number makes same-instant pops deterministic (FIFO), which the
runtime-vs-epoch-loop parity tests rely on.  Events are immutable;
handlers look up mutable round state on the runtime by ``round_idx``.

**Batched pops** (DESIGN.md §14): ``pop_batch`` drains the maximal FIFO
run of events sharing (time, kind, round_idx) at the heap top — the
shape a mega-constellation trigger produces (10^4 MODEL_ARRIVALs in one
dt-slice) — so the runtime touches Python round state once per run, not
once per satellite.  Batching is bit-exact by construction: any event a
run member's handler pushes has time >= t and a sequence number greater
than every remaining run member's (those were pushed earlier), so it
can never pop before the rest of the run; and since pops don't consume
sequence numbers, every push gets the same sequence number it would
have gotten one-at-a-time.  Histories are therefore identical to the
unbatched loop (the tier-1 parity pins).
"""
from __future__ import annotations

import dataclasses
import enum
import heapq
from typing import Dict, List, Optional


class EventKind(enum.IntEnum):
    TRAIN_DONE = 0
    MODEL_ARRIVAL = 1
    TRIGGER_TIMEOUT = 2
    SINK_HANDOFF = 3
    TRANSFER_FAILED = 4
    PS_DOWN = 5
    PS_UP = 6


@dataclasses.dataclass(frozen=True)
class Event:
    """One scheduled occurrence.  ``sat`` / ``row`` are payload for the
    training/arrival kinds (``row`` is the satellite's row in the round's
    padded training bank); -1 where not applicable.  ``pipelined`` marks
    a speculative ``SINK_HANDOFF`` that tries to extend the pipeline
    while its round is still in flight — the handler drops it when the
    pipeline is already at ``max_in_flight`` (DESIGN.md §8)."""
    time: float
    kind: EventKind
    round_idx: int
    sat: int = -1
    row: int = -1
    pipelined: bool = False
    # failed attempts so far in a lossy-transfer retry chain: attempt=k
    # on MODEL_ARRIVAL / TRANSFER_FAILED means this is retransmission k
    attempt: int = 0
    # the PS this event is addressed to: the outage server on
    # PS_DOWN/PS_UP, the sink the arrival was *timed against* on
    # MODEL_ARRIVAL/TRANSFER_FAILED (so a pop can detect "timed to a
    # now-dead sink" and reroute, DESIGN.md §11); -1 where not applicable
    ps: int = -1

    def __post_init__(self):
        if self.time != self.time:
            raise ValueError("event time must not be NaN")


class EventQueue:
    """Min-heap of events ordered by (time, push sequence)."""

    def __init__(self):
        self._heap: List = []
        self._seq = 0
        self.counts: Dict[str, int] = {k.name: 0 for k in EventKind}

    def push(self, ev: Event) -> None:
        self.counts[ev.kind.name] += 1
        heapq.heappush(self._heap, (ev.time, self._seq, ev))
        self._seq += 1

    def push_many(self, evs: List[Event]) -> None:
        """Bulk push preserving per-event FIFO order: event i of ``evs``
        gets the exact sequence number it would get from ``push`` calls
        in the same order."""
        for ev in evs:
            self.push(ev)

    def pop(self) -> Event:
        return heapq.heappop(self._heap)[2]

    def pop_batch(self) -> List[Event]:
        """Pop the maximal run of events sharing (time, kind, round_idx)
        with the heap top, in FIFO (sequence) order.  Always returns at
        least one event; a single-element list degrades to ``pop``."""
        t0, _seq, ev = heapq.heappop(self._heap)
        out = [ev]
        heap = self._heap
        while heap and heap[0][0] == t0:
            nxt = heap[0][2]
            if nxt.kind != ev.kind or nxt.round_idx != ev.round_idx:
                break
            out.append(heapq.heappop(heap)[2])
        return out

    def peek_time(self) -> Optional[float]:
        return self._heap[0][0] if self._heap else None

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)
