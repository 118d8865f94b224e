"""Structured round-lifecycle tracing (DESIGN.md §12), as the JAX
package's ``repro.obs.trace``.

The event runtime (`sched/runtime.py`) can answer *what* happened — a
flat counter dict — but not *when*: where a pipelined run's simulated
time went, how long a round sat in its trigger window.  A
:class:`Tracer` records the per-round lifecycle as **spans** (durations
in simulated seconds on a named track) and **instant events** (points
with structured args), into a plain in-memory buffer, which
``obs/export`` renders as Chrome trace-event JSON or JSONL.

Span taxonomy (one track per round, ``"round <idx>"``):

* ``round``          — open -> close (roles handed off);
* ``recruit``        — downlink phase: open -> last participant's
  global-model receive instant;
* ``transfers``      — uplink phase: first TRAIN_DONE -> last expected
  sink arrival;
* ``trigger_window`` — first *used* arrival -> the aggregation instant.

``channel_busy`` and ``outage`` name the per-PS spans that
``obs/export.add_runtime_tracks`` synthesizes after a run.  The runtime
records ``MODEL_ARRIVAL``, ``TRIGGER`` / ``DISPATCH`` / ``COMMIT``,
``WINDOW_SHRUNK`` and the fault instants (``TRANSFER_FAILED`` ...
``ENERGY_DEFERRAL``).

**The null-tracer parity invariant**: tracing is strictly read-only —
a traced run and a ``tracer=None`` run produce bit-identical histories
and weights.  ``tracer=None`` resolves to the module-level
:data:`NULL_TRACER`, whose every method is a no-op and whose ``enabled``
flag lets hot paths skip building args entirely, so untraced runs pay
nothing.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

# ---- span taxonomy ----------------------------------------------------------

SPAN_ROUND = "round"
SPAN_RECRUIT = "recruit"
SPAN_TRANSFERS = "transfers"
SPAN_TRIGGER = "trigger_window"
SPAN_CHANNEL = "channel_busy"
SPAN_OUTAGE = "outage"

# ---- instant-event names ----------------------------------------------------

EV_ARRIVAL = "MODEL_ARRIVAL"
EV_TRANSFER_FAILED = "TRANSFER_FAILED"
EV_TRANSFER_RETRY = "TRANSFER_RETRY"
EV_PS_DOWN = "PS_DOWN"
EV_PS_UP = "PS_UP"
EV_FAILOVER = "FAILOVER"
EV_REROUTE = "REROUTE"
EV_ENERGY_DEFER = "ENERGY_DEFERRAL"
EV_DROP = "DROP"
EV_TRIGGER = "TRIGGER"
EV_DISPATCH = "DISPATCH"
EV_COMMIT = "COMMIT"
EV_WINDOW_SHRUNK = "WINDOW_SHRUNK"


@dataclasses.dataclass
class Span:
    """One closed duration on a track; times are simulated seconds."""
    name: str
    track: str
    t_start: float
    t_end: float
    args: Dict

    @property
    def duration(self) -> float:
        return self.t_end - self.t_start


@dataclasses.dataclass
class Instant:
    """One point event on a track; time is simulated seconds."""
    name: str
    track: str
    t: float
    args: Dict


class Tracer:
    """In-memory span/instant recorder.

    ``begin``/``end`` bracket long-lived spans by handle (a round may
    stay open across thousands of events); ``span`` records an already-
    closed duration in one call; ``instant`` records a point.  Buffers
    are plain lists (``spans`` / ``instants``), and
    ``close_open_spans`` finalizes whatever is still open at run end
    (rounds alive at the horizon)."""

    enabled = True

    def __init__(self):
        self.spans: List[Span] = []
        self.instants: List[Instant] = []
        self._open: Dict[int, Tuple[str, str, float, Dict]] = {}
        self._next_handle = 0

    # ---- recording ---------------------------------------------------------

    def begin(self, name: str, t: float, track: str = "main",
              **args) -> int:
        """Open a span; returns the handle ``end`` closes it by."""
        h = self._next_handle
        self._next_handle += 1
        self._open[h] = (name, track, float(t), dict(args))
        return h

    def end(self, handle: int, t: float, **args) -> None:
        """Close an open span (unknown/already-closed handles are
        ignored, so callers never need to track liveness)."""
        ent = self._open.pop(handle, None)
        if ent is None:
            return
        name, track, t0, a = ent
        a.update(args)
        self.spans.append(Span(name, track, t0, max(float(t), t0), a))

    def span(self, name: str, t_start: float, t_end: float,
             track: str = "main", **args) -> None:
        t0 = float(t_start)
        self.spans.append(Span(name, track, t0, max(float(t_end), t0),
                               dict(args)))

    def instant(self, name: str, t: float, track: str = "main",
                **args) -> None:
        self.instants.append(Instant(name, track, float(t), dict(args)))

    # ---- lifecycle ---------------------------------------------------------

    def close_open_spans(self, t: float) -> None:
        """Finalize every still-open span at instant ``t`` (clamped so a
        span never ends before it starts) — called at run end so rounds
        alive at the horizon are recorded."""
        for h in sorted(self._open):
            self.end(h, t)

    def tracks(self) -> List[str]:
        """All track names, in first-appearance order."""
        seen: Dict[str, None] = {}
        for s in self.spans:
            seen.setdefault(s.track)
        for i in self.instants:
            seen.setdefault(i.track)
        for (_n, track, _t, _a) in self._open.values():
            seen.setdefault(track)
        return list(seen)

    def clear(self) -> None:
        self.spans.clear()
        self.instants.clear()
        self._open.clear()


class NullTracer:
    """The strict no-op tracer: every method returns immediately and
    records nothing, and ``enabled`` is False so hot paths can skip arg
    construction.  ``tracer=None`` everywhere resolves to the shared
    :data:`NULL_TRACER` — the bit-parity/overhead-free contract."""

    enabled = False
    __slots__ = ()

    def begin(self, *a, **kw) -> int:
        return -1

    def end(self, *a, **kw) -> None:
        pass

    def span(self, *a, **kw) -> None:
        pass

    def instant(self, *a, **kw) -> None:
        pass

    def close_open_spans(self, *a, **kw) -> None:
        pass

    def tracks(self):
        return []

    def clear(self) -> None:
        pass


NULL_TRACER = NullTracer()
