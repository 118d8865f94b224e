"""Trace export: Chrome trace-event JSON (Perfetto) and JSONL, as the JAX
package's ``repro.obs.export``.

``export_chrome`` renders an `obs/trace.Tracer` buffer to the Chrome
trace-event format — the ``{"traceEvents": [...]}`` object that
https://ui.perfetto.dev and chrome://tracing load directly.  Mapping:

* one **process** (pid 0, the simulation run), one **thread per track**
  (``"round <idx>"``, ``"ps <p>"``, ...), named via ``"M"``
  (metadata) ``thread_name`` events so the timeline shows real labels;
* spans become ``"X"`` (complete) events with ``ts``/``dur`` in
  microseconds — simulated seconds × 1e6, so one timeline second is one
  simulated microsecond-tick and Perfetto's zoom works naturally;
* instants become ``"i"`` events with thread scope (``"s": "t"``);
* span/instant ``args`` pass through verbatim.

``export_jsonl`` writes one JSON object per line (``kind`` span /
instant, times in simulated seconds) for programmatic analysis;
``benchmarks/trace_report.py`` reads either format.

``add_runtime_tracks`` synthesizes the per-PS tracks the runtime never
records explicitly: channel-occupancy spans from the §9 pools' interval
reservations and outage windows from the §11 schedule.  Call it once at
run end, before exporting.

``validate_chrome_trace`` is the schema check: structural errors
(missing keys, bad phases, negative durations) come back as a list of
strings, empty = valid.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

from repro_torch.obs.trace import SPAN_CHANNEL, SPAN_OUTAGE, Tracer

_US = 1e6          # simulated seconds -> trace microseconds


def _track_order(tracer: Tracer) -> Dict[str, int]:
    """track name -> tid; 'ps *' tracks first (sorted), then rounds in
    numeric order, then anything else in appearance order."""
    names = tracer.tracks()

    def key(n: str):
        parts = n.split()
        if parts[0] in ("ps", "round") and len(parts) == 2 \
                and parts[1].lstrip("-").isdigit():
            return (0 if parts[0] == "ps" else 1, int(parts[1]), n)
        return (2, 0, n)

    return {n: tid for tid, n in enumerate(sorted(names, key=key))}


def export_chrome(tracer: Tracer, path: Optional[str] = None) -> Dict:
    """Render the tracer buffer as a Chrome trace-event object; write it
    to ``path`` as JSON when given.  Returns the object either way."""
    tids = _track_order(tracer)
    events: List[Dict] = []
    for name, tid in tids.items():
        events.append({"ph": "M", "name": "thread_name", "pid": 0,
                       "tid": tid, "args": {"name": name}})
    for s in tracer.spans:
        events.append({"ph": "X", "name": s.name, "pid": 0,
                       "tid": tids[s.track],
                       "ts": s.t_start * _US,
                       "dur": (s.t_end - s.t_start) * _US,
                       "args": s.args})
    for i in tracer.instants:
        events.append({"ph": "i", "name": i.name, "pid": 0,
                       "tid": tids[i.track], "ts": i.t * _US, "s": "t",
                       "args": i.args})
    obj = {"traceEvents": events, "displayTimeUnit": "ms"}
    if path is not None:
        with open(path, "w") as f:
            json.dump(obj, f)
    return obj


def export_jsonl(tracer: Tracer, path: str) -> int:
    """One JSON object per span/instant (times in simulated seconds);
    returns the number of lines written."""
    n = 0
    with open(path, "w") as f:
        for s in tracer.spans:
            f.write(json.dumps({"kind": "span", "name": s.name,
                                "track": s.track, "t_start": s.t_start,
                                "t_end": s.t_end, "args": s.args}) + "\n")
            n += 1
        for i in tracer.instants:
            f.write(json.dumps({"kind": "instant", "name": i.name,
                                "track": i.track, "t": i.t,
                                "args": i.args}) + "\n")
            n += 1
    return n


def validate_chrome_trace(obj) -> List[str]:
    """Structural schema check for an exported Chrome trace object (the
    parsed JSON, not a path).  Returns a list of human-readable errors —
    empty means the trace is loadable."""
    errors: List[str] = []
    if not isinstance(obj, dict):
        return [f"top level must be an object, got {type(obj).__name__}"]
    evs = obj.get("traceEvents")
    if not isinstance(evs, list):
        return ["traceEvents must be a list"]
    for k, ev in enumerate(evs):
        where = f"traceEvents[{k}]"
        if not isinstance(ev, dict):
            errors.append(f"{where}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in ("X", "i", "I", "M", "B", "E", "C"):
            errors.append(f"{where}: unknown phase {ph!r}")
            continue
        if not isinstance(ev.get("name"), str):
            errors.append(f"{where}: missing/non-string name")
        if "pid" not in ev:
            errors.append(f"{where}: missing pid")
        if ph == "M":
            continue                       # metadata needs no timestamp
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)):
            errors.append(f"{where}: missing/non-numeric ts")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)):
                errors.append(f"{where}: complete event missing dur")
            elif dur < 0:
                errors.append(f"{where}: negative dur {dur}")
    return errors


def add_runtime_tracks(tracer: Tracer, rt) -> None:
    """Synthesize the per-PS tracks from an `EventDrivenRuntime` after
    ``run()``: channel-occupancy spans from the contention pools'
    reservations (DESIGN.md §9), in (channel, start, end) order, and
    outage windows from the compiled schedule (§11).  No-op for whatever
    the run did not configure."""
    if not tracer.enabled:
        return
    ctn = rt.plan.contention
    if ctn is not None and ctn.channels is not None:
        for direction, pool in (("tx", ctn.tx), ("rx", ctn.rx)):
            for ps in range(ctn.num_ps):
                for c, s, e in pool.intervals(ps):
                    tracer.span(SPAN_CHANNEL, s, e, track=f"ps {ps}",
                                direction=direction, channel=c)
    outages = getattr(rt, "_outages", None)
    if outages is not None:
        for ps, s, e in outages.events():
            tracer.span(SPAN_OUTAGE, s, e, track=f"ps {ps}", ps=ps)
