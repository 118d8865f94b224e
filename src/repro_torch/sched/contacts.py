"""Contact-plan compilation: orbital geometry -> schedulable link windows
(DESIGN.md §7; the multi-sink handoff query it serves is §8).

A *contact plan* is the standard artifact of DTN / satellite-network
scheduling (LRSIM's dynamic-state generation follows the same shape): the
constellation geometry, visibility grid and link model are compiled ONCE
into sorted availability windows, and everything downstream — the
event-driven runtime (`sched/runtime.py`), benchmarks, exports — consumes
the plan instead of re-deriving geometry.

``ContactPlan`` bundles three things:

* **windows** — run-length-encoded sat<->PS visibility intervals
  ``[t_start, t_end)`` (from the timeline's ``node_windows`` segment
  export, a dense-grid RLE), each annotated with the one-hop link delay
  at window start for a nominal payload.  Compiled lazily and cached.
* **ISL / IHL availability** — intra-orbit ISL rings are permanently
  available (adjacent neighbors, §IV-A), so they are a constant hop delay,
  not windows; the HAP ring likewise.
* **timing evaluators** — ``downlink_times`` / ``uplink_times`` answer
  "when does satellite n hold the global model" / "when does n's local
  model reach the sink" for a *specific* payload and instant, delegating
  the fine-grained delay math to the compiled-in ``PropagationModel``
  (the plan's windows and the evaluators read the same grid, so they never
  disagree).  The ``use_isl`` switch (strategies without inter-satellite
  links wait for direct visibility) lives here, moved out of the
  simulator.

`core/simulator.py` routes its propagation timing through a plan, and the
event-driven runtime schedules its wake-ups from the same object — one
compiled view of "who can talk to whom, when, at what delay".

**Link capacity** (DESIGN.md §9): the JAX package's ``ContentionModel``
(per-PS channel pools) comes to the port with the scheduler slice.  Until
then ``contention`` stays None, which keeps the infinite-parallelism
semantics bit-for-bit; the grant branches below are the reference's, kept
so the two packages time transfers with one code shape.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.constellation import GroundNode, WalkerDelta
from repro_torch.core.links import LinkModel
from repro_torch.core.propagation import PropagationModel
from repro_torch.core.topology import RingOfStars
from repro_torch.core.visibility import VisibilityTimeline


@dataclasses.dataclass(frozen=True)
class ContactWindow:
    """One sat<->PS visibility interval ``[t_start, t_end)`` with the
    link delay (transmission + propagation for the plan's nominal payload)
    evaluated at window start."""
    sat: int
    node: int
    t_start: float
    t_end: float
    delay_s: float


@dataclasses.dataclass
class ContactPlan:
    """Compiled contact plan over one simulation horizon.

    Construct via :meth:`compile` (builds timeline/topology/propagation
    from a constellation + PS nodes) or directly from an existing
    simulator's objects — ``FLSimulation`` does the latter so the epoch
    loop and the event runtime share one plan.
    """
    constellation: WalkerDelta
    nodes: List[GroundNode]
    timeline: VisibilityTimeline
    topo: RingOfStars
    prop: PropagationModel
    use_isl: bool = True
    nominal_bits: float = 0.0          # payload for window delay annotation
    # finite per-PS link capacity (DESIGN.md §9); None = infinite
    # parallelism, bit-identical to the pre-contention semantics
    contention: Optional[object] = None

    _windows: Optional[List[ContactWindow]] = dataclasses.field(
        default=None, repr=False)
    _node_vis: Optional[List[Tuple[np.ndarray, np.ndarray]]] = \
        dataclasses.field(default=None, repr=False)
    # ^ per-PS merged any-sat coverage runs (lo, hi), rows, hi exclusive

    # ---- construction ------------------------------------------------------

    @classmethod
    def compile(cls, constellation: WalkerDelta, nodes: List[GroundNode],
                duration_s: float, dt_s: float = 10.0,
                link: Optional[LinkModel] = None, *, use_isl: bool = True,
                nominal_bits: float = 0.0) -> "ContactPlan":
        timeline = VisibilityTimeline(constellation, nodes, duration_s, dt_s)
        topo = RingOfStars(constellation, nodes, timeline)
        prop = PropagationModel(topo, link or LinkModel())
        return cls(constellation, nodes, timeline, topo, prop,
                   use_isl=use_isl, nominal_bits=nominal_bits)

    # ---- windows (lazy RLE over the visibility grid) -----------------------

    def windows(self) -> List[ContactWindow]:
        """Sorted (by t_start, then sat) sat<->PS contact windows."""
        if self._windows is None:
            self._windows = self._compile_windows()
        return self._windows

    def _compile_windows(self) -> List[ContactWindow]:
        tl = self.timeline
        T = len(tl.times)
        dt = tl.dt_s
        out: List[ContactWindow] = []
        # per-node windows from the timeline's segment export (dense RLE)
        for p in range(len(self.nodes)):
            s_sats, s_rows, e_rows = tl.node_windows(p)
            if len(s_sats) == 0:
                continue
            t0 = tl.times[s_rows]
            # exclusive end: one step past the last visible sample, clamped
            t1 = tl.times[np.minimum(e_rows, T - 1)]
            t1 = np.where(e_rows >= T, tl.times[T - 1] + dt, t1)
            dist = self.topo.sat_ps_distances(s_sats, p, t0)
            delay = self.prop.link.total_delay(self.nominal_bits, dist)
            delay = np.broadcast_to(np.asarray(delay, np.float64),
                                    s_sats.shape)
            out.extend(ContactWindow(int(s), p, float(a), float(b), float(dl))
                       for s, a, b, dl in zip(s_sats, t0, t1, delay))
        out.sort(key=lambda w: (w.t_start, w.sat, w.node))
        return out

    # ---- plan-level queries -------------------------------------------------

    @property
    def num_sats(self) -> int:
        return self.constellation.num_sats

    @property
    def is_degenerate(self) -> bool:
        """True when every satellite sees a PS at every grid step — the
        all-visible plan used by the runtime-vs-epoch-loop parity tests."""
        tl = self.timeline
        return tl.covered_steps() == len(tl.times) * self.num_sats

    def isl_hop_delay(self, bits: float) -> float:
        """Intra-orbit ISL ring hop delay (permanently available)."""
        return self.prop.isl_hop_delay(bits)

    def next_contact(self, sats, t):
        """Vectorized earliest contact at/after ``t``: (times, ps ids),
        inf / -1 for satellites never visible again within the horizon."""
        return self.timeline.next_visible_after(sats, t)

    def next_contact_by_node(self, t: float) -> np.ndarray:
        """Per-PS earliest instant >= ``t`` at which ANY satellite is in
        view — ``(P,)`` with inf where a node sees nothing for the rest
        of the horizon.  This is the multi-sink handoff signal
        (DESIGN.md §8): `sched/policies.NextContactHandoff` opens the
        next round at the HAP that can start talking soonest.  The
        per-node coverage runs are built once and cached; each query is
        then two bisects per node instead of an O(T) scan."""
        if self._node_vis is None:
            self._node_vis = [self.timeline.node_cover(p)
                              for p in range(len(self.nodes))]
        times = self.timeline.times
        T = len(times)
        row_min = int(np.searchsorted(times, t, side="left"))
        out = np.full(len(self._node_vis), np.inf)
        for p, (lo, hi) in enumerate(self._node_vis):
            i = int(np.searchsorted(hi, row_min, side="right"))
            if i < len(lo):
                row = max(int(lo[i]), row_min)
                if row < T:
                    out[p] = times[row]
        return out

    def next_any_contact(self, t: float) -> Optional[float]:
        """Earliest time >= t when ANY satellite sees a PS (None if the
        plan is exhausted) — the runtime's idle-skip wake-up."""
        tv, _ps = self.timeline.next_visible_after(
            np.arange(self.constellation.num_sats), t)
        tmin = float(np.min(tv))
        return None if not np.isfinite(tmin) else tmin

    def coverage_fraction(self) -> float:
        """Mean fraction of grid steps with any PS in view, over sats."""
        tl = self.timeline
        return float(tl.covered_steps() / (len(tl.times) * self.num_sats))

    def summary(self) -> Dict:
        """Plan statistics for benchmarks / exports (windows compiled on
        first call)."""
        ws = self.windows()
        return {
            "num_sats": self.constellation.num_sats,
            "num_ps": len(self.nodes),
            "duration_s": float(self.timeline.duration_s),
            "dt_s": float(self.timeline.dt_s),
            "use_isl": bool(self.use_isl),
            "num_windows": len(ws),
            "coverage_fraction": self.coverage_fraction(),
            "mean_window_s": (float(np.mean([w.t_end - w.t_start
                                             for w in ws])) if ws else 0.0),
            "is_degenerate": self.is_degenerate,
        }

    def to_dicts(self) -> List[Dict]:
        """Windows as plain dicts (JSON-exportable contact-plan format,
        DESIGN.md §7)."""
        return [dataclasses.asdict(w) for w in self.windows()]

    # ---- model-propagation timing (moved from FLSimulation) ----------------

    def downlink_times(self, t0: float, bits: float,
                       source: int) -> np.ndarray:
        """Per-satellite receive time of the global model sent from
        ``source`` at ``t0`` (Alg. 1 with ISL relay; plain next-visibility
        per satellite for ISL-less strategies).  With a `ContentionModel`
        attached, each PS->sat copy is one tx-channel grant and concurrent
        transfers at the same PS serialize (DESIGN.md §9)."""
        if self.use_isl:
            return self.prop.downlink_times(t0, bits, source,
                                            contention=self.contention)
        S = self.constellation.num_sats
        sats = np.arange(S)
        tv, ps = self.timeline.next_visible_after(sats, t0)
        recv = np.full(S, np.inf)
        ok = np.isfinite(tv)
        for h in np.unique(ps[ok]):
            m = ok & (ps == h)
            d = self.topo.sat_ps_distances(sats[m], int(h), tv[m])
            recv[m] = tv[m] + self.prop.link.total_delay(bits, d)
        if self.contention is not None and ok.any():
            # the transfer would start transmitting at visibility (tv);
            # a queued grant shifts it by (start - tv), zero when free
            idx = np.flatnonzero(ok)
            t_t = self.prop.link.transmission_delay(bits)
            starts = self.contention.grant_tx_many(ps[idx], tv[idx], t_t)
            recv[idx] += starts - tv[idx]
        return recv

    def uplink_times(self, sats, t_done, bits: float,
                     sink: int) -> Tuple[np.ndarray, np.ndarray]:
        """Arrival times of the given satellites' local models at the sink
        (and the first-receiving PS ids); inf / -1 where unreachable.
        With a `ContentionModel` attached, each arriving model is one
        rx-channel grant at its first-receiving PS (DESIGN.md §9)."""
        if self.use_isl:
            return self.prop.uplink_many(sats, t_done, bits, sink,
                                         contention=self.contention)
        sats = np.asarray(sats, dtype=np.int64)
        tv, ps = self.timeline.next_visible_after(sats, t_done)
        out = np.full(len(sats), np.inf)
        hap = np.asarray(ps, dtype=np.int64)
        ok = np.isfinite(tv)
        for h in np.unique(hap[ok]):
            m = ok & (hap == h)
            d = self.topo.sat_ps_distances(sats[m], int(h), tv[m])
            out[m] = tv[m] + self.prop.link.total_delay(bits, d)
        if self.contention is not None and ok.any():
            # same convention as the ISL path: the PS receives over the
            # [arrival - transmission, arrival) interval — propagation
            # and processing delay the payload, not the receiver
            idx = np.flatnonzero(ok)
            t_t = self.prop.link.transmission_delay(bits)
            req = out[idx] - t_t
            starts = self.contention.grant_rx_many(hap[idx], req, t_t)
            out[idx] += starts - req
        return out, hap

    def reroute_times(self, ps_from: int, ps_to: int, t: float,
                      bits: float, avoid=()) -> float:
        """Ring-failover re-timing (DESIGN.md §11): a model that reached
        the ring at ``ps_from`` at instant ``t`` but found its sink dark
        relays along the ring to the live PS ``ps_to`` (routing around
        the ``avoid`` set, +inf when both arcs are blocked) and is
        charged one fresh rx-channel grant there, under the same §9
        convention as ``uplink_times``: the PS receives over the
        [arrival - transmission, arrival) interval, and a queued grant
        shifts the arrival by (start - request) — exactly 0.0 when
        uncontended, so ``ps_channels=None`` stays bit-identical."""
        delay = self.prop.ring_relay_delay(bits, ps_from, ps_to, t,
                                           avoid=avoid)
        ta = float(t) + float(delay)
        if self.contention is not None and np.isfinite(ta):
            t_t = self.prop.link.transmission_delay(bits)
            req = ta - t_t
            start = self.contention.grant_rx(ps_to, req, t_t)
            ta += start - req
        return ta
