"""Pluggable fault-injection / heterogeneity layer (DESIGN.md §10-§11), as
the JAX package's ``repro.sched.faults``: host numpy, every draw keyed
exactly as there, so the port's fault schedules equal the reference's.

The simulator's robustness story used to ride on geometry alone: every
satellite trained at the same speed, no transfer was ever lost, and no
satellite ever powered down.  ``FaultModel`` makes the missing failure
axes first-class, following FLGo's ``system_simulator`` shape
(pluggable availability / latency / dropout state on a shared clock):

* **compute-rate heterogeneity** — per-satellite multipliers that
  stretch local-training time (and therefore every ``TRAIN_DONE``
  instant): ``train_time_scale`` draws a seeded spread in
  ``[1, 1 + compute_rate_spread]`` (or takes explicit per-sat rates).
  Threaded through `FLSimulation._train_times`, the ONE shared timing
  helper of the epoch loop and the event runtime, so their parity is
  preserved under heterogeneity.
* **eclipse / duty-cycle availability** — ``availability_mask`` returns
  a (T, S) boolean that is ANDed into ``VisibilityTimeline.grid`` at
  simulator construction: a satellite in its (seeded-phase, periodic)
  eclipse window is simply not visible to any PS, so every downstream
  rule — contact windows, downlink stars, ISL relay seeds, uplink
  direct/relay/wait — routes around it without special cases.
* **lossy transfers** — ``transfer_fails`` is a *deterministic* seeded
  Bernoulli draw per (satellite, round, attempt): the event runtime
  turns a failed sat->PS model transfer into a ``TRANSFER_FAILED``
  event at the would-be arrival instant and re-times the retransmission
  from ``t + retry_backoff_s * 2**attempt`` through the contact plan
  (which charges a fresh rx-channel grant — retries re-enter the
  `ChannelPool`), up to ``max_retries`` attempts; grants of retries
  that can never complete are rolled back via the existing
  snapshot/restore machinery.  Loss requires the event runtime — the
  epoch loop cannot express retries and refuses to run with
  ``loss_prob > 0``.
* **correlated / bursty loss (§11)** — real Satcom channels fade in
  bursts (rain fade, scintillation), not i.i.d. coin flips.
  ``burst_len_s > 0`` switches ``transfer_fails`` to a two-state
  Gilbert–Elliott block-fading channel per (sat, PS) link: time is cut
  into windows of ``burst_len_s`` seconds, each window's good/bad state
  is a pure seeded draw keyed on ``(seed, sat, ps, window)`` with bad
  probability ``loss_prob`` (so the long-run loss rate matches the
  i.i.d. knob), and attempts inside a bad window fail with
  ``loss_prob_bad`` (default 1.0: the whole burst shares its fate —
  retries that land inside the same window all fail) vs
  ``loss_prob_good`` in good windows (default 0.0).  Consecutive bad
  windows happen by chance, so the mean bad dwell is
  ``burst_len_s / (1 - loss_prob)``.  ``burst_len_s=0`` is bit-identical
  to the i.i.d. draw (off-switch contract).
* **PS / HAP outages (§11)** — ``ps_outages`` (explicit intervals)
  and/or ``ps_outage_fraction`` (seeded periodic windows, the eclipse
  mirror for the server side) declare when a parameter server is dark.
  ``outage_intervals`` compiles them into a validated, merged schedule
  (`OutageSchedule`), ``outage_mask`` is ANDed into the visibility grid
  (a dark PS has no sat contacts), and the event runtime adds
  ``PS_DOWN`` / ``PS_UP`` events with ring-failover recovery semantics
  (see DESIGN.md §11 and `sched/runtime.py`).
* **energy budgets (§11)** — ``battery_j`` attaches per-satellite
  battery state (`EnergyState`): local training drains
  ``train_energy_j``, every transmit attempt drains ``tx_energy_j``,
  and the battery recharges at ``recharge_w`` watts scaled by the
  sunlit duty cycle ``1 - eclipse_fraction``.  A depleted satellite
  defers its uplink to the first affordable instant (energy as a
  consumable, not just the availability mask).  ``battery_j=None``
  attaches no state at all.

Every draw is a pure function of ``(seed, domain tag, ids...)``
— no global RNG state — so a fault schedule is reproducible across
runs and independent of event-processing order.

**Off-switch contract**: ``SimConfig.fault_model=None`` attaches no
state at all, and a default ``FaultModel()`` (every axis off) takes the
identical code paths — both are bit-identical to the fault-free
simulator (tests/test_torch_faults.py pins this).  Each new axis has its own
independent off-switch: ``burst_len_s=0`` keeps the i.i.d. draw,
``ps_outages=None`` + ``ps_outage_fraction=0`` attach no outage
schedule, ``battery_j=None`` attaches no energy state, and
``adaptive_backoff=False`` keeps the blind exponential backoff.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

# domain-separation tags so the fault axes never share a stream
_TAG_COMPUTE = 0xC0
_TAG_ECLIPSE = 0xEC
_TAG_LOSS = 0xF417
_TAG_BURST = 0xB5
_TAG_OUTAGE = 0x0A6E


@dataclasses.dataclass(frozen=True)
class FaultModel:
    """Declarative fault / heterogeneity scenario (all axes off by
    default; validated at construction).

    ``compute_rate_spread=s`` draws per-sat training-time multipliers
    uniformly in ``[1, 1+s]`` (0 = homogeneous); ``compute_rates``
    overrides with explicit multipliers.  ``eclipse_fraction=f`` makes
    each satellite unavailable for a fraction ``f`` of every
    ``eclipse_period_s`` window (seeded per-sat phase).  ``loss_prob``
    is the per-attempt Bernoulli loss of a sat->PS model transfer (in
    burst mode, the stationary bad-window probability); ``max_retries``
    bounds retransmissions and ``retry_backoff_s`` is the base of the
    exponential backoff (attempt k waits ``retry_backoff_s * 2**k``).

    §11 axes: ``burst_len_s`` switches the loss draw to a Gilbert–
    Elliott block-fading channel per (sat, PS) link with per-window
    failure probabilities ``loss_prob_bad`` / ``loss_prob_good``;
    ``ps_outages`` / ``ps_outage_fraction`` declare PS dark windows;
    ``battery_j`` attaches per-sat energy budgets; ``adaptive_backoff``
    replaces the blind exponential backoff with an AIMD delay driven by
    the sink pool's observed queue wait, capped at
    ``retry_backoff_cap_s``."""
    seed: int = 0
    # heterogeneity
    compute_rate_spread: float = 0.0
    compute_rates: Optional[Tuple[float, ...]] = None
    # eclipse / duty cycle
    eclipse_fraction: float = 0.0
    eclipse_period_s: float = 5400.0
    # lossy transfers
    loss_prob: float = 0.0
    max_retries: int = 3
    retry_backoff_s: float = 120.0
    # correlated / bursty loss (Gilbert–Elliott block fading, §11)
    burst_len_s: float = 0.0           # 0 = i.i.d. draw (bit-identical)
    loss_prob_bad: float = 1.0         # attempt failure prob in a bad window
    loss_prob_good: float = 0.0        # attempt failure prob in a good window
    # PS / HAP outages (§11)
    ps_outages: Optional[Tuple[Tuple[int, float, float], ...]] = None
    ps_outage_fraction: float = 0.0    # seeded periodic dark fraction per PS
    ps_outage_period_s: float = 21600.0
    # energy budgets (§11)
    battery_j: Optional[float] = None  # None = no energy state at all
    train_energy_j: float = 50.0       # drained per local-training round
    tx_energy_j: float = 5.0           # drained per transmit attempt
    recharge_w: float = 1.0            # sunlit recharge rate (W = J/s)
    initial_charge: float = 1.0        # starting charge as a capacity fraction
    # adaptive retry backoff (§11)
    adaptive_backoff: bool = False
    retry_backoff_cap_s: float = 3840.0

    def __post_init__(self):
        if int(self.seed) < 0:
            raise ValueError(f"FaultModel.seed must be >= 0, got {self.seed}")
        if self.compute_rate_spread < 0.0:
            raise ValueError("FaultModel.compute_rate_spread must be >= 0, "
                             f"got {self.compute_rate_spread}")
        if self.compute_rates is not None:
            rates = tuple(float(r) for r in self.compute_rates)
            if not rates or min(rates) <= 0.0:
                raise ValueError("FaultModel.compute_rates must be a "
                                 "non-empty tuple of positive multipliers, "
                                 f"got {self.compute_rates!r}")
            object.__setattr__(self, "compute_rates", rates)
        if not 0.0 <= self.eclipse_fraction < 1.0:
            raise ValueError("FaultModel.eclipse_fraction must be in "
                             f"[0, 1), got {self.eclipse_fraction}")
        if self.eclipse_period_s <= 0.0:
            raise ValueError("FaultModel.eclipse_period_s must be > 0, "
                             f"got {self.eclipse_period_s}")
        if not 0.0 <= self.loss_prob <= 1.0:
            raise ValueError("FaultModel.loss_prob must be in [0, 1], "
                             f"got {self.loss_prob}")
        if int(self.max_retries) < 0:
            raise ValueError("FaultModel.max_retries must be >= 0, "
                             f"got {self.max_retries}")
        if self.retry_backoff_s <= 0.0:
            raise ValueError("FaultModel.retry_backoff_s must be > 0, "
                             f"got {self.retry_backoff_s}")
        if self.burst_len_s < 0.0:
            raise ValueError("FaultModel.burst_len_s must be >= 0, "
                             f"got {self.burst_len_s}")
        for name in ("loss_prob_bad", "loss_prob_good"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"FaultModel.{name} must be in [0, 1], "
                                 f"got {v}")
        if self.ps_outages is not None:
            ivs = []
            for entry in self.ps_outages:
                try:
                    ps, start, end = entry
                except (TypeError, ValueError):
                    raise ValueError(
                        "FaultModel.ps_outages entries must be "
                        f"(ps, start_s, end_s) triples, got {entry!r}")
                if int(ps) < 0:
                    raise ValueError("FaultModel.ps_outages PS index must "
                                     f"be >= 0, got {ps}")
                if not 0.0 <= float(start) < float(end):
                    raise ValueError(
                        "FaultModel.ps_outages intervals need "
                        f"0 <= start < end, got ({start}, {end})")
                ivs.append((int(ps), float(start), float(end)))
            object.__setattr__(self, "ps_outages", tuple(ivs))
        if not 0.0 <= self.ps_outage_fraction < 1.0:
            raise ValueError("FaultModel.ps_outage_fraction must be in "
                             f"[0, 1), got {self.ps_outage_fraction}")
        if self.ps_outage_period_s <= 0.0:
            raise ValueError("FaultModel.ps_outage_period_s must be > 0, "
                             f"got {self.ps_outage_period_s}")
        if self.battery_j is not None and self.battery_j <= 0.0:
            raise ValueError("FaultModel.battery_j must be > 0 (or None), "
                             f"got {self.battery_j}")
        for name in ("train_energy_j", "tx_energy_j", "recharge_w"):
            if getattr(self, name) < 0.0:
                raise ValueError(f"FaultModel.{name} must be >= 0, "
                                 f"got {getattr(self, name)}")
        if not 0.0 <= self.initial_charge <= 1.0:
            raise ValueError("FaultModel.initial_charge must be in [0, 1], "
                             f"got {self.initial_charge}")
        if self.retry_backoff_cap_s < self.retry_backoff_s:
            raise ValueError(
                "FaultModel.retry_backoff_cap_s must be >= retry_backoff_s, "
                f"got {self.retry_backoff_cap_s} < {self.retry_backoff_s}")
        # per-instance memo for eclipse phases (keyed by num_sats); not a
        # dataclass field, so equality/hash/replace are unaffected
        object.__setattr__(self, "_phase_memo", {})

    # ---- derived state (pure functions of the frozen config) ---------------

    @property
    def is_null(self) -> bool:
        """True when every fault axis is off — a null model must be
        bit-identical to ``fault_model=None`` (the off-switch contract)."""
        return (self.compute_rate_spread == 0.0
                and self.compute_rates is None
                and self.eclipse_fraction == 0.0
                and self.loss_prob == 0.0
                and not self.has_burst
                and not self.has_outages
                and not self.has_energy)

    @property
    def has_burst(self) -> bool:
        """True when the Gilbert–Elliott burst channel is on."""
        return self.burst_len_s > 0.0

    @property
    def has_loss(self) -> bool:
        """True when any transfer-loss axis (i.i.d. or burst) is on."""
        return self.loss_prob > 0.0 or self.has_burst

    @property
    def has_outages(self) -> bool:
        """True when any PS-outage axis is configured."""
        return bool(self.ps_outages) or self.ps_outage_fraction > 0.0

    @property
    def has_energy(self) -> bool:
        """True when per-sat energy budgets are on."""
        return self.battery_j is not None

    def train_time_scale(self, num_sats: int) -> Optional[np.ndarray]:
        """Per-satellite training-time multipliers (>= 1 under a spread),
        or None when homogeneous — callers then keep the scalar
        ``train_time_s`` math, bit-identical to the fault-free path."""
        if self.compute_rates is not None:
            if len(self.compute_rates) != num_sats:
                raise ValueError(
                    f"FaultModel.compute_rates has {len(self.compute_rates)} "
                    f"entries but the constellation has {num_sats} satellites")
            return np.asarray(self.compute_rates, np.float64)
        if self.compute_rate_spread <= 0.0:
            return None
        rng = np.random.default_rng((self.seed, _TAG_COMPUTE))
        return 1.0 + self.compute_rate_spread * rng.random(num_sats)

    def _eclipse_phases(self, num_sats: int) -> np.ndarray:
        """Seeded per-sat eclipse phases, memoised per constellation size
        (the mask and the point query must agree exactly)."""
        memo = self._phase_memo
        phase = memo.get(num_sats)
        if phase is None:
            rng = np.random.default_rng((self.seed, _TAG_ECLIPSE))
            phase = rng.random(num_sats) * self.eclipse_period_s
            memo[num_sats] = phase
        return phase

    def availability_mask(self, times: np.ndarray,
                          num_sats: int) -> Optional[np.ndarray]:
        """(T, S) bool — True where a satellite is powered/available.
        None when eclipse modelling is off (no grid mutation at all).
        Each satellite is dark for ``eclipse_fraction`` of every
        ``eclipse_period_s`` window, at a seeded per-sat phase."""
        if self.eclipse_fraction <= 0.0:
            return None
        phase = self._eclipse_phases(num_sats)                    # (S,)
        dark = self.eclipse_fraction * self.eclipse_period_s
        rel = (np.asarray(times, np.float64)[:, None] + phase[None, :]) \
            % self.eclipse_period_s
        return rel >= dark

    def sat_available_at(self, sat: int, t: float, num_sats: int) -> bool:
        """Point query of the eclipse availability mask: is ``sat``
        sunlit/powered at instant ``t``?  Exactly the
        ``availability_mask`` formula, so a True here matches a True in
        the grid (used by fault-aware participant selection)."""
        if self.eclipse_fraction <= 0.0:
            return True
        phase = self._eclipse_phases(num_sats)
        dark = self.eclipse_fraction * self.eclipse_period_s
        rel = (float(t) + phase[int(sat)]) % self.eclipse_period_s
        return bool(rel >= dark)

    def in_bad_window(self, sat: int, ps: int, t: float) -> bool:
        """Gilbert–Elliott channel state of the (sat, ps) link at ``t``:
        True in a bad (fading) window.  Pure function of
        ``(seed, sat, ps, window)`` — independent of query order."""
        if not self.has_burst:
            return False
        window = int(float(t) // self.burst_len_s)
        rng = np.random.default_rng(
            (self.seed, _TAG_BURST, int(sat), int(ps), window))
        return bool(rng.random() < self.loss_prob)

    def transfer_fails(self, sat: int, round_idx: int, attempt: int,
                       ps: int = 0, t: float = 0.0) -> bool:
        """Deterministic loss draw for one transfer attempt.

        With ``burst_len_s=0`` (default) this is the i.i.d.
        Bernoulli keyed on (seed, sat, round, attempt) — ``ps`` and
        ``t`` are ignored, so the schedule is bit-identical.  With
        ``burst_len_s > 0`` the (sat, ps) link's Gilbert–Elliott window
        state at the attempt instant ``t`` picks the failure
        probability (``loss_prob_bad`` / ``loss_prob_good``); the
        per-attempt sub-draw is keyed on
        (seed, sat, ps, window, round, attempt).  Either way the result
        is a pure function of the key — independent of event-processing
        order and reproducible across runs."""
        if not self.has_burst:
            if self.loss_prob <= 0.0:
                return False
            if self.loss_prob >= 1.0:
                return True
            rng = np.random.default_rng(
                (self.seed, _TAG_LOSS, int(sat), int(round_idx),
                 int(attempt)))
            return bool(rng.random() < self.loss_prob)
        p = (self.loss_prob_bad if self.in_bad_window(sat, ps, t)
             else self.loss_prob_good)
        if p <= 0.0:
            return False
        if p >= 1.0:
            return True
        window = int(float(t) // self.burst_len_s)
        rng = np.random.default_rng(
            (self.seed, _TAG_LOSS, int(sat), int(ps), window,
             int(round_idx), int(attempt)))
        return bool(rng.random() < p)

    def retry_delay_s(self, attempt: int) -> float:
        """Exponential backoff before retransmission ``attempt + 1``."""
        return float(self.retry_backoff_s * (2.0 ** int(attempt)))

    # ---- PS outages (§11) --------------------------------------------------

    def outage_intervals(self, num_ps: int, duration_s: float) \
            -> Tuple[Tuple[int, float, float], ...]:
        """Compile the configured PS outages into explicit
        ``(ps, start_s, end_s)`` intervals clipped to ``[0, duration_s)``:
        the explicit ``ps_outages`` (validated against ``num_ps`` here,
        like ``compute_rates`` at ``train_time_scale`` time) plus the
        seeded periodic windows from ``ps_outage_fraction`` (dark for
        that fraction of every ``ps_outage_period_s``, at a seeded
        per-PS phase — the server-side eclipse mirror)."""
        out: List[Tuple[int, float, float]] = []
        if self.ps_outages:
            for ps, start, end in self.ps_outages:
                if ps >= num_ps:
                    raise ValueError(
                        f"FaultModel.ps_outages names PS {ps} but the "
                        f"topology has {num_ps} parameter servers")
                s, e = max(0.0, start), min(end, duration_s)
                if e > s:
                    out.append((ps, s, e))
        if self.ps_outage_fraction > 0.0:
            period = self.ps_outage_period_s
            dark = self.ps_outage_fraction * period
            rng = np.random.default_rng((self.seed, _TAG_OUTAGE))
            phase = rng.random(num_ps) * period
            for ps in range(num_ps):
                k_max = int((duration_s + phase[ps]) // period)
                for k in range(k_max + 1):
                    s = k * period - phase[ps]
                    e = s + dark
                    s, e = max(0.0, s), min(e, duration_s)
                    if e > s:
                        out.append((ps, s, e))
        out.sort()
        return tuple(out)

    def outage_mask(self, times: np.ndarray, num_ps: int,
                    duration_s: float) -> Optional[np.ndarray]:
        """(T, P) bool — True where a parameter server is up.  None when
        no outage axis is configured (no grid mutation at all).  ANDed
        into ``VisibilityTimeline.grid`` at simulator construction: a
        dark PS simply has no sat contacts, so every downstream timing
        rule routes around it."""
        ivs = self.outage_intervals(num_ps, duration_s)
        if not ivs:
            return None
        t = np.asarray(times, np.float64)
        avail = np.ones((t.shape[0], num_ps), bool)
        for ps, s, e in ivs:
            avail[(t >= s) & (t < e), ps] = False
        return avail


class OutageSchedule:
    """Compiled per-PS outage intervals with pure point/next queries.

    Built once at simulator construction from
    ``FaultModel.outage_intervals`` (merged, sorted, disjoint per PS);
    every query is a pure function of the schedule and the query
    instant, so runtime recovery decisions are independent of
    event-processing order.  The half-open convention matches the grid
    mask: a PS is down on ``[start, end)`` and up again AT ``end``."""

    def __init__(self, intervals: Sequence[Tuple[int, float, float]],
                 num_ps: int):
        self.num_ps = int(num_ps)
        by: List[List[Tuple[float, float]]] = [[] for _ in range(self.num_ps)]
        for ps, s, e in intervals:
            by[int(ps)].append((float(s), float(e)))
        self._starts: List[List[float]] = []
        self._ends: List[List[float]] = []
        for ivs in by:
            merged: List[Tuple[float, float]] = []
            for s, e in sorted(ivs):
                if merged and s <= merged[-1][1]:
                    merged[-1] = (merged[-1][0], max(merged[-1][1], e))
                else:
                    merged.append((s, e))
            self._starts.append([s for s, _ in merged])
            self._ends.append([e for _, e in merged])

    def events(self) -> List[Tuple[int, float, float]]:
        """Merged ``(ps, start, end)`` intervals, for PS_DOWN / PS_UP
        event scheduling and telemetry."""
        return [(ps, s, e)
                for ps in range(self.num_ps)
                for s, e in zip(self._starts[ps], self._ends[ps])]

    def down_at(self, ps: int, t: float) -> bool:
        """True when ``ps`` is dark at instant ``t``."""
        starts = self._starts[ps]
        i = bisect.bisect_right(starts, float(t)) - 1
        return i >= 0 and float(t) < self._ends[ps][i]

    def next_up(self, ps: int, t: float) -> float:
        """First instant >= ``t`` at which ``ps`` is up (``t`` itself
        when it already is)."""
        starts = self._starts[ps]
        i = bisect.bisect_right(starts, float(t)) - 1
        if i >= 0 and float(t) < self._ends[ps][i]:
            return float(self._ends[ps][i])
        return float(t)

    def all_down_at(self, t: float) -> bool:
        """True when EVERY parameter server is dark at ``t`` (the total
        outage the runtime's horizon clamp guards against)."""
        return all(self.down_at(ps, t) for ps in range(self.num_ps))

    def next_any_up(self, t: float) -> float:
        """First instant >= ``t`` at which at least one PS is up.
        Finite for any finite schedule (every interval ends)."""
        if not self.all_down_at(t):
            return float(t)
        return min(self.next_up(ps, t) for ps in range(self.num_ps))

    def down_set(self, t: float) -> set:
        """The set of PSs dark at ``t`` (for relay-path avoidance)."""
        return {ps for ps in range(self.num_ps) if self.down_at(ps, t)}


class EnergyState:
    """Per-satellite battery bookkeeping (runtime-only consumable state,
    DESIGN.md §11).

    Charge is advanced lazily in closed form at each query instant:
    ``charge(t) = min(cap, charge + rate * (t - t_last))`` with the
    mean-field recharge rate ``recharge_w * (1 - eclipse_fraction)``
    (the sunlit duty cycle), so no per-dt integration loop is needed.
    ``try_drain`` commits a withdrawal; ``time_to_afford`` answers when
    a withdrawal first becomes affordable (None if it never does —
    zero recharge or a cost above capacity).  ``snapshot``/``restore``
    mirror the §9 channel-pool rollback for aborted speculative opens."""

    def __init__(self, fault: FaultModel, num_sats: int):
        self.cap = float(fault.battery_j)
        self.rate_w = float(fault.recharge_w) * \
            (1.0 - float(fault.eclipse_fraction))
        self.train_j = float(fault.train_energy_j)
        self.tx_j = float(fault.tx_energy_j)
        self.charge = np.full(num_sats, self.cap * float(fault.initial_charge),
                              np.float64)
        self.t_last = np.zeros(num_sats, np.float64)
        self.drained_j = 0.0
        self.drains = 0

    def _advance(self, sat: int, t: float) -> None:
        dt = float(t) - self.t_last[sat]
        if dt > 0.0:
            self.charge[sat] = min(self.cap, self.charge[sat]
                                   + self.rate_w * dt)
            self.t_last[sat] = float(t)

    def level(self, sat: int, t: float) -> float:
        """Battery charge (J) of ``sat`` at instant ``t``."""
        self._advance(sat, t)
        return float(self.charge[sat])

    def try_drain(self, sat: int, t: float, joules: float) -> bool:
        """Withdraw ``joules`` at ``t`` if affordable; False otherwise
        (no partial drains)."""
        self._advance(sat, t)
        if self.charge[sat] + 1e-9 < joules:
            return False
        self.charge[sat] = max(0.0, self.charge[sat] - joules)
        self.drained_j += float(joules)
        self.drains += 1
        return True

    def time_to_afford(self, sat: int, t: float,
                       joules: float) -> Optional[float]:
        """First instant >= ``t`` at which ``sat`` can afford ``joules``
        (``t`` itself when it already can); None when it never will."""
        self._advance(sat, t)
        deficit = float(joules) - self.charge[sat]
        if deficit <= 0.0:
            return float(t)
        if self.rate_w <= 0.0 or float(joules) > self.cap + 1e-9:
            return None
        return float(t) + deficit / self.rate_w

    def snapshot(self):
        return (self.charge.copy(), self.t_last.copy(),
                self.drained_j, self.drains)

    def restore(self, snap) -> None:
        charge, t_last, drained_j, drains = snap
        self.charge = charge.copy()
        self.t_last = t_last.copy()
        self.drained_j = drained_j
        self.drains = drains
