"""FL-Satcom strategies: AsyncFLEO and the paper's baselines (§II, §V-A).

Each strategy is a declarative spec consumed by ``repro_torch.core.simulator``:

=================  ====== ======= ========== ============ =====================
strategy           sync   ISL     grouping   aggregation  PS placement
=================  ====== ======= ========== ============ =====================
asyncfleo-gs       no     yes     yes        asyncfleo    GS, arbitrary (Rolla)
asyncfleo-hap      no     yes     yes        asyncfleo    1 HAP, arbitrary
asyncfleo-twohap   no     yes     yes        asyncfleo    2 HAPs (ring)
fedavg / fedisl    yes    yes     no         fedavg       GS, arbitrary
fedisl-ideal       yes    yes     no         fedavg       GS at the North Pole
fedsat             no     no      no         per-arrival  GS at the North Pole
fedspace           no     no      no         interval     GS, arbitrary
fedhap             yes    yes     no         fedavg       1 HAP
fedasync           no     yes     no         per-arrival  GS, arbitrary
asyncfleo-pipelined no    yes     yes        asyncfleo    GS, 3 rounds in flight
=================  ====== ======= ========== ============ =====================

FedSpace's real scheduler optimizes the schedule from uploaded raw-data
fractions (which AsyncFLEO criticizes); we emulate its idle-vs-staleness
trade-off with a fixed-interval staleness-weighted aggregation (DESIGN.md §3).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

# mirror of repro_torch.core.aggregation.STALENESS_FNS (kept literal here so this
# module stays import-light; tests/test_torch_aggregation.py pins the
# two in sync)
_STALENESS_FNS = ("eq13", "constant", "hinge", "poly")
_AGG_MODES = ("asyncfleo", "fedavg", "per_arrival", "interval")


@dataclasses.dataclass(frozen=True)
class StrategySpec:
    name: str
    sync: bool
    use_isl: bool
    grouping: bool
    agg_mode: str                    # asyncfleo | fedavg | per_arrival | interval
    ps_scenario: str                 # gs | hap | twohap | gs-np | hapring:N
    interval_s: float = 1800.0       # for agg_mode == interval
    num_groups: int = 3
    strict_paper_eq14: bool = False
    # the JAX package's switch for its Pallas eq. 14 kernel; kept so the
    # two strategy tables stay field-for-field equal.  The port reads it
    # nowhere: a CUDA tensor always goes through the fed_agg kernel
    use_agg_kernel: bool = False
    # event-runtime trigger policy (sched/policies.py): "" derives it from
    # sync/agg_mode — sync -> barrier, per_arrival -> FedAsync, else the
    # AsyncFLEO idle-timeout window
    sched_policy: str = ""
    # pipelined event runtime (sched/runtime.py, DESIGN.md §8): how many
    # rounds may be in flight at once (1 = the single-round loop,
    # bit-identical to the epoch loop) and which sink-handoff policy
    # picks the next source/sink PS ("" -> the §IV-B3 ring role swap;
    # "next_contact" -> earliest-next-contact from the contact plan)
    max_in_flight: int = 1
    handoff_policy: str = ""
    # per-divergence-group trigger deadlines for the AsyncFLEO policy:
    # ((group_id, window_s), ...) pairs (group -1 = not-yet-grouped
    # orbits); empty keeps the single global agg_timeout_s window
    group_timeouts: tuple = ()
    # finite per-PS link capacity (sched/contacts.ContentionModel,
    # DESIGN.md §9): how many model transfers a PS can send (and,
    # separately, receive) in parallel — concurrent transfers at the same
    # PS beyond this serialize FIFO, including transfers from different
    # in-flight rounds.  None = infinite parallelism with no contention
    # state at all, bit-identical to the pre-contention semantics (the
    # parity default)
    ps_channels: Optional[int] = None
    # staleness-mitigation function for the asyncfleo aggregation mode
    # (core/aggregation.staleness_factor): "eq13" is the paper's k_n/beta
    # discount; "constant" / "hinge" / "poly" are the FedAsync family
    # (SNIPPETS.md §1) over the staleness gap beta - k_n
    staleness_fn: str = "eq13"
    # contention-aware trigger windows (DESIGN.md §10): when set, the
    # AsyncFLEO policy multiplies an idle window by
    # rx_backlog_window_scale whenever the sink PS's pending rx-channel
    # backlog exceeds this many channel-seconds at window-open time — a
    # congested sink commits sooner instead of waiting for arrivals that
    # are stuck in the queue anyway.  None (default) = off, windows
    # bit-identical to the uncontended trigger logic
    rx_backlog_threshold_s: Optional[float] = None
    rx_backlog_window_scale: float = 0.5
    # fault-aware participant selection (DESIGN.md §11): when True, the
    # event runtime skips recruiting satellites whose FaultModel eclipse
    # window covers the expected uplink instant (recv + training time),
    # or whose expected uplink lands in a total PS outage — the model
    # would only wait out the dark window anyway.  False (default) keeps
    # recruitment bit-identical to the fault-unaware runtime
    fault_aware_selection: bool = False

    def __post_init__(self):
        """Fail fast on malformed specs — a bad channel count or timeout
        table used to surface as an opaque IndexError deep in the
        runtime."""
        if self.agg_mode not in _AGG_MODES:
            raise ValueError(f"StrategySpec.agg_mode must be one of "
                             f"{_AGG_MODES}, got {self.agg_mode!r}")
        if self.staleness_fn not in _STALENESS_FNS:
            raise ValueError(f"StrategySpec.staleness_fn must be one of "
                             f"{_STALENESS_FNS}, got {self.staleness_fn!r}")
        if self.interval_s <= 0.0:
            raise ValueError(f"StrategySpec.interval_s must be > 0, "
                             f"got {self.interval_s}")
        if int(self.num_groups) < 1:
            raise ValueError(f"StrategySpec.num_groups must be >= 1, "
                             f"got {self.num_groups}")
        if int(self.max_in_flight) < 1:
            raise ValueError(f"StrategySpec.max_in_flight must be >= 1, "
                             f"got {self.max_in_flight}")
        if self.ps_channels is not None and int(self.ps_channels) < 1:
            raise ValueError(f"StrategySpec.ps_channels must be >= 1 or "
                             f"None (infinite), got {self.ps_channels}")
        for pair in self.group_timeouts:
            try:
                ok = (len(pair) == 2 and float(pair[0]) == int(pair[0])
                      and float(pair[1]) > 0.0)
            except (TypeError, ValueError):
                ok = False
            if not ok:
                raise ValueError(
                    "StrategySpec.group_timeouts must be (group_id, "
                    f"window_s > 0) pairs, got {self.group_timeouts!r}")
        if (self.rx_backlog_threshold_s is not None
                and self.rx_backlog_threshold_s < 0.0):
            raise ValueError(f"StrategySpec.rx_backlog_threshold_s must be "
                             f">= 0 or None, got {self.rx_backlog_threshold_s}")
        if not 0.0 < self.rx_backlog_window_scale <= 1.0:
            raise ValueError(f"StrategySpec.rx_backlog_window_scale must be "
                             f"in (0, 1], got {self.rx_backlog_window_scale}")


STRATEGIES = {
    "asyncfleo-gs": StrategySpec("asyncfleo-gs", False, True, True,
                                 "asyncfleo", "gs"),
    "asyncfleo-hap": StrategySpec("asyncfleo-hap", False, True, True,
                                  "asyncfleo", "hap"),
    "asyncfleo-twohap": StrategySpec("asyncfleo-twohap", False, True, True,
                                     "asyncfleo", "twohap"),
    "fedisl": StrategySpec("fedisl", True, True, False, "fedavg", "gs"),
    "fedisl-ideal": StrategySpec("fedisl-ideal", True, True, False,
                                 "fedavg", "gs-np"),
    "fedsat": StrategySpec("fedsat", False, False, False,
                           "per_arrival", "gs-np"),
    "fedspace": StrategySpec("fedspace", False, False, False,
                             "interval", "gs"),
    "fedhap": StrategySpec("fedhap", True, True, False, "fedavg", "hap"),
    # FedAsync-style baseline: immediate per-arrival aggregation at a GS
    # PS, full ISL relay — only meaningfully different from fedsat under
    # the event-driven runtime, where every MODEL_ARRIVAL triggers its own
    # aggregation instead of a batched window
    "fedasync": StrategySpec("fedasync", False, True, False,
                             "per_arrival", "gs", sched_policy="per_arrival"),
    # pipelined AsyncFLEO (DESIGN.md §8): same physics and PS placement
    # as asyncfleo-gs, but the event runtime keeps up to 3 rounds in
    # flight and opens each from the contact-plan-chosen PS — the
    # head-to-head row that isolates what overlap buys
    "asyncfleo-pipelined": StrategySpec("asyncfleo-pipelined", False, True,
                                        True, "asyncfleo", "gs",
                                        max_in_flight=3,
                                        handoff_policy="next_contact"),
}


def get_strategy(name: str) -> StrategySpec:
    if name not in STRATEGIES:
        raise KeyError(f"unknown strategy {name!r}; available: {sorted(STRATEGIES)}")
    return STRATEGIES[name]
