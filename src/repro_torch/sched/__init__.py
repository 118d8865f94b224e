"""Event-driven async FL scheduling (DESIGN.md §7-§9), as the JAX
package's ``repro.sched``: contact plans compiled from orbital geometry,
a priority-queue runtime that pipelines up to
``StrategySpec.max_in_flight`` overlapping rounds over the fused epoch
step, pluggable trigger policies (AsyncFLEO / sync barrier / FedAsync,
with optional per-divergence-group deadlines), sink handoff policies
(ring role swap / contact-plan next-contact), and finite per-PS link
capacity (``ContentionModel``: ``StrategySpec.ps_channels`` parallel
tx/rx channels per PS, FIFO grants, cross-round serialization), plus the
pluggable fault/heterogeneity layer (``FaultModel``: per-sat compute
rates, eclipse availability, lossy transfers with bounded retry/backoff)
and its §11 degradation-and-recovery axes (Gilbert–Elliott burst loss,
PS outage schedules with ring failover, per-sat energy budgets)."""
from repro_torch.sched.contacts import (ChannelPool, ContactPlan,
                                        ContactWindow, ContentionModel)
from repro_torch.sched.events import Event, EventKind, EventQueue
from repro_torch.sched.faults import EnergyState, FaultModel, OutageSchedule
from repro_torch.sched.policies import (AsyncFLEOPolicy, FedAsyncPolicy,
                                        HANDOFF_POLICIES, NextContactHandoff,
                                        POLICIES, RingHandoff,
                                        SyncBarrierPolicy,
                                        make_handoff_policy, make_policy)
from repro_torch.sched.runtime import EventDrivenRuntime, RoundState

__all__ = ["ChannelPool", "ContactPlan", "ContactWindow", "ContentionModel",
           "Event", "EventKind", "FaultModel", "OutageSchedule",
           "EnergyState", "EventQueue", "AsyncFLEOPolicy",
           "SyncBarrierPolicy", "FedAsyncPolicy", "POLICIES", "make_policy",
           "RingHandoff", "NextContactHandoff", "HANDOFF_POLICIES",
           "make_handoff_policy", "EventDrivenRuntime", "RoundState"]
