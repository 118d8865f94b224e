"""Discrete-event FL simulation over LEO trajectories (paper §V).

The simulator advances *simulated* time (seconds over a 3-day horizon) while
running real PyTorch training for every satellite's local model.  Per
global epoch beta:

  1. downlink  — Alg. 1 timing gives each satellite its receive time of
     w^beta (ring-of-stars + ISL relay for strategies that have ISL; plain
     next-visibility otherwise);
  2. train     — each satellite trains for J local iterations (real SGD),
     finishing ``train_time_s`` later in simulated time;
  3. uplink    — arrival time of each local model at the sink PS;
  4. aggregate — strategy-dependent trigger and rule (AsyncFLEO grouping +
     staleness discounting; FedAvg barrier; per-arrival; fixed interval);
  5. evaluate  — test accuracy of the new global model at the trigger time.

Three trainer paths, fastest first (DESIGN.md §2/§6):

* **fused** — trainers exposing the fused-epoch protocol
  (``epoch_train_fn`` + ``epoch_inputs``) run steps 2-4 as one
  ``EpochStepProgram.step`` call per epoch (``core/epoch_step.py``):
  propagation timing and all per-model weight metadata math happen on the
  host *before* the call, which trains, aggregates (eq. 14 through the
  fed_agg kernel) and computes the grouping distances on the device.
  Accuracy values stay device tensors until the history is finalized.
  Carried stragglers live in a small device matrix re-gathered per epoch.
* **stacked** (``use_fused_step=False``, or a trainer with
  ``train_many_stacked`` only) keeps the local models as one (C, N) device
  stack through grouping and aggregation, with separate calls: training,
  the grouping contractions, one ``combine_stacked`` over the epoch's
  bank and carried stragglers.
* **legacy** (``use_model_bank=False``, or a trainer with ``train_many``
  only) takes the seed's per-model path: a parameter dict per satellite,
  grouping distances as host numpy, aggregation through ``weighted_sum``
  (one ``fed_agg`` call, chained per arrival for the per-arrival EMA).

The output is a history of (sim_time_s, epoch, accuracy, ...) rows, from
which convergence time (time to reach a target accuracy) is read — the
paper's Table II / Fig. 6 quantities.

``SimConfig.event_driven`` hands the run to the event-driven runtime
(`sched/runtime.py`), which drives the same fused commit under trigger
policies, with pipelined rounds and, with ``StrategySpec.ps_channels``,
finite per-PS link capacity.  ``SimConfig.fault_model`` attaches the
fault layer (`sched/faults.py`): per-satellite compute rates in the
epoch loop and the runtime, eclipse and PS-outage masks on the
visibility grid, and — on the event-driven runtime only — lossy
transfers, outage failover and energy budgets.
``SimConfig.visibility="sparse"`` compiles the contact geometry as
segments instead of the dense grid, with the same answers.
``SimConfig.profiler`` attaches an ``obs/profile.DispatchProfiler`` to
the run's epoch step (read-only: the same history and model bits).
``SimConfig.dispatcher`` (a ``sweep/batch.DispatchBatcher``) routes the
fused steps of one scenario of a sweep through the batcher.

A device mesh (``SimConfig.mesh``) is not ported: it raises
``NotImplementedError`` naming the slice of the port that brings it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import aggregation as agg
from repro_torch.core.aggregation import SatelliteMeta
from repro_torch.core.constellation import (WalkerDelta, make_ps_nodes,
                                            paper_constellation)
from repro_torch.core.epoch_step import (carry_capacity, make_epoch_program,
                                         next_pow2)
from repro_torch.core.grouping import (GroupingState, segment_partial_inputs,
                                       segment_weight_matrix)
from repro_torch.core.links import LinkModel, model_bits
from repro_torch.core.modelbank import FlatSpec, gather_rows, pad_bucket_ids
from repro_torch.core.propagation import PropagationModel
from repro_torch.core.topology import RingOfStars
from repro_torch.core.visibility import (SparseVisibilityTimeline,
                                         VisibilityTimeline)
from repro_torch.fl.strategies import StrategySpec


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: it comes with ROADMAP queue A item "
        f"{item} of the PyTorch port")


@dataclasses.dataclass
class SimConfig:
    """The JAX package's ``SimConfig``, field for field.  ``mesh`` is not
    ported yet and must stay None: ``FLSimulation`` raises
    ``NotImplementedError`` otherwise."""
    duration_s: float = 3 * 86400.0
    dt_s: float = 10.0
    train_time_s: float = 600.0        # on-board local-training wall time
    agg_timeout_s: float = 1500.0      # async collection window per epoch
    min_models: int = 2                # never aggregate on fewer arrivals
    eval_fn: Optional[object] = None   # params -> accuracy
    seed: int = 0
    sync_stall_s: float = 86400.0      # cap a sync round at this (stragglers)
    link: Optional[LinkModel] = None   # None -> paper Table I RF (16 Mb/s)
    use_model_bank: bool = True        # stacked path when trainer supports it
    use_fused_step: bool = True        # one epoch step a call (DESIGN §6)
    mesh: Optional[object] = None      # a device mesh (not ported)
    event_driven: bool = False         # run() delegates to sched.runtime
    # pluggable fault/heterogeneity layer (sched/faults.FaultModel,
    # DESIGN.md §10-§11); None attaches NO fault state at all —
    # bit-identical to the fault-free simulator
    fault_model: Optional[object] = None
    tracer: Optional[object] = None        # obs/trace.Tracer (event runtime)
    profiler: Optional[object] = None      # obs/profile.DispatchProfiler
    # scenario-batched sweeps (sweep/batch.DispatchBatcher, DESIGN.md
    # §13): `_init_run` wraps the fused program in the batcher's proxy so
    # this simulation's epoch steps multiplex with the sweep's other
    # scenarios; None attaches nothing
    dispatcher: Optional[object] = None
    # contact-plan geometry backend (DESIGN.md §14): "dense" precomputes
    # the (T, S, P) visibility grid; "sparse" compiles per-(sat, PS)
    # window segments and answers every query by bisect — the same
    # answers, O(windows) memory.  Sparse cannot host the fault grid-masks
    # (eclipse/outage masks AND into the dense grid), so those
    # combinations raise at construction
    visibility: str = "dense"


def _check_ported(sim: SimConfig) -> None:
    if sim.mesh is not None:
        raise _not_ported("SimConfig.mesh", "15 (mesh- and pod-shaped code)")
    if sim.visibility not in ("dense", "sparse"):
        raise ValueError(f"visibility must be dense|sparse: {sim.visibility}")


@dataclasses.dataclass
class EpochRecord:
    epoch: int
    time_s: float
    accuracy: float
    num_models: int
    gamma: float
    stale_groups: int


def split_min_models(arrivals, t_agg: float, min_models: int):
    """(t_agg, used, late) partition of SORTED arrivals at ``t_agg`` with
    the ``min_models`` backstop: when fewer than ``min_models`` arrivals
    land inside the window, the first ``min_models`` are aggregated anyway
    and ``t_agg`` moves to the last of them.

    ``used`` is always a *prefix* of the sorted arrivals and ``late`` the
    exact remainder, so ``used + late == arrivals`` holds on every branch
    — in particular, arrivals *tied* at the backstop's ``t_agg`` beyond
    the ``min_models`` slice are carried as late, never dropped.
    """
    used = [a for a in arrivals if a[0] <= t_agg]
    if len(used) < min_models:
        used = arrivals[:min_models]
        t_agg = used[-1][0] if used else t_agg
    return t_agg, used, arrivals[len(used):]


class FLSimulation:
    def __init__(self, spec: StrategySpec, trainer, evaluator,
                 sim: SimConfig, constellation: Optional[WalkerDelta] = None):
        _check_ported(sim)
        self.spec = spec
        self.trainer = trainer
        self.evaluator = evaluator
        self.sim = sim
        self.constellation = constellation or paper_constellation()
        self.nodes = make_ps_nodes(spec.ps_scenario)
        tl_cls = (SparseVisibilityTimeline if sim.visibility == "sparse"
                  else VisibilityTimeline)
        self.timeline = tl_cls(self.constellation, self.nodes,
                               sim.duration_s, sim.dt_s)
        # fault/heterogeneity layer (DESIGN.md §10): eclipse windows mask
        # the visibility grid BEFORE anything derives state from it (the
        # timeline's next-visible cache, the topology, the contact plan's
        # windows and covers), so every downstream rule routes around dark
        # satellites with no special cases; the per-sat training-time
        # scale is applied in _train_times (None = scalar math,
        # bit-identical to the fault-free path)
        self.fault = sim.fault_model
        self._train_scale = None
        self._outages = None
        if self.fault is not None:
            S = self.constellation.num_sats
            self._train_scale = self.fault.train_time_scale(S)
            mask = self.fault.availability_mask(self.timeline.times, S)
            # PS outage windows (DESIGN.md §11) mask the PS axis the same
            # way — a dark parameter server has no satellite contacts —
            # and the compiled OutageSchedule drives the event runtime's
            # ring-failover recovery.  No outage config -> no schedule,
            # no grid mutation at all (the off-switch contract)
            omask = self.fault.outage_mask(self.timeline.times,
                                           len(self.nodes), sim.duration_s)
            if sim.visibility == "sparse" and (mask is not None
                                               or omask is not None):
                raise ValueError(
                    "sparse visibility cannot host eclipse/outage "
                    "grid-masks — use visibility='dense' with this "
                    "fault model")
            if mask is not None:
                self.timeline.grid &= mask[:, :, None]
            if omask is not None:
                # lazy, as the contact plan below: sched imports core
                from repro_torch.sched.faults import OutageSchedule
                self.timeline.grid &= omask[:, None, :]
                self._outages = OutageSchedule(
                    self.fault.outage_intervals(len(self.nodes),
                                                sim.duration_s),
                    len(self.nodes))
        self.topo = RingOfStars(self.constellation, self.nodes, self.timeline)
        self.prop = PropagationModel(self.topo, sim.link or LinkModel())
        # the compiled contact plan owns the downlink/uplink timing rules
        # (including the use_isl switch) and is shared with the
        # event-driven runtime; lazy import keeps core <-> sched acyclic
        from repro_torch.sched.contacts import ContactPlan, ContentionModel
        self.plan = ContactPlan(self.constellation, self.nodes,
                                self.timeline, self.topo, self.prop,
                                use_isl=spec.use_isl)
        if spec.ps_channels is not None:
            # finite per-PS link capacity (DESIGN.md §9): every sat<->PS
            # model transfer serializes over spec.ps_channels parallel
            # channels; None keeps infinite parallelism with NO contention
            # state at all (the parity default)
            self.plan.contention = ContentionModel(len(self.nodes),
                                                   int(spec.ps_channels))
        self.grouping = GroupingState(num_groups=spec.num_groups)
        self.orbit_ids = self.constellation.orbit_ids()
        self.last_epoch_included: Dict[int, int] = {}
        # legacy path: (arrival_t, sat, parameter dict, trained_from_epoch)
        self.pending: List[tuple] = []
        # stacked + fused paths: stragglers live in a small DEVICE matrix
        # (O(late) rows, not O(S)) and re-enter aggregation as one term
        self._pend_dev: Optional[torch.Tensor] = None      # (L, N)
        self._pend_meta: List[tuple] = []      # (arrival_t, sat, epoch)
        self._spec: Optional[FlatSpec] = None
        self._w_flat: Optional[torch.Tensor] = None
        self._fused_prog = None        # the run's epoch program (fused path)
        # distances of newly seen orbits are fetched lazily — (new_orbits,
        # device dists, block map, block size), resolved at the next
        # grouping read so the next epoch's host timing overlaps the
        # device stream instead of draining it
        self._dist_pending = None
        # the event-driven runtime of the last event-driven run (its
        # stats, its tracer); None until then
        self.runtime = None
        # wall-time attribution per host-side section
        self.segment_seconds: Dict[str, float] = {
            k: 0.0 for k in ("timing", "train", "step", "agg", "group",
                             "carry", "eval")}

    @contextlib.contextmanager
    def _seg(self, key: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.segment_seconds[key] += time.perf_counter() - t0

    def _combine(self, segments, weights, base_flat, base_weight: float):
        """Map metas-indexed ``weights`` onto per-segment weight vectors and
        run one ``combine_stacked`` over the segments (host bookkeeping and
        one ``fed_agg`` call for the bank and the carried stragglers)."""
        terms = []
        for stack, rows in segments:
            if stack is None or stack.shape[0] == 0:
                continue
            terms.append((stack,
                          agg.scatter_weights(rows, weights, stack.shape[0])))
        out = agg.combine_stacked(terms, base_flat, base_weight)
        return base_flat if out is None else out

    # ---- shared per-epoch host metadata ------------------------------

    def _trigger(self, arrivals, t: float):
        """Aggregation trigger: (t_agg, used, late) from sorted arrivals.
        ``used`` is a prefix of ``arrivals`` and ``late`` the exact
        remainder."""
        sim, spec = self.sim, self.spec
        if spec.sync:
            # barrier: last expected arrival, capped by the straggler
            # stall AND the simulation horizon
            t_agg = min(arrivals[-1][0] if arrivals else t,
                        t + sim.sync_stall_s, sim.duration_s)
            used = [a for a in arrivals if a[0] <= t_agg]
            return t_agg, used, arrivals[len(used):]
        t_first = arrivals[0][0] if arrivals else t
        t_agg = min(t_first + sim.agg_timeout_s, sim.duration_s)
        return split_min_models(arrivals, t_agg, sim.min_models)

    def _mode_weights(self, metas: List[SatelliteMeta], beta: int,
                      groups: Optional[Dict[int, List[int]]]):
        """Per-model weight vector + base weight for the epoch update
        (:func:`repro_torch.core.aggregation.epoch_weight_vector`)."""
        return agg.epoch_weight_vector(
            self.spec.agg_mode, metas, beta, groups,
            strict_paper_eq14=self.spec.strict_paper_eq14,
            staleness_fn=self.spec.staleness_fn)

    @staticmethod
    def _blocked_layout(new_orbits, orbit_indices, bank_rows, n_rows: int,
                        kpad: int):
        """Detect whether every new orbit's bank rows sit in one distinct
        contiguous block of ``n_rows // kpad`` rows (the common
        full-participation layout).  Returns (block size m, orbit-index ->
        block map); (0, {}) when the layout is irregular and the step must
        fall back to the dense one-hot GEMM.  The blocked einsum is
        O(C*N) instead of O(K*C*N) — see DESIGN.md §6."""
        if not kpad or not n_rows or n_rows % kpad:
            return 0, {}
        mb = n_rows // kpad
        block_of: Dict[int, int] = {}
        used = set()
        homeless = []
        for k, o in enumerate(new_orbits):
            blocks = {bank_rows[j] // mb for j in orbit_indices[o]
                      if bank_rows[j] >= 0}
            if len(blocks) > 1:
                return 0, {}
            if blocks:
                b = blocks.pop()
                if b in used:
                    return 0, {}
                block_of[k] = b
                used.add(b)
            else:
                homeless.append(k)      # carry-only orbit: any free block
        free = (b for b in range(kpad) if b not in used)
        for k in homeless:
            b = next(free, None)
            if b is None:
                return 0, {}
            block_of[k] = b
        return mb, block_of

    def _resolve_pending_dists(self) -> None:
        """Fetch + record the previous epoch's new-orbit distances.  MUST
        run before any grouping-state read (``group_of`` / ``groups``)."""
        pend = self._dist_pending
        if pend is None:
            return
        self._dist_pending = None
        new_orbits, dists, block_of, blocked_m = pend
        with self._seg("group"):
            ds_full = dists.cpu().numpy()          # tiny (kpad,) transfer
            if blocked_m:
                ds = ds_full[[block_of[k] for k in range(len(new_orbits))]]
            else:
                ds = ds_full[:len(new_orbits)]
            self.grouping.assign_distances(new_orbits, ds)

    def _carried_split(self, t_agg: float):
        """Indices of pending stragglers that arrived (<= t_agg) vs kept."""
        c_idx = [i for i, (ta, _s, _ep) in enumerate(self._pend_meta)
                 if ta <= t_agg]
        k_idx = [i for i in range(len(self._pend_meta)) if i not in c_idx]
        return c_idx, k_idx

    def _train_times(self, participants):
        """Per-participant local-training durations.  Homogeneous fleets
        get the scalar ``train_time_s`` (bit-identical to the fault-free
        arithmetic); under a FaultModel compute-rate spread each
        satellite's duration is stretched by its multiplier, which is how
        heterogeneity reaches every TRAIN_DONE instant of the epoch loop and
        the event runtime alike."""
        if self._train_scale is None:
            return self.sim.train_time_s
        return (self.sim.train_time_s
                * self._train_scale[np.asarray(participants, np.int64)])

    # ---- fused path (one step per epoch, DESIGN.md §6) ---------------

    def _arrival_times(self, participants, recv, bits, sink):
        """Participant timing for one round: padded bank ids, per-row
        training-done times, raw per-row sink arrival times, and the
        sorted finite (t_arr, sat, row) arrival triples.  ONE shared
        implementation for the epoch loop and the event runtime, so their
        timing math is identical by construction."""
        ids_np, _n = pad_bucket_ids(participants)
        t_done = recv[participants] + self._train_times(participants)
        t_arr, _haps = self.plan.uplink_times(participants, t_done, bits,
                                              sink)
        arrivals = [(float(t_arr[k]), s, k)
                    for k, s in enumerate(participants)
                    if np.isfinite(t_arr[k])]
        arrivals.sort(key=lambda a: a[0])
        return ids_np, t_done, t_arr, arrivals

    def _fused_epoch(self, prog, beta, participants, recv, t, bits, sink):
        """One epoch-loop iteration: propagation timing and the `_trigger`
        split happen here, everything after the trigger is
        `_fused_commit`."""
        arrivals = []
        ids_np = np.zeros(0, np.int32)
        if participants:
            with self._seg("timing"):
                ids_np, _td, _ta, arrivals = self._arrival_times(
                    participants, recv, bits, sink)
        if not arrivals and not self._pend_meta:
            return None
        t_agg, used, late = self._trigger(arrivals, t)
        return self._fused_commit(prog, beta, ids_np, participants, t_agg,
                                  used, late)

    def _fused_commit(self, prog, beta, ids_np, participants, t_agg, used,
                      late, train_epoch: Optional[int] = None):
        """Post-trigger tail of a fused epoch: metas/carry bookkeeping,
        grouping metadata, weight vectors, the one step call, and the
        straggler carry-over.  ``used``/``late`` are (t_arr, sat, bank row)
        triples split at ``t_agg`` — by `_trigger` on the epoch loop, by a
        trigger policy in the event runtime (`sched/runtime.py`).

        ``train_epoch`` names the round the commit belongs to: the global
        epoch counter when the round's downlink left the source (defaults
        to ``beta``, the epoch-loop case where rounds never overlap).
        With the pipelined runtime (DESIGN.md §8) a round may commit
        after later-opened rounds advanced ``beta``; its models — used
        AND late-carried — are stamped with ``train_epoch``, so eq. 13's
        staleness discount and Alg. 2's fresh/stale selection see the
        model version the round actually started from."""
        sim, spec = self.sim, self.spec
        if train_epoch is None:
            train_epoch = beta
        # the minibatch seed stays keyed on the commit-time counter:
        # commits are serialized so beta is unique per training step,
        # while two overlapping pipelined rounds can share a train_epoch
        # (and must NOT draw identical minibatch streams)
        seed = sim.seed * 1000 + beta
        self._spec = prog.spec
        N = prog.spec.num_params
        dev = self._w_flat.device
        c_idx, k_idx = self._carried_split(t_agg)

        metas = [SatelliteMeta(s, self.trainer.data_size(s),
                               loc=(0.0, 0.0), ts=ta, epoch=train_epoch)
                 for (ta, s, _k) in used]
        metas += [SatelliteMeta(s, self.trainer.data_size(s),
                                loc=(0.0, 0.0), ts=ta, epoch=ep)
                  for (ta, s, ep) in (self._pend_meta[i] for i in c_idx)]
        bank_rows = [k for (_, _, k) in used] + [-1] * len(c_idx)
        carry_rows = [-1] * len(used) + list(range(len(c_idx)))
        keep = agg.dedup_indices(metas)
        if len(keep) < len(metas):
            metas = [metas[i] for i in keep]
            bank_rows = [bank_rows[i] for i in keep]
            carry_rows = [carry_rows[i] for i in keep]

        # carried stragglers: a small padded device matrix (pad rows repeat
        # row 0 and carry zero weight), rebuilt from _pend_dev every epoch
        cap = carry_capacity(len(c_idx))
        if c_idx:
            gids = np.asarray(c_idx + [c_idx[0]] * (cap - len(c_idx)),
                              np.int64)
            carry = gather_rows(self._pend_dev, gids)
        else:
            carry = torch.zeros((cap, N), dtype=torch.float32, device=dev)

        # groups + new-orbit partial-model inputs (host metadata): the step
        # computes distances as an O(C*N) segment-sum, so the host ships
        # per-row weights + segment ids, not a (K, C) matrix
        groups = None
        new_orbits: List[int] = []
        orbit_indices: Dict[int, List[int]] = {}
        kpad, blocked_m = 0, 0
        block_of: Dict[int, int] = {}
        dw_row = np.zeros(len(ids_np), np.float32)
        dw_seg = np.zeros(len(ids_np), np.int32)
        dw_carry = np.zeros((0, cap), np.float32)
        fallback = False
        if spec.agg_mode == "asyncfleo" and not spec.grouping:
            groups = {0: list(range(len(metas)))}
        elif spec.agg_mode == "asyncfleo":
            self._resolve_pending_dists()        # state read follows
            for i, meta in enumerate(metas):
                orbit_indices.setdefault(
                    int(self.orbit_ids[meta.sat_id]), []).append(i)
            known = {o: self.grouping.group_of(o) for o in orbit_indices}
            new_orbits = [o for o, g in known.items() if g is None]
            if new_orbits:
                sizes = [m.size for m in metas]
                totals = {o: float(sum(sizes[j] for j in orbit_indices[o]))
                          for o in new_orbits}
                kpad = next_pow2(len(new_orbits))
                dw_row, dw_seg = segment_partial_inputs(
                    new_orbits, orbit_indices, bank_rows, sizes, totals,
                    len(ids_np), kpad)
                carry_w = segment_weight_matrix(
                    new_orbits, orbit_indices, carry_rows, sizes, totals,
                    cap)
                blocked_m, block_of = self._blocked_layout(
                    new_orbits, orbit_indices, bank_rows, len(ids_np),
                    kpad)
                dw_carry = np.zeros((kpad, cap), np.float32)
                if blocked_m:
                    for k in range(len(new_orbits)):
                        dw_carry[block_of[k]] = carry_w[k]
                else:
                    dw_carry[:len(new_orbits)] = carry_w
            any_stale = any(not m.is_fresh(beta) for m in metas)
            # group membership only moves weights through which *stale*
            # models survive selection; with everything fresh the weights
            # are group-independent, so provisional singleton groups keep
            # the epoch at one step.  A new orbit arriving while stale
            # models are pending is the one case where the weight vector
            # depends on this epoch's distances -> step, then aggregate.
            fallback = bool(new_orbits) and any_stale
            groups = {}
            provisional = -1
            for o, idxs in orbit_indices.items():
                gi = known[o]
                if gi is None:
                    gi = provisional
                    provisional -= 1
                groups.setdefault(gi, []).extend(idxs)

        if not participants:
            # nothing trained this epoch: no step — one combine over the
            # carried-stragglers matrix only
            return self._fused_no_train(beta, metas, carry, carry_rows,
                                        c_idx, k_idx, new_orbits,
                                        orbit_indices, groups, t_agg)

        with self._seg("agg"):
            if fallback:
                wv_bank = np.zeros(len(ids_np), np.float32)
                wv_carry = np.zeros(cap, np.float32)
                base_w, info = 1.0, None
            else:
                ws, base_w, info = self._mode_weights(metas, beta, groups)
                wv_bank = agg.scatter_weights(bank_rows, ws, len(ids_np))
                wv_carry = agg.scatter_weights(carry_rows, ws, cap)

        with self._seg("step"):
            inputs = self.trainer.epoch_inputs(ids_np)
            new_w, stack, dists, losses = prog.step(
                self._w_flat, carry, inputs, ids_np, seed,
                wv_bank, wv_carry, base_w, dw_row, dw_seg, kpad,
                blocked_m, dw_carry, self.grouping.ref_device(),
                fallback=fallback)

        if new_orbits:
            # don't block here: the fetch resolves at the next grouping
            # read, letting the next epoch's host work overlap the stream
            self._dist_pending = (new_orbits, dists, block_of, blocked_m)

        if fallback:
            self._resolve_pending_dists()        # weights need the groups
            with self._seg("agg"):
                groups = {}
                for o, idxs in orbit_indices.items():
                    gi = self.grouping.group_of(o)
                    groups.setdefault(gi, []).extend(idxs)
                ws, base_w, info = self._mode_weights(metas, beta, groups)
                out = agg.combine_stacked(
                    [(stack, agg.scatter_weights(bank_rows, ws,
                                                 len(ids_np))),
                     (carry if c_idx else None,
                      agg.scatter_weights(carry_rows, ws, cap))],
                    new_w, base_w)
                new_w = out if out is not None else new_w

        # retire carried stragglers, enqueue this epoch's late rows
        with self._seg("carry"):
            kept_meta = [self._pend_meta[i] for i in k_idx]
            kept_dev = (gather_rows(self._pend_dev, k_idx)
                        if k_idx else None)
            if late:
                late_dev = gather_rows(stack, [k for (_, _, k) in late])
                kept_dev = (late_dev if kept_dev is None
                            else torch.cat([kept_dev, late_dev]))
                kept_meta += [(ta, s, train_epoch)
                              for (ta, s, _k) in late]
            self._pend_dev, self._pend_meta = kept_dev, kept_meta

        self._w_flat = new_w
        return t_agg, metas, info, losses

    def _fused_no_train(self, beta, metas, carry, carry_rows, c_idx, k_idx,
                        new_orbits, orbit_indices, groups, t_agg):
        """Fused-path epoch with no participants: carried stragglers only."""
        spec = self.spec
        if new_orbits:
            with self._seg("group"):
                sizes = [m.size for m in metas]
                totals = {o: float(sum(sizes[j] for j in orbit_indices[o]))
                          for o in new_orbits}
                dw = segment_weight_matrix(new_orbits, orbit_indices,
                                           carry_rows, sizes, totals,
                                           carry.shape[0])
                pm = torch.as_tensor(dw, device=carry.device) @ carry
                ds = torch.linalg.norm(
                    pm - self.grouping.ref_device()[None, :],
                    dim=1).cpu().numpy()
                self.grouping.assign_distances(new_orbits, ds)
            if spec.agg_mode == "asyncfleo" and spec.grouping:
                groups = {}
                for o, idxs in orbit_indices.items():
                    groups.setdefault(self.grouping.group_of(o),
                                      []).extend(idxs)
        with self._seg("agg"):
            ws, base_w, info = self._mode_weights(metas, beta, groups)
            out = agg.combine_stacked(
                [(carry, agg.scatter_weights(carry_rows, ws,
                                             carry.shape[0]))],
                self._w_flat, base_w)
            if out is not None:
                self._w_flat = out
        kept_meta = [self._pend_meta[i] for i in k_idx]
        kept_dev = (gather_rows(self._pend_dev, k_idx) if k_idx else None)
        self._pend_dev, self._pend_meta = kept_dev, kept_meta
        return t_agg, metas, info, None

    # ---- stacked path (device-resident bank, separate calls) ----------

    def _stacked_epoch(self, beta, participants, recv, t, bits, sink,
                       w_tree):
        sim, spec = self.sim, self.spec
        bank = None
        arrivals = []
        if participants:
            with self._seg("train"):
                bank, _losses = self.trainer.train_many_stacked(
                    participants, w_tree, seed=sim.seed * 1000 + beta)
                self._spec = bank.spec
            with self._seg("timing"):
                t_done = recv[participants] + self._train_times(participants)
                t_arr_vec, _haps = self.plan.uplink_times(
                    participants, t_done, bits, sink)
            arrivals = [(float(t_arr_vec[k]), s, k)
                        for k, s in enumerate(participants)
                        if np.isfinite(t_arr_vec[k])]
            arrivals.sort(key=lambda a: a[0])
        if not arrivals and not self._pend_meta:
            return None
        t_agg, used, late = self._trigger(arrivals, t)
        c_idx, k_idx = self._carried_split(t_agg)

        metas = [SatelliteMeta(s, self.trainer.data_size(s),
                               loc=(0.0, 0.0), ts=ta, epoch=beta)
                 for (ta, s, _k) in used]
        metas += [SatelliteMeta(s, self.trainer.data_size(s),
                                loc=(0.0, 0.0), ts=ta, epoch=ep)
                  for (ta, s, ep) in (self._pend_meta[i] for i in c_idx)]
        # row bookkeeping instead of row gathers: metas index j maps to a
        # row of the intact epoch bank or the carried matrix
        bank_rows = [k for (_, _, k) in used] + [-1] * len(c_idx)
        carry_rows = [-1] * len(used) + list(range(len(c_idx)))
        with self._seg("carry"):
            carry_seg = (gather_rows(self._pend_dev, c_idx)
                         if c_idx else None)
            # retire carried stragglers, enqueue this epoch's late rows
            keep_dev = (gather_rows(self._pend_dev, k_idx)
                        if k_idx else None)
            keep_meta = [self._pend_meta[i] for i in k_idx]
            if late:
                late_dev = gather_rows(bank.stack, [k for (_, _, k) in late])
                keep_dev = (late_dev if keep_dev is None
                            else torch.cat([keep_dev, late_dev]))
                keep_meta += [(ta, s, beta) for (ta, s, _k) in late]
            self._pend_dev, self._pend_meta = keep_dev, keep_meta

        keep = agg.dedup_indices(metas)
        if len(keep) < len(metas):
            metas = [metas[i] for i in keep]
            bank_rows = [bank_rows[i] for i in keep]
            carry_rows = [carry_rows[i] for i in keep]
        carry_dev = (carry_seg
                     if carry_seg is not None
                     and any(r >= 0 for r in carry_rows) else None)
        segments = [(bank.stack if bank is not None else None, bank_rows),
                    (carry_dev, carry_rows)]

        groups: Optional[Dict[int, List[int]]] = None
        if spec.agg_mode == "asyncfleo":
            if not spec.grouping:                    # ablation: one group
                groups = {0: list(range(len(metas)))}
            else:
                with self._seg("group"):
                    # all new-orbit partial models and distances in one
                    # contraction per segment over the bank
                    orbit_indices: Dict[int, List[int]] = {}
                    for i, meta in enumerate(metas):
                        orbit_indices.setdefault(
                            int(self.orbit_ids[meta.sat_id]), []).append(i)
                    orbit_group = self.grouping.observe_orbits_multi(
                        orbit_indices, segments, [m.size for m in metas])
                    groups = {}
                    for i, meta in enumerate(metas):
                        gi = orbit_group[int(self.orbit_ids[meta.sat_id])]
                        groups.setdefault(gi, []).append(i)

        with self._seg("agg"):
            # per-model weights are host metadata math; the tensor update
            # is one combine over the epoch bank and the carried
            # stragglers, no row copies
            ws, base_w, info = self._mode_weights(metas, beta, groups)
            self._w_flat = self._combine(segments, ws, self._w_flat, base_w)
        return t_agg, metas, info, None

    # ---- legacy path (a parameter dict per model, the seed's semantics) -

    def _legacy_epoch(self, beta, participants, recv, t, bits, sink,
                      w_tree):
        sim, spec = self.sim, self.spec
        arrivals = []
        if participants:
            with self._seg("train"):
                trained, _losses = self.trainer.train_many(
                    participants, w_tree, seed=sim.seed * 1000 + beta)
            with self._seg("timing"):
                t_done = recv[participants] + self._train_times(participants)
                t_arr_vec, _haps = self.plan.uplink_times(
                    participants, t_done, bits, sink)
            arrivals = [(float(t_arr_vec[k]), s, p)
                        for k, (s, p)
                        in enumerate(zip(participants, trained))
                        if np.isfinite(t_arr_vec[k])]
            arrivals.sort(key=lambda a: a[0])
        if not arrivals and not self.pending:
            return None
        t_agg, used, late = self._trigger(arrivals, t)

        metas = [SatelliteMeta(s, self.trainer.data_size(s),
                               loc=(0.0, 0.0), ts=ta, epoch=beta)
                 for (ta, s, _p) in used]
        carried = [(ta, s, p, ep) for (ta, s, p, ep) in self.pending
                   if ta <= t_agg]
        self.pending = [x for x in self.pending if x[0] > t_agg]
        self.pending.extend((ta, s, p, beta) for (ta, s, p) in late)
        metas += [SatelliteMeta(s, self.trainer.data_size(s),
                                loc=(0.0, 0.0), ts=ta, epoch=ep)
                  for (ta, s, _p, ep) in carried]
        models = ([p for (_, _, p) in used]
                  + [p for (_, _, p, _) in carried])
        models, metas = agg.dedup(models, metas)
        base = w_tree

        info = {"gamma": 1.0, "stale_groups": 0}
        with self._seg("agg"):
            if spec.agg_mode == "fedavg":
                w_new = agg.fedavg(models, [m.size for m in metas])
            elif spec.agg_mode == "per_arrival":
                w_new = base
                for m_i, meta in zip(models, metas):
                    alpha = 0.5 / (1.0 + max(beta - meta.epoch, 0))
                    w_new = agg.weighted_sum([m_i], [alpha], base=w_new,
                                             base_weight=1.0 - alpha)
            elif spec.agg_mode == "interval":
                total = sum(m.size for m in metas)
                raw = np.array([m.size / (1.0 + max(beta - m.epoch, 0))
                                for m in metas])
                gam = float(np.clip(raw.sum() / max(total, 1e-9), 0.2, 1.0))
                w_new = agg.weighted_sum(models, gam * raw / raw.sum(),
                                         base=base, base_weight=1.0 - gam)
                info["gamma"] = gam
            else:                                    # asyncfleo (Alg. 2)
                groups: Dict[int, List[int]] = {}
                if not spec.grouping:                # ablation: one group
                    groups[0] = list(range(len(metas)))
                else:
                    for i, meta in enumerate(metas):
                        orbit = int(self.orbit_ids[meta.sat_id])
                        gi = self.grouping.group_of(orbit)
                        if gi is None:     # first sighting: distance to w0
                            same_orbit = [j for j, mm in enumerate(metas)
                                          if int(self.orbit_ids[mm.sat_id])
                                          == orbit]
                            gi = self.grouping.observe_orbit(
                                orbit, [models[j] for j in same_orbit],
                                [metas[j].size for j in same_orbit])
                        groups.setdefault(gi, [])
                        if i not in groups[gi]:
                            groups[gi].append(i)
                w_new, info = agg.asyncfleo_aggregate(
                    base, groups, models, metas, beta,
                    strict_paper_eq14=spec.strict_paper_eq14,
                    staleness_fn=spec.staleness_fn)
        return t_agg, metas, info, w_new

    # ------------------------------------------------------------------

    def _init_run(self, w0):
        """Run-state reset, shared by the epoch loop and the event-driven
        runtime.  Returns (model bits, the fused epoch program or None,
        stacked?)."""
        bits = model_bits(w0)
        self.grouping.set_reference(w0)
        if self.plan.contention is not None:
            self.plan.contention.reset()   # channel pools are per-run state
        stacked = self.sim.use_model_bank and hasattr(self.trainer,
                                                      "train_many_stacked")
        fused = None
        if stacked and self.sim.use_fused_step:
            fused = make_epoch_program(self.trainer, w0)
            if fused is not None:
                # dispatch profiling hook (obs/profile.py); programs are
                # cached on the trainer, so (re)set it every run: None
                # detaches a previous run's profiler
                fused.profiler = self.sim.profiler
                if self.sim.dispatcher is not None:
                    # scenario-batched sweep (DESIGN.md §13): route this
                    # run's steps through the shared batcher; the proxy
                    # keeps step()'s surface and counters
                    fused = self.sim.dispatcher.wrap(
                        fused, key=getattr(self.trainer,
                                           "scenario_batch_key", None))
        self._fused_prog = fused
        self._w_flat = None               # flat device view (stacked/fused)
        self._dist_pending = None
        if stacked:
            self._spec = self._spec or FlatSpec.of(w0)
            self._w_flat = self._spec.flatten(w0)  # a new tensor, never w0
        return bits, fused, stacked

    def _record_epoch(self, history: List[EpochRecord], beta: int,
                      t_agg: float, metas, info, lazy_eval: bool, w_tree):
        """Evaluate + append one epoch's history row.  Returns the recorded
        accuracy (a device scalar when ``lazy_eval``)."""
        for meta in metas:
            self.last_epoch_included[meta.sat_id] = beta
        with self._seg("eval"):
            if self.evaluator is None:
                acc = float("nan")
            elif lazy_eval:
                acc = self.evaluator.eval_async(w_tree)  # device tensor
            else:
                acc = float(self.evaluator(w_tree))
        history.append(EpochRecord(beta, t_agg, acc, len(metas),
                                   float(info.get("gamma", 1.0)),
                                   int(info.get("stale_groups", 0))))
        return acc

    def run(self, w0: Dict[str, torch.Tensor], max_epochs: int = 30,
            target_accuracy: Optional[float] = None) -> List[EpochRecord]:
        """Run the epoch loop from the global model ``w0`` (a parameter
        dict; the device of its tensors is the device of the run), or,
        with ``SimConfig.event_driven``, the event-driven runtime."""
        sim, spec = self.sim, self.spec
        if sim.event_driven:
            from repro_torch.sched.runtime import EventDrivenRuntime
            self.runtime = EventDrivenRuntime(self)
            return self.runtime.run(w0, max_epochs,
                                    target_accuracy=target_accuracy)
        if self.fault is not None and self.fault.has_loss:
            raise ValueError(
                "FaultModel transfer loss (loss_prob > 0 or burst_len_s "
                "> 0) requires the event-driven runtime "
                "(SimConfig.event_driven=True): the epoch loop cannot "
                "express TRANSFER_FAILED retry chains")
        if self.fault is not None and (self.fault.has_outages
                                       or self.fault.has_energy):
            raise ValueError(
                "FaultModel PS outages / energy budgets require the "
                "event-driven runtime (SimConfig.event_driven=True): the "
                "epoch loop cannot express ring failover or deferred "
                "uplinks (DESIGN.md §11)")
        bits, fused, stacked = self._init_run(w0)
        w_tree = w0                       # parameter view (trainer/evaluator)
        t = 0.0
        source = 0
        history: List[EpochRecord] = []
        S = self.constellation.num_sats
        lazy_eval = (target_accuracy is None
                     and hasattr(self.evaluator, "eval_async"))

        for beta in range(max_epochs):
            if t >= sim.duration_s:
                break
            sink = self.topo.sink_of(source)
            with self._seg("timing"):
                recv = self.plan.downlink_times(t, bits, source)
            participants = [s for s in range(S) if np.isfinite(recv[s])]

            if fused is not None:
                out = self._fused_epoch(fused, beta, participants, recv, t,
                                        bits, sink)
            elif stacked:
                out = self._stacked_epoch(beta, participants, recv, t, bits,
                                          sink, w_tree)
            else:
                out = self._legacy_epoch(beta, participants, recv, t, bits,
                                         sink, w_tree)
            if out is None:
                break
            t_agg, metas, info, extra = out
            if fused is not None:
                # the fused path trains from w_flat directly: the parameter
                # view only feeds the evaluator.  Views into w_flat: stream
                # order runs the evaluation before the next epoch updates
                # w_flat in place
                if self.evaluator is not None:
                    w_tree = self._spec.unflatten(self._w_flat)
            elif stacked:
                w_tree = self._spec.unflatten(self._w_flat)
            else:
                w_tree = extra
            if spec.agg_mode == "interval":
                t_agg = max(t_agg, t + spec.interval_s)

            acc = self._record_epoch(history, beta, t_agg, metas, info,
                                     lazy_eval, w_tree)
            t = t_agg
            source, sink = sink, source            # §IV-B3 role swap
            if target_accuracy is not None and acc >= target_accuracy:
                break
        self._resolve_pending_dists()        # leave grouping state complete
        with self._seg("eval"):
            for rec in history:              # block once, at finalize time
                rec.accuracy = float(rec.accuracy)
        return history


def convergence_time(history: List[EpochRecord],
                     target: float) -> Optional[float]:
    for rec in history:
        if rec.accuracy >= target:
            return rec.time_s
    return None
