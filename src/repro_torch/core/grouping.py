"""Satellite grouping by model-weight divergence (paper §IV-C1, Fig. 5).

The PS cannot see data (FL), so data-distribution similarity is inferred from
model weights: per orbit, a *partial global model* S'_o = data-size-weighted
average of that orbit's received local models; its Euclidean distance to the
*initial* global model w0 (largest divergence happens in epoch 1, giving the
sharpest differentiation) places the orbit on a 1-D axis; orbits with similar
distances form a group.  Later epochs assign new orbits to the group whose
members' mean distance is closest.

Models come as a ``ModelBank`` (the stacked and fused paths: partial
models and distances are tensor work on the bank's device) or as a list of
parameter dicts (the legacy path: the partial model and its distance are
host numpy, as in the reference, so group assignment is the exact host
math).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.aggregation import scatter_weights
from repro_torch.core.modelbank import ModelBank, flatten_tree
from repro_torch.kernels.pairwise_dist import dist_to_ref
from repro_torch.tree import tree_map


def flatten_model(model) -> torch.Tensor:
    """A parameter dict (or an already flat (N,) tensor) as a new flat
    float32 tensor, in the bank's sorted-key layout."""
    if isinstance(model, torch.Tensor) and model.dim() == 1:
        return model.detach().float().clone()
    return flatten_tree(model).detach()


def _host(model):
    """A parameter tree as float32 host arrays."""
    return tree_map(lambda v: (v.detach().cpu().numpy()
                               if isinstance(v, torch.Tensor)
                               else np.asarray(v)).astype(np.float32,
                                                          copy=False),
                    model)


def model_distance(model, ref_flat: np.ndarray) -> float:
    """|| flat(model) - flat(w0) ||_2, host numpy."""
    flat = flatten_tree(model).detach().cpu().numpy()
    return float(np.linalg.norm(flat - ref_flat))


def partial_global_model(models, sizes: Sequence[float]):
    """Data-size-weighted average of one orbit's local models (Fig. 5a).
    With a ``ModelBank`` this is one (1, C) x (C, N) contraction on the
    bank's device, the flat (N,) partial model; a list of parameter dicts
    keeps the reference's host math and gives a dict of host arrays."""
    total = float(sum(sizes))
    if isinstance(models, ModelBank):
        ws = torch.as_tensor(np.asarray(sizes, np.float32) / total,
                             device=models.stack.device)
        return ws @ models.stack
    ws = [s / total for s in sizes]
    return tree_map(lambda *leaves: sum(w * h for w, h in zip(ws, leaves)),
                    *[_host(m) for m in models])


def group_by_gaps(distances: Dict[int, float], num_groups: int = 3) -> List[List[int]]:
    """1-D clustering: sort orbit distances, split at the (num_groups-1)
    largest gaps.  Deterministic; matches the paper's 'similar Euclidean
    distances are grouped together'."""
    orbits = sorted(distances, key=lambda o: distances[o])
    if len(orbits) <= num_groups:
        return [[o] for o in orbits]
    vals = np.array([distances[o] for o in orbits])
    gaps = np.diff(vals)
    cuts = np.sort(np.argsort(gaps)[::-1][: num_groups - 1])
    groups, start = [], 0
    for c in cuts:
        groups.append(orbits[start:c + 1])
        start = c + 1
    groups.append(orbits[start:])
    return groups


def segment_partial_inputs(new_orbits: Sequence[int],
                           orbit_indices: Dict[int, List[int]],
                           rows: Sequence[int], sizes: Sequence[float],
                           totals: Dict[int, float], n_rows: int,
                           dump: int):
    """Per-row (weight, segment id) arrays for the fused epoch program's
    O(C*N) partial-model segment-sum: row ``r`` gets orbit k's
    size-normalized weight when model j with ``rows[j] == r`` belongs to
    ``new_orbits[k]``; unowned rows get weight 0 and segment ``dump``.
    Each bank row feeds at most one orbit, which is what makes the
    segment-sum equivalent to the dense (K, n_rows) matrix product."""
    w = np.zeros(n_rows, np.float32)
    seg = np.full(n_rows, dump, np.int32)
    for k, orbit in enumerate(new_orbits):
        for j in orbit_indices[orbit]:
            r = rows[j]
            if r >= 0:
                w[r] = sizes[j] / totals[orbit]
                seg[r] = k
    return w, seg


def segment_weight_matrix(new_orbits: Sequence[int],
                          orbit_indices: Dict[int, List[int]],
                          rows: Sequence[int], sizes: Sequence[float],
                          totals: Dict[int, float],
                          n_rows: int) -> np.ndarray:
    """(K, n_rows) per-orbit partial-model weight rows for ONE segment:
    row k holds the size-normalized weights of orbit k's models that live
    in this segment (``rows[j]`` is model j's row there, -1 elsewhere).
    Host metadata math — shared by ``observe_orbits_multi`` and the fused
    epoch program, which takes the matrices as inputs and returns the
    distances (DESIGN.md §6)."""
    return np.stack([scatter_weights(
        [rows[j] for j in orbit_indices[orbit]],
        [sizes[j] / totals[orbit] for j in orbit_indices[orbit]],
        n_rows) for orbit in new_orbits]) if new_orbits else \
        np.zeros((0, n_rows), np.float32)


@dataclasses.dataclass
class GroupingState:
    """Incremental grouping maintained by the sink HAP."""
    distances: Dict[int, float] = dataclasses.field(default_factory=dict)
    groups: List[List[int]] = dataclasses.field(default_factory=list)
    num_groups: int = 3
    use_dist_kernel: bool = False      # route distances through pairwise_dist
    _ref: Optional[torch.Tensor] = dataclasses.field(default=None, repr=False)
    _ref_host: Optional[np.ndarray] = dataclasses.field(default=None,
                                                        repr=False)

    def set_reference(self, w0) -> None:
        """Record flat(w0), the initial global model every distance is
        measured to (a copy: the caller may update its model in place)."""
        self._ref = flatten_model(w0)
        self._ref_host = None

    def ref_device(self) -> torch.Tensor:
        """flat(w0) on the model's device."""
        if self._ref is None:
            raise RuntimeError("GroupingState: set_reference(w0) first")
        return self._ref

    def ref_host(self) -> np.ndarray:
        """flat(w0) as a float32 host array (the legacy path's distances);
        copied from the device once."""
        if self._ref_host is None:
            self._ref_host = self.ref_device().cpu().numpy()
        return self._ref_host

    def group_of(self, orbit: int) -> Optional[int]:
        for gi, g in enumerate(self.groups):
            if orbit in g:
                return gi
        return None

    def observe_orbit(self, orbit: int, models,
                      sizes: Sequence[float]) -> int:
        """Ingest an orbit's freshly received models; returns its group id.
        First sighting computes the partial-model distance to w0; known
        orbits keep their stored group (paper: 'directly assigned to the
        associated group').  ``models`` is a ``ModelBank`` (one row per
        model: the distance through the pairwise_dist kernel when
        ``use_dist_kernel`` is set, else a plain norm, on the bank's
        device) or a list of parameter dicts (host numpy, the reference's
        legacy math)."""
        gi = self.group_of(orbit)
        if gi is not None:
            return gi
        pm = partial_global_model(models, sizes)
        if not isinstance(models, ModelBank):
            d = model_distance(pm, self.ref_host())
        elif self.use_dist_kernel:
            d = float(dist_to_ref(pm[None], self.ref_device())[0])
        else:
            d = float(torch.linalg.norm(pm - self.ref_device()))
        out: Dict[int, int] = {}
        self._assign_new([orbit], [d], out)
        return out[orbit]

    def observe_orbits(self, orbit_indices: Dict[int, List[int]],
                       bank: ModelBank,
                       sizes: Sequence[float]) -> Dict[int, int]:
        """Batched ``observe_orbit`` over a whole epoch's arrivals in one
        bank (``orbit_indices``: orbit id -> row indices into ``bank``;
        ``sizes``: per-row data sizes): ``observe_orbits_multi`` with the
        bank as its one segment.  Returns orbit -> group id."""
        return self.observe_orbits_multi(
            orbit_indices, [(bank.stack, range(len(bank)))], sizes)

    def observe_orbits_multi(self, orbit_indices: Dict[int, List[int]],
                             segments, sizes: Sequence[float]) -> Dict[int, int]:
        """Batched ``observe_orbit`` over an epoch's arrivals, with the
        models split across several matrices.

        ``segments``: list of (stack (C_s, N) or None, rows) where
        ``rows[j]`` is model j's row in that stack (-1 elsewhere) — e.g. the
        epoch's training bank plus a small carried-stragglers matrix.  Each
        segment contributes one fused (K,C_s)x(C_s,N) term to the partial
        models; no rows are gathered or concatenated.
        """
        out: Dict[int, int] = {}
        new_orbits = [o for o in orbit_indices if self.group_of(o) is None]
        for o in orbit_indices:
            if o not in new_orbits:
                out[o] = self.group_of(o)                       # type: ignore
        if not new_orbits:
            return out
        totals = {o: float(sum(sizes[j] for j in orbit_indices[o]))
                  for o in new_orbits}
        pm = None
        for stack, rows in segments:
            if stack is None or stack.shape[0] == 0:
                continue
            W = segment_weight_matrix(new_orbits, orbit_indices, rows,
                                      sizes, totals, stack.shape[0])
            if not W.any():
                continue
            term = torch.as_tensor(W, device=stack.device) @ stack
            pm = term if pm is None else pm + term
        if pm is None:
            return out
        ds = torch.linalg.norm(pm - self.ref_device()[None, :],
                               dim=1).cpu().numpy()
        self._assign_new(new_orbits, ds, out)
        return out

    def assign_distances(self, new_orbits: Sequence[int],
                         ds: Sequence[float]) -> Dict[int, int]:
        """Record externally computed distances-to-w0 (e.g. the fused epoch
        program's output) for new orbits and assign their groups — the same
        sequential replay ``observe_orbits*`` uses."""
        out: Dict[int, int] = {}
        self._assign_new(list(new_orbits), np.asarray(ds), out)
        return out

    def _assign_new(self, new_orbits, ds, out: Dict[int, int]) -> None:
        """Replay the exact sequential observe_orbit assignment logic
        (distances enter one at a time so intermediate reclusters match)."""
        for orbit, d in zip(new_orbits, ds):
            self.distances[orbit] = float(d)
            if len(self.groups) < self.num_groups:
                self.groups = group_by_gaps(self.distances, self.num_groups)
                out[orbit] = self.group_of(orbit)               # type: ignore
                continue
            means = [np.mean([self.distances[o] for o in g
                              if o in self.distances])
                     if any(o in self.distances for o in g) else np.inf
                     for g in self.groups]
            gi = int(np.argmin([abs(float(d) - m) for m in means]))
            self.groups[gi].append(orbit)
            out[orbit] = gi

    def regroup(self) -> None:
        """Re-run the gap clustering over all seen orbits (end of an epoch
        where new orbits appeared)."""
        if self.distances:
            self.groups = group_by_gaps(self.distances, self.num_groups)

    def all_grouped(self, num_orbits: int) -> bool:
        return sum(len(g) for g in self.groups) >= num_orbits
