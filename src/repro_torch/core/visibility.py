"""Visibility: satellite<->ground elevation gating and inter-satellite LoS.

The paper's link condition (§III-B): a satellite n and PS g can communicate
iff the elevation of n above g's local horizon is >= the minimum elevation
angle.  ``VisibilityTimeline`` precomputes the boolean visibility grid over
the whole simulation horizon (vectorized — 3 days at dt=10 s for 40 sats x
2 PSs is ~52k x 40 x 2 bools) and answers next-visible queries in O(1)-ish.

The sparse segment timeline of the JAX package (``SparseVisibilityTimeline``)
is not ported yet; it comes with the faults-and-sparse-contacts slice.
``VisibilityTimeline`` answers the query API that downstream code consumes
(the contact plan, topology and propagation layers never index ``.grid``
directly): ``visible`` / ``visible_sats`` / ``visible_rows`` /
``next_visible_time`` / ``next_visible_after`` / ``next_orbit_visible``
/ ``visibility_fraction`` plus the segment exports ``node_windows``,
``node_cover`` and ``covered_steps``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core.constellation import GroundNode, R_EARTH, WalkerDelta

ATMOSPHERE_MARGIN_M = 80e3   # ISL grazing margin above the surface


def elevation_deg(sat_pos: np.ndarray, gnd_pos: np.ndarray) -> np.ndarray:
    """Elevation of satellite(s) above ground node's horizon, degrees.
    Broadcasts over leading dims; last dim is xyz."""
    d = sat_pos - gnd_pos
    dn = np.linalg.norm(d, axis=-1)
    gn = np.linalg.norm(gnd_pos, axis=-1)
    sin_el = np.sum(d * gnd_pos, axis=-1) / np.maximum(dn * gn, 1e-9)
    return np.rad2deg(np.arcsin(np.clip(sin_el, -1.0, 1.0)))


def horizon_dip_deg(altitude_m: float) -> float:
    """Geometric horizon dip for an elevated observer: arccos(R/(R+h)).
    ~4.5 deg at 20 km — the physical reason a HAP sees more satellites than
    a GS at the same nominal minimum elevation (paper §I/§III)."""
    if altitude_m <= 0:
        return 0.0
    return float(np.rad2deg(np.arccos(R_EARTH / (R_EARTH + altitude_m))))


def is_visible(sat_pos, node: GroundNode, node_pos) -> np.ndarray:
    eff_min = node.min_elevation_deg - horizon_dip_deg(node.altitude_m)
    return elevation_deg(sat_pos, node_pos) >= eff_min


def sat_los(p1: np.ndarray, p2: np.ndarray,
            margin_m: float = ATMOSPHERE_MARGIN_M) -> np.ndarray:
    """Inter-satellite line-of-sight: True if the segment p1-p2 clears the
    Earth (+margin).  Broadcasts over leading dims."""
    d = p2 - p1
    dd = np.sum(d * d, axis=-1)
    t = -np.sum(p1 * d, axis=-1) / np.maximum(dd, 1e-9)
    t = np.clip(t, 0.0, 1.0)
    closest = p1 + t[..., None] * d
    return np.linalg.norm(closest, axis=-1) >= (R_EARTH + margin_m)


@dataclasses.dataclass
class VisibilityTimeline:
    """Precomputed sat x PS visibility over [0, duration] at step dt."""
    constellation: WalkerDelta
    nodes: List[GroundNode]
    duration_s: float
    dt_s: float = 10.0

    def __post_init__(self):
        self.times = np.arange(0.0, self.duration_s + self.dt_s, self.dt_s)
        sat_pos = self.constellation.positions(self.times)      # (T,S,3)
        self.grid = np.zeros((len(self.times), self.constellation.num_sats,
                              len(self.nodes)), dtype=bool)
        self._sat_pos = sat_pos
        for j, node in enumerate(self.nodes):
            npos = node.position(self.times)[:, None, :]        # (T,1,3)
            self.grid[:, :, j] = is_visible(sat_pos, node, npos)

    # ---- queries ----------------------------------------------------------

    def _ti(self, t: float) -> int:
        return int(np.clip(round(t / self.dt_s), 0, len(self.times) - 1))

    def visible(self, t: float) -> np.ndarray:
        """(S, P) bool at time t."""
        return self.grid[self._ti(t)]

    def visible_sats(self, t: float, node_idx: int) -> np.ndarray:
        return np.flatnonzero(self.grid[self._ti(t), :, node_idx])

    def next_visible_time(self, sat: int, t: float,
                          node_idx: Optional[int] = None) -> Optional[float]:
        """Earliest time >= t when ``sat`` sees any PS (or a specific one).
        None if never within the horizon."""
        ti = self._ti(t)
        col = (self.grid[ti:, sat, :].any(axis=-1) if node_idx is None
               else self.grid[ti:, sat, node_idx])
        hits = np.flatnonzero(col)
        if len(hits) == 0:
            return None
        return float(self.times[ti + hits[0]])

    def _next_visible_grid(self) -> np.ndarray:
        """(T, S) int32: for each (time step, sat), the earliest row >= t
        where the satellite sees any PS (== T when never again).  Built once
        by a reverse running-minimum over the visibility grid and cached —
        it turns every next-visible query into one fancy-index lookup."""
        if not hasattr(self, "_nxt"):
            T = self.grid.shape[0]
            any_ps = self.grid.any(axis=2)                      # (T, S)
            idx = np.where(any_ps, np.arange(T, dtype=np.int32)[:, None],
                           np.int32(T))
            self._nxt = np.minimum.accumulate(idx[::-1], axis=0)[::-1]
        return self._nxt

    def next_visible_after(self, sats, t):
        """Vectorized ``next_visible_time`` over (sat, per-sat time) pairs.
        Returns (times (P,), first-visible PS (P,)) with inf / -1 where a
        satellite is never visible again within the horizon."""
        sats = np.atleast_1d(np.asarray(sats, dtype=np.int64))
        t = np.broadcast_to(np.asarray(t, dtype=np.float64), sats.shape)
        ti = np.clip(np.round(t / self.dt_s).astype(np.int64), 0,
                     len(self.times) - 1)
        row = self._next_visible_grid()[ti, sats]
        ok = row < self.grid.shape[0]
        rowc = np.minimum(row, self.grid.shape[0] - 1)
        times = np.where(ok, self.times[rowc], np.inf)
        ps = np.where(ok, np.argmax(self.grid[rowc, sats, :], axis=1), -1)
        return times, ps

    def next_orbit_visible(self, orbit_sats: Sequence[int], t: float):
        """Earliest (time, sat) at/after t when any satellite of an orbit sees
        any PS.  Returns (None, None) if never."""
        ti = self._ti(t)
        sub = self.grid[ti:][:, list(orbit_sats), :].any(axis=-1)   # (T', n)
        rows = np.flatnonzero(sub.any(axis=1))
        if len(rows) == 0:
            return None, None
        row = rows[0]
        sat_local = int(np.flatnonzero(sub[row])[0])
        return float(self.times[ti + row]), int(list(orbit_sats)[sat_local])

    def visibility_fraction(self, sat: int) -> float:
        return float(self.grid[:, sat, :].any(axis=-1).mean())

    # ---- segment exports ----------------------------------------------------

    def visible_rows(self, rows, sats) -> np.ndarray:
        """Visibility at explicit grid rows: ``grid[rows, sats, :]`` with
        numpy broadcasting between ``rows`` and ``sats`` — bool (..., P).
        This is the query the propagation layer uses instead of indexing
        the grid directly, so it works against both timeline classes."""
        return self.grid[rows, sats, :]

    def node_windows(self, node_idx: int):
        """RLE visibility windows of one PS as ``(sats, lo, hi)`` int64
        arrays sorted by (sat, lo); ``hi`` is the EXCLUSIVE end row and
        may equal T when a window runs off the horizon."""
        col = self.grid[:, :, node_idx]                  # (T, S)
        pad = np.zeros((1, col.shape[1]), dtype=np.int8)
        d = np.diff(np.concatenate([pad, col.astype(np.int8), pad]),
                    axis=0)                              # (T+1, S)
        starts = np.argwhere(d == 1)                     # (n, 2): (row, sat)
        ends = np.argwhere(d == -1)
        if len(starts) == 0:
            z = np.zeros(0, dtype=np.int64)
            return z, z.copy(), z.copy()
        # argwhere is row-major sorted; regroup per sat so the k-th start
        # pairs with the k-th end of the same column
        order_s = np.lexsort((starts[:, 0], starts[:, 1]))
        order_e = np.lexsort((ends[:, 0], ends[:, 1]))
        return (starts[order_s, 1].astype(np.int64),
                starts[order_s, 0].astype(np.int64),
                ends[order_e, 0].astype(np.int64))

    def node_cover(self, node_idx: int):
        """Merged any-sat coverage runs of one PS: ``(lo, hi)`` int64
        arrays of maximal covered row intervals, ``hi`` exclusive."""
        any_sat = self.grid[:, :, node_idx].any(axis=1).astype(np.int8)
        d = np.diff(np.concatenate([[0], any_sat, [0]]))
        return (np.flatnonzero(d == 1).astype(np.int64),
                np.flatnonzero(d == -1).astype(np.int64))

    def covered_steps(self) -> int:
        """Total (step, sat) samples with any PS in view — the scalar the
        plan's coverage/degeneracy checks reduce to."""
        return int(self.grid.any(axis=2).sum())
