"""Visibility: satellite<->ground elevation gating and inter-satellite LoS.

The paper's link condition (§III-B): a satellite n and PS g can communicate
iff the elevation of n above g's local horizon is >= the minimum elevation
angle.  ``VisibilityTimeline`` precomputes the boolean visibility grid over
the whole simulation horizon (vectorized — 3 days at dt=10 s for 40 sats x
2 PSs is ~52k x 40 x 2 bools) and answers next-visible queries in O(1)-ish.

``SparseVisibilityTimeline`` (DESIGN.md §14) answers the SAME queries from
a segment representation — per-(sat, PS) visibility windows as
``[lo, hi)`` grid-step intervals — without ever materializing the dense
(T, S, P) grid or the (T, S, 3) position tensor.  At S = 10^4 over a
1-day horizon the dense grid + positions are gigabytes; the windows are
a few megabytes.  Compilation is chunked coarse-to-fine: elevation is
sampled every ``_COARSE`` steps, a provable bound on the elevation rate
(relative angular speed over the minimum slant range, plus Earth
rotation) classifies whole coarse intervals as certainly-visible /
certainly-invisible, and only satellites with an uncertain interval in a
chunk are evaluated densely — so the boolean per step is EXACTLY what
the dense grid holds, and every query below is bit-identical to the
dense timeline (tests/test_torch_sparse.py).  Unlike the JAX package's,
its point queries take a PS that has no window at all (they answer
False there instead of indexing an empty array).

Both classes share the query API that downstream code consumes (the
contact plan, topology and propagation layers never index ``.grid``
directly): ``visible`` / ``visible_sats`` / ``visible_rows`` /
``next_visible_time`` / ``next_visible_after`` / ``next_orbit_visible``
/ ``visibility_fraction`` plus the segment exports ``node_windows``,
``node_cover`` and ``covered_steps``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core.constellation import (GroundNode, OMEGA_EARTH,
                                            R_EARTH, WalkerDelta)

# Sparse compilation: rows densely addressable per chunk, and the coarse
# sampling stride (rows) whose intervals the elevation-rate bound classifies.
_CHUNK_STEPS = 2048
_COARSE = 8

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

    # ---- segment exports (shared with SparseVisibilityTimeline) -----------

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

def elevation_rate_bound_deg_s(cst: WalkerDelta, node: GroundNode) -> float:
    """Provable upper bound on |d(elevation)/dt| in deg/s for any
    satellite of ``cst`` as seen from ``node``.

    The line-of-sight direction rotates at most v_rel / d_min, with
    v_rel <= v_sat + Omega_E * (R + h_node) (the node's inertial speed)
    and d_min = alt_sat - h_node (the two bodies live on concentric
    spheres, so their distance is at least the radius difference).  The
    node's local horizon frame itself rotates at Omega_E, which adds at
    most Omega_E to the elevation rate.  A 5% safety factor absorbs the
    small-angle approximations; inf (= no interval pruning, full dense
    evaluation) when the geometry degenerates (sat shell at/below the
    node altitude)."""
    d_min = cst.altitude_m - node.altitude_m
    if d_min <= 0:
        return float("inf")
    v_node = OMEGA_EARTH * (R_EARTH + node.altitude_m)
    rate_rad = (cst.velocity + v_node) / d_min + OMEGA_EARTH
    return float(np.rad2deg(rate_rad) * 1.05)


@dataclasses.dataclass
class SparseVisibilityTimeline:
    """Segment-based drop-in for :class:`VisibilityTimeline` (DESIGN.md
    §14): per-(sat, PS) visibility windows as ``[lo, hi)`` grid-step
    intervals, compiled chunked coarse-to-fine and queried by bisect on
    composite ``sat*(T+1)+row`` keys.  Never materializes the (T, S, P)
    grid or the full (T, S, 3) position tensor — memory and query cost
    are O(windows), which is what makes S = 10^4 compile in seconds.

    Exactness: coarse elevation samples every ``_COARSE`` steps classify
    whole sample intervals via :func:`elevation_rate_bound_deg_s`
    (certainly-visible / certainly-invisible / uncertain); uncertain
    interval interiors are densely evaluated with the same elementwise
    math the dense grid uses (``WalkerDelta.positions_at`` + is_visible), so
    every per-step boolean — hence every window, query answer, and
    downstream runtime history — is bit-identical to the dense timeline.
    """
    constellation: WalkerDelta
    nodes: List[GroundNode]
    duration_s: float
    dt_s: float = 10.0

    def __post_init__(self):
        self.times = np.arange(0.0, self.duration_s + self.dt_s, self.dt_s)
        self._T = len(self.times)
        self._compile()

    # ---- compilation ------------------------------------------------------

    def _compile(self) -> None:
        cst, T = self.constellation, self._T
        S = cst.num_sats
        P = len(self.nodes)
        eff_min = [n.min_elevation_deg - horizon_dip_deg(n.altitude_m)
                   for n in self.nodes]
        band_rate = [elevation_rate_bound_deg_s(cst, n) * self.dt_s
                     for n in self.nodes]                # deg per gap-step
        prev = [np.zeros(S, dtype=bool) for _ in range(P)]
        acc_s = [[] for _ in range(P)]   # per node: (rows, sats) start pairs
        acc_e = [[] for _ in range(P)]
        for c0 in range(0, T, _CHUNK_STEPS):
            c1 = min(c0 + _CHUNK_STEPS, T)
            L = c1 - c0
            samp = np.arange(0, L, _COARSE, dtype=np.int64)
            if samp[-1] != L - 1:
                samp = np.append(samp, L - 1)
            t_samp = self.times[c0 + samp]
            pos = cst.positions(t_samp)                  # (Q, S, 3)
            qidx = np.searchsorted(samp, np.arange(L), side="right") - 1
            for j, node in enumerate(self.nodes):
                npos = node.position(t_samp)[:, None, :]
                margin = elevation_deg(pos, npos) - eff_min[j]   # (Q, S)
                # sample rows are exact; interval interiors inherit the
                # left endpoint's sign unless the interval is uncertain
                vis = (margin >= 0.0)[qidx]              # (L, S) bool
                if len(samp) > 1:
                    m0, m1 = margin[:-1], margin[1:]
                    gap = np.diff(samp).astype(np.float64)[:, None]
                    band = band_rate[j] * gap + 1e-9
                    certain = (((m0 > 0) & (m1 > 0) & (m0 + m1 > band))
                               | ((m0 < 0) & (m1 < 0) & (-(m0 + m1) > band)))
                    unc = ~certain                       # (Q-1, S)
                    active = np.flatnonzero(unc.any(axis=0))
                    mark = np.zeros(L, dtype=bool)
                    for q in np.flatnonzero(unc.any(axis=1)):
                        mark[samp[q] + 1:samp[q + 1]] = True
                    rows_u = np.flatnonzero(mark)
                    if len(rows_u) and len(active):
                        t_u = self.times[c0 + rows_u]
                        npos_u = node.position(t_u)[:, None, :]
                        for b0 in range(0, len(active), 4096):
                            batch = active[b0:b0 + 4096]
                            pos_u = cst.positions_at(*np.broadcast_arrays(
                                batch[None, :], t_u[:, None]))   # (U, B, 3)
                            vis[np.ix_(rows_u, batch)] = \
                                is_visible(pos_u, node, npos_u)
                ext = np.concatenate([prev[j][None, :].astype(np.int8),
                                      vis.astype(np.int8)], axis=0)
                d = np.diff(ext, axis=0)                 # (L, S)
                st = np.argwhere(d == 1)                 # (n, 2): (row, sat)
                en = np.argwhere(d == -1)
                if len(st):
                    acc_s[j].append((st[:, 0] + c0, st[:, 1]))
                if len(en):
                    acc_e[j].append((en[:, 0] + c0, en[:, 1]))
                prev[j] = vis[-1].copy()
        # flush windows still open at the horizon: exclusive end = T
        for j in range(P):
            tail = np.flatnonzero(prev[j])
            if len(tail):
                acc_e[j].append((np.full(len(tail), T, dtype=np.int64), tail))
        self._wsat: List[np.ndarray] = []
        self._wlo: List[np.ndarray] = []
        self._whi: List[np.ndarray] = []
        self._klo: List[np.ndarray] = []
        self._khi: List[np.ndarray] = []
        for j in range(P):
            if acc_s[j]:
                s_rows = np.concatenate([r for r, _ in acc_s[j]])
                s_sats = np.concatenate([s for _, s in acc_s[j]])
                e_rows = np.concatenate([r for r, _ in acc_e[j]])
                e_sats = np.concatenate([s for _, s in acc_e[j]])
                os_ = np.lexsort((s_rows, s_sats))
                oe = np.lexsort((e_rows, e_sats))
                sat = s_sats[os_].astype(np.int64)
                lo = s_rows[os_].astype(np.int64)
                hi = e_rows[oe].astype(np.int64)
                assert len(lo) == len(hi) and np.array_equal(
                    sat, e_sats[oe].astype(np.int64))
            else:
                sat = lo = hi = np.zeros(0, dtype=np.int64)
            self._wsat.append(sat)
            self._wlo.append(lo)
            self._whi.append(hi)
            self._klo.append(sat * (T + 1) + lo)
            self._khi.append(sat * (T + 1) + hi)
        # cross-node union per sat (any-PS queries): merge overlapping or
        # touching windows in the composite key space, where distinct
        # sats can never merge (hi <= T < T+1 separates their ranges)
        if any(len(w) for w in self._wsat):
            glo = np.concatenate([k for k in self._klo])
            ghi = np.concatenate([k for k in self._khi])
            order = np.argsort(glo, kind="stable")
            glo, ghi = glo[order], ghi[order]
            run_hi = np.maximum.accumulate(ghi)
            new = np.ones(len(glo), dtype=bool)
            new[1:] = glo[1:] > run_hi[:-1]
            heads = np.flatnonzero(new)
            ulo_g = glo[heads]
            uhi_g = np.maximum.reduceat(ghi, heads)
            self._usat = ulo_g // (T + 1)
            self._ulo = ulo_g - self._usat * (T + 1)
            self._uhi = uhi_g - self._usat * (T + 1)
        else:
            self._usat = self._ulo = self._uhi = np.zeros(0, dtype=np.int64)
        self._uklo = self._usat * (T + 1) + self._ulo
        self._ukhi = self._usat * (T + 1) + self._uhi
        self._cover: List = [None] * P

    # ---- queries (same contracts as VisibilityTimeline) -------------------

    def _ti(self, t: float) -> int:
        return int(np.clip(round(t / self.dt_s), 0, self._T - 1))

    def _point(self, j: int, key: np.ndarray, sats: np.ndarray,
               rows: np.ndarray) -> np.ndarray:
        """Window-containment test for node j at composite keys."""
        if not len(self._klo[j]):
            # a PS no satellite ever sees: nothing to index (the JAX
            # package's version indexes the empty window list and raises)
            return np.zeros(np.shape(key), dtype=bool)
        i = np.searchsorted(self._klo[j], key, side="right") - 1
        ic = np.maximum(i, 0)
        return ((i >= 0) & (self._wsat[j][ic] == sats)
                & (self._whi[j][ic] > rows))

    def visible(self, t: float) -> np.ndarray:
        """(S, P) bool at time t."""
        ti = self._ti(t)
        out = np.zeros((self.constellation.num_sats, len(self.nodes)),
                       dtype=bool)
        for j in range(len(self.nodes)):
            m = (self._wlo[j] <= ti) & (self._whi[j] > ti)
            out[self._wsat[j][m], j] = True
        return out

    def visible_sats(self, t: float, node_idx: int) -> np.ndarray:
        ti = self._ti(t)
        j = node_idx
        m = (self._wlo[j] <= ti) & (self._whi[j] > ti)
        return self._wsat[j][m]

    def visible_rows(self, rows, sats) -> np.ndarray:
        rows_b, sats_b = np.broadcast_arrays(
            np.asarray(rows, dtype=np.int64), np.asarray(sats, np.int64))
        key = sats_b * (self._T + 1) + rows_b
        out = np.zeros(rows_b.shape + (len(self.nodes),), dtype=bool)
        for j in range(len(self.nodes)):
            out[..., j] = self._point(j, key, sats_b, rows_b)
        return out

    def _next_from(self, khi: np.ndarray, wsat: np.ndarray,
                   wlo: np.ndarray, sats: np.ndarray,
                   rows: np.ndarray):
        """First window of each (sat, row>=rows) pair in a key-sorted
        window list: (ok, row-of-first-visibility)."""
        i = np.searchsorted(khi, sats * (self._T + 1) + rows, side="right")
        ic = np.minimum(i, len(khi) - 1) if len(khi) else i * 0
        ok = (i < len(khi)) & (len(khi) > 0)
        if len(khi):
            ok &= wsat[ic] == sats
            row = np.maximum(wlo[ic], rows)
        else:
            row = rows
        return ok, row

    def next_visible_time(self, sat: int, t: float,
                          node_idx: Optional[int] = None) -> Optional[float]:
        ti = self._ti(t)
        sats = np.asarray([sat], dtype=np.int64)
        rows = np.asarray([ti], dtype=np.int64)
        if node_idx is None:
            ok, row = self._next_from(self._ukhi, self._usat, self._ulo,
                                      sats, rows)
        else:
            j = node_idx
            ok, row = self._next_from(self._khi[j], self._wsat[j],
                                      self._wlo[j], sats, rows)
        if not ok[0]:
            return None
        return float(self.times[row[0]])

    def next_visible_after(self, sats, t):
        sats = np.atleast_1d(np.asarray(sats, dtype=np.int64))
        t = np.broadcast_to(np.asarray(t, dtype=np.float64), sats.shape)
        ti = np.clip(np.round(t / self.dt_s).astype(np.int64), 0,
                     self._T - 1)
        ok, row = self._next_from(self._ukhi, self._usat, self._ulo,
                                  sats, ti)
        rowc = np.where(ok, row, 0)
        times = np.where(ok, self.times[rowc], np.inf)
        # first-visible PS = lowest node index in view at the row (the
        # dense path's argmax-of-bool), found by per-node containment
        ps = np.full(sats.shape, -1, dtype=np.int64)
        remaining = ok.copy()
        key = sats * (self._T + 1) + rowc
        for j in range(len(self.nodes)):
            if not remaining.any():
                break
            hit = remaining & self._point(j, key, sats, rowc)
            ps[hit] = j
            remaining &= ~hit
        return times, ps

    def next_orbit_visible(self, orbit_sats: Sequence[int], t: float):
        sats = np.asarray(list(orbit_sats), dtype=np.int64)
        ti = np.full(sats.shape, self._ti(t), dtype=np.int64)
        ok, row = self._next_from(self._ukhi, self._usat, self._ulo,
                                  sats, ti)
        if not ok.any():
            return None, None
        rowv = np.where(ok, row, self._T)
        best = int(rowv.min())
        first = int(np.flatnonzero(ok & (rowv == best))[0])
        return float(self.times[best]), int(sats[first])

    def visibility_fraction(self, sat: int) -> float:
        m = self._usat == sat
        covered = int((self._uhi[m] - self._ulo[m]).sum())
        return float(covered / self._T)

    # ---- segment exports --------------------------------------------------

    def node_windows(self, node_idx: int):
        j = node_idx
        return self._wsat[j], self._wlo[j], self._whi[j]

    def node_cover(self, node_idx: int):
        if self._cover[node_idx] is None:
            lo, hi = self._wlo[node_idx], self._whi[node_idx]
            if len(lo) == 0:
                z = np.zeros(0, dtype=np.int64)
                self._cover[node_idx] = (z, z.copy())
            else:
                order = np.argsort(lo, kind="stable")
                lo, hi = lo[order], hi[order]
                run_hi = np.maximum.accumulate(hi)
                new = np.ones(len(lo), dtype=bool)
                new[1:] = lo[1:] > run_hi[:-1]
                heads = np.flatnonzero(new)
                self._cover[node_idx] = (lo[heads],
                                         np.maximum.reduceat(hi, heads))
        return self._cover[node_idx]

    def covered_steps(self) -> int:
        return int((self._uhi - self._ulo).sum())

    @property
    def num_windows(self) -> int:
        return int(sum(len(w) for w in self._wsat))
