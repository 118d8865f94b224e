"""Ring-of-stars topology (paper §IV-A).

HAP layer: the HAPs form a ring (each talks to its two neighbors via IHL);
one is *source*, one *sink* (roles swap every global epoch).  Each HAP also
runs a star with its currently visible satellites.  SAT layer: satellites of
one orbit form an ISL ring (adjacent neighbors only — cross-orbit links are
excluded because of Doppler, §IV-A).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.constellation import GroundNode, WalkerDelta
from repro_torch.core.visibility import VisibilityTimeline


@dataclasses.dataclass
class RingOfStars:
    constellation: WalkerDelta
    nodes: List[GroundNode]
    timeline: VisibilityTimeline

    # ---- HAP ring ----------------------------------------------------------

    @property
    def num_ps(self) -> int:
        return len(self.nodes)

    def ring_hops(self, src: int, dst: int) -> int:
        """Hops along the HAP ring from src to dst (shorter direction —
        the relay floods both ways)."""
        H = self.num_ps
        d = abs(dst - src)
        return min(d, H - d)

    def sink_of(self, source: int) -> int:
        """Sink = HAP farthest from the source on the ring (§IV-B1)."""
        H = self.num_ps
        return (source + H // 2) % H if H > 1 else source

    def ring_path(self, src: int, dst: int) -> List[int]:
        """HAP ids along the shorter ring arc src -> dst, endpoints
        included (ties broken toward increasing id)."""
        H = self.num_ps
        fwd = (dst - src) % H
        step, hops = (1, fwd) if fwd <= H - fwd else (-1, H - fwd)
        return [(src + i * step) % H for i in range(hops + 1)]

    def ring_path_via(self, src: int, dst: int,
                      avoid=()) -> Optional[List[int]]:
        """Like ``ring_path`` but routing around the ``avoid`` HAPs
        (e.g. PSs inside an outage window, DESIGN.md §11): the shorter
        arc when its interior is clear, else the other arc, else None
        (both arcs blocked — src/dst endpoints are never checked)."""
        H = self.num_ps
        fwd = (dst - src) % H
        step, hops = (1, fwd) if fwd <= H - fwd else (-1, H - fwd)
        arcs = [[(src + i * step) % H for i in range(hops + 1)]]
        if 0 < fwd < H and hops < H:
            arcs.append([(src - i * step) % H for i in range(H - hops + 1)])
        for path in arcs:
            if not any(p in avoid for p in path[1:-1]):
                return path
        return None

    def ihl_distance(self, a: int, b: int, t):
        """HAP a <-> b distance; ``t`` may be scalar or an array of times."""
        d = np.linalg.norm(self.nodes[a].position(t)
                           - self.nodes[b].position(t), axis=-1)
        return float(d) if np.ndim(t) == 0 else d

    # ---- stars --------------------------------------------------------------

    def star_members(self, ps: int, t: float) -> np.ndarray:
        return self.timeline.visible_sats(t, ps)

    def visible_ps_of(self, sat: int, t: float) -> List[int]:
        return list(np.flatnonzero(self.timeline.visible(t)[sat]))

    # ---- SAT-layer ISL ring --------------------------------------------------

    def orbit_sats(self, orbit: int) -> np.ndarray:
        N = self.constellation.sats_per_orbit
        return np.arange(orbit * N, (orbit + 1) * N)

    def isl_neighbors(self, sat: int) -> Tuple[int, int]:
        N = self.constellation.sats_per_orbit
        o, s = divmod(sat, N)
        return o * N + (s - 1) % N, o * N + (s + 1) % N

    def isl_ring_distance(self, a: int, b: int) -> int:
        """Hops along the intra-orbit ring (two-front relay => shorter arc).
        Satellites on different orbits are unreachable (returns a big int)."""
        N = self.constellation.sats_per_orbit
        if a // N != b // N:
            return 10 ** 9
        d = abs(a % N - b % N)
        return min(d, N - d)

    def isl_ring_distance_matrix(self) -> np.ndarray:
        """(N, N) intra-orbit hop distances — identical for every orbit."""
        N = self.constellation.sats_per_orbit
        d = np.abs(np.arange(N)[:, None] - np.arange(N)[None, :])
        return np.minimum(d, N - d)

    def isl_chord_m(self) -> float:
        """Distance between ring-adjacent satellites (constant for circular
        equally-spaced orbits)."""
        N = self.constellation.sats_per_orbit
        return float(2 * self.constellation.radius_m * np.sin(np.pi / N))

    def sat_ps_distance(self, sat: int, ps: int, t: float) -> float:
        sp = self.constellation.positions(t)[sat]
        return float(np.linalg.norm(sp - self.nodes[ps].position(t)))

    def sat_ps_distances(self, sats, ps: int, t) -> np.ndarray:
        """Distances of the given satellites to one PS; ``t`` scalar or
        per-satellite (P,).  Vectorized — no full-constellation positions."""
        sats = np.atleast_1d(np.asarray(sats, dtype=np.int64))
        t_arr = np.broadcast_to(np.asarray(t, dtype=np.float64), sats.shape)
        sp = self.constellation.positions_at(sats, t_arr)       # (P,3)
        gp = self.nodes[ps].position(t_arr)                     # (P,3)
        return np.linalg.norm(sp - np.atleast_2d(gp), axis=-1)
