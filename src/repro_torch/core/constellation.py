"""Walker-delta LEO constellation — circular Kepler orbits (paper §III).

Orbital period  T_o = 2*pi*(R_E + h_o) / v_o,  v_o = sqrt(GM / (R_E + h_o)).
Satellite (o, s) flies at argument-of-latitude
    u(t) = 2*pi*s/N_o + F*2*pi*o/(O*N_o) + n*t        (n = mean motion)
in the plane with RAAN  Omega_o = 2*pi*o/O  and inclination i.  Ground nodes
(GS) and HAPs are Earth-fixed and rotate with the Earth in ECI.

Everything is vectorized numpy; times are seconds since sim start.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

R_EARTH = 6371.0e3          # m
GM = 3.986004418e14         # m^3/s^2
OMEGA_EARTH = 7.2921159e-5  # rad/s
C_LIGHT = 299_792_458.0     # m/s


@dataclasses.dataclass(frozen=True)
class WalkerDelta:
    num_orbits: int
    sats_per_orbit: int
    altitude_m: float = 2000e3
    inclination_deg: float = 80.0
    phasing: int = 1                      # Walker F factor

    @property
    def num_sats(self) -> int:
        return self.num_orbits * self.sats_per_orbit

    @property
    def radius_m(self) -> float:
        return R_EARTH + self.altitude_m

    @property
    def velocity(self) -> float:
        return float(np.sqrt(GM / self.radius_m))

    @property
    def period_s(self) -> float:
        return float(2 * np.pi * self.radius_m / self.velocity)

    @property
    def mean_motion(self) -> float:
        return 2 * np.pi / self.period_s

    def orbit_of(self, sat: int) -> int:
        return sat // self.sats_per_orbit

    def index_in_orbit(self, sat: int) -> int:
        return sat % self.sats_per_orbit

    def orbit_ids(self) -> np.ndarray:
        return np.arange(self.num_sats) // self.sats_per_orbit

    def positions(self, t) -> np.ndarray:
        """ECI positions at time(s) t.  t scalar -> (S,3); t (T,) -> (T,S,3)."""
        t = np.asarray(t, dtype=np.float64)
        scalar = t.ndim == 0
        t = np.atleast_1d(t)
        O, N = self.num_orbits, self.sats_per_orbit
        o = np.repeat(np.arange(O), N)
        s = np.tile(np.arange(N), O)
        raan = 2 * np.pi * o / O
        phase0 = 2 * np.pi * s / N + self.phasing * 2 * np.pi * o / (O * N)
        u = phase0[None, :] + self.mean_motion * t[:, None]     # (T,S)
        inc = np.deg2rad(self.inclination_deg)
        r = self.radius_m
        # in-plane
        xp, yp = r * np.cos(u), r * np.sin(u)
        # rotate by inclination (about x), then RAAN (about z)
        x1, y1, z1 = xp, yp * np.cos(inc), yp * np.sin(inc)
        cosO, sinO = np.cos(raan)[None, :], np.sin(raan)[None, :]
        x = x1 * cosO - y1 * sinO
        y = x1 * sinO + y1 * cosO
        pos = np.stack([x, y, z1], axis=-1)                     # (T,S,3)
        return pos[0] if scalar else pos

    def positions_at(self, sats, t) -> np.ndarray:
        """ECI positions of *specific* satellites at per-satellite times.
        ``sats`` (P,) int, ``t`` scalar or (P,) -> (P, 3).  Unlike
        ``positions`` this never materializes the full constellation, so
        per-satellite timing paths stay O(P)."""
        sats = np.atleast_1d(np.asarray(sats, dtype=np.int64))
        t = np.broadcast_to(np.asarray(t, dtype=np.float64), sats.shape)
        O, N = self.num_orbits, self.sats_per_orbit
        o, s = sats // N, sats % N
        raan = 2 * np.pi * o / O
        phase0 = 2 * np.pi * s / N + self.phasing * 2 * np.pi * o / (O * N)
        u = phase0 + self.mean_motion * t
        inc = np.deg2rad(self.inclination_deg)
        r = self.radius_m
        xp, yp = r * np.cos(u), r * np.sin(u)
        x1, y1, z1 = xp, yp * np.cos(inc), yp * np.sin(inc)
        cosO, sinO = np.cos(raan), np.sin(raan)
        return np.stack([x1 * cosO - y1 * sinO, x1 * sinO + y1 * cosO, z1],
                        axis=-1)


@dataclasses.dataclass(frozen=True)
class GroundNode:
    """A GS (altitude ~0) or HAP (stratosphere, ~20 km) fixed over a location."""
    name: str
    lat_deg: float
    lon_deg: float
    altitude_m: float = 0.0
    min_elevation_deg: float = 10.0
    kind: str = "gs"                      # gs | hap

    def position(self, t) -> np.ndarray:
        """ECI position at time(s) t (Earth-fixed point rotating with Earth)."""
        t = np.asarray(t, dtype=np.float64)
        scalar = t.ndim == 0
        t = np.atleast_1d(t)
        lat, lon = np.deg2rad(self.lat_deg), np.deg2rad(self.lon_deg)
        r = R_EARTH + self.altitude_m
        theta = lon + OMEGA_EARTH * t                           # (T,)
        x = r * np.cos(lat) * np.cos(theta)
        y = r * np.cos(lat) * np.sin(theta)
        z = np.full_like(theta, r * np.sin(lat))
        pos = np.stack([x, y, z], axis=-1)
        return pos[0] if scalar else pos


# paper §V-A locations
ROLLA = (37.95, -91.77)
PORTLAND = (45.52, -122.68)
NORTH_POLE = (90.0, 0.0)


def paper_constellation() -> WalkerDelta:
    """40 satellites over 5 orbits at 2000 km, 80 deg inclination (§V-A)."""
    return WalkerDelta(num_orbits=5, sats_per_orbit=8,
                       altitude_m=2000e3, inclination_deg=80.0)


def make_ps_nodes(scenario: str) -> List[GroundNode]:
    """'gs' | 'hap' | 'twohap' | 'gs-np' (ideal-setup baselines), plus the
    parametric 'hapring:N' mega-constellation scenario: N >= 1 HAPs at
    20 km spread evenly in longitude at the Rolla latitude, forming a
    P = N parameter-server ring (§IV-A ring-of-stars at scale)."""
    if scenario.startswith("hapring:"):
        n = int(scenario.split(":", 1)[1])
        if n < 1:
            raise ValueError(scenario)
        lat, lon0 = ROLLA
        return [GroundNode(f"HAP-ring{k}", lat,
                           ((lon0 + 360.0 * k / n + 180.0) % 360.0) - 180.0,
                           20e3, kind="hap")
                for k in range(n)]
    if scenario == "gs":
        return [GroundNode("GS-Rolla", *ROLLA, 0.0)]
    if scenario == "hap":
        return [GroundNode("HAP-Rolla", *ROLLA, 20e3, kind="hap")]
    if scenario == "twohap":
        return [GroundNode("HAP-Rolla", *ROLLA, 20e3, kind="hap"),
                GroundNode("HAP-Portland", *PORTLAND, 20e3, kind="hap")]
    if scenario == "gs-np":
        return [GroundNode("GS-NorthPole", *NORTH_POLE, 0.0)]
    raise ValueError(scenario)
