"""Model propagation timing (paper §IV-B, Algorithm 1).

Downlink: the source HAP relays the global model around the HAP ring; every
HAP broadcasts to its visible satellites; visible satellites relay along the
intra-orbit ISL ring (two fronts, ceasing where they meet), so invisible
satellites start training with minimal delay.  Orbits with *no* visible
satellite wait for their next pass.

Uplink: a trained local model goes straight up if its satellite sees a HAP,
else it relays along the ring toward the nearest (eventually-)visible
orbit-mate; received sets are relayed along the HAP ring to the sink.

This module converts those rules into per-satellite receive/arrival *times*
(simulated seconds), which is everything the discrete-event simulator needs.
The hot paths are numpy-broadcast vectorized: ``downlink_times`` is one
min-plus relaxation over the (O, N, N) ring-hop grid and ``uplink_many``
times a whole participant set at once (per-satellite Python scans only
survive for the rare no-visibility fallbacks).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.links import LinkModel
from repro_torch.core.topology import RingOfStars

_UNREACH = 10 ** 9      # ring distance between different orbits


@dataclasses.dataclass
class PropagationModel:
    topo: RingOfStars
    link: LinkModel

    # ---- primitive hop delays ----------------------------------------------

    def isl_hop_delay(self, bits: float) -> float:
        return self.link.total_delay(bits, self.topo.isl_chord_m())

    def ihl_hop_delay(self, bits: float, a: int, b: int, t: float) -> float:
        return self.link.total_delay(bits, self.topo.ihl_distance(a, b, t))

    def sat_ps_delay(self, bits: float, sat: int, ps: int, t: float) -> float:
        return self.link.total_delay(bits, self.topo.sat_ps_distance(sat, ps, t))

    def ring_relay_delay(self, bits: float, src: int, dst: int, t0,
                         avoid=()):
        """Accumulated IHL delay along the *actual* shorter ring arc
        src -> dst: each successive HAP pair contributes its own delay,
        evaluated at the model's current arrival time.  ``t0`` may be a
        scalar or a vector of per-model send times.

        ``avoid`` (default empty — identical behavior) lists HAPs the
        relay may not transit (e.g. PSs inside an outage window,
        DESIGN.md §11): the relay takes the other ring arc when the
        shorter arc's interior is blocked, and returns +inf when both
        arcs are (the model cannot reach ``dst`` right now)."""
        if avoid:
            path = self.topo.ring_path_via(src, dst, avoid)
            if path is None:
                return np.full_like(np.asarray(t0, np.float64), np.inf) \
                    if np.ndim(t0) else np.inf
        else:
            path = self.topo.ring_path(src, dst)
        t = np.asarray(t0, dtype=np.float64)
        for a, b in zip(path, path[1:]):
            t = t + self.link.total_delay(bits, self.topo.ihl_distance(a, b, t))
        return t - np.asarray(t0, dtype=np.float64)

    # ---- downlink (Alg. 1 lines 2-10) ---------------------------------------

    def hap_receive_times(self, t0: float, bits: float, source: int) -> np.ndarray:
        """Time each HAP holds the global model after the ring relay (walks
        the successive ring pairs, not ``hops x`` one endpoint-pair delay)."""
        H = self.topo.num_ps
        out = np.full(H, float(t0))
        for h in range(H):
            out[h] = t0 + self.ring_relay_delay(bits, source, h, t0)
        return out

    def downlink_times(self, t0: float, bits: float, source: int = 0,
                       contention=None) -> np.ndarray:
        """Per-satellite time of receiving the global model (Alg. 1).
        Vectorized: star broadcasts are per-HAP distance vectors; the ISL
        relay is one broadcast min-plus over the ring-hop matrix.

        ``contention`` (a `sched/contacts.ContentionModel`, optional)
        charges one transmit-channel grant per PS->sat model copy — each
        HAP unicasts the global model to every satellite in its star, so
        finite ``ps_channels`` serialize those transfers per busy interval
        (the transmission time) instead of the pure delay formula.  Every
        *visible* satellite is charged, even one a scheduler will not
        recruit: it still receives the copy and seeds the intra-orbit
        relay for its orbit-mates (Alg. 1 broadcasts unconditionally).
        The ISL relay onward is satellite-to-satellite and the HAP ring a
        dedicated trunk: neither is charged (DESIGN.md §9)."""
        topo = self.topo
        O = topo.constellation.num_orbits
        N = topo.constellation.sats_per_orbit
        S = topo.constellation.num_sats
        recv = np.full(S, np.inf)
        hap_t = self.hap_receive_times(t0, bits, source)

        # star broadcast from each HAP to its visible satellites
        if contention is None:
            for h in range(topo.num_ps):
                vis = topo.star_members(h, hap_t[h])
                if len(vis) == 0:
                    continue
                cand = hap_t[h] + self.link.total_delay(
                    bits, topo.sat_ps_distances(vis, h, hap_t[h]))
                recv[vis] = np.minimum(recv[vis], cand)
        else:
            # per-transfer tx grants (FIFO by request time across HAPs);
            # a queued grant shifts the copy by (start - request), which
            # is exactly 0.0 when the channel is free, so uncontended
            # results stay bit-identical to the vectorized branch
            ps_ids, reqs, frees, sat_ids = [], [], [], []
            for h in range(topo.num_ps):
                vis = topo.star_members(h, hap_t[h])
                if len(vis) == 0:
                    continue
                free = hap_t[h] + self.link.total_delay(
                    bits, topo.sat_ps_distances(vis, h, hap_t[h]))
                free = np.broadcast_to(np.asarray(free, np.float64),
                                       (len(vis),))
                ps_ids.extend([h] * len(vis))
                reqs.extend([hap_t[h]] * len(vis))
                frees.extend(free.tolist())
                sat_ids.extend(int(s) for s in vis)
            if sat_ids:
                t_t = self.link.transmission_delay(bits)
                starts = contention.grant_tx_many(ps_ids, reqs, t_t)
                cand = (np.asarray(frees)
                        + (starts - np.asarray(reqs, np.float64)))
                np.minimum.at(recv, sat_ids, cand)

        # intra-orbit ISL relay from the seeded (visible) satellites:
        # recv[o,i] = min_j recv[o,j] + ringd[j,i] * hop, all orbits at once
        hop = self.isl_hop_delay(bits)
        ringd = topo.isl_ring_distance_matrix()
        recv_on = recv.reshape(O, N)
        relay = (recv_on[:, :, None] + ringd[None] * hop).min(axis=1)
        recv_on = np.minimum(recv_on, relay)

        # orbits with no visible satellite now: wait for the next pass
        for orbit in np.flatnonzero(~np.isfinite(recv_on).any(axis=1)):
            sats = topo.orbit_sats(orbit)
            t_vis, seed = topo.timeline.next_orbit_visible(sats, t0)
            if t_vis is None:
                continue                 # never visible within horizon
            ps = topo.visible_ps_of(seed, t_vis)
            ps0 = ps[0] if ps else 0
            t_seed = (max(t_vis, hap_t[ps0])
                      + self.sat_ps_delay(bits, seed, ps0, t_vis))
            if contention is not None:
                req = max(t_vis, hap_t[ps0])
                start = contention.grant_tx(
                    ps0, req, self.link.transmission_delay(bits))
                t_seed += start - req
            recv_on[orbit] = np.minimum(recv_on[orbit],
                                        t_seed + ringd[seed - sats[0]] * hop)
        return recv_on.reshape(S)

    # ---- uplink (Alg. 1 lines 11-22) ----------------------------------------

    def uplink_many(self, sats: Sequence[int], t_done, bits: float,
                    sink: int, contention=None) -> Tuple[np.ndarray,
                                                         np.ndarray]:
        """Vectorized uplink timing for a whole participant set.

        Returns (arrival times at the sink HAP, first-receiving HAP id) as
        (P,) arrays; inf / -1 where a model never reaches a HAP.

        ``contention`` charges one receive-channel grant per model at its
        first-receiving HAP, held for the transmission time: a PS with
        finite ``ps_channels`` serializes simultaneous uplinks instead of
        absorbing them all at once (DESIGN.md §9).  The onward HAP-ring
        relay to the sink is a dedicated trunk and is not charged.
        """
        topo, tl = self.topo, self.topo.timeline
        sats = np.atleast_1d(np.asarray(sats, dtype=np.int64))
        t_done = np.broadcast_to(np.asarray(t_done, dtype=np.float64),
                                 sats.shape).copy()
        P = len(sats)
        hop = self.isl_hop_delay(bits)
        N = topo.constellation.sats_per_orbit
        ringd = topo.isl_ring_distance_matrix()
        ti = np.clip(np.round(t_done / tl.dt_s).astype(np.int64), 0,
                     len(tl.times) - 1)

        t_at = np.full(P, np.inf)          # arrival at the first HAP
        hap = np.full(P, -1, dtype=np.int64)

        # --- direct: the satellite sees a HAP at t_done ---------------------
        vis = tl.visible_rows(ti, sats)                          # (P, H)
        direct = vis.any(axis=1)
        if direct.any():
            di = np.flatnonzero(direct)
            hsel = np.argmax(vis[di], axis=1)
            for h in np.unique(hsel):
                m = di[hsel == h]
                d = topo.sat_ps_distances(sats[m], int(h), t_done[m])
                t_at[m] = t_done[m] + self.link.total_delay(bits, d)
                hap[m] = h

        # --- relay: a currently visible orbit-mate exists -------------------
        rest = np.flatnonzero(~direct)
        if len(rest):
            orb = sats[rest] // N
            mates = orb[:, None] * N + np.arange(N)[None, :]     # (Q, N)
            mate_vis = tl.visible_rows(ti[rest][:, None], mates)  # (Q, N, H)
            mate_any = mate_vis.any(axis=2)                      # (Q, N)
            has_mate = mate_any.any(axis=1)
            if has_mate.any():
                q = np.flatnonzero(has_mate)
                rd = ringd[sats[rest[q]] % N]                    # (|q|, N)
                rdm = np.where(mate_any[q], rd, _UNREACH)
                jstar = np.argmin(rdm, axis=1)
                s_star = mates[q, jstar]
                d_hops = rdm[np.arange(len(q)), jstar]
                t_arrive = t_done[rest[q]] + d_hops * hop
                hsel = np.argmax(mate_vis[q, jstar, :], axis=1)
                for h in np.unique(hsel):
                    m = hsel == h
                    rows = rest[q[m]]
                    d = topo.sat_ps_distances(s_star[m], int(h), t_arrive[m])
                    t_at[rows] = t_arrive[m] + self.link.total_delay(bits, d)
                    hap[rows] = h

            # --- wait: whole orbit invisible; relay pre-positions -----------
            for qi in np.flatnonzero(~has_mate):
                p = rest[qi]
                t_vis, s_star = tl.next_orbit_visible(
                    topo.orbit_sats(int(sats[p] // N)), float(t_done[p]))
                if t_vis is None:
                    continue
                d = topo.isl_ring_distance(int(sats[p]), int(s_star))
                t_ready = max(t_done[p] + d * hop, t_vis)
                vis2 = topo.visible_ps_of(s_star, t_vis)
                h = vis2[0] if vis2 else 0
                t_at[p] = t_ready + self.sat_ps_delay(bits, s_star, h, t_ready)
                hap[p] = h

        # --- receive contention at the first HAP ----------------------------
        if contention is not None:
            okc = np.flatnonzero(np.isfinite(t_at))
            if len(okc):
                t_t = self.link.transmission_delay(bits)
                # the PS starts receiving at (unconstrained completion -
                # transmission time); a queued grant shifts completion by
                # (start - request), exactly 0.0 when a channel is free
                req = t_at[okc] - t_t
                starts = contention.grant_rx_many(hap[okc], req, t_t)
                t_at[okc] += starts - req

        # --- HAP ring relay to the sink (walks the actual ring path) --------
        out = np.full(P, np.inf)
        ok = np.isfinite(t_at)
        for h in np.unique(hap[ok]):
            m = ok & (hap == h)
            out[m] = t_at[m] + self.ring_relay_delay(bits, int(h), sink,
                                                     t_at[m])
        return out, hap

    def uplink(self, sat: int, t_done: float, bits: float, sink: int,
               contention=None) -> Tuple[float, int]:
        """Arrival time of sat's local model at the *sink* HAP, and the HAP
        that first received it (scalar convenience over ``uplink_many``;
        this single-transfer shape is what the event runtime's
        lossy-transfer retries re-time — each retransmission is a fresh
        uplink, and a fresh rx grant when ``contention`` is given).

        The fault layer (sched/faults.py) never appears here explicitly:
        eclipse windows are ANDed into the visibility grid before the
        plan compiles, so all uplink routing (direct / relay / wait)
        already avoids dark satellites."""
        t_arr, haps = self.uplink_many([sat], [t_done], bits, sink,
                                       contention=contention)
        return float(t_arr[0]), int(haps[0])
