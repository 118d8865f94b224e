"""RF link budget and delay model (paper §III-B, eqs. 5-9, Table I).

SNR(x,y)   = Pt*Gx*Gy / (kB * T * B * FSPL)                       (eq. 5)
FSPL       = (4*pi*d*f/c)^2 for LoS, inf otherwise                (eq. 6)
t_c        = t_t + t_p + t_x + t_y                                (eq. 7)
t_t        = bits/R,  t_p = d/c                                   (eq. 8)
R          ~ B*log2(1+SNR)                                        (eq. 9)

The paper's evaluation fixes R = 16 Mb/s for fairness with baselines;
``LinkModel(rate_bps=...)`` reproduces that, while ``shannon_rate`` exposes
the full budget (and shows FSO-class rates are available if desired).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.constellation import C_LIGHT

K_BOLTZMANN = 1.380649e-23


def dbm_to_watt(dbm: float) -> float:
    return 10 ** ((dbm - 30) / 10)


def dbi_to_linear(dbi: float) -> float:
    return 10 ** (dbi / 10)


@dataclasses.dataclass(frozen=True)
class LinkModel:
    # Table I defaults
    tx_power_dbm: float = 40.0
    antenna_gain_dbi: float = 6.98
    carrier_freq_hz: float = 2.4e9
    noise_temp_k: float = 354.81
    bandwidth_hz: float = 20e6
    rate_bps: float = 16e6            # fixed evaluation rate (Table I)
    proc_delay_s: float = 0.5         # t_x + t_y combined

    def fspl(self, distance_m: float) -> float:
        return (4 * np.pi * distance_m * self.carrier_freq_hz / C_LIGHT) ** 2

    def snr(self, distance_m: float) -> float:
        pt = dbm_to_watt(self.tx_power_dbm)
        g = dbi_to_linear(self.antenna_gain_dbi)
        noise = K_BOLTZMANN * self.noise_temp_k * self.bandwidth_hz
        return pt * g * g / (noise * self.fspl(distance_m))

    def shannon_rate(self, distance_m: float) -> float:
        return self.bandwidth_hz * np.log2(1.0 + self.snr(distance_m))

    # ---- delays ------------------------------------------------------------

    def transmission_delay(self, bits: float, use_shannon: bool = False,
                           distance_m: float = 0.0) -> float:
        rate = self.shannon_rate(distance_m) if use_shannon else self.rate_bps
        return bits / rate

    def propagation_delay(self, distance_m: float) -> float:
        return distance_m / C_LIGHT

    def total_delay(self, bits: float, distance_m: float,
                    use_shannon: bool = False) -> float:
        return (self.transmission_delay(bits, use_shannon, distance_m)
                + self.propagation_delay(distance_m) + self.proc_delay_s)

    def busy_interval(self, t_start: float, bits: float):
        """Channel-occupancy interval ``[t_start, t_start + t_t)`` of one
        transfer that begins transmitting at ``t_start``: the channel is
        held for the transmission time only — propagation and processing
        delay the *payload*, not the transmitter.  This is the per-
        transfer quantity the contention model (`sched/contacts.py`,
        DESIGN.md §9) serializes; ``total_delay`` stays the payload's
        end-to-end latency."""
        return t_start, t_start + self.transmission_delay(bits)


def fso_link(rate_bps: float = 1e11, proc_delay_s: float = 0.1) -> LinkModel:
    """Free-space-optical link (paper §III-B: 'AsyncFLEO can actually benefit
    from FSO links... as high as Terabytes per second').  Default 100 Gb/s —
    conservative for laser ISL terminals."""
    return LinkModel(carrier_freq_hz=1.93e14,        # 1550 nm
                     bandwidth_hz=10e9, rate_bps=rate_bps,
                     proc_delay_s=proc_delay_s)


def model_bits(params) -> float:
    """Size in bits of a parameter dict of tensors at fp32 (paper transmits
    fp32 weights)."""
    return float(sum(int(t.numel()) for t in params.values()) * 32)
