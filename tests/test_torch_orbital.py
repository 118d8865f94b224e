"""Port vs JAX package: the host-side orbital and timing layer.

Constellation geometry, dense visibility, the ring-of-stars topology,
propagation timing and the contact plan are numpy in both packages, copied
with only their imports changed, so every result must be exactly equal
(``array_equal`` / ``==``), not merely close.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.paper_models import SmallNetConfig as JSmallNetConfig
from repro.core import constellation as jcst
from repro.core.links import LinkModel as JLinkModel, model_bits as jbits
from repro.core.propagation import PropagationModel as JProp
from repro.core.topology import RingOfStars as JRing
from repro.core.visibility import VisibilityTimeline as JTimeline
from repro.models import cnn as jcnn
from repro.sched.contacts import ContactPlan as JPlan
from repro_torch.configs.paper_models import MNIST_CNN, SmallNetConfig
from repro_torch.core import constellation as tcst
from repro_torch.core.links import LinkModel, model_bits
from repro_torch.core.modelbank import params_from_jax
from repro_torch.core.propagation import PropagationModel
from repro_torch.core.topology import RingOfStars
from repro_torch.core.visibility import VisibilityTimeline
from repro_torch.sched.contacts import ContactPlan

HORIZON_S = 6 * 3600.0      # short horizon: keeps each plan well under 1 s
BITS = 206_922 * 32.0       # MNIST_CNN at fp32


def _both(scenario, use_isl=True):
    jc, tc = jcst.paper_constellation(), tcst.paper_constellation()
    jn, tn = jcst.make_ps_nodes(scenario), tcst.make_ps_nodes(scenario)
    jtl = JTimeline(jc, jn, HORIZON_S, 10.0)
    ttl = VisibilityTimeline(tc, tn, HORIZON_S, 10.0)
    jtopo, ttopo = JRing(jc, jn, jtl), RingOfStars(tc, tn, ttl)
    jp = JPlan(jc, jn, jtl, jtopo, JProp(jtopo, JLinkModel()),
               use_isl=use_isl)
    tp = ContactPlan(tc, tn, ttl, ttopo, PropagationModel(ttopo, LinkModel()),
                     use_isl=use_isl)
    return jp, tp


@pytest.fixture(scope="module", params=["gs", "hap", "twohap"])
def plans(request):
    return request.param, _both(request.param)


def test_constellation_positions_equal():
    jc, tc = jcst.paper_constellation(), tcst.paper_constellation()
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    t = np.linspace(0.0, 86400.0, 97)
    assert np.array_equal(jc.positions(t), tc.positions(t))
    assert np.array_equal(jc.orbit_ids(), tc.orbit_ids())
    for scen in ("gs", "hap", "twohap", "gs-np", "hapring:4"):
        jn, tn = jcst.make_ps_nodes(scen), tcst.make_ps_nodes(scen)
        assert [dataclasses.asdict(n) for n in jn] == \
            [dataclasses.asdict(n) for n in tn]
        for a, b in zip(jn, tn):
            assert np.array_equal(a.position(t), b.position(t))


def test_visibility_and_topology_equal(plans):
    _, (jp, tp) = plans
    assert np.array_equal(jp.timeline.grid, tp.timeline.grid)
    assert np.array_equal(jp.timeline.times, tp.timeline.times)
    for p in range(len(jp.nodes)):
        for a, b in zip(jp.timeline.node_windows(p),
                        tp.timeline.node_windows(p)):
            assert np.array_equal(a, b)
    assert np.array_equal(jp.topo.isl_ring_distance_matrix(),
                          tp.topo.isl_ring_distance_matrix())
    assert jp.topo.isl_chord_m() == tp.topo.isl_chord_m()
    for t in (0.0, 3600.0, 12345.0):
        for h in range(len(jp.nodes)):
            assert np.array_equal(jp.topo.star_members(h, t),
                                  tp.topo.star_members(h, t))
    assert [dataclasses.asdict(w) for w in jp.windows()] == \
        [dataclasses.asdict(w) for w in tp.windows()]


@pytest.mark.parametrize("t0", [0.0, 1234.0, 7200.0, 15000.0])
def test_downlink_uplink_times_equal(plans, t0):
    _, (jp, tp) = plans
    S = jp.constellation.num_sats
    for source in range(len(jp.nodes)):
        jr = jp.downlink_times(t0, BITS, source)
        tr = tp.downlink_times(t0, BITS, source)
        assert np.array_equal(jr, tr)
        part = [s for s in range(S) if np.isfinite(jr[s])]
        t_done = jr[part] + 600.0
        sink = jp.topo.sink_of(source)
        for a, b in zip(jp.uplink_times(part, t_done, BITS, sink),
                        tp.uplink_times(part, t_done, BITS, sink)):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("t0", [0.0, 5000.0])
def test_isl_less_plan_timing_equal(t0):
    jp, tp = _both("gs-np", use_isl=False)
    jr, tr = jp.downlink_times(t0, BITS, 0), tp.downlink_times(t0, BITS, 0)
    assert np.array_equal(jr, tr)
    part = [s for s in range(len(jr)) if np.isfinite(jr[s])]
    for a, b in zip(jp.uplink_times(part, jr[part] + 600.0, BITS, 0),
                    tp.uplink_times(part, tr[part] + 600.0, BITS, 0)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("cfg", [MNIST_CNN,
                                 SmallNetConfig("tiny", "cnn", 28, 1,
                                                hidden=16,
                                                conv_channels=(4, 8)),
                                 SmallNetConfig("mlp", "mlp", 28, 1,
                                                hidden=32)])
def test_model_bits_equal(cfg):
    jcfg = JSmallNetConfig(**dataclasses.asdict(cfg))
    w = jax.device_get(jcnn.init_params(jax.random.PRNGKey(0), jcfg))
    tw = params_from_jax(w, device="cpu")
    assert model_bits(tw) == jbits(w)          # the same float, exactly
    if cfg is MNIST_CNN:
        assert model_bits(tw) == 206_922 * 32.0
        assert all(v.device == torch.device("cpu") for v in tw.values())
