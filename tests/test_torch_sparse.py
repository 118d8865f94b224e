"""The port's sparse contact compilation (``SparseVisibilityTimeline``,
``ContactPlan.compile(visibility="sparse")``, ``SimConfig.visibility``).

The sparse timeline is host numpy and must answer exactly as the dense
one: the compiled window set, every plan query and every point query
equal the port's dense timeline and the JAX package's sparse timeline,
on the three geometries of ``tests/test_sparse_contacts.py``.  The event
runtime's histories, models and event counts are bit-identical sparse
against dense at S = 40 and S = 200; ``hapring:4`` and ``hapring:6`` run
end to end.  A PS that no satellite ever sees answers False (the JAX
package's sparse timeline raises there, C-ref 1).  Sparse visibility
refuses the fault grid-masks and unknown modes.  Nothing here has a
tolerance: every comparison is exact.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core.constellation import (WalkerDelta as JWalker,
                                      make_ps_nodes as jnodes)
from repro.sched import ContactPlan as JPlan
from repro_torch.core.constellation import (WalkerDelta, make_ps_nodes,
                                            paper_constellation)
from repro_torch.core.simulator import FLSimulation, SimConfig
from repro_torch.core.visibility import (SparseVisibilityTimeline,
                                         VisibilityTimeline,
                                         elevation_rate_bound_deg_s)
from repro_torch.data.partition import iid_partition
from repro_torch.data.synthetic import class_conditional_images
from repro_torch.fl.client import ImageClassifierPool
from repro_torch.fl.strategies import get_strategy
from repro_torch.sched import ContactPlan, EventDrivenRuntime, FaultModel
from test_torch_cnn_client import TINY
from test_torch_sched import (one_torch_thread,  # noqa: F401
                              setup)  # (fixtures)

WALKER200 = dict(num_orbits=10, sats_per_orbit=20, altitude_m=600e3,
                 inclination_deg=60.0)
GEOMETRIES = {
    "paper-twohap": ("paper", "twohap"),
    "paper-hap": ("paper", "hap"),
    "walker200-ring4": (WALKER200, "hapring:4"),
}
HOURS = 6


def _geometry(key, jax=False):
    cst, scenario = GEOMETRIES[key]
    if cst == "paper":
        cst = paper_constellation()
        if jax:
            from repro.core.constellation import paper_constellation as jp
            cst = jp()
    else:
        cst = (JWalker if jax else WalkerDelta)(**cst)
    return cst, (jnodes if jax else make_ps_nodes)(scenario)


def _plans(key, dt_s=30.0):
    """The port's dense and sparse plans and the reference's sparse plan."""
    cst, nodes = _geometry(key)
    jcst, jn = _geometry(key, jax=True)
    dur = HOURS * 3600.0
    return (ContactPlan.compile(cst, nodes, dur, dt_s),
            ContactPlan.compile(cst, nodes, dur, dt_s, visibility="sparse"),
            JPlan.compile(jcst, jn, dur, dt_s, visibility="sparse"))


def _windows(plan):
    return [(w.sat, w.node, w.t_start, w.t_end, w.delay_s)
            for w in plan.windows()]


@pytest.mark.parametrize("key", sorted(GEOMETRIES))
def test_sparse_windows_match_dense_and_reference(key):
    dense, sparse, jsparse = _plans(key)
    assert isinstance(sparse.timeline, SparseVisibilityTimeline)
    assert isinstance(dense.timeline, VisibilityTimeline)
    assert _windows(dense) and _windows(sparse) == _windows(dense)
    assert _windows(sparse) == _windows(jsparse)
    assert sparse.timeline.num_windows == jsparse.timeline.num_windows
    assert sparse.summary() == dense.summary() == jsparse.summary()


@pytest.mark.parametrize("key", sorted(GEOMETRIES))
def test_sparse_plan_queries_match_dense_and_reference(key):
    dense, sparse, jsparse = _plans(key)
    sats = np.arange(0, dense.num_sats, 3)
    rng = np.random.default_rng(5)
    for t in rng.uniform(0.0, HOURS * 3600.0, size=40):
        td, pd = dense.next_contact(sats, float(t))
        for plan in (sparse, jsparse):
            ts, ps = plan.next_contact(sats, float(t))
            np.testing.assert_array_equal(td, ts)
            np.testing.assert_array_equal(pd, ps)
            np.testing.assert_array_equal(
                dense.next_contact_by_node(float(t)),
                plan.next_contact_by_node(float(t)))


@pytest.mark.parametrize("key", sorted(GEOMETRIES))
def test_sparse_point_queries_match_dense_and_reference(key):
    dense, sparse, jsparse = _plans(key)
    tld, tls, tlj = dense.timeline, sparse.timeline, jsparse.timeline
    S, P = dense.num_sats, len(dense.nodes)
    rng = np.random.default_rng(9)
    for t in rng.uniform(0.0, HOURS * 3600.0, size=25):
        t = float(t)
        for tl in (tls, tlj):
            np.testing.assert_array_equal(tld.visible(t), tl.visible(t))
            for p in range(P):
                np.testing.assert_array_equal(tld.visible_sats(t, p),
                                              tl.visible_sats(t, p))
            for sat in range(0, S, 11):
                assert (tld.next_visible_time(sat, t)
                        == tl.next_visible_time(sat, t))
                for p in range(P):
                    assert (tld.next_visible_time(sat, t, p)
                            == tl.next_visible_time(sat, t, p))
        sats = rng.integers(0, S, 30)
        ts = rng.uniform(0.0, HOURS * 3600.0, 30)
        want = tld.next_visible_after(sats, ts)
        for tl in (tls, tlj):
            got = tl.next_visible_after(sats, ts)
            np.testing.assert_array_equal(want[0], got[0])
            np.testing.assert_array_equal(want[1], got[1])
    rows = rng.integers(0, len(tld.times), (7, 13))
    sats = rng.integers(0, S, (7, 13))
    for tl in (tls, tlj):
        np.testing.assert_array_equal(tld.visible_rows(rows, sats),
                                      tl.visible_rows(rows, sats))
        for orbit in range(min(S, 5)):
            members = list(range(orbit, S, max(1, S // 8)))[:8]
            for t in (0.0, 3000.0, 15000.0):
                assert (tld.next_orbit_visible(members, t)
                        == tl.next_orbit_visible(members, t))
        for sat in range(0, S, 7):
            assert tld.visibility_fraction(sat) == tl.visibility_fraction(sat)
        assert tld.covered_steps() == tl.covered_steps()
        for p in range(P):
            for a, b in zip(tld.node_windows(p), tl.node_windows(p)):
                np.testing.assert_array_equal(a, b)
            for a, b in zip(tld.node_cover(p), tl.node_cover(p)):
                np.testing.assert_array_equal(a, b)


def test_elevation_rate_bound_equals_reference():
    from repro.core.visibility import elevation_rate_bound_deg_s as jbound
    for key in GEOMETRIES:
        (cst, nodes), (jcst, jn) = _geometry(key), _geometry(key, jax=True)
        for n, m in zip(nodes, jn):
            assert elevation_rate_bound_deg_s(cst, n) == jbound(jcst, m)
    low = WalkerDelta(1, 1, 10e3, 50.0)
    assert elevation_rate_bound_deg_s(low, make_ps_nodes("hap")[0]) == \
        float("inf")


def test_empty_node_windows_do_not_raise():
    """C-ref 1: one satellite at 500 km and 40°, four ring HAPs, dt 30 s
    over 2 h (the example recorded in ``.hypothesis/patches/``): some
    HAPs never see the satellite.  The JAX package's sparse timeline
    raises an IndexError there; the port's plan equals its dense plan."""
    cst = WalkerDelta(1, 1, 500000.0, 40.0)
    nodes = make_ps_nodes("hapring:4")
    dur, dt = 2 * 3600.0, 30.0
    dense = ContactPlan.compile(cst, nodes, dur, dt)
    sparse = ContactPlan.compile(cst, nodes, dur, dt, visibility="sparse")
    assert any(not len(w) for w in sparse.timeline._wsat)
    assert _windows(dense) == _windows(sparse)
    assert dense.summary() == sparse.summary()
    sats = np.arange(cst.num_sats)
    for t in (0.0, 1800.0, dur - dt):
        td, pd = dense.next_contact(sats, t)
        ts, ps = sparse.next_contact(sats, t)
        np.testing.assert_array_equal(td, ts)
        np.testing.assert_array_equal(pd, ps)
        np.testing.assert_array_equal(dense.next_contact_by_node(t),
                                      sparse.next_contact_by_node(t))
    rows = np.arange(0, int(dur / dt), 17)
    np.testing.assert_array_equal(
        dense.timeline.visible_rows(rows, np.zeros_like(rows)),
        sparse.timeline.visible_rows(rows, np.zeros_like(rows)))
    with pytest.raises(IndexError):
        JPlan.compile(JWalker(1, 1, 500000.0, 40.0), jnodes("hapring:4"),
                      dur, dt, visibility="sparse").next_contact(sats, 0.0)


# ---- the runtime, sparse against dense -------------------------------------

@pytest.fixture(scope="module")
def pool200():
    """A TINY pool over 200 satellites (two images each)."""
    imgs, labs = class_conditional_images(0, 400, separation=0.8)
    return ImageClassifierPool(TINY, imgs, labs, iid_partition(labs, 200, 0),
                               local_iters=2, batch_size=8, device="cpu")


def _run(pool, evaluator, w0, scheme, visibility, cst=None, spec_kw=None,
         epochs=3, **sim_kw):
    spec = get_strategy(scheme)
    if spec_kw:
        spec = dataclasses.replace(spec, **spec_kw)
    fls = FLSimulation(spec, pool, evaluator,
                       SimConfig(duration_s=86400.0, event_driven=True,
                                 visibility=visibility, **sim_kw),
                       constellation=cst)
    rt = EventDrivenRuntime(fls)
    hist = rt.run(w0, max_epochs=epochs)
    return fls, rt, hist


@pytest.mark.parametrize("scheme,big", [
    ("asyncfleo-twohap", False), ("asyncfleo-hap", False),
    ("asyncfleo-pipelined", False), ("asyncfleo-twohap", True)])
def test_sparse_runtime_history_bit_identical(setup, pool200, scheme, big):
    *_, work = setup
    pool, cst = (pool200, WalkerDelta(**WALKER200)) if big else \
        (work.pool, None)
    runs = []
    for visibility in ("dense", "sparse"):
        fls, rt, hist = _run(pool, work.evaluator, work.w0, scheme,
                             visibility, cst=cst)
        runs.append(([vars(r) for r in hist], fls._w_flat, dict(rt.stats),
                     rt.events.counts))
    assert len(runs[0][0]) == 3 and runs[0][0] == runs[1][0]
    assert torch.equal(runs[0][1], runs[1][1])
    assert runs[0][2:] == runs[1][2:]


@pytest.mark.parametrize("n_ps", [4, 6])
def test_hapring_multi_ps_end_to_end(setup, pool200, n_ps):
    *_, work = setup
    fls, rt, hist = _run(pool200, work.evaluator, work.w0, "asyncfleo-gs",
                         "sparse", cst=WalkerDelta(**WALKER200),
                         spec_kw={"ps_scenario": f"hapring:{n_ps}"})
    assert len(fls.nodes) == n_ps
    assert all(n.kind == "hap" for n in fls.nodes)
    assert {w.node for w in fls.plan.windows()} == set(range(n_ps))
    assert len(hist) == 3 and all(r.num_models > 0 for r in hist)
    sinks = {rnd.sink for rnd in rt.rounds.values()}
    assert len(sinks) >= 2 and sinks <= set(range(n_ps))


# ---- guard rails ----------------------------------------------------------

@pytest.mark.parametrize("fault", [dict(eclipse_fraction=0.25),
                                   dict(ps_outage_fraction=0.1)])
def test_sparse_rejects_grid_mask_faults(setup, fault):
    *_, work = setup
    with pytest.raises(ValueError, match="sparse"):
        FLSimulation(get_strategy("asyncfleo-twohap"), work.pool,
                     work.evaluator,
                     SimConfig(duration_s=3600.0, visibility="sparse",
                               fault_model=FaultModel(**fault)))


def test_sparse_takes_non_mask_faults(setup):
    """Loss and compute spread touch no grid: sparse hosts them, with
    the dense run's history."""
    *_, work = setup
    fm = FaultModel(loss_prob=0.3, compute_rate_spread=1.0)
    hists = [[vars(r) for r in _run(work.pool, work.evaluator, work.w0,
                                    "asyncfleo-twohap", v,
                                    fault_model=fm)[2]]
             for v in ("dense", "sparse")]
    assert len(hists[0]) == 3 and hists[0] == hists[1]


def test_unknown_visibility_mode_rejected(setup):
    *_, work = setup
    with pytest.raises(ValueError, match="visibility"):
        FLSimulation(get_strategy("asyncfleo-twohap"), work.pool,
                     work.evaluator,
                     SimConfig(duration_s=3600.0, visibility="banana"))
    with pytest.raises(KeyError):
        ContactPlan.compile(paper_constellation(), make_ps_nodes("hap"),
                            3600.0, 30.0, visibility="banana")
