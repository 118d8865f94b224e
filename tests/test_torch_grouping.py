"""Port vs JAX package: divergence grouping (paper §IV-C1, Fig. 5) and the
pairwise_dist kernel's plain version.

Group assignment is host numpy over distances; the fixtures place each
orbit's models at a clearly different distance from w0, so no two gaps
between sorted distances are near a tie and the groups must be equal.
Distances are f32 on both sides: rtol 1e-5.  ``pairwise_dist_sq`` uses the
Gram formulation, which loses digits when rows are close, so it is held
as ``tests/test_kernels.py::test_pairwise_dist_sweep`` holds the Pallas
kernel: divided by max(D, 1), atol 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import grouping as jgrp
from repro.core.modelbank import FlatSpec as JFlatSpec, ModelBank as JBank
from repro.kernels.pairwise_dist import ops as jpd
from repro.kernels.pairwise_dist.ref import pairwise_dist_sq_ref as jref
from repro_torch.core import grouping as tgrp
from repro_torch.core.modelbank import FlatSpec, ModelBank
from repro_torch.kernels.pairwise_dist import dist_to_ref, pairwise_dist_sq

N_PARAMS = 3000
SCALES = (0.2, 0.9, 1.6, 3.0, 5.5)      # per-orbit spread around w0


def _model(flat):
    return {"w": flat[:2000].reshape(40, 50), "b": flat[2000:]}


def _orbit_rows(seed, orbit, m):
    rng = np.random.default_rng(seed * 100 + orbit)
    return (SCALES[orbit] * rng.standard_normal((m, N_PARAMS)) / 30.0
            ).astype(np.float32)


@pytest.fixture
def w0():
    return np.random.default_rng(0).standard_normal(N_PARAMS).astype(
        np.float32)


def _states(w0, use_dist_kernel=False):
    js = jgrp.GroupingState(num_groups=3, use_dist_kernel=use_dist_kernel)
    js.set_reference(_model(jnp.asarray(w0)))
    ts = tgrp.GroupingState(num_groups=3, use_dist_kernel=use_dist_kernel)
    ts.set_reference(_model(torch.from_numpy(w0)))
    return js, ts


def _banks(rows):
    jspec = JFlatSpec.of(_model(np.zeros(N_PARAMS, np.float32)))
    tspec = FlatSpec.of(_model(torch.zeros(N_PARAMS)))
    return (JBank(jspec, jnp.asarray(rows)),
            ModelBank(tspec, torch.from_numpy(rows)))


@pytest.mark.parametrize("seed", range(8))
def test_group_by_gaps_equal(seed):
    rng = np.random.default_rng(seed)
    d = {int(o): float(v) for o, v in enumerate(rng.uniform(0, 10, 7))}
    for k in (1, 2, 3, 5, 9):
        assert jgrp.group_by_gaps(d, k) == tgrp.group_by_gaps(d, k)


@pytest.mark.parametrize("use_dist_kernel", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_observe_orbit_both_routes_equal(w0, use_dist_kernel, seed):
    js, ts = _states(w0, use_dist_kernel)
    for orbit in (3, 0, 4, 1, 2):          # arrival order != orbit order
        rows = w0[None] + _orbit_rows(seed, orbit, 8)
        sizes = list(np.random.default_rng(orbit).integers(50, 150, 8))
        jb, tb = _banks(rows)
        assert js.observe_orbit(orbit, jb, sizes) == \
            ts.observe_orbit(orbit, tb, sizes)
        # a known orbit keeps its group without a new distance
        assert js.observe_orbit(orbit, jb, sizes) == \
            ts.observe_orbit(orbit, tb, sizes)
    assert js.groups == ts.groups and len(ts.groups) == 3
    assert js.distances.keys() == ts.distances.keys()
    for o in js.distances:
        np.testing.assert_allclose(ts.distances[o], js.distances[o],
                                   rtol=1e-5)


def test_observe_orbits_multi_and_assign_distances_equal(w0):
    js, ts = _states(w0)
    m = 4
    rows = np.concatenate([w0[None] + _orbit_rows(5, o, m) for o in range(5)])
    # models of orbits 0..3 in the epoch bank, orbit 4's in a carry matrix
    bank_rows = list(range(4 * m)) + [-1] * m
    carry_rows = [-1] * (4 * m) + list(range(m))
    orbit_indices = {o: list(range(o * m, (o + 1) * m)) for o in range(5)}
    sizes = [float(s) for s in np.random.default_rng(1).integers(50, 150,
                                                                  5 * m)]
    jb, tb = _banks(rows[:4 * m])
    jc, tc = _banks(rows[4 * m:])
    got = ts.observe_orbits_multi(orbit_indices,
                                  [(tb.stack, bank_rows),
                                   (tc.stack, carry_rows)], sizes)
    want = js.observe_orbits_multi(orbit_indices,
                                   [(jb.stack, bank_rows),
                                    (jc.stack, carry_rows)], sizes)
    assert got == want and js.groups == ts.groups
    for o in js.distances:
        np.testing.assert_allclose(ts.distances[o], js.distances[o],
                                   rtol=1e-5)
    # later orbits join the nearest established group, distances from
    # outside (the fused epoch step's output)
    ds = np.array([js.distances[1] + 0.01, js.distances[4] - 0.02])
    assert js.assign_distances([7, 8], ds) == ts.assign_distances([7, 8], ds)
    assert js.groups == ts.groups


def test_segment_inputs_equal():
    orbit_indices = {0: [0, 1, 2], 3: [3, 4], 2: [5]}
    rows = [0, 1, -1, 2, 3, -1]
    sizes = [10.0, 20.0, 30.0, 40.0, 50.0, 60.0]
    totals = {o: float(sum(sizes[j] for j in orbit_indices[o]))
              for o in orbit_indices}
    new = [3, 0]
    for a, b in zip(jgrp.segment_partial_inputs(new, orbit_indices, rows,
                                                sizes, totals, 8, 2),
                    tgrp.segment_partial_inputs(new, orbit_indices, rows,
                                                sizes, totals, 8, 2)):
        assert np.array_equal(a, b)
    assert np.array_equal(
        jgrp.segment_weight_matrix(new, orbit_indices, rows, sizes, totals, 4),
        tgrp.segment_weight_matrix(new, orbit_indices, rows, sizes, totals, 4))


@pytest.mark.parametrize("M,N", [(2, 50), (5, 9000), (8, 4096), (3, 4097),
                                 (66, 300), (130, 4097)])
def test_pairwise_dist_plain_matches_pallas(M, N):
    x = np.random.default_rng(N).standard_normal((M, N)).astype(np.float32)
    want = np.asarray(jpd.pairwise_dist(jnp.asarray(x), squared=True))
    exact = np.asarray(jref(jnp.asarray(x)))
    got = pairwise_dist_sq(torch.from_numpy(x)).numpy()
    scale = max(float(exact.max()), 1.0)
    np.testing.assert_allclose(got / scale, want / scale, atol=1e-5)
    np.testing.assert_allclose(got / scale, exact / scale, atol=1e-5)
    np.testing.assert_allclose(got, got.T, atol=1e-3)


@pytest.mark.parametrize("M", [1, 9, 64, 70])
def test_dist_to_ref_equal(M):
    rng = np.random.default_rng(M)
    ref = rng.standard_normal(4097).astype(np.float32)
    stack = (ref[None] + rng.standard_normal((M, 4097))).astype(np.float32)
    want = np.asarray(jpd.dist_to_ref(jnp.asarray(stack), jnp.asarray(ref)))
    got = dist_to_ref(torch.from_numpy(stack), torch.from_numpy(ref)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("M", [0, 1, 8, 65])
def test_pairwise_dist_leading_row_matches_pallas(M):
    """``ref`` as row 0 beside the stack: the JAX package's kernel over the
    concatenation (what ``dist_to_ref`` runs there)."""
    rng = np.random.default_rng(100 + M)
    ref = rng.standard_normal(1000).astype(np.float32)
    x = (ref[None] + rng.standard_normal((M, 1000))).astype(np.float32)
    cat = np.concatenate([ref[None], x])
    want = np.asarray(jpd.pairwise_dist(jnp.asarray(cat), squared=True))
    got = pairwise_dist_sq(torch.from_numpy(x),
                           ref=torch.from_numpy(ref)).numpy()
    assert got.shape == (M + 1, M + 1)
    scale = max(float(want.max()), 1.0)
    np.testing.assert_allclose(got / scale, want / scale, atol=1e-5)


def test_pairwise_dist_checks():
    # 66 rows: above the largest stack dist_to_ref gives the kernel, and
    # taken like any other M (the JAX package's kernel takes any M)
    x = np.random.default_rng(66).standard_normal((66, 10)).astype(np.float32)
    want = np.asarray(jpd.pairwise_dist(jnp.asarray(x), squared=True))
    got = pairwise_dist_sq(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got / max(float(want.max()), 1.0),
                               want / max(float(want.max()), 1.0), atol=1e-5)
    # rows that are not contiguous f32 are cast once, as the reference
    # casts its stacks: the result is that of the cast rows
    xt = torch.from_numpy(x[:3])
    assert torch.equal(pairwise_dist_sq(xt.double()), pairwise_dist_sq(xt))
    assert torch.equal(pairwise_dist_sq(xt[:, ::2]),
                       pairwise_dist_sq(xt[:, ::2].contiguous()))
    with pytest.raises(ValueError):
        pairwise_dist_sq(torch.zeros((3, 10), dtype=torch.int32))
    with pytest.raises(ValueError):
        pairwise_dist_sq(torch.zeros((0, 10)))            # no rows
    with pytest.raises(ValueError):
        pairwise_dist_sq(torch.zeros((3, 10)), ref=torch.zeros(9))
    assert torch.equal(pairwise_dist_sq(xt, ref=xt[0].double()),
                       pairwise_dist_sq(xt, ref=xt[0]))
