"""Port vs JAX package: the strategy table, the eq. 13/14 host weight math,
and eq. 14's tensor contraction (``fed_agg`` and the stacked combiners).

The host math is numpy in both packages: exactly equal.  The contraction
is f32 on both sides with sums taken in another order: atol = rtol = 1e-5,
the tolerance of ``tests/test_kernels.py::test_fed_agg_sweep``.  The JAX
side runs its Pallas kernel in interpret mode, as its own tests do; the
port's side runs the plain version, because its tensors are on the CPU.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg
from repro.core.modelbank import FlatSpec as JFlatSpec, ModelBank as JBank
from repro.fl import strategies as jstrat
from repro.kernels.fed_agg import ops as jfed
from repro_torch.core import aggregation as tagg
from repro_torch.core.modelbank import FlatSpec, ModelBank
from repro_torch.fl import strategies as tstrat
from repro_torch.kernels.fed_agg import fed_agg
from repro_torch.kernels.fed_agg.ref import fed_agg_ref

TOL = dict(atol=1e-5, rtol=1e-5)


def test_strategy_table_equal():
    assert sorted(jstrat.STRATEGIES) == sorted(tstrat.STRATEGIES)
    for name, spec in jstrat.STRATEGIES.items():
        assert dataclasses.asdict(spec) == \
            dataclasses.asdict(tstrat.get_strategy(name))
    assert tstrat._STALENESS_FNS == tagg.STALENESS_FNS == jagg.STALENESS_FNS
    with pytest.raises(ValueError):
        tstrat.StrategySpec("x", False, True, True, "nope", "gs")


def _metas(rng, n, beta, mod):
    return [mod.SatelliteMeta(int(s), float(rng.integers(50, 150)), (0., 0.),
                              float(rng.uniform(0, 1e4)),
                              int(rng.integers(max(beta - 3, 0), beta + 1)))
            for s in rng.integers(0, 40, n)]


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("mode", ["asyncfleo", "fedavg", "per_arrival",
                                  "interval"])
def test_epoch_weight_vector_equal(seed, mode):
    rng = np.random.default_rng(seed)
    beta = int(rng.integers(0, 6))
    n = int(rng.integers(1, 12))
    jm = _metas(np.random.default_rng(seed), n, beta, jagg)
    tm = _metas(np.random.default_rng(seed), n, beta, tagg)
    assert jagg.dedup_indices(jm) == tagg.dedup_indices(tm)
    groups = {g: [i for i in range(n) if i % 3 == g] for g in range(3)}
    groups = {g: v for g, v in groups.items() if v}
    for fn in jagg.STALENESS_FNS:
        for strict in (False, True):
            jw, jb, ji = jagg.epoch_weight_vector(
                mode, jm, beta, groups, strict_paper_eq14=strict,
                staleness_fn=fn)
            tw, tb, ti = tagg.epoch_weight_vector(
                mode, tm, beta, groups, strict_paper_eq14=strict,
                staleness_fn=fn)
            assert np.array_equal(jw, tw) and jb == tb and ji == ti
    assert jagg.staleness_gamma(jm, 500.0, beta) == \
        tagg.staleness_gamma(tm, 500.0, beta)
    for fn in jagg.STALENESS_FNS:
        assert jagg.staleness_factor(fn, beta + 4, beta) == \
            tagg.staleness_factor(fn, beta + 4, beta)
    rows = [int(r) for r in rng.integers(-1, 8, n)]
    ws = rng.uniform(0, 1, n)
    assert np.array_equal(jagg.scatter_weights(rows, ws, 8),
                          tagg.scatter_weights(rows, ws, 8))


@pytest.mark.parametrize("C,N", [(2, 100), (7, 10_000), (16, 2048), (3, 5000)])
@pytest.mark.parametrize("base_weight", [0.0, 0.35])
def test_fed_agg_plain_matches_pallas(C, N, base_weight):
    rng = np.random.default_rng(C * 1000 + N)
    stack = rng.standard_normal((C, N)).astype(np.float32)
    gamma = (rng.uniform(0, 1, C) / C).astype(np.float32)
    base = rng.standard_normal(N).astype(np.float32)
    want = np.asarray(jfed.fed_agg(jnp.asarray(stack), jnp.asarray(gamma),
                                   jnp.asarray(base), base_weight))
    got = fed_agg(torch.from_numpy(stack), torch.from_numpy(gamma),
                  torch.from_numpy(base), base_weight)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # in place onto base: the carry pass's aliasing contract
    b = torch.from_numpy(base.copy())
    out = fed_agg(torch.from_numpy(stack), torch.from_numpy(gamma), b,
                  base_weight, out=b)
    assert out.data_ptr() == b.data_ptr()
    np.testing.assert_allclose(b.numpy(), want, **TOL)


@pytest.mark.parametrize("C2", [0, 1, 4])
@pytest.mark.parametrize("C,N", [(7, 10_000), (16, 2050), (1, 1001)])
def test_fed_agg_two_segments_match_two_pallas_passes(C, N, C2):
    """Bank and carry in one call against the JAX package's epoch step: a
    bank pass folding in the base, then a carry pass onto its output."""
    rng = np.random.default_rng(C * 100 + C2)
    stack = rng.standard_normal((C, N)).astype(np.float32)
    gamma = (rng.uniform(0, 1, C) / C).astype(np.float32)
    stack2 = rng.standard_normal((C2, N)).astype(np.float32)
    gamma2 = (rng.uniform(0, 1, C2) / 4).astype(np.float32)
    base = rng.standard_normal(N).astype(np.float32)
    want = jfed.fed_agg(jnp.asarray(stack), jnp.asarray(gamma),
                        jnp.asarray(base), 0.35)
    if C2:
        want = jfed.fed_agg(jnp.asarray(stack2), jnp.asarray(gamma2), want,
                            1.0)
    want = np.asarray(want)
    seg2 = dict(stack2=torch.from_numpy(stack2),
                gamma2=torch.from_numpy(gamma2))
    got = fed_agg(torch.from_numpy(stack), torch.from_numpy(gamma),
                  torch.from_numpy(base), 0.35, **seg2)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # in place onto base, as the epoch step calls it
    b = torch.from_numpy(base.copy())
    out = fed_agg(torch.from_numpy(stack), torch.from_numpy(gamma), b, 0.35,
                  out=b, **seg2)
    assert out.data_ptr() == b.data_ptr()
    np.testing.assert_allclose(b.numpy(), want, **TOL)


def test_fed_agg_second_segment_checks():
    rng = np.random.default_rng(1)
    stack = torch.from_numpy(rng.standard_normal((3, 1001)).astype(np.float32))
    g = torch.tensor([0.2, 0.3, 0.5])
    carry = torch.from_numpy(rng.standard_normal((4, 1001)).astype(np.float32))
    g2 = torch.full((4,), 0.1)
    with pytest.raises(ValueError):
        fed_agg(stack, g, out=carry[1], stack2=carry, gamma2=g2)  # overlaps
    with pytest.raises(ValueError):
        fed_agg(stack, g, out=g2.new_zeros(1001), stack2=carry,
                gamma2=g2[:3])                                  # wrong C2
    with pytest.raises(ValueError):
        fed_agg(stack, g, stack2=carry)                         # no gamma2
    with pytest.raises(ValueError):
        fed_agg(stack, g, stack2=carry[:, :1000].contiguous(), gamma2=g2)
    with pytest.raises(ValueError):
        fed_agg(stack, g, stack2=carry[:, ::2], gamma2=g2)      # strided
    two = fed_agg(stack, g, stack2=carry, gamma2=g2)
    assert torch.allclose(two, g @ stack + g2 @ carry, atol=1e-6)


def test_fed_agg_edge_cases_and_checks():
    rng = np.random.default_rng(0)
    base = torch.from_numpy(rng.standard_normal(1001).astype(np.float32))
    empty = torch.zeros((0, 1001))
    # C = 0 gives bw * base (exact: one multiply)
    assert torch.equal(fed_agg(empty, torch.zeros(0), base, 0.35),
                       0.35 * base)
    stack = torch.from_numpy(rng.standard_normal((3, 1001)).astype(np.float32))
    g = torch.tensor([0.2, 0.3, 0.5])
    assert torch.equal(fed_agg(stack, g), fed_agg_ref(stack, g, None, 0.0))
    with pytest.raises(ValueError):
        fed_agg(stack, torch.zeros(2))                    # wrong C
    with pytest.raises(ValueError):
        fed_agg(stack.double(), g.double())               # not f32
    with pytest.raises(ValueError):
        fed_agg(stack[:, ::2], g)                         # not contiguous
    with pytest.raises(ValueError):
        fed_agg(stack, g, out=stack[0])                   # out overlaps stack
    with pytest.raises(ValueError):
        fed_agg(stack, g, base, 1.0, out=torch.zeros(1000))


def _bank_pair(rng, C, shapes):
    rows = rng.standard_normal((C, sum(int(np.prod(s)) for s in shapes.values())
                                )).astype(np.float32)
    model = {k: np.zeros(s, np.float32) for k, s in shapes.items()}
    jbank = JBank(JFlatSpec.of(model), jnp.asarray(rows))
    tbank = ModelBank(FlatSpec.of({k: torch.from_numpy(v)
                                   for k, v in model.items()}),
                      torch.from_numpy(rows))
    return jbank, tbank


@pytest.mark.parametrize("live", [1, 2, 3])
@pytest.mark.parametrize("base_weight", [0.0, 0.6])
def test_combine_stacked_terms_equal(live, base_weight):
    """One, two (one fed_agg call) and three live terms (a second call
    onto the first's output) against the JAX package's combiner."""
    rng = np.random.default_rng(live)
    n = 2050
    stacks = [rng.standard_normal((c, n)).astype(np.float32)
              for c in (6, 4, 3)[:live]]
    ws = [rng.uniform(0, 1, s.shape[0]).astype(np.float32) / 8
          for s in stacks]
    base = rng.standard_normal(n).astype(np.float32)
    want = jagg.combine_stacked(
        [(jnp.asarray(s), w) for s, w in zip(stacks, ws)],
        jnp.asarray(base), base_weight)
    got = tagg.combine_stacked(
        [(torch.from_numpy(s), w) for s, w in zip(stacks, ws)],
        torch.from_numpy(base), base_weight)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("base_weight", [0.0, 0.6])
def test_weighted_sum_and_combine_stacked_equal(base_weight):
    rng = np.random.default_rng(7)
    shapes = {"w": (30, 20), "b": (20,), "a": (7,)}
    jbank, tbank = _bank_pair(rng, 6, shapes)
    w = rng.uniform(0, 1, 6).astype(np.float32)
    base = rng.standard_normal(tbank.num_params).astype(np.float32)
    want = np.asarray(jagg.weighted_sum_stacked(jbank, w, jnp.asarray(base),
                                                base_weight))
    got = tagg.weighted_sum_stacked(tbank, w, torch.from_numpy(base),
                                    base_weight)
    np.testing.assert_allclose(got.numpy(), want, **TOL)

    carry = rng.standard_normal((4, tbank.num_params)).astype(np.float32)
    wc = np.array([0.0, 0.3, 0.0, 0.1], np.float32)
    for terms_w in ([w, wc], [np.zeros(6, np.float32), wc],
                    [np.zeros(6, np.float32), np.zeros(4, np.float32)]):
        want = jagg.combine_stacked(
            [(jbank.stack, terms_w[0]), (jnp.asarray(carry), terms_w[1])],
            jnp.asarray(base), base_weight)
        got = tagg.combine_stacked(
            [(tbank.stack, terms_w[0]), (torch.from_numpy(carry), terms_w[1])],
            torch.from_numpy(base), base_weight)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert tagg.combine_stacked([(None, w)], None, 0.0) is None
