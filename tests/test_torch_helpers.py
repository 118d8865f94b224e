"""Port vs JAX package: the public helpers beside the kernels and the bank.

``pairwise_dist`` and ``model_pairwise_dist`` against the JAX package's
(its Pallas kernel in interpret mode), ``fed_agg_flat_ref`` against its
oracle, and the kernel wrappers' stacks that are not contiguous float32
(bf16 rows, transposed views), which they cast once as the reference
casts; ``ChannelPool.intervals`` after a snapshot and restore, as
``tests/test_contention.py`` checks the reference's;
``ModelConfig.active_param_count`` on all ten archs; ``FlatSpec.
unflatten_host`` and ``ModelBank.row``/``pytree``, as
``tests/test_modelbank.py`` checks the reference's; and
``core.epoch_step.bank_sharding``.  Tolerances: the distances differ
only in the order of f32 sums (1e-5 of the largest squared distance, as
``tests/test_kernels.py``); the rest is exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.core import epoch_step as jes
from repro.core import modelbank as jmb
from repro.kernels.fed_agg.ref import fed_agg_flat_ref as jfed_ref
from repro.kernels.pairwise_dist import ops as jpd
from repro.sched import contacts as jcon
from repro_torch.configs import ARCHS
from repro_torch.core import epoch_step as tes
from repro_torch.core import modelbank as tmb
from repro_torch.kernels.fed_agg import fed_agg
from repro_torch.kernels.fed_agg.ref import fed_agg_flat_ref, fed_agg_ref
from repro_torch.kernels.pairwise_dist import (model_pairwise_dist,
                                               pairwise_dist,
                                               pairwise_dist_sq)
from repro_torch.launch import sharding as tsharding
from repro_torch.sched import contacts as tcon


def _models(vals):
    """tests/test_modelbank.py's models: keys out of sorted order, one
    nested dict."""
    rng = np.random.default_rng(0)
    return [{"w": np.full((3, 4), v, np.float32),
             "b": np.full((5,), -v, np.float32),
             "nested": {"k": (v * rng.standard_normal(7))
                        .astype(np.float32)}} for v in vals]


def _torch_tree(m):
    return {k: _torch_tree(v) if isinstance(v, dict) else torch.tensor(v)
            for k, v in m.items()}


def _leaves_equal(got, want):
    ga, wa = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(ga) == len(wa)
    for a, b in zip(ga, wa):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("squared", [False, True])
@pytest.mark.parametrize("M,N", [(2, 1001), (9, 300), (66, 40)])
def test_pairwise_dist_matches_jax(M, N, squared):
    x = np.random.default_rng(M).standard_normal((M, N)).astype(np.float32)
    want = np.asarray(jpd.pairwise_dist(jnp.asarray(x), squared=squared,
                                        interpret=True))
    got = pairwise_dist(torch.from_numpy(x), squared=squared).numpy()
    scale = max(float((want ** (1 if squared else 2)).max()), 1.0)
    if squared:
        np.testing.assert_allclose(got / scale, want / scale, atol=1e-5)
    else:
        np.testing.assert_allclose(got ** 2 / scale, want ** 2 / scale,
                                   atol=1e-5)


def test_model_pairwise_dist_matches_jax():
    """The reference's leaf order (sorted keys at every level) and its
    sqrt(6), sqrt(54) example."""
    models = _models([0.0, 1.0, 2.5, -1.0])
    want = np.asarray(jpd.model_pairwise_dist(models, interpret=True))
    got = model_pairwise_dist([_torch_tree(m) for m in models]).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    small = [{"w": torch.full((3, 2), float(v))} for v in (0, 1, 3)]
    d = model_pairwise_dist(small).numpy()
    np.testing.assert_allclose(d[0, 1], np.sqrt(6.0), rtol=1e-5)
    np.testing.assert_allclose(d[0, 2], np.sqrt(54.0), rtol=1e-5)


@pytest.mark.parametrize("stack_dtype", ["float32", "bfloat16"])
def test_fed_agg_flat_ref_matches_jax(stack_dtype):
    rng = np.random.default_rng(7)
    stack = rng.standard_normal((5, 1001)).astype(np.float32)
    gamma = rng.uniform(size=5).astype(np.float32) / 5
    base = rng.standard_normal(1001).astype(np.float32)
    js = jnp.asarray(stack).astype(getattr(jnp, stack_dtype))
    ts = torch.from_numpy(stack).to(getattr(torch, stack_dtype))
    want = np.asarray(jfed_ref(js, jnp.asarray(gamma), jnp.asarray(base),
                               0.35))
    got = fed_agg_flat_ref(ts, torch.from_numpy(gamma),
                           torch.from_numpy(base), 0.35)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("form", ["bfloat16", "transposed"])
def test_wrappers_cast_stacks_as_the_reference_does(form):
    """fed_agg and pairwise_dist_sq on a bf16 stack and on a transposed
    view: the reference's function of the stack cast to float32."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((6, 513)).astype(np.float32)
    if form == "bfloat16":
        t = torch.from_numpy(x).bfloat16()
        jx = jnp.asarray(x).astype(jnp.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(x.T)).T
        jx = jnp.asarray(x)
    assert t.dtype != torch.float32 or not t.is_contiguous()
    gamma = rng.uniform(size=6).astype(np.float32) / 6
    base = rng.standard_normal(513).astype(np.float32)
    want = np.asarray(jfed_ref(jx, jnp.asarray(gamma), jnp.asarray(base),
                               0.5))
    got = fed_agg(t, torch.from_numpy(gamma), torch.from_numpy(base), 0.5)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    assert torch.equal(got, fed_agg_ref(t.float().contiguous(),
                                        torch.from_numpy(gamma),
                                        torch.from_numpy(base), 0.5))
    want_d = np.asarray(jpd.pairwise_dist(jx.astype(jnp.float32),
                                          squared=True, interpret=True))
    got_d = pairwise_dist_sq(t).numpy()
    scale = max(float(want_d.max()), 1.0)
    np.testing.assert_allclose(got_d / scale, want_d / scale, atol=1e-5)


def test_channel_pool_intervals_after_restore():
    """tests/test_contention.py's mid-batch rollback: after the restore,
    one reservation on PS 0's rx pool and none on its tx pool, as the
    reference's; the port's exporter reads the same list."""
    pools = []
    for mod in (jcon, tcon):
        c = mod.ContentionModel(2, 1)
        assert c.grant_rx(0, 0.0, 10.0) == 0.0
        snap = c.snapshot()
        assert c.grant_rx(0, 5.0, 10.0) == 10.0
        assert c.grant_tx(1, 0.0, 10.0) == 0.0
        assert c.grant_rx(0, 12.0, 10.0) == 20.0
        assert c.grant_tx(0, 3.0, 10.0) == 3.0
        c.restore(snap)
        assert c.grant_rx(0, 5.0, 10.0) == 10.0
        assert c.grant_tx(0, 3.0, 10.0) == 3.0
        pools.append([pool.intervals(ps) for pool in (c.tx, c.rx)
                      for ps in range(2)])
        c.restore(snap)
        assert c.rx.intervals(0) == [(0, 0.0, 10.0)]
        assert c.tx.intervals(0) == []
    assert pools[0] == pools[1]
    # rx at PS 0: the kept grant and the re-grant behind it, merged
    assert pools[1][2] == [(0, 0.0, 20.0)]


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_active_param_count_matches_jax(arch):
    got = ARCHS[arch].active_param_count()
    assert got == JARCHS[arch].active_param_count()
    assert got <= ARCHS[arch].param_count()
    assert (got < ARCHS[arch].param_count()) == ARCHS[arch].is_moe


def test_flatspec_unflatten_host_matches_jax():
    """tests/test_modelbank.py's roundtrip: host numpy leaves, equal to
    the model and to the reference's ``unflatten_host``."""
    m = _models([1.5])[0]
    tm = _torch_tree(m)
    spec = tmb.FlatSpec.of(tm)
    flat = spec.flatten(tm)
    host = spec.unflatten_host(flat)
    assert all(isinstance(leaf, np.ndarray)
               for leaf in jax.tree_util.tree_leaves(host))
    _leaves_equal(host, m)
    jspec = jmb.FlatSpec.of(m)
    _leaves_equal(host, jspec.unflatten_host(jspec.flatten(m)))
    _leaves_equal(spec.unflatten_host(flat.numpy()), m)


def test_modelbank_row_and_pytree_match_jax():
    """tests/test_modelbank.py's select: a sub-bank's rows and trees are
    the selected models', as the reference's bank gives them."""
    models = _models([0.0, 1.0, 2.0, 3.0])
    bank = tmb.ModelBank.from_pytrees([_torch_tree(m) for m in models])
    jbank = jmb.ModelBank.from_pytrees(models)
    sub, jsub = bank.select([3, 1]), jbank.select([3, 1])
    for i, want in enumerate((models[3], models[1])):
        _leaves_equal(sub.pytree(i), want)
        np.testing.assert_array_equal(sub.row(i).numpy(),
                                      np.asarray(jsub.row(i)))
    # views of the bank's row, no copy
    assert sub.row(0).data_ptr() == sub.stack.data_ptr()
    assert (sub.pytree(1)["w"].untyped_storage().data_ptr()
            == sub.stack.untyped_storage().data_ptr())


def test_bank_sharding_delegates_to_launch_sharding():
    """The (C, N) bank: participants over "data", parameters replicated,
    as the reference's ``bank_sharding``."""
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))
    want = tuple(jes.bank_sharding(mesh).spec)
    got = tes.bank_sharding(None)
    assert got == tsharding.bank_sharding(None)
    assert tuple(got) == want == ("data", None)
