"""Port vs JAX package: one fused epoch step on identical inputs.

Both packages train the same participants from the same flat model with
the same minibatch indices (the JAX draws, fed to the port), then run
eq. 14 and the new-orbit distances.  Training compounds different f32
reduction orders over J steps, so the stack, the new model, the distances
and the losses are held at atol 1e-4.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.epoch_step import make_epoch_program as jmake
from repro.fl.client import ImageClassifierPool as JPool
from repro_torch.core.epoch_step import (carry_capacity, make_epoch_program,
                                         next_pow2)
from repro_torch.core.modelbank import FlatSpec, params_from_jax
from repro_torch.fl.client import ImageClassifierPool
from test_torch_cnn_client import TINY, _data, _w0, injected, jcfg

TOL = dict(atol=1e-4)
C = 8


@pytest.fixture(scope="module")
def programs():
    imgs, labs, shards = _data()
    kw = dict(local_iters=3, batch_size=8)
    jpool = JPool(jcfg(TINY), imgs, labs, shards, **kw)
    tpool = ImageClassifierPool(TINY, imgs, labs, shards, device="cpu",
                                batch_indices=injected(kw, shards), **kw)
    w = _w0(TINY)
    tw = params_from_jax(w, device="cpu")
    return (jmake(jpool, w), jpool, make_epoch_program(tpool, tw), tpool,
            FlatSpec.of(tw).flatten(tw).numpy())


def _inputs(layout, n):
    rng = np.random.default_rng(3)
    ids = np.arange(C, dtype=np.int32) * 5
    carry = rng.standard_normal((4, n)).astype(np.float32) * 0.1
    wv_bank = rng.uniform(0, 0.1, C).astype(np.float32)
    wv_carry = np.array([0.05, 0.0, 0.02, 0.0], np.float32)
    kpad, blocked_m = 2, 0
    if layout == "blocked":
        blocked_m = C // kpad
        dw_row = np.full(C, 1.0 / blocked_m, np.float32)
        dw_seg = np.repeat(np.arange(kpad, dtype=np.int32), blocked_m)
    elif layout == "one-hot":
        dw_seg = np.array([0, 1, 2, 0, 1, 2, 2, 0], np.int32)   # 2 = dump
        dw_row = np.where(dw_seg < kpad, 1.0 / 3.0, 0.0).astype(np.float32)
    else:                                   # no new orbit this epoch
        kpad = 0
        dw_seg = np.zeros(C, np.int32)
        dw_row = np.zeros(C, np.float32)
    dw_carry = np.zeros((kpad, 4), np.float32)
    if kpad:
        dw_carry[1, 0] = 0.25
    return ids, carry, wv_bank, wv_carry, dw_row, dw_seg, kpad, blocked_m, \
        dw_carry


@pytest.mark.parametrize("layout", ["blocked", "one-hot", "none"])
@pytest.mark.parametrize("fallback", [False, True])
def test_step_matches_jax(programs, layout, fallback):
    jprog, jpool, tprog, tpool, flat = programs
    ids, carry, wv_bank, wv_carry, dw_row, dw_seg, kpad, blocked_m, \
        dw_carry = _inputs(layout, flat.size)
    base_w = 0.4
    if fallback:            # the step runs with zero weights, base 1.0
        wv_bank, wv_carry, base_w = (np.zeros_like(wv_bank),
                                     np.zeros_like(wv_carry), 1.0)
    seed = 2001
    ref = flat * 0.5
    before = (jprog.dispatches, jprog.fallback_dispatches,
              tprog.dispatches, tprog.fallback_dispatches)
    jout = jprog.step(jnp.asarray(flat), jnp.asarray(carry),
                      jpool.epoch_inputs(ids), ids, seed, wv_bank, wv_carry,
                      base_w, dw_row, dw_seg, kpad, blocked_m, dw_carry,
                      jnp.asarray(ref), fallback=fallback)
    w_flat = torch.from_numpy(flat.copy())
    tout = tprog.step(w_flat, torch.from_numpy(carry),
                      tpool.epoch_inputs(ids), ids, seed, wv_bank, wv_carry,
                      base_w, dw_row, dw_seg, kpad, blocked_m, dw_carry,
                      torch.from_numpy(ref), fallback=fallback)
    assert tout[0].data_ptr() == w_flat.data_ptr()     # updated in place
    names = ("new_w", "stack", "dists", "losses")
    for name, a, b in zip(names, tout, jout):
        assert tuple(a.shape) == tuple(b.shape), name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **TOL)
    if fallback:
        assert torch.equal(tout[0], torch.from_numpy(flat))
    counts = (jprog.dispatches, jprog.fallback_dispatches,
              tprog.dispatches, tprog.fallback_dispatches)
    d = [a - b for a, b in zip(counts, before)]
    assert d == ([0, 1, 0, 1] if fallback else [1, 0, 1, 0])


def test_program_is_cached_per_trainer(programs):
    _, _, tprog, tpool, _ = programs
    w = params_from_jax(_w0(TINY), device="cpu")
    assert make_epoch_program(tpool, w) is tprog
    assert make_epoch_program(object(), w) is None
    with pytest.raises(NotImplementedError, match="mesh"):
        make_epoch_program(tpool, w, mesh=object())


@pytest.mark.parametrize("n", range(0, 70, 7))
def test_buckets_equal(n):
    from repro.core import epoch_step as jes
    assert next_pow2(n) == jes.next_pow2(n)
    assert carry_capacity(n) == jes.carry_capacity(n)
