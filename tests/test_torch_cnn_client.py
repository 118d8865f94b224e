"""Port vs JAX package: the paper's CNN/MLP, one SGD step, and a J-step
client-pool training.

The forward pass is the same f32 arithmetic in another order (im2col
matmuls, a log-sum-exp): atol 1e-5.  The pool training is held with the
JAX package's own minibatch indices fed to the port (the two random
streams differ by design: threefry against torch.Generator).  Over J SGD
steps the different reduction orders of the two frameworks' matmuls and
gradient sums compound, so the trained stacks and losses are held at
atol 1e-4.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper_models import SmallNetConfig as JSmallNetConfig
from repro.data import class_conditional_images, iid_partition
from repro.fl.client import (Evaluator as JEvaluator,
                             ImageClassifierPool as JPool)
from repro.models import cnn as jcnn
from repro.optim import apply_updates as japply, sgd as jsgd
from repro_torch.configs.paper_models import SmallNetConfig
from repro_torch.core.modelbank import FlatSpec, params_from_jax
from repro_torch.fl.client import Evaluator, ImageClassifierPool
from repro_torch.models import cnn as tcnn
from repro_torch.optim import apply_updates, sgd

TINY = SmallNetConfig("tiny", "cnn", 28, 1, hidden=16, conv_channels=(4, 8))
MLP = SmallNetConfig("tiny-mlp", "mlp", 28, 1, hidden=24)


def jcfg(cfg):
    return JSmallNetConfig(**dataclasses.asdict(cfg))


def jax_batch_indices(local_iters, batch_size):
    """The minibatch indices the JAX pool draws inside its fused program:
    PRNGKey(seed * 9973 + id) in uint32 arithmetic, split into J keys, one
    ``randint(0, n)`` of ``batch_size`` per step (``repro/fl/client.py``).
    Returns a ``batch_indices`` function for the port's pool."""
    @functools.partial(jax.jit, static_argnums=1)
    def draw(seeds, n):
        def one(s):
            keys = jax.random.split(jax.random.PRNGKey(s), local_iters)
            return jax.vmap(
                lambda k: jax.random.randint(k, (batch_size,), 0, n))(keys)
        return jax.vmap(one)(seeds)

    def fn(seed, ids, n):
        seeds = np.array([(int(seed) * 9973 + int(s)) & 0xFFFFFFFF
                          for s in ids], np.uint32)
        return torch.from_numpy(np.asarray(draw(seeds, n)).astype(np.int64))
    return fn


def injected(pool_kwargs, shards):
    """``batch_indices`` for a port pool built on the same shards as a JAX
    pool: the JAX draws over the equalized shard length."""
    n = min(len(s) for s in shards)
    fn = jax_batch_indices(pool_kwargs["local_iters"],
                           pool_kwargs["batch_size"])
    return lambda seed, ids: fn(seed, ids, n)


def _data(num=400, sats=40):
    imgs, labs = class_conditional_images(0, num, separation=0.8)
    return imgs, labs, iid_partition(labs, sats, 0)


def _w0(cfg, seed=0):
    return jax.device_get(jcnn.init_params(jax.random.PRNGKey(seed),
                                           jcfg(cfg)))


@pytest.mark.parametrize("cfg", [TINY, MLP])
def test_apply_loss_accuracy_equal(cfg):
    imgs, labs, _ = _data(num=48)
    ws = [_w0(cfg, s) for s in range(3)]
    stacked = {k: torch.from_numpy(np.stack([w[k] for w in ws]))
               for k in ws[0]}
    x = torch.from_numpy(imgs.reshape(3, 16, 28, 28, 1))
    y = torch.from_numpy(labs.reshape(3, 16).astype(np.int64))
    logits = tcnn.apply(stacked, cfg, x)
    loss = tcnn.loss_fn(stacked, cfg, x, y)
    acc = tcnn.accuracy(stacked, cfg, x, y)
    for c, w in enumerate(ws):
        xi, yi = imgs[16 * c:16 * (c + 1)], labs[16 * c:16 * (c + 1)]
        np.testing.assert_allclose(
            logits[c].numpy(), np.asarray(jcnn.apply(w, jcfg(cfg), xi)),
            atol=1e-5)
        np.testing.assert_allclose(
            float(loss[c]), float(jcnn.loss_fn(w, jcfg(cfg), xi, yi)),
            atol=1e-5)
        assert float(acc[c]) == pytest.approx(
            float(jcnn.accuracy(w, jcfg(cfg), xi, yi)), abs=1e-6)


def test_one_sgd_step_equal():
    imgs, labs, _ = _data(num=32)
    w = _w0(TINY)
    loss, g = jax.value_and_grad(jcnn.loss_fn)(w, jcfg(TINY), imgs, labs)
    opt = jsgd(0.01)
    upd, _ = opt.update(g, opt.init(w), w)
    want = jax.device_get(japply(w, upd))

    p = {k: torch.from_numpy(v[None].copy()).requires_grad_(True)
         for k, v in w.items()}
    tloss = tcnn.loss_fn(p, TINY, torch.from_numpy(imgs[None]),
                         torch.from_numpy(labs[None].astype(np.int64)))
    keys = sorted(p)
    grads = torch.autograd.grad(tloss.sum(), [p[k] for k in keys])
    topt = sgd(0.01)
    with torch.no_grad():
        tupd, _ = topt.update(dict(zip(keys, grads)), topt.init(p), p)
        got = apply_updates(p, tupd)
    assert float(tloss.detach()[0]) == pytest.approx(float(loss), abs=1e-5)
    for k in w:
        np.testing.assert_allclose(got[k][0].numpy(), want[k], atol=1e-6)


def test_momentum_state_matches():
    g = {"a": torch.tensor([1.0, -2.0])}
    opt = sgd(0.1, momentum=0.9)
    s = opt.init(g)
    u1, s = opt.update(g, s)
    u2, s = opt.update(g, s)
    jopt = jsgd(0.1, momentum=0.9)
    js = jopt.init({"a": jnp.zeros(2)})
    ju1, js = jopt.update({"a": jnp.array([1.0, -2.0])}, js)
    ju2, js = jopt.update({"a": jnp.array([1.0, -2.0])}, js)
    np.testing.assert_allclose(u2["a"].numpy(), np.asarray(ju2["a"]),
                               atol=1e-7)


def test_pool_training_matches_jax_with_its_indices():
    imgs, labs, shards = _data()
    kw = dict(local_iters=4, batch_size=8)
    jpool = JPool(jcfg(TINY), imgs, labs, shards, **kw)
    tpool = ImageClassifierPool(TINY, imgs, labs, shards, device="cpu",
                                batch_indices=injected(kw, shards),
                                **kw)
    w = _w0(TINY)
    ids = np.array([3, 17, 29, 3], np.int32)        # padded, as the loop does
    seed = 1002
    jstack, jloss = jax.jit(jpool.epoch_train_fn())(
        w, jpool.epoch_inputs(ids), jnp.asarray(ids), np.uint32(seed))
    tstack, tloss = tpool.epoch_train_fn()(
        params_from_jax(w, device="cpu"), tpool.epoch_inputs(ids), ids, seed)
    for k in w:
        np.testing.assert_allclose(tstack[k].numpy(),
                                   np.asarray(jstack[k]), atol=1e-4)
    np.testing.assert_allclose(tloss.numpy(), np.asarray(jloss), atol=1e-4)
    # the padded duplicate trains identically to its original row
    for k in w:
        assert torch.equal(tstack[k][0], tstack[k][3])
    assert tpool.data_size(3) == jpool.data_size(3)


def test_pool_default_indices_are_seeded_per_sat():
    imgs, labs, shards = _data()
    pool = ImageClassifierPool(TINY, imgs, labs, shards, local_iters=3,
                               batch_size=5, device="cpu")
    a = pool.minibatch_indices(7, np.array([1, 2, 1]), 10)
    b = pool.minibatch_indices(7, np.array([1, 2, 1]), 10)
    assert a.shape == (3, 3, 5) and a.dtype == torch.int64
    assert torch.equal(a, b) and torch.equal(a[0], a[2])
    assert not torch.equal(a[0], a[1])
    assert int(a.min()) >= 0 and int(a.max()) < 10


def test_evaluator_matches_jax():
    ti, tl = class_conditional_images(99, 64, separation=0.8)
    w = _w0(TINY)
    got = Evaluator(TINY, ti, tl, device="cpu")(params_from_jax(w,
                                                                device="cpu"))
    want = JEvaluator(jcfg(TINY), ti, tl)(w)
    assert abs(got - want) <= 1.0 / 64          # within one test sample
    flat = FlatSpec.of(params_from_jax(w, device="cpu"))
    assert flat.num_params == sum(v.size for v in w.values())


def test_init_params_shapes_and_device():
    w = tcnn.init_params(0, TINY, device="cpu")
    jw = _w0(TINY)
    assert {k: tuple(v.shape) for k, v in w.items()} == \
        {k: v.shape for k, v in jw.items()}
    assert float(w["conv1"].abs().max()) <= 2.0 / 3.0 + 1e-6   # ±2 std, fan 9
    assert torch.equal(w["w1"], tcnn.init_params(0, TINY, device="cpu")["w1"])
