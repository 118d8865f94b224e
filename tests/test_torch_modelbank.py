"""Port vs JAX package: the flat (C, N) model-bank layout.

Flattening and unflattening only move float32 values, so every comparison
is exact: a port bank must equal the JAX bank row for row.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper_models import SmallNetConfig as JSmallNetConfig
from repro.core import modelbank as jmb
from repro.models import cnn as jcnn
from repro_torch.configs.paper_models import MNIST_CNN, SmallNetConfig
from repro_torch.core import modelbank as tmb

CNN_LEAF_ORDER = ("b1", "b2", "bc1", "bc2", "conv1", "conv2", "w1", "w2")
TINY = SmallNetConfig("tiny", "cnn", 28, 1, hidden=16, conv_channels=(4, 8))


def _jax_params(cfg, seed=0):
    jcfg = JSmallNetConfig(**dataclasses.asdict(cfg))
    return jax.device_get(jcnn.init_params(jax.random.PRNGKey(seed), jcfg))


@pytest.mark.parametrize("cfg", [MNIST_CNN, TINY])
def test_params_round_trip_and_leaf_order(cfg):
    w = _jax_params(cfg)
    tw = tmb.params_from_jax(w, device="cpu")
    back = tmb.params_to_jax(tw)
    assert back.keys() == w.keys()
    for k in w:
        assert back[k].dtype == np.float32 and np.array_equal(back[k], w[k])
        assert tuple(tw[k].shape) == w[k].shape
    spec, jspec = tmb.FlatSpec.of(tw), jmb.FlatSpec.of(w)
    assert spec.keys == CNN_LEAF_ORDER
    assert spec.shapes == jspec.shapes and spec.sizes == jspec.sizes
    if cfg is MNIST_CNN:
        assert spec.num_params == 206_922


def test_flatten_unflatten_row_for_row():
    w = _jax_params(TINY)
    tw = tmb.params_from_jax(w, device="cpu")
    spec, jspec = tmb.FlatSpec.of(tw), jmb.FlatSpec.of(w)
    flat = spec.flatten(tw)
    assert np.array_equal(flat.numpy(), np.asarray(jspec.flatten(w)))
    views = spec.unflatten(flat)
    for k in w:
        assert np.array_equal(views[k].numpy(), w[k])
    views["b1"][0] = 7.0                      # views share flat's storage
    assert flat[0] == 7.0
    # a stacked (C, ...) dict flattens to the JAX bank's rows
    rng = np.random.default_rng(0)
    stacked = {k: rng.standard_normal((5,) + v.shape).astype(np.float32)
               for k, v in w.items()}
    want = np.asarray(jspec.flatten_stacked(
        {k: jnp.asarray(v) for k, v in stacked.items()}))
    bank = tmb.ModelBank.from_stacked_tree(
        {k: torch.from_numpy(v) for k, v in stacked.items()})
    assert np.array_equal(bank.stack.numpy(), want)
    assert len(bank) == 5 and bank.num_params == spec.num_params
    sel = bank.select([4, 1])
    assert np.array_equal(sel.stack.numpy(), want[[4, 1]])
    assert np.array_equal(
        tmb.gather_rows(bank.stack, np.array([2, 2, 0], np.int32)).numpy(),
        np.asarray(jmb.gather_rows(jnp.asarray(want),
                                   np.array([2, 2, 0], np.int32))))


@pytest.mark.parametrize("ids", [[], [3], [5, 1, 9], list(range(40)),
                                 list(range(7, 40, 2))])
def test_pad_bucket_ids_equal(ids):
    a, n = tmb.pad_bucket_ids(ids)
    b, m = jmb.pad_bucket_ids(ids)
    assert n == m and a.dtype == b.dtype and np.array_equal(a, b)


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: nothing to refuse")
    w = _jax_params(TINY)
    with pytest.raises(RuntimeError, match="cuda"):
        tmb.params_from_jax(w)                # the default device is cuda
