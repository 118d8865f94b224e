"""The port's synthetic data and federated partitions against the JAX
package's: host numpy, so exactly equal, dtype included.

Figs. 7-8 draw MNIST-shaped (28x28x1) and CIFAR-shaped (32x32x3) images;
Table II shards them with the paper's 4/6-class non-IID split over the
paper constellation's orbits; the Dirichlet split serves the ablations and
``token_stream`` the LM pretraining example.
"""
import numpy as np
import pytest

from repro.core import paper_constellation as jconstellation
from repro.data import partition as jpart, synthetic as jsyn
from repro_torch.core.constellation import paper_constellation
from repro_torch.data import partition as tpart, synthetic as tsyn

SEEDS = [0, 1, 7]
SHAPES = [(28, 1), (32, 3)]


def same(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def same_shards(got, want):
    return len(got) == len(want) and all(same(g, w)
                                         for g, w in zip(got, want))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("size,channels", SHAPES)
def test_class_conditional_images_equal(seed, size, channels):
    for n, sep in ((257, 0.8), (64, 1.6)):
        ti, tl = tsyn.class_conditional_images(seed, n, size=size,
                                               channels=channels,
                                               separation=sep)
        ji, jl = jsyn.class_conditional_images(seed, n, size=size,
                                               channels=channels,
                                               separation=sep)
        assert ti.shape == (n, size, size, channels)
        assert same(ti, ji) and same(tl, jl)


@pytest.mark.parametrize("seed", SEEDS)
def test_token_stream_equal(seed):
    for n, vocab in ((4096, 1000), (333, 64)):
        got = tsyn.token_stream(seed, n, vocab)
        assert same(got, jsyn.token_stream(seed, n, vocab))
        assert got.min() >= 0 and got.max() < vocab


def _labels(seed, n=1000):
    return jsyn.class_conditional_images(seed, n, size=8)[1]


@pytest.mark.parametrize("seed", SEEDS)
def test_iid_partition_equal(seed):
    labs = _labels(seed)
    for clients in (40, 7):
        got = tpart.iid_partition(labs, clients, seed)
        assert same_shards(got, jpart.iid_partition(labs, clients, seed))
        assert same(np.sort(np.concatenate(got)), np.arange(len(labs)))


@pytest.mark.parametrize("seed", SEEDS)
def test_paper_noniid_partition_equal(seed):
    labs = _labels(seed)
    orbits = paper_constellation().orbit_ids()
    assert same(orbits, jconstellation().orbit_ids())
    got = tpart.paper_noniid_partition(labs, orbits, seed)
    assert same_shards(got, jpart.paper_noniid_partition(labs, orbits, seed))
    for s, idx in enumerate(got):
        lo = orbits[s] < 2
        assert np.isin(labs[idx], np.arange(4) if lo
                       else np.arange(4, 10)).all()
    # a non-default split
    kw = dict(split_classes=3, low_orbits=1)
    assert same_shards(tpart.paper_noniid_partition(labs, orbits, seed, **kw),
                       jpart.paper_noniid_partition(labs, orbits, seed, **kw))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("alpha", [0.1, 1.0])
def test_dirichlet_partition_equal(seed, alpha):
    labs = _labels(seed)
    got = tpart.dirichlet_partition(labs, 40, alpha, seed)
    assert same_shards(got, jpart.dirichlet_partition(labs, 40, alpha, seed))
    assert same(np.sort(np.concatenate(got)), np.arange(len(labs)))
