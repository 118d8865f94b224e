"""The paper's Table II on the port's epoch loop, against the JAX package.

Table II (``benchmarks/table2.py``) runs eight schemes on the paper's
non-IID split (satellites of two orbits hold four classes, the other three
orbits the remaining six; ``benchmarks/common.py``'s ``make_setup``).  Each
scheme runs here at TINY width over the paper's 40 satellites for one
simulated day, from the same w0, with the JAX minibatch draws fed to the
port, as ``tests/test_torch_slice.py`` holds the IID histories:

* host fields (epoch, simulated time, model count, eq. 13 gamma, stale
  groups) exactly equal;
* accuracy within one test sample (f32 reduction order can move one
  argmax);
* the final global model at atol 1e-4 (J SGD steps of reduction-order
  noise);
* the divergence groups and the carried stragglers' metadata equal.

On the non-IID split grouping forms several divergence groups (the two
class halves diverge from w0 differently).  The four schemes that no other
history test holds on the epoch loop (fedisl-ideal, fedsat, fedhap,
asyncfleo-twohap) also run on IID shards.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import FLSimulation as JSim, SimConfig as JSimConfig
from repro.core import paper_constellation as jconstellation
from repro.data import (class_conditional_images, iid_partition,
                        paper_noniid_partition)
from repro.fl import Evaluator as JEvaluator, ImageClassifierPool as JPool
from repro.fl import get_strategy as jget
from repro_torch.core.modelbank import params_from_jax
from repro_torch.core.simulator import FLSimulation, SimConfig
from repro_torch.fl.strategies import get_strategy
from repro_torch.fl_constellation_sim import build_workload
from test_torch_cnn_client import TINY, _w0, injected, jcfg
from test_torch_sched import one_torch_thread  # noqa: F401  (autouse)

DAYS = 1.0
NUM_TRAIN = 400
NUM_TEST = 100
KW = dict(local_iters=2, batch_size=8)
TABLE2 = ["fedisl", "fedisl-ideal", "fedsat", "fedspace", "fedhap",
          "asyncfleo-gs", "asyncfleo-hap", "asyncfleo-twohap"]


def _setup(iid: bool):
    """(JAX pool, JAX evaluator, JAX w0, the port's workload) on the same
    shards: the reference's built as ``benchmarks/common.py`` builds them,
    the port's through ``build_workload``."""
    imgs, labs = class_conditional_images(0, NUM_TRAIN, separation=0.8)
    ti, tl = class_conditional_images(99, NUM_TEST, separation=0.8)
    const = jconstellation()
    shards = (iid_partition(labs, const.num_sats, 0) if iid
              else paper_noniid_partition(labs, const.orbit_ids(), 0))
    jpool = JPool(jcfg(TINY), imgs, labs, shards, **KW)
    jevl = JEvaluator(jcfg(TINY), ti, tl)
    w0 = _w0(TINY)
    work = build_workload(iid=iid, device="cpu", cfg=TINY,
                          num_train=NUM_TRAIN, num_test=NUM_TEST,
                          w0=params_from_jax(w0, device="cpu"),
                          batch_indices=injected(KW, shards), **KW)
    return jpool, jevl, w0, work


@pytest.fixture(scope="module")
def noniid():
    return _setup(iid=False)


@pytest.fixture(scope="module")
def iid():
    return _setup(iid=True)


def run_loop_pair(setup, scheme, epochs, *, spec_kw=None, days=DAYS):
    """The scheme on the JAX package's epoch loop and the port's, from the
    same w0.  ``spec_kw`` replaces strategy fields on both sides.  Returns
    (JAX simulation, its history, port simulation, its history)."""
    jpool, jevl, w0, work = setup
    jspec, tspec = jget(scheme), get_strategy(scheme)
    if spec_kw:
        jspec = dataclasses.replace(jspec, **spec_kw)
        tspec = dataclasses.replace(tspec, **spec_kw)
    jsim = JSim(jspec, jpool, jevl, JSimConfig(duration_s=days * 86400.0))
    jhist = jsim.run(w0, max_epochs=epochs)
    tsim = FLSimulation(tspec, work.pool, work.evaluator,
                        SimConfig(duration_s=days * 86400.0))
    thist = tsim.run(work.w0, max_epochs=epochs)
    return jsim, jhist, tsim, thist


def host_fields(hist):
    return [(r.epoch, r.time_s, r.num_models, r.gamma, r.stale_groups)
            for r in hist]


def assert_same_loop(jsim, jhist, tsim, thist, num_test=NUM_TEST,
                     model_atol=1e-4):
    """The epoch-loop parity of the module docstring."""
    assert len(thist) == len(jhist)
    assert host_fields(thist) == host_fields(jhist)
    for a, b in zip(thist, jhist):
        assert abs(a.accuracy - b.accuracy) <= 1.0 / num_test + 1e-6
    np.testing.assert_allclose(tsim._w_flat.numpy(),
                               np.asarray(jsim._w_flat), atol=model_atol)
    assert tsim.grouping.groups == jsim.grouping.groups
    assert tsim._pend_meta == jsim._pend_meta
    assert tsim.last_epoch_included == jsim.last_epoch_included


@pytest.mark.parametrize("scheme", TABLE2)
def test_table2_noniid_history_matches_jax(noniid, scheme):
    jsim, jhist, tsim, thist = run_loop_pair(noniid, scheme, 8)
    assert len(thist) >= 6
    assert_same_loop(jsim, jhist, tsim, thist)
    if scheme == "asyncfleo-hap":
        # the two class halves diverge from w0 apart: several groups
        assert len(tsim.grouping.groups) > 1


def test_noniid_shards_equal_reference(noniid):
    """``build_workload(iid=False)`` shards the data as ``make_setup``
    does: the port's pool holds the reference pool's shards."""
    jpool, _, _, work = noniid
    assert len(work.pool.shards) == len(jpool.shards) == 40
    for got, want in zip(work.pool.shards, jpool.shards):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(work.pool.labels, jpool.labels)
    assert [work.pool.data_size(s) for s in range(40)] == \
        [jpool.data_size(s) for s in range(40)]
    # two class halves: orbits 0-1 hold classes 0-3, the rest 4-9
    orbit = jconstellation().orbit_ids()
    for s, idx in enumerate(work.pool.shards):
        classes = set(work.pool.labels[idx].tolist())
        assert classes <= (set(range(4)) if orbit[s] < 2
                           else set(range(4, 10)))


@pytest.mark.parametrize("scheme", ["fedisl-ideal", "fedsat", "fedhap",
                                    "asyncfleo-twohap"])
def test_unheld_schemes_iid_history_matches_jax(iid, scheme):
    jsim, jhist, tsim, thist = run_loop_pair(iid, scheme, 3)
    assert len(thist) == 3
    assert_same_loop(jsim, jhist, tsim, thist)
