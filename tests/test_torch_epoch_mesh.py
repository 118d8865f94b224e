"""The fused epoch step's mesh branch and the simulator on a data mesh,
in gloo worlds of 2 and 4 CPU ranks, against the JAX package.

Each world is spawned once (a module fixture, ``torch_mesh_cases``) and
returns the numbers of every case; the tests assert them one by one.

* ``sharded_contract``: a C = 16384 bank, each rank passing its C/n rows,
  against ``w @ bank`` at atol 1e-3, rtol 1e-4 (the reference's
  ``tests/test_scale_sharding.py``).
* The step (that test's synthetic train function): the sharded step
  against the unsharded one in the same process at 1e-5 (the new model
  and the distances, summed in another order); the losses and the late
  rows exactly (copied across ranks, never summed with anything but
  zeros), read back through ``stack_rows``, which refuses other rows of a
  sharded bank; the fallback combine; one ``fed_agg`` call a step on
  every rank; each rank's share of the rows.  C = 6 at 4 ranks does not
  divide: every rank takes the unsharded path, as the reference does.
* A 2-epoch ``FLSimulation`` at small CNN width against the reference's
  ``mesh=None`` run with the same minibatch indices: host history equal,
  accuracy at 1e-6, final model at 1e-5, groups and carried stragglers
  equal.  One run carries stragglers (a 120 s window); one takes the
  fallback split: asyncfleo-hap for 15 epochs with an orbit forgotten at
  epoch 14, its first stale-only group (tests/test_torch_slice.py).
* Every rank's every result is bit-equal to rank 0's.
* A mesh program refuses the sweep's scenario batching.
"""
import numpy as np
import pytest
import torch

from repro.core import FLSimulation as JSim, SimConfig as JSimConfig
from repro.data import class_conditional_images, iid_partition
from repro.fl import Evaluator as JEvaluator, ImageClassifierPool as JPool
from repro.fl import get_strategy as jget
from repro_torch.core.epoch_step import EpochStepProgram
from repro_torch.core.modelbank import FlatSpec
from test_torch_cnn_client import _w0, injected, jcfg
from test_torch_slice import _with_fallback_at
from torch_mesh_cases import (TINY, epoch_step_case, run_world,
                              simulation_case)

WORLDS = (2, 4)
C_BANK = 16384
STEPS = [(C_BANK, "blocked", False), (64, "one-hot", False),
         (64, "one-hot", True), (8, "blocked", True), (6, "blocked", False)]
KW = dict(local_iters=2, batch_size=8)
# (scheme, SimConfig keywords, epochs, epoch at which an orbit is forgotten)
SIMS = {"hap": ("asyncfleo-hap", {}, 2, None),
        "twohap-late": ("asyncfleo-twohap", dict(agg_timeout_s=120.0), 2,
                        None),
        "hap-fallback": ("asyncfleo-hap", {}, 15, 14)}


def world_cases(rank, n, table, w0):
    """Everything one rank of a world runs for this file."""
    return {"step": epoch_step_case(rank, n, C_BANK, STEPS),
            "sims": {name: simulation_case(rank, n, w0, table, scheme,
                                           epochs, KW, sim_kw, forget)
                     for name, (scheme, sim_kw, epochs, forget)
                     in SIMS.items()}}


@pytest.fixture(scope="module")
def runs():
    imgs, labs = class_conditional_images(0, 400, separation=0.8)
    ti, tl = class_conditional_images(99, 100, separation=0.8)
    shards = iid_partition(labs, 40, 0)
    w0 = _w0(TINY)
    refs = {}
    for name, (scheme, sim_kw, epochs, forget) in SIMS.items():
        jpool = JPool(jcfg(TINY), imgs, labs, shards, **KW)
        cls = JSim if forget is None else _with_fallback_at(JSim, forget)
        jsim = cls(jget(scheme), jpool, JEvaluator(jcfg(TINY), ti, tl),
                   JSimConfig(duration_s=86400.0, **sim_kw))
        refs[name] = (jsim.run(w0, max_epochs=epochs), jsim)
    # the reference's minibatch indices of every satellite at each epoch's
    # seed (0 * 1000 + epoch), for the ranks' batch_indices hook
    draw = injected(KW, shards)
    ids = np.arange(40)
    table = {}
    for seed in range(max(case[2] for case in SIMS.values())):
        idx = draw(seed, ids).numpy()
        table.update({(seed, int(s)): idx[i] for i, s in enumerate(ids)})
    w0n = {k: np.asarray(v) for k, v in w0.items()}
    worlds = {n: run_world(n, world_cases, table, w0n) for n in WORLDS}
    return refs, worlds


@pytest.mark.parametrize("n", WORLDS)
def test_sharded_contract_at_scale(runs, n):
    _, worlds = runs
    rng = np.random.default_rng(0)
    bank = rng.standard_normal((C_BANK, 32)).astype(np.float32)
    w = rng.random(C_BANK).astype(np.float32)
    for res in worlds[n]:
        assert res["step"]["rows"] == C_BANK // n
        np.testing.assert_allclose(res["step"]["contract"], w @ bank,
                                   atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("case", STEPS, ids=lambda c: f"{c[0]}-{c[1]}-"
                         f"{'fallback' if c[2] else 'fused'}")
def test_step_mesh_matches_single(runs, n, case):
    _, worlds = runs
    C, _layout, fallback = case
    sharded = C % n == 0
    for res in worlds[n]:
        got, want = res["step"][case]["mesh"], res["step"][case]["single"]
        np.testing.assert_allclose(got["w"], want["w"], atol=1e-5)
        np.testing.assert_allclose(got["dists"], want["dists"], atol=1e-5)
        for key in ("losses", "late"):
            np.testing.assert_array_equal(got[key], want[key])
        assert got["local"] == ((C // n, 32) if sharded else (C, 32))
        assert got["refuses"] == sharded and not want["refuses"]
        assert got["fed_agg_calls"] == want["fed_agg_calls"] == 1
        assert got["dispatches"] == ((0, 1) if fallback else (1, 0))


@pytest.mark.parametrize("n", WORLDS)
def test_ranks_bit_equal(runs, n):
    _, worlds = runs
    first = worlds[n][0]
    for res in worlds[n][1:]:
        for case in STEPS:
            for key in ("w", "dists", "losses", "late"):
                np.testing.assert_array_equal(
                    res["step"][case]["mesh"][key],
                    first["step"][case]["mesh"][key])
        for name in SIMS:
            a, b = res["sims"][name], first["sims"][name]
            np.testing.assert_array_equal(a["w"], b["w"])
            assert (a["history"], a["groups"], a["pend"], a["steps"]) == \
                (b["history"], b["groups"], b["pend"], b["steps"])


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("name", list(SIMS))
def test_simulation_matches_reference(runs, n, name):
    refs, worlds = runs
    jhist, jsim = refs[name]
    for res in worlds[n]:
        got = res["sims"][name]
        assert len(got["history"]) == len(jhist) == SIMS[name][2]
        for a, b in zip(got["history"], jhist):
            assert (a["epoch"], a["time_s"], a["num_models"], a["gamma"],
                    a["stale_groups"]) == (b.epoch, b.time_s, b.num_models,
                                           b.gamma, b.stale_groups)
            assert a["accuracy"] == pytest.approx(b.accuracy, abs=1e-6)
        np.testing.assert_allclose(got["w"], np.asarray(jsim._w_flat),
                                   atol=1e-5)
        assert got["groups"] == jsim.grouping.groups
        assert got["pend"] == [m[:2] for m in jsim._pend_meta]
        assert got["steps"] == (jsim._fused_prog.dispatches,
                                jsim._fused_prog.fallback_dispatches)
        # each case exercises what it names
        if name == "twohap-late":
            assert got["pend"]
        assert got["steps"][1] == (name == "hap-fallback")


def test_mesh_program_refuses_scenario_batching():
    """A mesh program's steps hold collectives: it runs solo, as in the
    reference, and refuses the sweep's batched step."""
    prog = EpochStepProgram(FlatSpec.of({"w": torch.zeros(2)}),
                            lambda *a: None, mesh=object())
    with pytest.raises(ValueError, match="mesh=None only"):
        prog.batched_step(*([None] * 14))
