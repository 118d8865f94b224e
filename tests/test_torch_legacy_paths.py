"""The stacked and legacy simulator paths against the fused one and the JAX
package's, and the helpers they run on.

The three-way contract is the reference's own (``tests/test_epoch_step.py``,
``tests/test_modelbank.py``): legacy (a parameter dict per model), stacked
(a device bank, separate calls) and fused (one step a call) histories are
equal, and the final models agree within atol 1e-5.  The deterministic
tiny trainer has one copy on each side, so the JAX package's history is
the yardstick too.  Host metadata (times, counts, gamma, groups) is exact;
tensor math on identical inputs is held at atol 1e-5, pool training with
the JAX package's minibatch indices at atol 1e-4, as everywhere in the
port's tests.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import FLSimulation as JSim, SimConfig as JSimConfig
from repro.core import aggregation as jagg
from repro.core.grouping import GroupingState as JGrouping
from repro.core.grouping import model_distance as jmodel_distance
from repro.core.grouping import partial_global_model as jpartial
from repro.core.modelbank import (FlatSpec as JFlatSpec, ModelBank as JBank,
                                  flat_base as jflat_base,
                                  flatten_tree as jflatten_tree)
from repro.fl import get_strategy as jget
from repro.fl.client import ImageClassifierPool as JPool
from repro.kernels.fed_agg import ops as jfed_ops
from repro_torch.core import aggregation as agg
from repro_torch.core.grouping import (GroupingState, model_distance,
                                       partial_global_model)
from repro_torch.core.modelbank import (FlatSpec, ModelBank, flat_base,
                                        flatten_tree, params_from_jax)
from repro_torch.core.simulator import FLSimulation, SimConfig
from repro_torch.fl.client import ImageClassifierPool
from repro_torch.fl.strategies import get_strategy
from repro_torch.kernels.fed_agg import fed_agg_bank, fed_agg_pytree
from test_torch_cnn_client import TINY, _data, _w0, injected, jcfg

TOL = dict(atol=1e-5, rtol=0)
SHAPES = {"a": (3, 4), "b": (5,), "c": (2, 2, 2)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for these small CPU runs (as
    ``tests/test_torch_sched.py``): under several pytest workers torch's
    thread pools otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- the tiny deterministic trainer, one copy a side ----------------------

JW0 = {"w": np.zeros((6,), np.float32), "b": np.ones((3,), np.float32)}


class JTinyTrainer:
    """The JAX side: model * 0.9 + a per-(sat, seed) offset, through all
    three protocols with identical math (the reference's test trainer)."""

    def __init__(self, w0):
        self.spec = JFlatSpec.of(w0)

    def data_size(self, sat):
        return 100 + (sat % 5) * 10

    def epoch_inputs(self, ids_np):
        return None

    def epoch_train_fn(self):
        def _fn(params, inputs, ids, seed):
            flat = jflatten_tree(params)
            offs = ((ids * 37 + seed.astype(jnp.int32)) % 11
                    - 5).astype(jnp.float32) * 0.01
            return flat[None, :] * 0.9 + offs[:, None], jnp.zeros(
                ids.shape[0])
        return _fn

    def train_many_stacked(self, sats, params, seed):
        flat = self.spec.flatten(params)
        offs = jnp.asarray([(s * 37 + seed) % 11 - 5 for s in sats],
                           jnp.float32) * 0.01
        return (JBank(self.spec, flat[None, :] * 0.9 + offs[:, None]),
                np.zeros(len(sats)))

    def train_many(self, sats, params, seed):
        bank, losses = self.train_many_stacked(sats, params, seed)
        return bank.to_pytrees(), losses


class TinyTrainer:
    """The port's copy of ``JTinyTrainer``: the fused, stacked and legacy
    protocols, each the same math."""

    def __init__(self, w0):
        self.spec = FlatSpec.of(w0)

    def data_size(self, sat):
        return 100 + (sat % 5) * 10

    def _offsets(self, ids, seed):
        ids = torch.as_tensor(np.asarray(ids, np.int64))
        return ((ids * 37 + int(seed)) % 11 - 5).float() * 0.01

    # fused protocol
    def epoch_inputs(self, ids_np):
        return None

    def epoch_train_fn(self):
        def _fn(params, inputs, ids, seed):
            flat = flatten_tree(params)
            offs = self._offsets(ids, seed)
            return flat[None, :] * 0.9 + offs[:, None], torch.zeros(len(offs))
        return _fn

    # stacked protocol
    def train_many_stacked(self, sats, params, seed):
        flat = self.spec.flatten(params)
        offs = self._offsets(sats, seed)
        return (ModelBank(self.spec, flat[None, :] * 0.9 + offs[:, None]),
                np.zeros(len(sats)))

    # legacy protocol
    def train_many(self, sats, params, seed):
        bank, losses = self.train_many_stacked(sats, params, seed)
        return bank.to_pytrees(), losses


class LegacyOnlyTrainer:
    """Only ``train_many``: the legacy path whatever ``SimConfig`` says."""

    def __init__(self, w0):
        self._tiny = TinyTrainer(w0)

    def data_size(self, sat):
        return self._tiny.data_size(sat)

    def train_many(self, sats, params, seed):
        return self._tiny.train_many(sats, params, seed)


def _flat_host(params):
    return np.concatenate([np.ravel(np.asarray(params[k], np.float32))
                           for k in sorted(params)])


def _port_run(mode, name, trainer_cls=TinyTrainer, max_epochs=4, **simkw):
    """The port's simulation on one path; (history rows, the evaluated
    global models, the simulation)."""
    seen = []

    def ev(params):
        seen.append(flatten_tree(params).numpy().copy())
        return 0.0
    w0 = {k: torch.tensor(v) for k, v in JW0.items()}
    sim = SimConfig(duration_s=86400.0, train_time_s=300.0,
                    use_model_bank=mode != "legacy",
                    use_fused_step=mode == "fused", **simkw)
    fls = FLSimulation(get_strategy(name), trainer_cls(w0), ev, sim)
    hist = fls.run(w0, max_epochs=max_epochs)
    rows = [(r.epoch, r.time_s, r.num_models, r.gamma, r.stale_groups)
            for r in hist]
    return rows, seen, fls


def _jax_run(name, max_epochs=4, **simkw):
    seen = []

    def ev(params):
        seen.append(_flat_host(params))
        return 0.0
    sim = JSimConfig(duration_s=86400.0, train_time_s=300.0, **simkw)
    fls = JSim(jget(name), JTinyTrainer(JW0), ev, sim)
    hist = fls.run(JW0, max_epochs=max_epochs)
    rows = [(r.epoch, r.time_s, r.num_models, r.gamma, r.stale_groups)
            for r in hist]
    return rows, seen, fls


@pytest.mark.parametrize("timeout", [None, 120.0])
@pytest.mark.parametrize("name", ["asyncfleo-twohap", "fedhap", "fedsat",
                                  "fedspace"])
def test_three_paths_equal_each_other_and_jax(name, timeout):
    """Legacy, stacked and fused histories equal (a tight window carries
    stragglers), and equal to the JAX package's; every evaluated global
    model within 1e-5 of the JAX run's."""
    kw = {} if timeout is None else dict(agg_timeout_s=timeout)
    jrows, jseen, jfls = _jax_run(name, **kw)
    runs = {m: _port_run(m, name, **kw) for m in ("legacy", "stacked",
                                                  "fused")}
    assert len(jrows) == 4
    for mode, (rows, seen, fls) in runs.items():
        assert rows == jrows, mode
        assert len(seen) == len(jseen) == len(rows), mode
        for a, b in zip(seen, jseen):
            np.testing.assert_allclose(a, b, **TOL, err_msg=mode)
        assert fls.grouping.groups == jfls.grouping.groups, mode
        assert fls.last_epoch_included == jfls.last_epoch_included, mode


def test_path_selection():
    """``_init_run`` picks the fused, stacked or legacy path as the
    reference; the event-driven runtime needs the fused one."""
    w0 = {k: torch.tensor(v) for k, v in JW0.items()}

    def picked(trainer, **simkw):
        fls = FLSimulation(get_strategy("asyncfleo-hap"), trainer, None,
                           SimConfig(duration_s=3600.0, **simkw))
        _bits, fused, stacked = fls._init_run(w0)
        return fused is not None, stacked

    assert picked(TinyTrainer(w0)) == (True, True)
    assert picked(TinyTrainer(w0), use_fused_step=False) == (False, True)
    assert picked(TinyTrainer(w0), use_model_bank=False) == (False, False)
    assert picked(LegacyOnlyTrainer(w0)) == (False, False)
    for kw in (dict(use_fused_step=False), dict(use_model_bank=False)):
        fls = FLSimulation(get_strategy("asyncfleo-gs"), TinyTrainer(w0),
                           None, SimConfig(duration_s=3600.0,
                                           event_driven=True, **kw))
        with pytest.raises(ValueError, match="fused epoch step"):
            fls.run(w0, max_epochs=1)


def test_legacy_only_trainer_runs_the_legacy_path():
    rows, seen, fls = _port_run("fused", "asyncfleo-twohap",
                                trainer_cls=LegacyOnlyTrainer)
    assert fls._w_flat is None and fls._fused_prog is None
    assert rows == _port_run("legacy", "asyncfleo-twohap")[0]


# ---- aggregation helpers against the reference ----------------------------

def _models(seed, n, shapes=SHAPES):
    rng = np.random.default_rng(seed)
    return [{k: rng.standard_normal(s).astype(np.float32)
             for k, s in shapes.items()} for _ in range(n)]


def _port(models):
    return [{k: torch.tensor(v) for k, v in m.items()} for m in models]


def _metas(seed, n, beta=4):
    rng = np.random.default_rng(seed + 100)
    sats = rng.integers(0, max(2, n - 1), n)       # some duplicates
    metas = [(int(s), float(rng.integers(50, 150)), float(rng.uniform(0, 9)),
              int(rng.integers(0, beta + 1))) for s in sats]
    return ([agg.SatelliteMeta(s, d, (0.0, 0.0), ts, ep)
             for s, d, ts, ep in metas],
            [jagg.SatelliteMeta(s, d, (0.0, 0.0), ts, ep)
             for s, d, ts, ep in metas])


def _close(port, ref):
    """A port result (parameter dict or flat tensor) against the
    reference's (pytree or flat array), at atol 1e-5."""
    if isinstance(port, dict):
        assert sorted(port) == sorted(ref)
        for k in port:
            np.testing.assert_allclose(port[k].numpy(), np.asarray(ref[k]),
                                       **TOL)
    else:
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("seed", range(3))
def test_dedup_equal(seed):
    jm = _models(seed, 6)
    metas, jmetas = _metas(seed, 6)
    (pm, pmeta), (rm, rmeta) = (agg.dedup(_port(jm), metas),
                                jagg.dedup(jm, jmetas))
    assert [vars(m) for m in pmeta] == [vars(m) for m in rmeta]
    for a, b in zip(pm, rm):
        _close(a, b)
    bank, jbank = ModelBank.from_pytrees(_port(jm)), JBank.from_pytrees(jm)
    (pb, _), (rb, _) = agg.dedup(bank, metas), jagg.dedup(jbank, jmetas)
    _close(pb.stack, rb.stack)


@pytest.mark.parametrize("form", ["list", "bank"])
@pytest.mark.parametrize("base_weight", [0.0, 0.3])
@pytest.mark.parametrize("seed", range(2))
def test_weighted_sum_and_fedavg_equal(seed, base_weight, form):
    jm = _models(seed, 5)
    base = _models(seed + 7, 1)[0]
    rng = np.random.default_rng(seed)
    ws = rng.uniform(0, 0.3, 5)
    sizes = rng.integers(50, 150, 5).astype(float)
    models = _port(jm)
    if form == "bank":
        models, jm = ModelBank.from_pytrees(models), JBank.from_pytrees(jm)
    _close(agg.weighted_sum(models, ws, base=_port([base])[0],
                            base_weight=base_weight),
           jagg.weighted_sum(jm, ws, base=base, base_weight=base_weight))
    _close(agg.fedavg(models, sizes), jagg.fedavg(jm, sizes))


@pytest.mark.parametrize("form", ["list", "bank"])
@pytest.mark.parametrize("strict", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_asyncfleo_aggregate_equal(seed, strict, form):
    jm = _models(seed, 6)
    w_prev = _models(seed + 9, 1)[0]
    metas, jmetas = _metas(seed, 6)
    groups = {0: [0, 1, 2], 1: [3], 2: [4, 5]}
    models = _port(jm)
    if form == "bank":
        models, jm = ModelBank.from_pytrees(models), JBank.from_pytrees(jm)
    pw, pinfo = agg.asyncfleo_aggregate(_port([w_prev])[0], groups, models,
                                        metas, 4, strict_paper_eq14=strict)
    rw, rinfo = jagg.asyncfleo_aggregate(w_prev, groups, jm, jmetas, 4,
                                         strict_paper_eq14=strict)
    assert pinfo == rinfo
    _close(pw, rw)


def test_asyncfleo_aggregate_nothing_selected_returns_w_prev():
    w_prev = _port(_models(0, 1))[0]
    out, info = agg.asyncfleo_aggregate(w_prev, {}, [], [], 3)
    assert out is w_prev and info["selected"] == 0


# ---- the model bank and fed_agg's bank and pytree forms -------------------

def test_modelbank_forms_equal():
    jm = _models(3, 4)
    pm = _port(jm)
    jspec = JFlatSpec.of(jm[0])
    bank, jbank = ModelBank.from_pytrees(pm), JBank.from_pytrees(jm)
    _close(bank.stack, jbank.stack)
    for a, b in zip(bank.to_pytrees(), jbank.to_pytrees()):
        _close(a, b)
    rows = ModelBank.from_rows(bank.spec, [r.numpy() for r in bank.stack])
    assert torch.equal(rows.stack, bank.stack)
    _close(flatten_tree(pm[0]), jflatten_tree(jm[0]))
    nested = {"z": pm[1], "a": pm[0]["b"]}
    _close(flatten_tree(nested), jflatten_tree({"z": jm[1],
                                                "a": jm[0]["b"]}))
    _close(flat_base(bank.spec, pm[2]), jflat_base(jspec, jm[2]))
    flat = bank.stack[1]
    assert flat_base(bank.spec, flat) is flat
    assert flat_base(bank.spec, None) is None
    # to_pytrees copies: a later in-place update of the bank leaves them
    trees = bank.to_pytrees()
    bank.stack.zero_()
    _close(trees[0], jm[0])


@pytest.mark.parametrize("base_weight", [0.0, 0.45])
def test_fed_agg_bank_and_pytree_equal(base_weight):
    jm = _models(5, 3)
    base = _models(6, 1)[0]
    g = np.array([0.2, 0.5, 0.1], np.float32)
    pm = _port(jm)
    jbank = JBank.from_pytrees(jm)
    want = jfed_ops.fed_agg_bank(jbank, g, base, base_weight)
    _close(fed_agg_bank(ModelBank.from_pytrees(pm), g, _port([base])[0],
                        base_weight), want)
    _close(fed_agg_bank(ModelBank.from_pytrees(pm), torch.tensor(g),
                        flatten_tree(_port([base])[0]), base_weight), want)
    _close(fed_agg_pytree(pm, g, _port([base])[0], base_weight),
           jfed_ops.fed_agg_pytree(jm, g, base, base_weight))


# ---- grouping: list and bank forms ----------------------------------------

def _orbit_models(seed, orbit, m, scale):
    rng = np.random.default_rng(seed * 31 + orbit)
    return [{k: (rng.standard_normal(s) * 0.01 + scale * (orbit + 1))
             .astype(np.float32) for k, s in SHAPES.items()}
            for _ in range(m)]


def _grouping_pair(w0, num_groups=3):
    st, jst = GroupingState(num_groups=num_groups), JGrouping(
        num_groups=num_groups)
    st.set_reference(_port([w0])[0])
    jst.set_reference(w0)
    return st, jst


@pytest.mark.parametrize("seed", range(3))
def test_observe_orbit_list_and_bank_forms_equal(seed):
    """Seven orbits, one at a time: the list form's host math gives the
    reference's distances bit for bit; the bank form agrees to 1e-5; both
    give the reference's groups."""
    w0 = _models(seed + 40, 1)[0]
    scale = np.random.default_rng(seed).permutation(
        [0.1, 0.35, 0.2, 0.9, 0.5, 0.3, 0.7])
    (lst, jlst), (bnk, jbnk) = _grouping_pair(w0), _grouping_pair(w0)
    for orbit in range(7):
        jm = _orbit_models(seed, orbit, 3, scale[orbit])
        sizes = [100.0 + 10 * j for j in range(3)]
        assert (lst.observe_orbit(orbit, _port(jm), sizes)
                == jlst.observe_orbit(orbit, jm, sizes))
        assert (bnk.observe_orbit(orbit, ModelBank.from_pytrees(_port(jm)),
                                  sizes)
                == jbnk.observe_orbit(orbit, JBank.from_pytrees(jm), sizes))
        assert lst.distances[orbit] == jlst.distances[orbit]
        assert bnk.distances[orbit] == pytest.approx(jbnk.distances[orbit],
                                                     abs=1e-5)
    assert lst.groups == jlst.groups == bnk.groups == jbnk.groups
    # a known orbit keeps its group
    assert lst.observe_orbit(2, [], []) == lst.group_of(2)
    pm = partial_global_model(_port(jm), sizes)
    jpm = jpartial(jm, sizes)
    for k in pm:
        assert np.array_equal(pm[k], np.asarray(jpm[k]))
    assert (model_distance(pm, lst.ref_host())
            == jmodel_distance(jpm, jlst.ref_flat))


@pytest.mark.parametrize("layout", ["blocked", "dense"])
def test_observe_orbits_regroup_all_grouped_equal(layout):
    w0 = _models(50, 1)[0]
    rows, orbit_indices = [], {}
    for orbit in range(5):
        m = 3 if layout == "blocked" else 2 + orbit % 2
        orbit_indices[orbit] = list(range(len(rows), len(rows) + m))
        rows += _orbit_models(7, orbit, m, 0.15 * (orbit + 1) ** 1.5)
    if layout == "dense":                 # not in constellation order
        orbit_indices = {o: idx[::-1] for o, idx in
                         reversed(list(orbit_indices.items()))}
    sizes = [100.0 + 7 * j for j in range(len(rows))]
    st, jst = _grouping_pair(w0)
    out = st.observe_orbits(orbit_indices, ModelBank.from_pytrees(
        _port(rows)), sizes)
    jout = jst.observe_orbits(orbit_indices, JBank.from_pytrees(rows), sizes)
    assert out == jout and st.groups == jst.groups
    for o in orbit_indices:
        assert st.distances[o] == pytest.approx(jst.distances[o], abs=1e-5)
    assert st.all_grouped(5) == jst.all_grouped(5) is True
    assert st.all_grouped(6) == jst.all_grouped(6) is False
    st.regroup()
    jst.regroup()
    assert st.groups == jst.groups
    # every orbit known now: no new distances
    again = st.observe_orbits(orbit_indices, ModelBank.from_pytrees(
        _port(rows)), sizes)
    assert again == jst.observe_orbits(orbit_indices,
                                       JBank.from_pytrees(rows), sizes)


# ---- the pool's stacked and legacy forms ----------------------------------

@pytest.fixture(scope="module")
def pools():
    imgs, labs, shards = _data()
    kw = dict(local_iters=3, batch_size=8)
    jpool = JPool(jcfg(TINY), imgs, labs, shards, **kw)
    tpool = ImageClassifierPool(TINY, imgs, labs, shards, device="cpu",
                                batch_indices=injected(kw, shards), **kw)
    w = _w0(TINY)
    return jpool, tpool, w, params_from_jax(w, device="cpu")


@pytest.mark.parametrize("sats", [[3, 9, 17], list(range(0, 40, 3)), []])
def test_pool_stacked_and_legacy_forms_equal(pools, sats):
    jpool, tpool, w, tw = pools
    bank, losses = tpool.train_many_stacked(sats, tw, seed=7)
    jbank, jlosses = jpool.train_many_stacked(sats, w, seed=7)
    assert bank.stack.shape == jbank.stack.shape == (
        len(sats), FlatSpec.of(tw).num_params)
    np.testing.assert_allclose(bank.stack.numpy(), np.asarray(jbank.stack),
                               atol=1e-4)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses),
                               atol=1e-4)
    trees, tl = tpool.train_many(sats, tw, seed=7)
    jtrees, _ = jpool.train_many(sats, w, seed=7)
    assert len(trees) == len(jtrees) == len(sats)
    for a, b in zip(trees, jtrees):
        for k in a:
            np.testing.assert_allclose(a[k].numpy(), b[k], atol=1e-4)
    assert torch.equal(tl, losses)


def test_pool_train_one_equal(pools):
    jpool, tpool, w, tw = pools
    tree, loss = tpool.train(11, tw, seed=3)
    jtree, jloss = jpool.train(11, w, seed=3)
    for k in tree:
        np.testing.assert_allclose(tree[k].numpy(), jtree[k], atol=1e-4)
    assert loss == pytest.approx(jloss, abs=1e-4)


@pytest.mark.parametrize("mode", ["stacked", "legacy"])
def test_pool_paths_equal_fused(pools, mode):
    """The CNN pool on the stacked and legacy paths against its fused run
    (the same minibatch indices, so the same training): host rows equal,
    accuracy within one test sample, models within 1e-5."""
    from repro.data import class_conditional_images
    from repro_torch.fl.client import Evaluator
    _jpool, tpool, _w, tw = pools
    ti, tl = class_conditional_images(99, 100, separation=0.8)
    ev = Evaluator(TINY, ti, tl, device="cpu")
    runs = {}
    for m in ("fused", mode):
        seen = []

        def evaluate(params, seen=seen):
            seen.append(flatten_tree(params).clone())
            return float(ev(params))
        sim = SimConfig(duration_s=86400.0, use_model_bank=m != "legacy",
                        use_fused_step=m == "fused", agg_timeout_s=600.0)
        fls = FLSimulation(get_strategy("asyncfleo-twohap"), tpool,
                           evaluate, sim)
        hist = fls.run(tw, max_epochs=3)
        runs[m] = hist, seen
    (fh, fseen), (mh, mseen) = runs["fused"], runs[mode]
    key = [(r.epoch, r.time_s, r.num_models, r.gamma, r.stale_groups)
           for r in fh]
    assert key == [(r.epoch, r.time_s, r.num_models, r.gamma,
                    r.stale_groups) for r in mh]
    for a, b in zip(fh, mh):
        assert abs(a.accuracy - b.accuracy) <= 1 / 100 + 1e-6
    for a, b in zip(fseen, mseen):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)
