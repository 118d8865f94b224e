"""Port vs JAX package: ``LMPool`` (AdamW local training over token
shards) and federated LM pretraining through the epoch loop on its fused,
stacked and legacy paths (``repro_torch.llm_federated_pretrain.run``
against the JAX package's ``LMPool`` in its own ``FLSimulation``).

Both sides start from the JAX package's weights and train on the same
minibatches: the port's ``batch_indices`` hook gives the indices the JAX
package draws (``PRNGKey(seed * 7919 + id)`` split J ways).  Tolerances:
* losses and eval losses: 1e-5 and 1e-4 (f32 training over J steps);
* trained and aggregated models: 1e-4 element by element, except where
  AdamW's first step took the sign of a gradient that rounding sets (an
  element whose gradient is within the two packages' rounding of zero
  moves by +-lr either way); such elements may number at most 1e-4 of
  the model, and the whole difference must stay within 1e-4 of the
  model's norm.  ``test_model_limit_rejects_a_lost_update`` shows that a
  lost update fails it.
* host history fields (epoch, time, models, gamma, stale groups): equal.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import FLSimulation as JSim, SimConfig as JSimConfig
from repro.core.constellation import WalkerDelta as JWalker
from repro.data.synthetic import token_stream as jtoken_stream
from repro.fl import LMPool as JLMPool, get_strategy as jget
from repro.models import registry as JR
from repro_torch import llm_federated_pretrain as LFP
from repro_torch.core.modelbank import FlatSpec, flatten_tree, params_from_jax
from repro_torch.fl import client
from repro_torch.fl.client import LMPool
from repro_torch.tree import tree_leaves
from test_torch_train import one_torch_thread  # noqa: F401

SATS, SEQ, SEQS_PER_SAT, J, EPOCHS = 4, 32, 8, 2, 2
LAYERS, D_MODEL = 2, 64
TRAINED_TOL = 1e-4
FLIP_SHARE = 1e-4


def _cfgs():
    jc = jget_config("qwen3-4b").reduced().replace(
        remat=False, dtype="float32", num_layers=LAYERS, d_model=D_MODEL)
    return jc, LFP.example_config("qwen3-4b", LAYERS, D_MODEL)


def jax_indices(n: int, local_iters: int = J, batch: int = 4):
    """The port's ``batch_indices`` hook: the JAX ``LMPool``'s minibatch
    indices for (epoch seed, padded participant ids)."""
    def hook(seed, ids_np):
        out = []
        for s in ids_np:
            key = jax.random.PRNGKey(np.uint32(seed) * np.uint32(7919)
                                     + np.uint32(s))
            out.append([np.asarray(jax.random.randint(k, (batch,), 0, n))
                        for k in jax.random.split(key, local_iters)])
        return np.asarray(out, np.int64)
    return hook


def assert_model_close(got, want, what):
    """``TRAINED_TOL`` element by element outside AdamW's sign flips."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    d = np.abs(got - want)
    beyond = int((d > TRAINED_TOL).sum())
    assert beyond <= max(1, FLIP_SHARE * d.size), \
        f"{what}: {beyond} of {d.size} elements beyond {TRAINED_TOL}"
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= TRAINED_TOL, f"{what}: relative distance {rel:.3e}"


def test_lmpool_size_mode_on_board_vs_trained():
    toks = np.zeros((10, 8), np.int32)
    shards = [np.arange(0, 6), np.arange(6, 10)]     # sizes 6 and 4 -> m=4
    pool = LMPool(model_cfg=None, tokens=toks, shards=shards, device="cpu")
    jpool = JLMPool(model_cfg=None, tokens=toks, shards=shards)
    assert pool.size_mode == jpool.size_mode == "on_board"
    assert [pool.data_size(s) for s in (0, 1)] == \
        [jpool.data_size(s) for s in (0, 1)] == [6, 4]
    trained = LMPool(model_cfg=None, tokens=toks, shards=shards,
                     size_mode="trained", device="cpu")
    assert trained.data_size(0) == trained.data_size(1) == 4
    assert trained.num_clients == 2
    with pytest.raises(ValueError, match="size_mode"):
        LMPool(model_cfg=None, tokens=toks, shards=shards, size_mode="full",
               device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            LMPool(model_cfg=None, tokens=toks, shards=shards)


@pytest.fixture(scope="module")
def trained():
    """The JAX pool's and the port's ``train_many_stacked`` over 3 of 4
    uneven shards (padded to 4: the first id twice), from the same
    weights with the same minibatches."""
    jc, cfg = _cfgs()
    toks = jtoken_stream(0, 30 * SEQ, jc.vocab_size).reshape(-1, SEQ)
    shards = np.array_split(np.arange(len(toks)), SATS)   # 8, 8, 7, 7
    n = min(len(s) for s in shards)
    jp = jax.device_get(JR.init_params(jax.random.PRNGKey(1), jc))
    jpool = JLMPool(jc, toks, shards, local_iters=3, batch_size=4)
    jbank, jlosses = jpool.train_many_stacked([2, 0, 3], jp, seed=11)
    pool = LMPool(cfg, toks, shards, local_iters=3, batch_size=4,
                  device="cpu", batch_indices=jax_indices(n, 3))
    params = params_from_jax(jp, device="cpu")
    bank, losses = pool.train_many_stacked([2, 0, 3], params, seed=11)
    return dict(pool=pool, params=params, bank=bank, losses=losses,
                jbank=np.asarray(jbank.stack), jlosses=np.asarray(jlosses))


def test_train_many_stacked_matches_jax(trained):
    bank, losses = trained["bank"], trained["losses"]
    assert bank.stack.shape == trained["jbank"].shape
    assert bank.spec == FlatSpec.of(trained["params"])
    np.testing.assert_allclose(losses.numpy(), trained["jlosses"], rtol=0,
                               atol=1e-5)
    for c in range(len(bank)):
        assert_model_close(bank.stack[c].numpy(), trained["jbank"][c],
                           f"bank row {c}")


def test_model_limit_rejects_a_lost_update(trained):
    """The known-bad control: one participant's update lost (its row the
    global model it trained from)."""
    bad = trained["bank"].stack.clone()
    bad[1] = flatten_tree(trained["params"])
    with pytest.raises(AssertionError):
        assert_model_close(bad[1].numpy(), trained["jbank"][1], "lost")


def test_train_many_and_train_give_the_bank_rows(trained):
    pool, params = trained["pool"], trained["params"]
    trees, losses = pool.train_many([2, 0, 3], params, seed=11)
    assert len(trees) == 3
    for c, tree in enumerate(trees):
        assert torch.equal(flatten_tree(tree), trained["bank"].stack[c])
    tree, loss = pool.train(0, params, seed=11)
    assert isinstance(loss, float)
    assert torch.equal(flatten_tree(tree), trained["bank"].stack[1])
    empty, no_losses = pool.train_many_stacked([], params, seed=11)
    assert len(empty) == 0 and empty.num_params == FlatSpec.of(
        params).num_params and no_losses.numel() == 0
    # the padded row (id 2 again) is a copy of row 0, not retrained
    stack, _ = pool.train_stacked(params, pool.epoch_inputs(
        np.array([2, 0, 3, 2], np.int32)), np.array([2, 0, 3, 2]), 11)
    assert torch.equal(stack[3], stack[0])


def _reference_run(mode):
    """The JAX package's example (scaled down) on one simulator path:
    (history, each record's flat global model)."""
    jc, _ = _cfgs()
    const = JWalker(num_orbits=2, sats_per_orbit=SATS // 2,
                    altitude_m=2000e3)
    toks = jtoken_stream(0, SATS * SEQS_PER_SAT * SEQ,
                         jc.vocab_size).reshape(-1, SEQ)
    shards = np.array_split(np.arange(len(toks)), const.num_sats)
    pool = JLMPool(jc, toks, shards, local_iters=J, batch_size=4)
    eval_toks = jtoken_stream(7, 16 * SEQ, jc.vocab_size).reshape(16, SEQ)
    seen = []

    def evaluator(p):
        seen.append(np.concatenate([np.asarray(x).ravel()
                                    for x in jax.tree_util.tree_leaves(p)]))
        return float(-JR.train_loss(p, jc, {"tokens": eval_toks})[0])

    sim = JSim(jget("asyncfleo-hap"), pool, evaluator,
               JSimConfig(duration_s=86400.0, train_time_s=300.0,
                          use_model_bank=mode != "legacy",
                          use_fused_step=mode == "fused"),
               constellation=const)
    jp = jax.device_get(JR.init_params(jax.random.PRNGKey(0), jc))
    return sim.run(jp, max_epochs=EPOCHS), seen, jp


@pytest.mark.parametrize("mode", ["fused", "stacked", "legacy"])
def test_lm_fl_history_matches_jax(mode, monkeypatch):
    jhist, jseen, jp = _reference_run(mode)
    seen = []
    make = LFP.make_evaluator

    def recording(cfg, seq, device):
        ev = make(cfg, seq, device)

        def evaluator(p):
            seen.append(flatten_tree(p).numpy())
            return ev(p)
        return evaluator

    monkeypatch.setattr(LFP, "make_evaluator", recording)
    _, cfg = _cfgs()
    n = SEQS_PER_SAT
    res = LFP.run(cfg, sats=SATS, seq=SEQ, seqs_per_sat=SEQS_PER_SAT,
                  local_iters=J, epochs=EPOCHS, device="cpu",
                  params=params_from_jax(jp, device="cpu"),
                  batch_indices=jax_indices(n),
                  sim_kw=dict(use_model_bank=mode != "legacy",
                              use_fused_step=mode == "fused"), log=None)
    hist = res["history"]
    assert len(hist) == len(jhist) == EPOCHS
    for a, b in zip(hist, jhist):
        assert (a.epoch, a.time_s, a.num_models, a.gamma, a.stale_groups) \
            == (b.epoch, b.time_s, b.num_models, b.gamma, b.stale_groups)
        assert abs(a.accuracy - b.accuracy) <= 1e-4
    assert len(seen) == len(jseen) == EPOCHS
    for k, (a, b) in enumerate(zip(seen, jseen)):
        assert_model_close(a, b, f"{mode} record {k}")
    sim = res["sim"]
    if mode == "fused":
        prog = sim.trainer._epoch_programs[sim._spec]
        assert prog.dispatches + prog.fallback_dispatches == EPOCHS
    if mode != "legacy":
        assert np.array_equal(sim._w_flat.numpy(), seen[-1])
    assert isinstance(sim.trainer, client.LMPool)


def test_llm_federated_pretrain_main_on_the_cpu(capsys):
    res = LFP.main(["--epochs", "1", "--sats", "4", "--seq", "16",
                    "--seqs-per-sat", "4", "--local-iters", "1",
                    "--layers", "1", "--d-model", "32", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "OK: federated LM pretraining converging" in out
    assert "4 satellites, 16 sequences" in out
    assert len(res["history"]) == 1
    assert all(t.device.type == "cpu" for t in tree_leaves(res["params"]))
    assert isinstance(res["sim"].trainer, LMPool)
    assert np.isfinite(res["history"][-1].accuracy)


def test_llm_federated_pretrain_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="cuda"):
        LFP.main(["--epochs", "1"])
