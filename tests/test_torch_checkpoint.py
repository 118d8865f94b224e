"""Port vs JAX package: checkpoints (``repro_torch.checkpoint``) in the
reference's file format, written by either package and read by the other,
and the FL launcher ``repro_torch.launch.fl_train`` with ``--checkpoint``
and ``--resume``.

The launcher keeps one deviation from the reference (C-ref 4 in
ROADMAP.md): the reference's ``fl_train`` saves the initial model
(``w_final = w0``); the port saves the global model the run ended with.
"""
import json

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import load_pytree as jload_pytree
from repro.checkpoint import load_server_state as jload_server_state
from repro.checkpoint import save_pytree as jsave_pytree
from repro.checkpoint import save_server_state as jsave_server_state
from repro.configs import get_config as jget_config
from repro.models import registry as JR
from repro_torch.checkpoint import (load_pytree, load_server_state,
                                    save_pytree, save_server_state)
from repro_torch.configs import get_config
from repro_torch.core.modelbank import flatten_tree, params_from_jax
from repro_torch.launch import fl_train
from repro_torch.models import cnn
from repro_torch.models import registry as R
from repro_torch.optim import adamw
from repro_torch.tree import tree_paths
from test_torch_train import one_torch_thread  # noqa: F401

FL_ARGV = ["--strategy", "asyncfleo-hap", "--epochs", "2", "--iid",
           "--model", "mlp", "--local-iters", "2", "--days", "1",
           "--device", "cpu"]


def _lm_tree():
    """A nested LM parameter tree and an AdamW state over it (its int32
    step a 0-dim leaf)."""
    cfg = get_config("qwen3-4b").reduced().replace(remat=False,
                                                   dtype="float32")
    params = R.init_params(3, cfg, device="cpu")
    opt = adamw(1e-3)
    state = opt.init(params)
    state["step"] = state["step"] + 7
    return {"params": params, "opt_state": state}


def _same_tree(torch_tree, np_tree):
    pairs = tree_paths(torch_tree)
    leaves = jax.tree_util.tree_leaves(np_tree)
    assert len(pairs) == len(leaves)
    assert [p for p, _ in pairs] == [
        tuple(str(k.key) for k in path)
        for path, _ in jax.tree_util.tree_flatten_with_path(np_tree)[0]]
    for (path, a), b in zip(pairs, leaves):
        b = np.asarray(b)
        assert a.dtype == torch.from_numpy(b.copy()).dtype, path
        assert np.array_equal(a.numpy(), b), path


def test_port_writes_jax_reads_nested_lm_tree(tmp_path):
    tree = _lm_tree()
    path = str(tmp_path / "lm.npz")
    save_pytree(path, tree)
    _same_tree(tree, jload_pytree(path))


def test_jax_writes_port_reads_nested_lm_tree(tmp_path):
    jc = jget_config("qwen3-4b").reduced().replace(remat=False,
                                                   dtype="float32")
    jp = jax.device_get(JR.init_params(jax.random.PRNGKey(0), jc))
    tree = {"params": jp, "step": np.int32(4),
            "mask": np.array([True, False])}
    path = str(tmp_path / "lm.npz")
    jsave_pytree(path, tree)
    got = load_pytree(path, device="cpu")
    _same_tree(got, tree)
    assert got["step"].dtype == torch.int32 and got["step"].dim() == 0
    assert torch.equal(flatten_tree(got["params"]),
                       flatten_tree(params_from_jax(jp, device="cpu")))


def test_server_state_both_ways(tmp_path):
    model = _lm_tree()["params"]
    groups = [[0, 3], [1], [2, 4]]
    meta = {"strategy": "asyncfleo-hap", "seed": 0}
    path = str(tmp_path / "server.npz")
    save_server_state(path, global_model=model, epoch=5, grouping=groups,
                      metadata=meta)
    jm, jside = jload_server_state(path)
    assert jside == {"epoch": 5, "grouping": groups, "metadata": meta}
    _same_tree(model, jm)
    path2 = str(tmp_path / "server_jax.npz")
    jsave_server_state(path2, global_model=jm, epoch=6)
    m, side = load_server_state(path2, device="cpu")
    assert side == {"epoch": 6, "grouping": [], "metadata": {}}
    _same_tree(m, jm)
    with open(path2 + ".json") as f:
        assert json.load(f) == side


def test_load_on_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: nothing to refuse")
    path = str(tmp_path / "t.npz")
    save_pytree(path, {"w": torch.ones(2)})
    with pytest.raises(RuntimeError, match="cuda"):
        load_pytree(path)


def test_fl_train_saves_the_final_model_and_resumes(tmp_path, capsys):
    ckpt = str(tmp_path / "out" / "server.npz")
    out = fl_train.main(FL_ARGV + ["--checkpoint", ckpt])
    hist, sim = out["history"], out["sim"]
    assert len(hist) == 2 and f"server state -> {ckpt}" in \
        capsys.readouterr().out
    # C-ref 4: the saved model is the last commit, not w0
    jm, side = jload_server_state(ckpt)
    assert side["epoch"] == hist[-1].epoch
    assert side["grouping"] == sim.grouping.groups
    saved = np.concatenate([np.asarray(x).ravel()
                            for x in jax.tree_util.tree_leaves(jm)])
    assert np.array_equal(saved, sim._w_flat.numpy())
    assert not np.array_equal(saved, flatten_tree(out["w0"]).numpy())
    _same_tree(out["w_final"], jm)
    # --resume from it: the run starts from the saved model
    out2 = fl_train.main(FL_ARGV[:3] + ["1"] + FL_ARGV[4:]
                         + ["--resume", ckpt])
    assert f"resumed from {ckpt} at epoch {hist[-1].epoch}" in \
        capsys.readouterr().out
    assert np.array_equal(flatten_tree(out2["w0"]).numpy(), saved)
    assert len(out2["history"]) == 1


def test_fl_train_resumes_from_a_jax_checkpoint(tmp_path, capsys):
    from repro_torch.configs import MNIST_MLP
    w = cnn.init_params(9, MNIST_MLP, device="cpu")
    path = str(tmp_path / "jax_server.npz")
    jsave_server_state(path, global_model={k: v.numpy() for k, v in
                                           w.items()}, epoch=3)
    out = fl_train.main(FL_ARGV[:3] + ["1"] + FL_ARGV[4:]
                        + ["--resume", path])
    assert "at epoch 3" in capsys.readouterr().out
    assert torch.equal(flatten_tree(out["w0"]), flatten_tree(w))


def test_fl_train_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="cuda"):
        fl_train.main(["--epochs", "1"])
