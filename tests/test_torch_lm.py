"""Port vs JAX package: the LM serving path (configs, layers, the dense /
vlm / audio transformer, registry, steps, the serving entry point).

Weights are drawn by the JAX package and carried across with
``params_from_jax``; inputs come from numpy seeds.  Tolerances:
* layers, f32: the same arithmetic in another order (1e-5);
* whole models, reduced configs in f32: the kernel route against the JAX
  package's Pallas route (interpret mode), and the plain route against
  its XLA route, at 2e-4, the JAX package's own route-parity tolerance
  (``tests/test_models.py::test_pallas_attention_path_in_model``);
* decode over S steps against the JAX package's decode at 1e-4, its own
  decode-vs-forward tolerance (``tests/test_models.py``).
The JAX side's interpret-mode Pallas is slow, so sequences stay at S <= 32.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS, SHAPES as JSHAPES
from repro.launch import steps as jsteps
from repro.models import layers as JL
from repro.models import registry as JR
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.core.modelbank import params_from_jax, params_to_jax
from repro_torch.launch import steps
from repro_torch.models import layers as L
from repro_torch.models import registry as R
from repro_torch.serve_decode import main as serve_main

KEY = jax.random.PRNGKey(3)


def _reduced(arch):
    return ARCHS[arch].reduced().replace(remat=False, dtype="float32")


def _jreduced(arch):
    return JARCHS[arch].reduced().replace(remat=False, dtype="float32")


def _carry(jparams):
    return params_from_jax(jax.device_get(jparams), device="cpu")


def _close(got, want, atol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0)


# --------------------------------------------------------------------------
# configs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(JARCHS))
def test_config_and_reduced_equal_jax(arch):
    assert sorted(ARCHS) == sorted(JARCHS)
    assert dataclasses.asdict(ARCHS[arch]) == dataclasses.asdict(JARCHS[arch])
    assert (dataclasses.asdict(ARCHS[arch].reduced())
            == dataclasses.asdict(JARCHS[arch].reduced()))
    assert ARCHS[arch].resolved_head_dim == JARCHS[arch].resolved_head_dim


def test_window_and_cache_len_for_every_arch_and_shape():
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JSHAPES.items()}
    for arch in JARCHS:
        for shape in JSHAPES:
            c, s = ARCHS[arch], SHAPES[shape]
            jc, js = JARCHS[arch], JSHAPES[shape]
            assert steps.window_for(c, s) == jsteps.window_for(jc, js)
            assert steps.cache_len_for(c, s) == jsteps.cache_len_for(jc, js)


@pytest.mark.parametrize("arch", ["qwen3-4b", "granite-8b", "internvl2-1b",
                                  "hubert-xlarge", "deepseek-v2-236b",
                                  "kimi-k2-1t-a32b"])
def test_param_count_and_tree_equal_jax(arch):
    assert (R.analytic_param_count(ARCHS[arch])
            == JR.analytic_param_count(JARCHS[arch]))
    if arch == "qwen3-4b":
        assert R.analytic_param_count(ARCHS[arch]) == 4_411_424_256
    jp = jax.device_get(JR.init_params(KEY, _jreduced(arch)))
    tp = R.init_params(0, _reduced(arch), device="cpu")
    shapes = jax.tree_util.tree_map(np.shape, jp)
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), tp,
                                  is_leaf=torch.is_tensor) == shapes


def test_nested_params_round_trip():
    jp = jax.device_get(JR.init_params(KEY, _jreduced("qwen3-4b")))
    back = params_to_jax(params_from_jax(jp, device="cpu"))
    leaves, tree = jax.tree_util.tree_flatten(jp)
    bleaves, btree = jax.tree_util.tree_flatten(back)
    assert tree == btree
    for a, b in zip(leaves, bleaves):
        assert b.dtype == np.float32 and np.array_equal(a, b)


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------

def test_rms_norm_rope_mlp_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 12, 4, 64)).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    _close(L.rms_norm(torch.tensor(x), torch.tensor(scale)),
           JL.rms_norm(jnp.asarray(x), jnp.asarray(scale)), 1e-5)
    pos = np.broadcast_to(np.arange(12) * 37, (2, 12)).copy()
    for arr in (x, x[:, :, 0]):              # with and without a heads axis
        _close(L.apply_rope(torch.tensor(arr), torch.tensor(pos), 1e6),
               JL.apply_rope(jnp.asarray(arr), jnp.asarray(pos), 1e6), 1e-5)
    jp = jax.device_get(JL.init_mlp(KEY, 64, 96))
    h = rng.standard_normal((2, 12, 64)).astype(np.float32)
    _close(L.mlp(_carry(jp), torch.tensor(h)),
           JL.mlp(jp, jnp.asarray(h)), 1e-5)


@pytest.mark.parametrize("window,q_chunks,impl", [
    (0, 1, "plain"), (5, 1, "plain"), (0, 4, "plain"), (5, 4, "plain"),
    (0, 1, "kernel"), (5, 1, "kernel")])
def test_attention_block_matches_jax(window, q_chunks, impl):
    cfg, jcfg = _reduced("qwen3-4b"), _jreduced("qwen3-4b")
    jp = jax.device_get(JL.init_attention(KEY, jcfg))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(16), (2, 16)).copy()
    want, _ = JL.attention(jp, jcfg, jnp.asarray(x), jnp.asarray(pos),
                           window=window, q_chunks=q_chunks,
                           impl="pallas" if impl == "kernel" else "xla")
    got, cache = L.attention(_carry(jp), cfg, torch.tensor(x),
                             torch.tensor(pos), window=window,
                             q_chunks=q_chunks, impl=impl)
    assert cache is None
    _close(got, want, 1e-5)


def test_attention_refuses_unknown_impl():
    cfg = _reduced("qwen3-4b")
    p = R.init_params(0, cfg, device="cpu")["layers"]["attn"]
    with pytest.raises(ValueError, match="impl"):
        L.attention({k: v[0] for k, v in p.items()}, cfg,
                    torch.zeros((1, 4, cfg.d_model)),
                    torch.zeros((1, 4), dtype=torch.long), impl="pallas")


# --------------------------------------------------------------------------
# whole models
# --------------------------------------------------------------------------

def _batch(cfg, B, S, seed=0):
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio_stub":
        return {"frame_embeds": rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)}
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.frontend == "vision_stub":
        b["prefix_embeds"] = rng.standard_normal(
            (B, cfg.num_prefix_embeds, cfg.d_model)).astype(np.float32)
    return b


def _to_torch(batch):
    return {k: torch.tensor(v.astype(np.int64) if v.dtype == np.int32 else v)
            for k, v in batch.items()}


@pytest.mark.parametrize("arch", ["qwen3-4b", "llama3-8b", "granite-8b",
                                  "starcoder2-3b", "internvl2-1b",
                                  "hubert-xlarge"])
def test_model_routes_match_jax(arch):
    cfg, jcfg = _reduced(arch), _jreduced(arch)
    jp = JR.init_params(KEY, jcfg)
    tp = _carry(jp)
    batch = _batch(cfg, 2, 24)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = _to_torch(batch)
    want_k, _ = JR.apply(jp, jcfg, jb, impl="pallas")
    got_k, aux = R.apply(tp, cfg, tb, impl="kernel")
    assert float(aux) == 0.0
    _close(got_k, want_k, 2e-4)
    want_p, _ = JR.apply(jp, jcfg, jb, impl="xla")
    got_p, _ = R.apply(tp, cfg, tb, impl="plain")
    _close(got_p, want_p, 2e-4)
    jloss, jm = JR.train_loss(jp, jcfg, dict(
        jb, labels=jnp.asarray(np.arange(24 * 2).reshape(2, 24) % 7)))
    tloss, tm = R.train_loss(tp, cfg, dict(
        tb, labels=torch.arange(24 * 2).reshape(2, 24) % 7))
    assert abs(float(tloss) - float(jloss)) <= 2e-4
    assert abs(float(tm["ce"]) - float(jm["ce"])) <= 2e-4


def test_hubert_at_its_published_head_dim_matches_jax():
    """hubert-xlarge at head dim 80 (d_model 160 over 2 heads, the
    published 1280 / 16), 2 layers: the kernel route against the JAX
    package's Pallas route in interpret mode."""
    kw = dict(num_layers=2, d_model=160, num_heads=2, num_kv_heads=2,
              d_ff=640, remat=False, dtype="float32")
    cfg, jcfg = ARCHS["hubert-xlarge"].replace(**kw), \
        JARCHS["hubert-xlarge"].replace(**kw)
    assert cfg.resolved_head_dim == 80
    jp = JR.init_params(KEY, jcfg)
    batch = _batch(cfg, 2, 24)
    want, _ = JR.apply(jp, jcfg, {k: jnp.asarray(v) for k, v in
                                  batch.items()}, impl="pallas")
    got, _ = R.apply(_carry(jp), cfg, _to_torch(batch), impl="kernel")
    assert got.shape == (2, 24, cfg.vocab_size)
    _close(got, want, 2e-4)


@pytest.mark.parametrize("arch,S,window,cache_len", [
    ("qwen3-4b", 12, 0, 12), ("llama3-8b", 12, 0, 16),
    ("granite-8b", 12, 0, 12), ("starcoder2-3b", 12, 0, 12),
    ("qwen3-4b", 24, 8, 8),             # the ring buffer, W = cache_len
])
def test_decode_matches_jax(arch, S, window, cache_len):
    cfg, jcfg = _reduced(arch), _jreduced(arch)
    jp = JR.init_params(KEY, jcfg)
    tp = _carry(jp)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, S))
    jstep = jax.jit(lambda c, t: JR.decode_step(jp, jcfg, c, t,
                                                window=window))
    jc = JR.init_cache(jcfg, 2, cache_len, jnp.float32)
    tc = R.init_cache(cfg, 2, cache_len, torch.float32, device="cpu")
    step = steps.make_decode_step(cfg, window=window)
    for t in range(S):
        jl, jc = jstep(jc, jnp.asarray(toks[:, t:t + 1], jnp.int32))
        tl, tc = step(tp, tc, torch.tensor(toks[:, t:t + 1]))
        assert tl.shape == (2, 1, cfg.vocab_size)
        _close(tl, jl, 1e-4)
    assert tc["index"] == int(jc["index"]) == S
    _close(tc["k"], jc["k"], 1e-4)
    _close(tc["v"], jc["v"], 1e-4)
    # and decode equals the port's own full forward (the ring buffer with
    # the same window)
    full, _ = R.apply(tp, cfg, {"tokens": torch.tensor(toks)},
                      window=window)
    tc = R.init_cache(cfg, 2, cache_len, torch.float32, device="cpu")
    outs = []
    for t in range(S):
        tl, tc = R.decode_step(tp, cfg, tc, torch.tensor(toks[:, t:t + 1]),
                               window=window)
        outs.append(tl[:, 0])
    assert float((torch.stack(outs, 1) - full).abs().max()) < 1e-4


def test_prefill_step_matches_jax():
    cfg, jcfg = _reduced("qwen3-4b"), _jreduced("qwen3-4b")
    jp = JR.init_params(KEY, jcfg)
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (1, 32))
    want = jsteps.make_prefill_step(jcfg, impl="pallas")(
        jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    got = steps.make_prefill_step(cfg, impl="kernel")(
        _carry(jp), {"tokens": torch.tensor(toks)})
    _close(got, want, 2e-4)


def test_kernel_route_is_the_default(monkeypatch):
    """Callers that name no route reach flash_attention once a layer;
    only impl="plain", named, and decode take the plain route."""
    calls = []

    def spy(*args, **kw):
        calls.append(1)
        return flash_attention(*args, **kw)

    flash_attention = L.flash_attention
    monkeypatch.setattr(L, "flash_attention", spy)
    cfg = _reduced("qwen3-4b")
    params = R.init_params(0, cfg, device="cpu")
    toks = torch.tensor(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (1, 8)))
    n = cfg.num_layers
    steps.make_prefill_step(cfg)(params, {"tokens": toks})
    R.apply(params, cfg, {"tokens": toks})
    R.train_loss(params, cfg, {"tokens": toks})
    assert len(calls) == 3 * n
    R.apply(params, cfg, {"tokens": toks}, impl="plain")
    cache = R.init_cache(cfg, 1, 4, torch.float32, device="cpu")
    steps.make_decode_step(cfg)(params, cache, toks[:, :1])
    assert len(calls) == 3 * n


# --------------------------------------------------------------------------
# the serving entry point
# --------------------------------------------------------------------------

def test_serve_decode_runs_on_the_cpu(capsys):
    res = serve_main(["--device", "cpu", "--batch", "2", "--tokens", "5",
                      "--cache-len", "4", "--window", "4",
                      "--prefill-len", "16"])
    out = capsys.readouterr().out
    assert "tok/s on CPU" in out and "prefill 2x16" in out
    assert res["tokens"].shape == (2, 5)
    assert res["prefill_logits_shape"] == (2, 16, res["cfg"].vocab_size)
    assert len(res["step_s"]) == 5 and torch.isfinite(res["logits"]).all()
    assert serve_main(["--device", "cpu", "--arch", "hubert-xlarge"]) is None
    assert "encoder-only" in capsys.readouterr().out


def test_serve_decode_deepseek_v2_runs_on_the_cpu(capsys):
    """MLA and MoE: the prefill in the expanded form, decode in the
    absorbed form over a 4-slot latent ring that wraps."""
    res = serve_main(["--device", "cpu", "--arch", "deepseek-v2-236b",
                      "--batch", "2", "--tokens", "6", "--cache-len", "4",
                      "--prefill-len", "16"])
    out = capsys.readouterr().out
    assert "tok/s on CPU" in out and "prefill 2x16" in out
    assert res["cfg"].use_mla and res["cfg"].is_moe
    assert res["tokens"].shape == (2, 6)
    assert res["prefill_logits_shape"] == (2, 16, res["cfg"].vocab_size)
    assert torch.isfinite(res["logits"]).all()


def test_serve_decode_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        serve_main(["--tokens", "1"])
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        R.init_params(0, _reduced("qwen3-4b"))
