"""Port vs JAX package: the MoE FFN and MLA (``models/moe.py``), the moe
family's transformer (``lead_layers``, the MLA latent cache, the aux
loss) and its two archs, deepseek-v2 (MLA + MoE) and kimi-k2 (GQA + MoE),
through the registry, the steps and the serving entry point.

Weights are drawn by the JAX package and carried across with
``params_from_jax``.  The JAX init leaves the norm scales at 1, which
would hide their paths, so the tests set them to random values first (the
same values on both sides).  Inputs come from numpy seeds.  Tolerances:
* one MoE FFN or MLA block, f32: the same arithmetic in another order
  (1e-5), at a capacity that drops nothing (factor 64) and at a tight one
  (0.25) where the same assignments must drop on both sides;
* whole reduced models in f32 (MoE capacity factor 64, as the JAX
  package's own decode tests use, so prefill and decode drop nothing):
  logits, aux and loss at 1e-4, the kimi-k2 kernel route against the
  JAX package's Pallas route (interpret mode) at 2e-4, its route-parity
  tolerance; decode over 16 steps against the JAX package's decode and
  against the port's full forward at 1e-4, its decode-vs-forward
  tolerance (``tests/test_models.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.models import moe as JMOE
from repro.models import registry as JR
from repro_torch.configs import ARCHS
from repro_torch.core.modelbank import params_from_jax, params_to_jax
from repro_torch.launch import steps
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import registry as R
from repro_torch.models.transformer import layer_view
from repro_torch.serve_decode import main as serve_main

KEY = jax.random.PRNGKey(11)
DS, KIMI = "deepseek-v2-236b", "kimi-k2-1t-a32b"
# the model variants: reduced deepseek-v2 (MLA through wq), the same with
# a query low-rank branch (w_dq, q_norm, w_uq: the published config's
# branch), reduced kimi-k2 (GQA attention)
VARIANTS = {"ds": (DS, {}), "ds-qlora": (DS, dict(q_lora_rank=32)),
            "kimi": (KIMI, {})}
NORMS = ("ln1", "ln2", "kv_norm", "q_norm", "final_norm")


def _cfgs(variant="ds", **kw):
    arch, extra = VARIANTS[variant]
    kw = {"remat": False, "dtype": "float32", "moe_capacity_factor": 64.0,
          **extra, **kw}
    return (ARCHS[arch].reduced().replace(**kw),
            JARCHS[arch].reduced().replace(**kw))


def _randomize_norms(tree, rng):
    for k, v in tree.items():
        if isinstance(v, dict):
            _randomize_norms(v, rng)
        elif k in NORMS:
            tree[k] = (1.0 + 0.3 * rng.standard_normal(v.shape)
                       ).astype(np.float32)
    return tree


def _params(variant="ds", seed=0):
    """JAX params (numpy, the norms random), as jnp, and the port's copy."""
    _, jcfg = _cfgs(variant)
    jp = _randomize_norms(jax.device_get(JR.init_params(KEY, jcfg)),
                          np.random.default_rng(seed))
    return jax.tree.map(jnp.asarray, jp), params_from_jax(jp, device="cpu")


def _close(got, want, atol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0)


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))


def _x(cfg, B, S, seed=0, spread=0.5):
    return (spread * np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model))).astype(np.float32)


def _layer0(jp, tp, key):
    """Layer 0 of the MoE stack (``layers``) or of the dense lead stack."""
    return jax.tree.map(lambda a: a[0], jp[key]), layer_view(tp[key], 0)


# --------------------------------------------------------------------------
# the MoE FFN
# --------------------------------------------------------------------------

@pytest.mark.parametrize("tokens", [1, 2, 4, 31, 32, 512, 8192])
@pytest.mark.parametrize("experts,top_k,factor", [
    (4, 2, 1.25), (4, 2, 0.25), (4, 2, 64.0), (160, 6, 1.25),
    (384, 8, 1.25), (160, 6, 64.0)])
def test_moe_capacity_equals_jax(tokens, experts, top_k, factor):
    got = MOE.moe_capacity(tokens, experts, top_k, factor)
    assert got == JMOE.moe_capacity(tokens, experts, top_k, factor)
    assert got % 8 == 0 and got >= 8
    if (tokens, experts, top_k, factor) == (8192, 160, 6, 1.25):
        assert got == 384                  # deepseek-v2's serving prefill


@pytest.mark.parametrize("variant", ["ds", "kimi"])
@pytest.mark.parametrize("factor", [64.0, 0.25])
def test_moe_ffn_matches_jax(variant, factor):
    """The layer's output and aux loss; at 0.25 some assignments drop,
    the same ones on both sides (a different drop moves the output by
    far more than the tolerance)."""
    cfg, jcfg = _cfgs(variant)
    jp, tp = _params(variant)
    jl, tl = _layer0(jp, tp, "layers")
    x = _x(cfg, 2, 16)
    want, jaux = JMOE.moe_ffn(jl["ffn"], jcfg, jnp.asarray(x),
                              capacity_factor=factor)
    got, aux = MOE.moe_ffn(tl["ffn"], cfg, torch.tensor(x),
                           capacity_factor=factor)
    assert got.shape == x.shape and aux.dtype == torch.float32
    _close(got, want, 1e-5)
    assert abs(float(aux) - float(jaux)) <= 1e-6 and float(aux) > 0.0
    T, E, k = 32, cfg.num_experts, cfg.top_k
    counts = torch.bincount(MOE.route(tl["ffn"], cfg, torch.tensor(
        x).reshape(T, -1))[2].flatten(), minlength=E)
    dropped = int((counts - MOE.moe_capacity(T, E, k, factor))
                  .clamp(min=0).sum())
    assert (dropped > 0) == (factor < 1.0)
    if factor < 1.0:           # the drops change the output
        loose, _ = MOE.moe_ffn(tl["ffn"], cfg, torch.tensor(x),
                               capacity_factor=64.0)
        assert float((loose - got).abs().max()) > 1e-3


@pytest.mark.parametrize("variant", ["ds", "kimi"])
def test_moe_ffn_reference_matches_jax_and_moe_ffn(variant):
    cfg, jcfg = _cfgs(variant)
    jp, tp = _params(variant, seed=1)
    jl, tl = _layer0(jp, tp, "layers")
    x = _x(cfg, 2, 16, seed=1)
    ref = MOE.moe_ffn_reference(tl["ffn"], cfg, torch.tensor(x))
    _close(ref, JMOE.moe_ffn_reference(jl["ffn"], jcfg, jnp.asarray(x)),
           1e-5)
    out, _ = MOE.moe_ffn(tl["ffn"], cfg, torch.tensor(x),
                         capacity_factor=64.0)
    _close(out, ref.numpy(), 1e-5)


def test_moe_ffn_in_bf16_matches_jax():
    """bf16 compute over f32 weights, the serving dtypes: within two bf16
    spacings of outputs of order 1."""
    cfg, jcfg = _cfgs("ds", dtype="bfloat16")
    jp, tp = _params("ds", seed=2)
    jl, tl = _layer0(jp, tp, "layers")
    x = _x(cfg, 2, 16, seed=2)
    want, jaux = JMOE.moe_ffn(jl["ffn"], jcfg,
                              jnp.asarray(x, jnp.bfloat16))
    got, aux = MOE.moe_ffn(tl["ffn"], cfg,
                           torch.tensor(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    _close(got, np.asarray(want, np.float32), 2 ** -6)
    assert abs(float(aux) - float(jaux)) <= 1e-5


# --------------------------------------------------------------------------
# MLA
# --------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["ds", "ds-qlora"])
@pytest.mark.parametrize("q_chunks,window", [(1, 0), (4, 0), (1, 5),
                                             (4, 5)])
def test_mla_prefill_matches_jax(variant, q_chunks, window):
    cfg, jcfg = _cfgs(variant)
    jp, tp = _params(variant, seed=3)
    jl, tl = _layer0(jp, tp, "lead_layers")
    assert ("w_dq" in tl["attn"]) == (variant == "ds-qlora")
    x = _x(cfg, 2, 16, seed=3)
    pos = np.broadcast_to(np.arange(16) * 3, (2, 16)).copy()
    want, _ = JMOE.mla_attention(jl["attn"], jcfg, jnp.asarray(x),
                                 jnp.asarray(pos), window=window,
                                 q_chunks=q_chunks)
    got, cache = MOE.mla_attention(tl["attn"], cfg, torch.tensor(x),
                                   torch.tensor(pos), window=window,
                                   q_chunks=q_chunks)
    assert cache is None
    _close(got, want, 1e-5)


@pytest.mark.parametrize("variant", ["ds", "ds-qlora"])
@pytest.mark.parametrize("window", [0, 4])
def test_mla_absorbed_decode_matches_jax_across_a_wrap(variant, window):
    """12 steps over a 6-slot latent ring: the absorbed decode's output
    each step and both latent caches against the JAX package's."""
    cfg, jcfg = _cfgs(variant)
    jp, tp = _params(variant, seed=4)
    jl, tl = _layer0(jp, tp, "layers")
    B, steps_n, cache_len = 2, 12, 6
    xs = _x(cfg, B, steps_n, seed=4)
    jc = {"c_kv": jnp.zeros((B, cache_len, cfg.kv_lora_rank)),
          "k_rope": jnp.zeros((B, cache_len, cfg.rope_head_dim)),
          "index": jnp.zeros((), jnp.int32)}
    tc = {"c_kv": torch.zeros((B, cache_len, cfg.kv_lora_rank)),
          "k_rope": torch.zeros((B, cache_len, cfg.rope_head_dim)),
          "index": 0}
    jstep = jax.jit(lambda c, x: JMOE.mla_attention(
        jl["attn"], jcfg, x, None, c, window=window))
    for t in range(steps_n):
        want, jc = jstep(jc, jnp.asarray(xs[:, t:t + 1]))
        tc["k_pos"] = L.ring_positions(tc["index"], cache_len, "cpu")
        got, tc = MOE.mla_attention(tl["attn"], cfg,
                                    torch.tensor(xs[:, t:t + 1]), None, tc,
                                    window=window)
        assert got.shape == (B, 1, cfg.d_model)
        _close(got, want, 1e-5)
    assert tc["index"] == int(jc["index"]) == steps_n
    _close(tc["c_kv"], jc["c_kv"], 1e-5)
    _close(tc["k_rope"], jc["k_rope"], 1e-5)


# --------------------------------------------------------------------------
# param trees and counts
# --------------------------------------------------------------------------

FULL_COUNTS = {DS: (235_741_434_880, 21_329_280_000),
               KIMI: (1_028_298_994_688, 34_590_553_088)}


@pytest.mark.parametrize("arch", [DS, KIMI])
@pytest.mark.parametrize("width", ["reduced", "full"])
def test_param_tree_and_count_equal_jax(arch, width):
    if width == "full":
        cfg, jcfg = ARCHS[arch], JARCHS[arch]
        jshapes = jax.tree_util.tree_map(
            lambda s: tuple(s.shape),
            jax.eval_shape(lambda k: JR.init_params(k, jcfg), KEY))
        tp = R.init_params(0, cfg, device="meta")
        total, active = FULL_COUNTS[arch]
        assert R.analytic_param_count(cfg) == total
        assert R.analytic_param_count(cfg, active_only=True) == active
    else:
        cfg, jcfg = ARCHS[arch].reduced(), JARCHS[arch].reduced()
        jshapes = jax.tree_util.tree_map(
            np.shape, jax.device_get(JR.init_params(KEY, jcfg)))
        tp = R.init_params(0, cfg, device="cpu")
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), tp,
                                  is_leaf=torch.is_tensor) == jshapes
    for active_only in (False, True):
        assert (R.analytic_param_count(cfg, active_only)
                == JR.analytic_param_count(jcfg, active_only))
    n_lead = cfg.first_dense_layers
    assert tp["lead_layers"]["ffn"]["w1"].shape[0] == n_lead
    assert tp["layers"]["ffn"]["we1"].shape == (
        cfg.num_layers - n_lead, cfg.num_experts, cfg.d_model, cfg.moe_d_ff)
    assert ("w_uk" in tp["layers"]["attn"]) == cfg.use_mla


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_params_carry_across_both_ways(variant):
    _, jcfg = _cfgs(variant)
    jp = jax.device_get(JR.init_params(KEY, jcfg))
    back = params_to_jax(params_from_jax(jp, device="cpu"))
    leaves, tree = jax.tree_util.tree_flatten(jp)
    bleaves, btree = jax.tree_util.tree_flatten(back)
    assert tree == btree and "lead_layers" in back
    assert all(np.array_equal(a, b) for a, b in zip(leaves, bleaves))


# --------------------------------------------------------------------------
# whole models
# --------------------------------------------------------------------------

@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_model_matches_jax(variant):
    """Logits, aux and the loss (with 0.01 aux) of the reduced model, the
    kernel route against the JAX package's Pallas route and the plain
    route against its XLA route; MLA takes the same plain path on both."""
    cfg, jcfg = _cfgs(variant)
    jp, tp = _params(variant, seed=5)
    S = 24
    toks = _tokens(cfg, 2, S, seed=5)
    jb = {"tokens": jnp.asarray(toks, jnp.int32)}
    tb = {"tokens": torch.tensor(toks)}
    for impl, jimpl, tol in (("kernel", "pallas", 2e-4),
                             ("plain", "xla", 1e-4)):
        want, jaux = JR.apply(jp, jcfg, jb, impl=jimpl)
        got, aux = R.apply(tp, cfg, tb, impl=impl)
        assert got.shape == (2, S, cfg.vocab_size)
        _close(got, want, tol)
        assert float(aux) > 0.0 and abs(float(aux) - float(jaux)) <= 1e-5
    assert torch.equal(steps.make_prefill_step(cfg, impl="plain")(tp, tb),
                       got)
    jloss, jm = JR.train_loss(jp, jcfg, jb, impl="xla")
    tloss, tm = R.train_loss(tp, cfg, tb, impl="plain")
    assert abs(float(tm["aux"]) - float(jm["aux"])) <= 1e-5
    assert abs(float(tloss) - float(jloss)) <= 1e-4
    assert float(tloss) == pytest.approx(
        float(tm["ce"]) + R.MOE_AUX_WEIGHT * float(tm["aux"]), abs=1e-6)
    assert R.MOE_AUX_WEIGHT == JR.MOE_AUX_WEIGHT == 0.01


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_decode_matches_jax(variant):
    """16 steps over a 16-slot cache: logits each step and the whole cache
    at the end against the JAX package's decode."""
    cfg, jcfg = _cfgs(variant)
    jp, tp = _params(variant, seed=6)
    B, T = 2, 16
    toks = _tokens(cfg, B, T, seed=6)
    jstep = jax.jit(lambda c, t: JR.decode_step(jp, jcfg, c, t))
    jc = JR.init_cache(jcfg, B, T, jnp.float32)
    tc = R.init_cache(cfg, B, T, torch.float32, device="cpu")
    assert sorted(tc) == sorted(jc)
    step = steps.make_decode_step(cfg)
    for t in range(T):
        jl, jc = jstep(jc, jnp.asarray(toks[:, t:t + 1], jnp.int32))
        tl, tc = step(tp, tc, torch.tensor(toks[:, t:t + 1]))
        assert tl.shape == (B, 1, cfg.vocab_size)
        _close(tl, jl, 1e-4)
    assert tc["index"] == int(jc["index"]) == T
    for name in tc:
        if name != "index":
            assert tc[name].shape[0] == cfg.num_layers
            _close(tc[name], jc[name], 1e-4)


@pytest.mark.parametrize("variant,window,cache_len", [
    ("ds", 0, 16), ("ds-qlora", 0, 16), ("kimi", 0, 16),
    ("ds", 6, 6)])                        # the latent ring, W = cache_len
def test_decode_matches_the_full_forward(variant, window, cache_len):
    cfg, _ = _cfgs(variant)
    _, tp = _params(variant, seed=7)
    B, T = 2, 16
    toks = torch.tensor(_tokens(cfg, B, T, seed=7))
    cache = R.init_cache(cfg, B, cache_len, torch.float32, device="cpu")
    outs = []
    for t in range(T):
        lg, cache = R.decode_step(tp, cfg, cache, toks[:, t:t + 1],
                                  window=window)
        outs.append(lg[:, 0])
    dec = torch.stack(outs, 1)
    for impl in ("kernel", "plain"):
        full, _ = R.apply(tp, cfg, {"tokens": toks}, window=window,
                          impl=impl)
        assert float((dec - full).abs().max()) < 1e-4


@pytest.mark.parametrize("variant", ["ds", "ds-qlora"])
def test_mla_q_chunks_equal_one_chunk(variant):
    cfg, _ = _cfgs(variant)
    _, tp = _params(variant, seed=8)
    toks = {"tokens": torch.tensor(_tokens(cfg, 2, 32, seed=8))}
    one, aux1 = R.apply(tp, cfg, toks)
    four, aux4 = R.apply(tp, cfg, toks, q_chunks=4)
    assert float((one - four).abs().max()) < 1e-5
    assert abs(float(aux1) - float(aux4)) < 1e-6


def test_routes_reach_flash_attention_as_the_family_says(monkeypatch):
    """kimi-k2's prefill reaches flash_attention once a layer (the lead
    layer too); deepseek-v2's MLA never; decode never."""
    calls = []

    def spy(*args, **kw):
        calls.append(args[0].shape)
        return flash_attention(*args, **kw)

    flash_attention = L.flash_attention
    monkeypatch.setattr(L, "flash_attention", spy)
    for variant, want in (("kimi", 2), ("ds", 0), ("ds-qlora", 0)):
        calls.clear()
        cfg, _ = _cfgs(variant)
        params = R.init_params(0, cfg, device="cpu")
        toks = torch.tensor(_tokens(cfg, 1, 8, seed=9))
        steps.make_prefill_step(cfg)(params, {"tokens": toks})
        assert len(calls) == want == (cfg.num_layers if variant == "kimi"
                                      else 0)
        R.apply(params, cfg, {"tokens": toks}, impl="plain")
        cache = R.init_cache(cfg, 1, 4, torch.float32, device="cpu")
        steps.make_decode_step(cfg)(params, cache, toks[:, :1])
        assert len(calls) == want


def test_moe_combine_is_deterministic():
    """The combine writes each (token, j) slot once: two calls agree bit
    for bit, drops included."""
    cfg, _ = _cfgs("ds")
    _, tp = _params("ds", seed=10)
    tl = layer_view(tp["layers"], 0)
    x = torch.tensor(_x(cfg, 2, 32, seed=10))
    a, _ = MOE.moe_ffn(tl["ffn"], cfg, x, capacity_factor=0.25)
    b, _ = MOE.moe_ffn(tl["ffn"], cfg, x, capacity_factor=0.25)
    assert torch.equal(a, b)


# --------------------------------------------------------------------------
# the serving entry point
# --------------------------------------------------------------------------

def test_serve_decode_kimi_k2_runs_on_the_cpu(capsys):
    """(deepseek-v2's case is in ``tests/test_torch_lm.py``.)"""
    res = serve_main(["--device", "cpu", "--arch", KIMI, "--batch", "2",
                      "--tokens", "4", "--prefill-len", "16",
                      "--cache-len", "8"])
    out = capsys.readouterr().out
    assert "tok/s on CPU" in out and "prefill 2x16" in out
    assert res["cfg"].family == "moe" and res["tokens"].shape == (2, 4)
    assert res["prefill_logits_shape"] == (2, 16, res["cfg"].vocab_size)
    assert torch.isfinite(res["logits"]).all()


def test_moe_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: nothing to refuse")
    for variant in ("ds", "kimi"):
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            R.init_params(0, _cfgs(variant)[0])
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            R.init_cache(_cfgs(variant)[0], 1, 8, torch.float32)
