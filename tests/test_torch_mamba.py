"""Port vs JAX package: Mamba2 and the hybrid family (``models/mamba.py``,
the registry's ``hybrid`` branches, zamba2 through the serving entry
point).

Weights are drawn by the JAX package and carried across with
``params_from_jax``.  The JAX init leaves the conv bias, ``A_log``, ``D``,
``dt_bias`` and the norm scales at constants, which would hide their
paths, so the tests set them to random values first (the same values on
both sides).  Inputs come from numpy seeds.  Tolerances:
* the causal conv, f32: the same arithmetic (1e-6), its state exactly;
* one Mamba2 block, f32, with a state carried in: 1e-4 on the output and
  both states, the port's plain route against the JAX package's jnp route
  and its kernel route against the Pallas kernel (interpret mode);
* whole reduced models in f32: 2e-4, the JAX package's own route-parity
  tolerance (``tests/test_models.py``), the kernel route against its
  Pallas route and the plain route against its XLA route;
* decode against the JAX package's decode and against the port's full
  forward at 1e-4, its own decode-vs-forward tolerance
  (``tests/test_models.py``).
Three model variants: ``reduced()`` (one group of 2 Mamba2 layers after
the shared block), ``num_layers=4`` (two groups: the shared weights are
reused and each group has its own KV cache) and ``d_model=320`` with 4
heads (the shared block at zamba2's head dim 80).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.models import mamba as JMB
from repro.models import registry as JR
from repro_torch.configs import ARCHS
from repro_torch.core.modelbank import params_from_jax
from repro_torch.kernels import chunk_scan as cs_pkg
from repro_torch.launch import steps
from repro_torch.models import layers as L
from repro_torch.models import mamba as MB
from repro_torch.models import registry as R
from repro_torch.serve_decode import main as serve_main

KEY = jax.random.PRNGKey(7)
ARCH = "zamba2-2.7b"
VARIANTS = {"g1": {}, "g2": dict(num_layers=4), "hd80": dict(d_model=320)}
# (mean, spread) of the values the constant-initialised params get
RANDOMIZED = {"conv_b": (0.0, 0.3), "A_log": (0.0, 0.5), "D": (1.0, 0.5),
              "dt_bias": (-2.0, 1.0), "ln": (1.0, 0.3),
              "out_norm": (1.0, 0.3)}
SHARED_NORMS = ("ln_a", "ln_m")


def _cfgs(variant="g1"):
    kw = dict(remat=False, dtype="float32", **VARIANTS[variant])
    return (ARCHS[ARCH].reduced().replace(**kw),
            JARCHS[ARCH].reduced().replace(**kw))


def _params(variant="g1", seed=0):
    """JAX params (numpy) with the constant-initialised ones set to random
    values; the port's copy of them."""
    _, jcfg = _cfgs(variant)
    jp = jax.device_get(JR.init_params(KEY, jcfg))
    rng = np.random.default_rng(seed)
    for name, (mean, spread) in RANDOMIZED.items():
        a = jp["mamba"][name]
        jp["mamba"][name] = (mean + spread * rng.standard_normal(a.shape)
                             ).astype(np.float32)
    for name in SHARED_NORMS:
        a = jp["shared"][name]
        jp["shared"][name] = (1.0 + 0.3 * rng.standard_normal(a.shape)
                              ).astype(np.float32)
    return jp, params_from_jax(jp, device="cpu")


def _close(got, want, atol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0)


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))


def _layer0(jp, tp):
    return (jax.tree.map(lambda a: jnp.asarray(a[0, 0]), jp["mamba"]),
            {k: v[0, 0] for k, v in tp["mamba"].items()})


# --------------------------------------------------------------------------
# the Mamba2 layer
# --------------------------------------------------------------------------

@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_jax(with_state):
    rng = np.random.default_rng(1)
    B, S, C = 2, 12, 40
    xc = rng.standard_normal((B, S, C)).astype(np.float32)
    w = rng.standard_normal((MB.CONV_K, C)).astype(np.float32)
    b = rng.standard_normal(C).astype(np.float32)
    st = (rng.standard_normal((B, MB.CONV_K - 1, C)).astype(np.float32)
          if with_state else None)
    want, want_st = JMB._causal_conv(
        jnp.asarray(xc), jnp.asarray(w), jnp.asarray(b),
        None if st is None else jnp.asarray(st))
    got, got_st = MB._causal_conv(torch.tensor(xc), torch.tensor(w),
                                  torch.tensor(b),
                                  None if st is None else torch.tensor(st))
    _close(got, want, 1e-6)
    assert np.array_equal(got_st.numpy(), np.asarray(want_st))
    assert got_st.shape == (B, MB.CONV_K - 1, C)


@pytest.mark.parametrize("S", [1, 32, 64])
def test_block_matches_jax(S):
    """One Mamba2 layer with a conv and an SSM state carried in: S = 1 is
    the recurrent step, S = 32 one chunk, S = 64 two."""
    cfg, jcfg = _cfgs()
    jp, tp = _params()
    jl, tl = _layer0(jp, tp)
    H, hd, d_inner, N = MB._dims(cfg)
    rng = np.random.default_rng(2)
    B = 2
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    conv = rng.standard_normal((B, MB.CONV_K - 1, d_inner + 2 * N)
                               ).astype(np.float32)
    ssm = (rng.standard_normal((B, H, N, hd)) * 0.1).astype(np.float32)
    jst = {"conv": jnp.asarray(conv), "ssm": jnp.asarray(ssm)}
    for impl, jimpl in (("plain", "jnp"), ("kernel", "pallas")):
        want, want_st = JMB.block(jl, jcfg, jnp.asarray(x), jst, impl=jimpl)
        got, got_st = MB.block(tl, cfg, torch.tensor(x),
                               {"conv": torch.tensor(conv),
                                "ssm": torch.tensor(ssm)}, impl=impl)
        assert got.shape == (B, S, cfg.d_model)
        assert got_st["ssm"].dtype == torch.float32
        _close(got, want, 1e-4)
        for name in ("conv", "ssm"):
            _close(got_st[name], want_st[name], 1e-4)


def test_block_passes_the_scan_views_without_a_copy(monkeypatch):
    """r is C broadcast over heads (head stride 0), v a view of the conv
    output (row stride d_inner + 2 N), the decay (B, S, H)."""
    seen = {}

    def spy(r, k, v, log_decay, *a, **kw):
        seen.update(r=r, k=k, v=v, ld=log_decay)
        return chunk_scan(r, k, v, log_decay, *a, **kw)

    chunk_scan = cs_pkg.chunk_scan
    monkeypatch.setattr(cs_pkg, "chunk_scan", spy)
    cfg, _ = _cfgs()
    _, tl = _layer0(*_params())
    H, hd, d_inner, N = MB._dims(cfg)
    B, S = 2, 64
    st = MB.init_state(cfg, B, torch.float32, device="cpu")
    x = np.random.default_rng(3).standard_normal((B, S, cfg.d_model))
    MB.block(tl, cfg, torch.tensor(x, dtype=torch.float32), st)
    r, k, v, ld = seen["r"], seen["k"], seen["v"], seen["ld"]
    assert r.shape == k.shape == (B, S, H, N) and r.stride(2) == 0
    assert v.shape == (B, S, H, hd)
    assert v.stride() == (S * (d_inner + 2 * N), d_inner + 2 * N, hd, 1)
    assert v.untyped_storage().data_ptr() == r.untyped_storage().data_ptr()
    assert k.is_contiguous() and ld.shape == (B, S, H)


# --------------------------------------------------------------------------
# params
# --------------------------------------------------------------------------

@pytest.mark.parametrize("width", ["reduced", "full"])
def test_param_tree_and_count_equal_jax(width):
    if width == "full":
        cfg, jcfg = ARCHS[ARCH], JARCHS[ARCH]
        jshapes = jax.tree_util.tree_map(
            lambda s: tuple(s.shape),
            jax.eval_shape(lambda k: JR.init_params(k, jcfg), KEY))
        tp = R.init_params(0, cfg, device="meta")
        assert R.analytic_param_count(cfg) == 2_417_134_160
    else:
        cfg, jcfg = _cfgs("g2")
        jshapes = jax.tree_util.tree_map(
            np.shape, jax.device_get(JR.init_params(KEY, jcfg)))
        tp = R.init_params(0, cfg, device="cpu")
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), tp,
                                  is_leaf=torch.is_tensor) == jshapes
    assert R.analytic_param_count(cfg) == JR.analytic_param_count(jcfg)
    G = cfg.num_layers // cfg.attn_every
    H, hd, d_inner, N = MB._dims(cfg)
    assert tp["mamba"]["in_proj"].shape == (
        G, cfg.attn_every, cfg.d_model, 2 * d_inner + 2 * N + H)
    assert tp["shared"]["attn"]["wq"].shape == (
        cfg.d_model, cfg.num_heads, cfg.resolved_head_dim)


# --------------------------------------------------------------------------
# the hybrid model
# --------------------------------------------------------------------------

@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_model_routes_match_jax(variant):
    """S = 64: two chunks of 32 in every Mamba2 layer."""
    cfg, jcfg = _cfgs(variant)
    jp, tp = _params(variant)
    jpj = jax.tree.map(jnp.asarray, jp)
    S = 64
    toks = _tokens(cfg, 2, S)
    jb = {"tokens": jnp.asarray(toks, jnp.int32)}
    tb = {"tokens": torch.tensor(toks)}
    want_k, _ = JR.apply(jpj, jcfg, jb, impl="pallas")
    got_k, aux = R.apply(tp, cfg, tb, impl="kernel")
    assert float(aux) == 0.0 and got_k.shape == (2, S, cfg.vocab_size)
    _close(got_k, want_k, 2e-4)
    want_p, _ = JR.apply(jpj, jcfg, jb, impl="xla")
    got_p, _ = R.apply(tp, cfg, tb, impl="plain")
    _close(got_p, want_p, 2e-4)
    assert torch.equal(steps.make_prefill_step(cfg)(tp, tb), got_k)
    jloss, _ = JR.train_loss(jpj, jcfg, jb)
    tloss, _ = R.train_loss(tp, cfg, tb)
    assert abs(float(tloss) - float(jloss)) <= 2e-4


@pytest.mark.parametrize("variant", ["g1", "g2"])
def test_decode_matches_jax(variant):
    """16 steps over an 8-slot ring (the KV caches wrap), logits each step
    and every cache at the end against the JAX package's decode."""
    cfg, jcfg = _cfgs(variant)
    jp, tp = _params(variant, seed=1)
    jpj = jax.tree.map(jnp.asarray, jp)
    B, T, cache_len = 2, 16, 8
    toks = _tokens(cfg, B, T, seed=2)
    jstep = jax.jit(lambda c, t: JR.decode_step(jpj, jcfg, c, t))
    jc = JR.init_cache(jcfg, B, cache_len, jnp.float32)
    tc = R.init_cache(cfg, B, cache_len, torch.float32, device="cpu")
    G = cfg.num_layers // cfg.attn_every
    assert tc["attn_k"].shape == (G, B, cache_len, cfg.num_kv_heads,
                                  cfg.resolved_head_dim)
    step = steps.make_decode_step(cfg)
    for t in range(T):
        jl, jc = jstep(jc, jnp.asarray(toks[:, t:t + 1], jnp.int32))
        tl, tc = step(tp, tc, torch.tensor(toks[:, t:t + 1]))
        assert tl.shape == (B, 1, cfg.vocab_size)
        _close(tl, jl, 1e-4)
    assert tc["index"] == int(jc["index"]) == T
    for name in ("attn_k", "attn_v"):
        _close(tc[name], jc[name], 1e-4)
    for name in ("conv", "ssm"):
        _close(tc["mamba"][name], jc["mamba"][name], 1e-4)


@pytest.mark.parametrize("variant", ["g2", "hd80"])
def test_decode_matches_the_full_forward(variant):
    """Decode from an empty cache against the port's full forward over the
    same 32 tokens (one chunk), both routes, in f32."""
    cfg, _ = _cfgs(variant)
    _, tp = _params(variant, seed=3)
    B, T = 2, 32
    toks = torch.tensor(_tokens(cfg, B, T, seed=4))
    cache = R.init_cache(cfg, B, T, torch.float32, device="cpu")
    outs = []
    for t in range(T):
        lg, cache = R.decode_step(tp, cfg, cache, toks[:, t:t + 1])
        outs.append(lg[:, 0])
    dec = torch.stack(outs, 1)
    for impl in ("kernel", "plain"):
        full, _ = R.apply(tp, cfg, {"tokens": toks}, impl=impl)
        assert float((dec - full).abs().max()) < 1e-4


def test_kernel_route_is_the_default(monkeypatch):
    """The prefill reaches chunk_scan once a Mamba2 layer and
    flash_attention once a group; decode and impl="plain" reach neither."""
    scans, attns = [], []

    def scan_spy(*args, **kw):
        scans.append(kw["chunk"])
        return chunk_scan(*args, **kw)

    def attn_spy(*args, **kw):
        attns.append(args[0].shape)
        return flash_attention(*args, **kw)

    chunk_scan, flash_attention = cs_pkg.chunk_scan, L.flash_attention
    monkeypatch.setattr(cs_pkg, "chunk_scan", scan_spy)
    monkeypatch.setattr(L, "flash_attention", attn_spy)
    cfg, _ = _cfgs("g2")
    params = R.init_params(0, cfg, device="cpu")
    toks = torch.tensor(_tokens(cfg, 1, 64, seed=5))
    steps.make_prefill_step(cfg)(params, {"tokens": toks})
    G = cfg.num_layers // cfg.attn_every
    assert scans == [cfg.chunk_size] * cfg.num_layers and len(attns) == G
    R.apply(params, cfg, {"tokens": toks}, impl="plain")
    cache = R.init_cache(cfg, 1, 4, torch.float32, device="cpu")
    steps.make_decode_step(cfg)(params, cache, toks[:, :1])
    assert len(scans) == cfg.num_layers and len(attns) == G
    with pytest.raises(ValueError, match="impl"):
        R.apply(params, cfg, {"tokens": toks}, impl="pallas")


# --------------------------------------------------------------------------
# the serving entry point
# --------------------------------------------------------------------------

def test_serve_decode_zamba2_runs_on_the_cpu(capsys):
    res = serve_main(["--device", "cpu", "--arch", ARCH, "--batch", "2",
                      "--tokens", "4", "--prefill-len", "64",
                      "--cache-len", "8"])
    out = capsys.readouterr().out
    assert "tok/s on CPU" in out and "prefill 2x64" in out
    assert res["tokens"].shape == (2, 4)
    assert res["prefill_logits_shape"] == (2, 64, res["cfg"].vocab_size)
    assert res["cfg"].family == "hybrid"
    assert torch.isfinite(res["logits"]).all()


def test_serve_decode_zamba2_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        serve_main(["--arch", ARCH, "--tokens", "1"])
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        R.init_cache(_cfgs()[0], 1, 8, torch.float32)


@pytest.mark.parametrize("prefill_len", [48, 100])
def test_serve_decode_refuses_a_ragged_prefill(prefill_len, monkeypatch):
    """A prefill above chunk_size (32 reduced) that it does not divide
    raises before any weight is drawn."""
    def no_init(*a, **kw):
        raise AssertionError("weights drawn before the check")

    monkeypatch.setattr(R, "init_params", no_init)
    with pytest.raises(ValueError, match="multiple of the chunk length 32"):
        serve_main(["--device", "cpu", "--arch", ARCH, "--tokens", "1",
                    "--prefill-len", str(prefill_len)])
    cfg, _ = _cfgs()
    steps.check_prefill_len(cfg, 24)            # one chunk of 24
    steps.check_prefill_len(cfg, 96)
    with pytest.raises(ValueError):
        steps.check_prefill_len(ARCHS[ARCH], 2000)   # full width: 128
