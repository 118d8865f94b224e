"""Port vs JAX package: RWKV6 serving (``models/rwkv.py``, the registry's
``ssm`` family, ``layers.group_norm_heads``, the serving entry point).

Weights are drawn by the JAX package and carried across with
``params_from_jax``.  The JAX init leaves the bonus ``u``, the token-shift
mixes and the group-norm affine at zeros and ones, which would hide the
bonus and token-shift paths, so the tests set them to random non-zero
values first (the same values on both sides).  Tolerances: layers in f32
at 1e-5 times the largest magnitude of the output, at least 1 (the same
arithmetic in another order; the WKV state reaches magnitudes of ~20);
whole reduced models in f32 at 2e-4, the kernel route against the JAX
package's Pallas route and the plain route against its jnp route (its
own route-parity tolerance); decode
against the JAX package's decode and against the port's full forward at
1e-4 (its own decode-vs-forward tolerance).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.models import layers as JL
from repro.models import registry as JR
from repro.models import rwkv as JRW
from repro_torch.configs import ARCHS
from repro_torch.core.modelbank import params_from_jax, params_to_jax
from repro_torch.kernels import chunk_scan as cs_pkg
from repro_torch.launch import steps
from repro_torch.models import layers as L
from repro_torch.models import registry as R
from repro_torch.models import rwkv as RW
from repro_torch.serve_decode import main as serve_main

KEY = jax.random.PRNGKey(5)
ARCH = "rwkv6-7b"
RANDOMIZED = ("u", "mu", "mu_base", "cm_mu_r", "cm_mu_k", "gn_scale",
              "gn_bias")


def _cfgs():
    return (ARCHS[ARCH].reduced().replace(remat=False, dtype="float32"),
            JARCHS[ARCH].reduced().replace(remat=False, dtype="float32"))


def _params(seed=0):
    """JAX params (numpy) with the zero-initialised mixes, bonus and norm
    affine set to random values; the port's copy of them."""
    _, jcfg = _cfgs()
    jp = jax.device_get(JR.init_params(KEY, jcfg))
    rng = np.random.default_rng(seed)
    for name in RANDOMIZED:
        a = jp["layers"][name]
        jp["layers"][name] = (rng.standard_normal(a.shape) * 0.5
                              ).astype(np.float32)
    return jp, params_from_jax(jp, device="cpu")


def _close(got, want, atol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0)


def _close_scaled(got, want, rel):
    """Within ``rel`` times the larger of 1 and the largest |want|."""
    want = np.asarray(want, np.float32)
    _close(got, want, rel * max(1.0, float(np.abs(want).max())))


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))


def test_group_norm_heads_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 4, 64)).astype(np.float32) * 3 + 1
    scale = rng.standard_normal((4, 64)).astype(np.float32)
    bias = rng.standard_normal((4, 64)).astype(np.float32)
    _close(L.group_norm_heads(*map(torch.tensor, (x, scale, bias))),
           JL.group_norm_heads(*map(jnp.asarray, (x, scale, bias))), 1e-5)


def test_param_count_and_tree_equal_jax():
    assert R.analytic_param_count(ARCHS[ARCH]) == 7_576_752_128
    assert (R.analytic_param_count(ARCHS[ARCH])
            == JR.analytic_param_count(JARCHS[ARCH]))
    cfg, jcfg = _cfgs()
    jp = jax.device_get(JR.init_params(KEY, jcfg))
    tp = R.init_params(0, cfg, device="cpu")
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), tp,
                                  is_leaf=torch.is_tensor) == \
        jax.tree_util.tree_map(np.shape, jp)
    # the RWKV tree round-trips through the weight carriers
    back = params_to_jax(params_from_jax(jp, device="cpu"))
    for a, b in zip(jax.tree_util.tree_leaves(jp),
                    jax.tree_util.tree_leaves(back)):
        assert b.dtype == np.float32 and np.array_equal(a, b)
    assert tp["layers"]["u"].shape == (cfg.num_layers, cfg.ssm_heads,
                                       cfg.d_model // cfg.ssm_heads)
    assert tp["layers"]["tm_w2"].shape == (cfg.num_layers, 5, RW.TM_LORA,
                                           cfg.d_model)
    assert tp["layers"]["mu"].shape == (cfg.num_layers, 5, cfg.d_model)


@pytest.mark.parametrize("S", [1, 12, 64])
def test_time_and_channel_mix_match_jax(S):
    """One layer's time-mix (chunked for S > 1, with a state carried in)
    and channel-mix against the JAX package's."""
    cfg, jcfg = _cfgs()
    jp, tp = _params()
    jl = jax.tree.map(lambda a: a[0], jp["layers"])
    tl = {k: v[0] for k, v in tp["layers"].items()}
    rng = np.random.default_rng(6)
    B, d, H = 2, cfg.d_model, cfg.ssm_heads
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    prev = rng.standard_normal((B, d)).astype(np.float32)
    wkv = rng.standard_normal((B, H, d // H, d // H)).astype(np.float32) * .1
    want = JRW.time_mix(jl, jcfg, jnp.asarray(x), jnp.asarray(prev),
                        jnp.asarray(wkv), chunked=S > 1)
    for impl in ("plain", "kernel"):
        got = RW.time_mix(tl, cfg, torch.tensor(x), torch.tensor(prev),
                          torch.tensor(wkv), chunked=S > 1, impl=impl)
        for g, w in zip(got, want):
            _close_scaled(g, w, 1e-5)
    want = JRW.channel_mix(jl, jnp.asarray(x), jnp.asarray(prev))
    got = RW.channel_mix(tl, torch.tensor(x), torch.tensor(prev))
    for g, w in zip(got, want):
        _close_scaled(g, w, 1e-5)


@pytest.mark.parametrize("S", [24, 64])
def test_model_routes_match_jax(S):
    """S = 24 is one chunk of 24 (below chunk_size 32); S = 64 is two."""
    cfg, jcfg = _cfgs()
    jp, tp = _params()
    jpj = jax.tree.map(jnp.asarray, jp)
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
    got_s = steps.make_prefill_step(cfg)(tp, tb)
    assert torch.equal(got_s, got_k)
    jloss, _ = JR.train_loss(jpj, jcfg, jb)
    tloss, _ = R.train_loss(tp, cfg, tb)
    assert abs(float(tloss) - float(jloss)) <= 2e-4


def test_decode_matches_jax_and_the_full_forward():
    cfg, jcfg = _cfgs()
    jp, tp = _params(seed=1)
    jpj = jax.tree.map(jnp.asarray, jp)
    S = 12
    toks = _tokens(cfg, 2, S, seed=2)
    jstep = jax.jit(lambda c, t: JR.decode_step(jpj, jcfg, c, t))
    jc = JR.init_cache(jcfg, 2, 8, jnp.float32)
    tc = R.init_cache(cfg, 2, 8, torch.float32, device="cpu")
    assert set(tc) == {"tm_x", "cm_x", "wkv"}
    step = steps.make_decode_step(cfg)
    outs = []
    for t in range(S):
        jl, jc = jstep(jc, jnp.asarray(toks[:, t:t + 1], jnp.int32))
        tl, tc = step(tp, tc, torch.tensor(toks[:, t:t + 1]))
        assert tl.shape == (2, 1, cfg.vocab_size)
        _close(tl, jl, 1e-4)
        outs.append(tl[:, 0])
    for name in ("tm_x", "cm_x", "wkv"):
        _close(tc[name], jc[name], 1e-4)
    full, _ = R.apply(tp, cfg, {"tokens": torch.tensor(toks)})
    assert float((torch.stack(outs, 1) - full).abs().max()) < 1e-4


def test_decode_matches_the_full_forward_in_float64():
    """In float64 the plain path computes in float64 throughout (the
    scans and norms promote to at least f32), so decode and the full
    forward agree far below f32 rounding — the form in which
    ``chip_smoke.py`` holds them at full width."""
    cfg, _ = _cfgs()
    cfg = cfg.replace(dtype="float64")
    _, tp = _params(seed=2)
    tp = {k: ({n: t.double() for n, t in v.items()} if isinstance(v, dict)
              else v.double()) for k, v in tp.items()}
    toks = torch.tensor(_tokens(cfg, 2, 32, seed=4))      # one chunk
    full, _ = R.apply(tp, cfg, {"tokens": toks}, impl="plain")
    assert full.dtype == torch.float64
    cache = R.init_cache(cfg, 2, 0, torch.float64, device="cpu")
    assert cache["wkv"].dtype == torch.float64
    outs = []
    for t in range(32):
        lg, cache = R.decode_step(tp, cfg, cache, toks[:, t:t + 1])
        outs.append(lg[:, 0])
    assert float((torch.stack(outs, 1) - full).abs().max()) < 1e-9


def test_kernel_route_is_the_default(monkeypatch):
    """The prefill reaches the chunk_scan wrapper once a layer; decode
    (S = 1) and impl="plain" never do."""
    calls = []

    def spy(*args, **kw):
        calls.append(kw["chunk"])
        return chunk_scan(*args, **kw)

    chunk_scan = cs_pkg.chunk_scan
    monkeypatch.setattr(cs_pkg, "chunk_scan", spy)
    cfg, _ = _cfgs()
    params = R.init_params(0, cfg, device="cpu")
    toks = torch.tensor(_tokens(cfg, 1, 64, seed=3))
    steps.make_prefill_step(cfg)(params, {"tokens": toks})
    assert calls == [cfg.chunk_size] * cfg.num_layers
    R.apply(params, cfg, {"tokens": toks}, impl="plain")
    cache = R.init_cache(cfg, 1, 4, torch.float32, device="cpu")
    steps.make_decode_step(cfg)(params, cache, toks[:, :1])
    assert len(calls) == cfg.num_layers
    with pytest.raises(ValueError, match="impl"):
        R.apply(params, cfg, {"tokens": toks}, impl="pallas")


def test_serve_decode_rwkv_runs_on_the_cpu(capsys):
    res = serve_main(["--device", "cpu", "--arch", ARCH, "--batch", "2",
                      "--tokens", "4", "--prefill-len", "64"])
    out = capsys.readouterr().out
    assert "tok/s on CPU" in out and "prefill 2x64" in out
    assert res["tokens"].shape == (2, 4)
    assert res["prefill_logits_shape"] == (2, 64, res["cfg"].vocab_size)
    assert res["cfg"].family == "ssm" and torch.isfinite(res["logits"]).all()


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
    steps.check_prefill_len(ARCHS["qwen3-4b"], prefill_len)   # no chunks
    with pytest.raises(ValueError):
        steps.check_prefill_len(ARCHS[ARCH], 2000)   # full width: 128

