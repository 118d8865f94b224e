"""Port vs JAX package: the chunked linear recurrence (``scan_ops``) and the
chunk_scan wrapper with its plain version.

On the CPU the port's wrapper takes its plain version (the sequential
recurrence); it is held against the JAX package's oracle
``chunk_scan_ref`` and its Pallas ``chunk_scan`` in interpret mode, on that
package's sweep (``tests/test_kernels.py``: three shapes, both modes, f32
and bf16) at the sweep's tolerances (atol 5e-5 in f32, 3e-2 in bf16, rtol
0.1).  The port's plain chunked form is held against the JAX package's
chunked form at 5e-5 in f32 (the same sums in another order).

C-ref 3: with every step's log-decay at the clamp (-1) and chunks of 128,
the JAX package's chunked forms overflow (exp(128) is not a finite f32)
and return NaN; the port's chunked form, which re-references its
exponents every 16 rows, stays finite and within 5e-5 of the JAX
package's sequential recurrence.  The CUDA kernel itself is held against
the same plain version on the card by ``chip_smoke.py``.

The kernel's own decomposition (chunk states, a pass over them, per-chunk
outputs in 16-row sub-blocks), in plain PyTorch as
``chunk_scan_blocked_ref``, is held against the JAX package's oracle on
the same sweep, in f32 and with its products' operands split into TF32
hi and lo halves (3 passes, the kernel's split), at the sweep's
tolerances; with one TF32 pass the state misses 5e-5.

The kernel's whole domain, any K, any V and any chunk that divides T: the
same comparison at (K, V, chunk, T) = (128, 64, 256, 512), (256, 64, 64,
256), (6, 10, 16, 64) and (96, 130, 32, 96), and at the shapes the
wrapper once refused (K 128, V 15, a chunk of 288 steps); then every input
the JAX wrapper takes: K past one sub-block's 256-channel tiles (264,
300), f16, r, k and v in three dtypes, RWKV6 mode without a bonus, each
against the JAX kernel in interpret mode and its oracle: f32 y and every
final state within 5e-5, f16 and bf16 y within one spacing of their dtype
beyond it (both sides compute in f32 and round once).  The wrapper
refuses a ragged chunk and float64 (which JAX narrows to f32).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.chunk_scan.ops import chunk_scan as jchunk_scan
from repro.kernels.chunk_scan.ref import chunk_scan_ref as jchunk_scan_ref
from repro.models import scan_ops as JS
from repro_torch.kernels import chunk_scan as cs_pkg
from repro_torch.kernels.chunk_scan import chunk_scan
from repro_torch.kernels.chunk_scan.ref import (chunk_scan_blocked_ref,
                                                chunk_scan_ref, tf32_round)
from repro_torch.models import scan_ops as S
from torch_spacing import assert_within_one_spacing

SWEEP = [(1, 64, 2, 8, 16, 16), (2, 128, 3, 16, 32, 32),
         (1, 96, 1, 4, 64, 32)]
# the kernel's whole domain beyond the sweep: K 128 in chunks of 256, K
# 256, K and V off multiples of 4, V past two 64-column tiles; and the
# shapes the wrapper refused before (K 128, V 15, a chunk of 288 steps)
DOMAIN = SWEEP + [(1, T, 2, K, V, chunk) for K, V, chunk, T in (
    (128, 64, 256, 512), (256, 64, 64, 256), (6, 10, 16, 64),
    (96, 130, 32, 96))] + [(1, 96, 2, 128, 16, 32), (1, 96, 2, 8, 15, 32),
                           (1, 288, 2, 8, 16, 288)]
TOL = {"float32": 5e-5, "bfloat16": 3e-2}


def _inputs(B, T, H, K, V, mode, seed=0, ld_const=None):
    """numpy inputs as the JAX sweep draws them: r, k, v ~ 0.3 N(0, 1),
    s0 ~ 0.1 N(0, 1), log-decay ~ -0.8 U(0, 1) (per channel for RWKV6,
    per head for Mamba2), bonus ~ 0.2 N(0, 1)."""
    rng = np.random.default_rng(seed)
    r = rng.standard_normal((B, T, H, K)).astype(np.float32) * 0.3
    k = rng.standard_normal((B, T, H, K)).astype(np.float32) * 0.3
    v = rng.standard_normal((B, T, H, V)).astype(np.float32) * 0.3
    s0 = rng.standard_normal((B, H, K, V)).astype(np.float32) * 0.1
    shape = (B, T, H, K) if mode == "rwkv" else (B, T, H)
    ld = (-rng.uniform(size=shape).astype(np.float32) * 0.8
          if ld_const is None else np.full(shape, ld_const, np.float32))
    u = (rng.standard_normal((H, K)).astype(np.float32) * 0.2
         if mode == "rwkv" else None)
    return r, k, v, ld, s0, u


def _jax(arrs, dtype):
    r, k, v, ld, s0, u = arrs
    cast = [jnp.asarray(a).astype(dtype) for a in (r, k, v)]
    return (*cast, jnp.asarray(ld), jnp.asarray(s0),
            None if u is None else jnp.asarray(u))


def _torch(arrs, dtype):
    r, k, v, ld, s0, u = arrs
    cast = [torch.tensor(a).to(getattr(torch, dtype)) for a in (r, k, v)]
    return (*cast, torch.tensor(ld), torch.tensor(s0),
            None if u is None else torch.tensor(u))


def _close(got, want, atol, rtol=0.0):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("B,T,H,K,V,chunk", DOMAIN)
@pytest.mark.parametrize("mode", ["rwkv", "mamba"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunk_scan_matches_jax_kernel_and_oracle(B, T, H, K, V, chunk, mode,
                                                  dtype):
    arrs = _inputs(B, T, H, K, V, mode)
    jr, jk, jv, jld, js0, ju = _jax(arrs, getattr(jnp, dtype))
    r, k, v, ld, s0, u = _torch(arrs, dtype)
    kw = dict(include_current=mode == "mamba")
    y, s_fin = chunk_scan(r, k, v, ld, s0, bonus=u, chunk=chunk, **kw)
    assert y.dtype == v.dtype and y.shape == (B, T, H, V)
    assert s_fin.dtype == torch.float32 and s_fin.shape == (B, H, K, V)
    y_ref, s_ref = jchunk_scan_ref(jr, jk, jv, jld, js0, bonus=ju, **kw)
    y_pal, s_pal = jchunk_scan(jr, jk, jv, jld, js0, bonus=ju, chunk=chunk,
                               interpret=True, **kw)
    if not np.isfinite(np.asarray(y_pal, np.float32)).all():
        # C-ref 3: past ~88 of cumulative decay in one chunk (256 or 288
        # steps at the sweep's mean decay of -0.4) the JAX kernel's factor
        # exp(-L) is no finite f32.  The function does not depend on the
        # chunk: its kernel is held at the widest chunk of at most 64 steps
        # that divides T
        assert chunk > 64
        jc = max(d for d in range(1, 65) if T % d == 0)
        y_pal, s_pal = jchunk_scan(jr, jk, jv, jld, js0, bonus=ju, chunk=jc,
                                   interpret=True, **kw)
    assert torch.isfinite(y).all() and torch.isfinite(s_fin).all()
    for want_y, want_s in ((y_ref, s_ref), (y_pal, s_pal)):
        _close(y, want_y, TOL[dtype], 0.1)
        _close(s_fin, want_s, TOL[dtype], 0.1)
    # the wrapper's CPU route is its plain version, as it stands
    y2, s2 = chunk_scan_ref(r, k, v, ld, s0, bonus=u, **kw)
    assert torch.equal(y, y2) and torch.equal(s_fin, s2)


@pytest.mark.parametrize("B,T,H,K,V,chunk", SWEEP)
@pytest.mark.parametrize("mode", ["rwkv", "mamba"])
def test_chunked_scan_matches_jax(B, T, H, K, V, chunk, mode):
    arrs = _inputs(B, T, H, K, V, mode, seed=1)
    jr, jk, jv, jld, js0, ju = _jax(arrs, jnp.float32)
    r, k, v, ld, s0, u = _torch(arrs, "float32")
    kw = dict(include_current=mode == "mamba")
    want_y, want_s = JS.chunked_scan(jr, jk, jv, jld, js0, bonus=ju,
                                     chunk=chunk, **kw)
    y, s_fin = S.chunked_scan(r, k, v, ld, s0, bonus=u, chunk=chunk, **kw)
    _close(y, want_y, 5e-5)
    _close(s_fin, want_s, 5e-5)
    want_y, want_s = JS.recurrent_scan(jr, jk, jv, jld, js0, bonus=ju, **kw)
    y, s_fin = S.recurrent_scan(r, k, v, ld, s0, bonus=u, **kw)
    _close(y, want_y, 5e-5)
    _close(s_fin, want_s, 5e-5)


@pytest.mark.parametrize("mode", ["rwkv", "mamba"])
def test_c_ref_3_port_stays_finite_at_the_clamp(mode):
    """Every step at the clamp, chunk 128: the JAX package's chunked forms
    (jnp and its Pallas kernel) give NaN; the port's plain chunked form and
    its kernel route agree with the JAX package's recurrence."""
    arrs = _inputs(1, 256, 2, 64, 64, mode, seed=2, ld_const=-1.0)
    jr, jk, jv, jld, js0, ju = _jax(arrs, jnp.float32)
    r, k, v, ld, s0, u = _torch(arrs, "float32")
    kw = dict(include_current=mode == "mamba")
    jy, _ = JS.chunked_scan(jr, jk, jv, jld, js0, bonus=ju, chunk=128, **kw)
    py, _ = jchunk_scan(jr, jk, jv, jld, js0, bonus=ju, chunk=128,
                        interpret=True, **kw)
    assert not np.isfinite(np.asarray(jy)).all()
    assert not np.isfinite(np.asarray(py)).all()
    want_y, want_s = JS.recurrent_scan(jr, jk, jv, jld, js0, bonus=ju, **kw)
    for impl in S.IMPLS:
        y, s_fin = S.chunked_scan(r, k, v, ld, s0, bonus=u, chunk=128,
                                  impl=impl, **kw)
        assert torch.isfinite(y).all() and torch.isfinite(s_fin).all()
        _close(y, want_y, 5e-5)
        _close(s_fin, want_s, 5e-5)


@pytest.mark.parametrize("mode", ["rwkv", "mamba"])
def test_recurrent_step_matches_jax(mode):
    r, k, v, ld, s0, u = _inputs(2, 1, 3, 16, 32, mode, seed=3)
    kw = dict(include_current=mode == "mamba")
    jy, js = JS.recurrent_step(jnp.asarray(r[:, 0]), jnp.asarray(k[:, 0]),
                               jnp.asarray(v[:, 0]), jnp.asarray(ld[:, 0]),
                               jnp.asarray(s0), bonus=None if u is None
                               else jnp.asarray(u), **kw)
    y, s_new = S.recurrent_step(
        torch.tensor(r[:, 0]), torch.tensor(k[:, 0]), torch.tensor(v[:, 0]),
        torch.tensor(ld[:, 0]), torch.tensor(s0),
        bonus=None if u is None else torch.tensor(u), **kw)
    _close(y, jy, 1e-6)
    _close(s_new, js, 1e-6)


def test_kernel_route_calls_the_wrapper(monkeypatch):
    """``chunked_scan(impl="kernel")`` reaches ``kernels.chunk_scan`` with
    the chunk it was given; unknown routes are refused."""
    calls = []

    def spy(*args, **kw):
        calls.append(kw["chunk"])
        return chunk_scan(*args, **kw)

    monkeypatch.setattr(cs_pkg, "chunk_scan", spy)
    r, k, v, ld, s0, u = _torch(_inputs(1, 64, 2, 8, 16, "rwkv"), "float32")
    y, _ = S.chunked_scan(r, k, v, ld, s0, include_current=False, bonus=u,
                          chunk=32, impl="kernel")
    assert calls == [32]
    want, _ = S.recurrent_scan(r, k, v, ld, s0, include_current=False,
                               bonus=u)
    assert torch.equal(y, want)
    with pytest.raises(ValueError, match="impl"):
        S.chunked_scan(r, k, v, ld, s0, include_current=False, bonus=u,
                       chunk=32, impl="pallas")


@pytest.mark.parametrize("case", ["ragged_chunk", "float64", "meta"])
def test_chunk_scan_refuses_what_the_kernel_does_not_take(case):
    r, k, v, ld, s0, u = _torch(_inputs(1, 96, 2, 8, 16, "rwkv"), "float32")
    if case == "meta":                        # no kernel for the device
        r, k, v, ld, s0, u = (t.to("meta") for t in (r, k, v, ld, s0, u))
    kw = dict(include_current=False, bonus=u, chunk=32)
    if case == "ragged_chunk":
        kw["chunk"] = 40                      # 96 % 40 != 0
        with pytest.raises(ValueError, match="multiple of the chunk"):
            S.chunked_scan(r, k, v, ld, s0, **kw)
    elif case == "float64":                   # JAX narrows it to f32
        v = v.double()
    with pytest.raises(ValueError, match="chunk_scan|chunk"):
        chunk_scan(r, k, v, ld, s0, **kw)


def _against_jax(arrs, dtypes, chunk, mode, bonus=True):
    """The port's wrapper and the JAX package's (its Pallas kernel in
    interpret mode) and oracle on the same numpy inputs, r, k and v cast
    to ``dtypes``: y within the f32 tolerance where v is f32, else within
    one spacing of v's dtype beyond it; the f32 state within 5e-5."""
    r, k, v, ld, s0, u = arrs
    u = u if bonus else None
    jargs = [jnp.asarray(a).astype(d) for a, d in zip((r, k, v), dtypes)]
    targs = [torch.tensor(a).to(getattr(torch, d))
             for a, d in zip((r, k, v), dtypes)]
    kw = dict(include_current=mode == "mamba")
    y, s_fin = chunk_scan(*targs, torch.tensor(ld), torch.tensor(s0),
                          bonus=None if u is None else torch.tensor(u),
                          chunk=chunk, **kw)
    B, T, H, _ = r.shape
    assert y.dtype == targs[2].dtype and y.shape == (B, T, H, v.shape[-1])
    assert s_fin.dtype == torch.float32
    jrest = (jnp.asarray(ld), jnp.asarray(s0))
    ju = None if u is None else jnp.asarray(u)
    # the JAX oracle takes no missing bonus: it gets the zeros that the
    # JAX wrapper puts in its place
    ju0 = jnp.zeros((H, r.shape[3]), jnp.float32) if ju is None else ju
    for want_y, want_s in (
            jchunk_scan_ref(*jargs, *jrest, bonus=ju0, **kw),
            jchunk_scan(*jargs, *jrest, bonus=ju, chunk=chunk,
                        interpret=True, **kw)):
        if dtypes[2] == "float32":
            _close(y, want_y, TOL["float32"])
        else:
            assert_within_one_spacing(y, want_y, dtypes[2], TOL["float32"])
        _close(s_fin, want_s, TOL["float32"])


@pytest.mark.parametrize("K", [264, 300])
@pytest.mark.parametrize("mode", ["rwkv", "mamba"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_chunk_scan_wide_k_matches_jax_kernel_and_oracle(K, mode, dtype):
    """K past one sub-block's tiles (the kernel streams 256 channels at a
    time), T 64 in chunks of 32."""
    _against_jax(_inputs(1, 64, 2, K, 16, mode, seed=5), (dtype,) * 3, 32,
                 mode)


@pytest.mark.parametrize("B,T,H,K,V,chunk", SWEEP[:2] + [
    (1, 64, 2, 300, 16, 32)])
@pytest.mark.parametrize("mode", ["rwkv", "mamba"])
@pytest.mark.parametrize("dtypes", [("float16",) * 3,
                                    ("float16", "float32", "bfloat16")],
                         ids=["f16", "f16-f32-bf16"])
def test_chunk_scan_f16_and_mixed_dtypes_match_jax(B, T, H, K, V, chunk,
                                                   mode, dtypes):
    """f16, and r, k, v in three dtypes (both packages widen each to f32
    and write y in v's dtype)."""
    _against_jax(_inputs(B, T, H, K, V, mode, seed=6), dtypes, chunk, mode)


@pytest.mark.parametrize("B,T,H,K,V,chunk", [SWEEP[0],
                                             (1, 64, 2, 264, 16, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunk_scan_rwkv_without_a_bonus_matches_jax(B, T, H, K, V, chunk,
                                                     dtype):
    """RWKV6 mode with no bonus: a zero (H, K) bonus, as the JAX wrapper
    takes it."""
    _against_jax(_inputs(B, T, H, K, V, "rwkv", seed=7), (dtype,) * 3,
                 chunk, "rwkv", bonus=False)


@pytest.mark.parametrize("B,T,H,K,V,chunk", SWEEP)
@pytest.mark.parametrize("mode", ["rwkv", "mamba"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("passes", [0, 3])
def test_blocked_ref_matches_jax_oracle(B, T, H, K, V, chunk, mode, dtype,
                                        passes):
    arrs = _inputs(B, T, H, K, V, mode, seed=4)
    jr, jk, jv, jld, js0, ju = _jax(arrs, getattr(jnp, dtype))
    r, k, v, ld, s0, u = _torch(arrs, dtype)
    kw = dict(include_current=mode == "mamba")
    y, s_fin = chunk_scan_blocked_ref(r, k, v, ld, s0, bonus=u, chunk=chunk,
                                      tf32_passes=passes, **kw)
    assert y.dtype == v.dtype and y.shape == (B, T, H, V)
    assert s_fin.dtype == torch.float32 and s_fin.shape == (B, H, K, V)
    want_y, want_s = jchunk_scan_ref(jr, jk, jv, jld, js0, bonus=ju, **kw)
    _close(y, want_y, TOL[dtype], 0.1)
    _close(s_fin, want_s, TOL[dtype], 0.1)


@pytest.mark.parametrize("mode", ["rwkv", "mamba"])
@pytest.mark.parametrize("passes", [0, 3])
def test_blocked_ref_at_the_clamp(mode, passes):
    """Every log-decay at -1, chunk 128: the blocked form stays finite and
    within 5e-5 of the JAX package's recurrence, as the port's chunked
    form does (C-ref 3)."""
    arrs = _inputs(1, 256, 2, 64, 64, mode, seed=2, ld_const=-1.0)
    jr, jk, jv, jld, js0, ju = _jax(arrs, jnp.float32)
    r, k, v, ld, s0, u = _torch(arrs, "float32")
    kw = dict(include_current=mode == "mamba")
    want_y, want_s = JS.recurrent_scan(jr, jk, jv, jld, js0, bonus=ju, **kw)
    y, s_fin = chunk_scan_blocked_ref(r, k, v, ld, s0, bonus=u, chunk=128,
                                      tf32_passes=passes, **kw)
    assert torch.isfinite(y).all() and torch.isfinite(s_fin).all()
    _close(y, want_y, 5e-5)
    _close(s_fin, want_s, 5e-5)


def test_one_tf32_pass_misses_the_state_tolerance():
    """Why the kernel splits its operands: with TF32 hi . hi alone the
    final state is off by more than 5e-5 (about 1e-4 here), with the
    split it is within it."""
    arrs = _inputs(1, 64, 2, 8, 16, "rwkv", seed=4)
    jr, jk, jv, jld, js0, ju = _jax(arrs, jnp.float32)
    r, k, v, ld, s0, u = _torch(arrs, "float32")
    _, want_s = jchunk_scan_ref(jr, jk, jv, jld, js0, bonus=ju,
                                include_current=False)
    want_s = np.asarray(want_s)
    errs = {}
    for passes in (1, 3):
        _, s_fin = chunk_scan_blocked_ref(r, k, v, ld, s0, bonus=u, chunk=16,
                                          include_current=False,
                                          tf32_passes=passes)
        errs[passes] = float(np.abs(s_fin.numpy() - want_s).max())
    assert errs[1] > 5e-5 and errs[3] <= 5e-5, errs


def test_tf32_round_keeps_ten_mantissa_bits_to_nearest():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -12,
                      -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -10, 3.0e-3])
    got = tf32_round(x)
    assert got[0] == 1.0 and got[4] == 1.0 + 2.0 ** -10
    assert got[1] == 1.0 + 2.0 ** -10            # a tie goes away from zero
    assert got[2] == 1.0 + 2.0 ** -10
    assert got[3] == -(1.0 + 2.0 ** -10)
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all()
    assert abs(float(got[5]) - 3.0e-3) <= 3.0e-3 * 2.0 ** -11
