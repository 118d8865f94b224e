"""The plain chunked scan's backward (``scan_ops._ChunkedScan``): it saves
its operands as passed and the state entering each chunk, and recomputes
one chunk at a time.

* Gradients of ``chunked_scan`` with respect to r, k, v, the log-decay,
  state0 and the bonus, in both modes, against ``jax.vjp`` of the JAX
  package's ``scan_ops.chunked_scan`` (its jnp route) on the same numpy
  inputs and cotangents, at ``tests/test_torch_chunk_scan.py``'s sweep
  shapes (K != V, 3 or 4 chunks): f32, each leaf within 5e-5 of
  max(1, max |g|).  With every log-decay just inside the clamp (-0.999)
  or past it (-1.5) and chunks of 128 the JAX package's chunked form is
  NaN (C-ref 3): there the port is held against ``jax.vjp`` of the JAX
  package's sequential recurrence, at the same tolerance.  A known-bad
  control (the state between chunks detached in the backward) must miss
  it.
* float64 (which the JAX package never runs): the same gradients against
  autograd through the port's sequential recurrence in float64, within
  1e-10 of max(1, max |g|).
* The forward is the sub-block form as it was (frozen below): y and the
  final state bit-equal in f32, bf16 and float64, and the gradients
  bit-equal to autograd's through the frozen copy.
* Saved bytes: one call saves at most its operands' storages plus (T /
  chunk + 1) states plus 1 MB (``SAVED_SLACK``); the frozen copy under
  autograd saves more than that bound at the same size.
* Under ``torch.utils.checkpoint`` (the models' remat) and with only one
  of the two outputs used, the same gradients.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from repro.models import scan_ops as JS
from repro_torch.launch.collectives import saved_bytes
from repro_torch.models import scan_ops as S

SWEEP = [(1, 64, 2, 8, 16, 16), (2, 128, 3, 16, 32, 32),
         (1, 96, 1, 4, 64, 32)]
MODES = ("rwkv", "mamba")
F32_TOL = 5e-5              # of max(1, max |g|), against the JAX package
F64_TOL = 1e-10             # of max(1, max |g|), against the recurrence
SAVED_SLACK = 1 << 20
NAMES = ("r", "k", "v", "log_decay", "state0", "bonus")


def _inputs(B, T, H, K, V, mode, seed=0, ld_const=None):
    """numpy inputs as the JAX sweep draws them (see
    ``tests/test_torch_chunk_scan.py``) and cotangents of y and the final
    state."""
    rng = np.random.default_rng(seed)
    r, k = (rng.standard_normal((B, T, H, K)).astype(np.float32) * 0.3
            for _ in range(2))
    v = rng.standard_normal((B, T, H, V)).astype(np.float32) * 0.3
    s0 = rng.standard_normal((B, H, K, V)).astype(np.float32) * 0.1
    shape = (B, T, H, K) if mode == "rwkv" else (B, T, H)
    ld = (-rng.uniform(size=shape).astype(np.float32) * 0.8
          if ld_const is None else np.full(shape, ld_const, np.float32))
    u = (rng.standard_normal((H, K)).astype(np.float32) * 0.2
         if mode == "rwkv" else None)
    gy = rng.standard_normal((B, T, H, V)).astype(np.float32)
    gs = rng.standard_normal((B, H, K, V)).astype(np.float32)
    return [r, k, v, ld, s0, u], (gy, gs)


def _leaves(arrs, dtype=torch.float32):
    return [None if a is None else torch.tensor(a, dtype=dtype)
            .requires_grad_(True) for a in arrs]


def _torch_grads(fn, arrs, cots, dtype=torch.float32, **kw):
    leaves = _leaves(arrs, dtype)
    r, k, v, ld, s0, u = leaves
    y, s_fin = fn(r, k, v, ld, s0, bonus=u, **kw)
    used = [t for t in leaves if t is not None]
    got = torch.autograd.grad((y, s_fin), used,
                              [torch.tensor(c, dtype=y.dtype)
                               for c in cots], allow_unused=True)
    # an operand with no path to the outputs (only in the control) has a
    # zero gradient
    got = [torch.zeros_like(t) if g is None else g
           for t, g in zip(used, got)]
    return y.detach(), s_fin.detach(), got


def _jax_grads(jfn, arrs, cots, **kw):
    used = [jnp.asarray(a) for a in arrs if a is not None]
    rwkv = arrs[5] is not None

    def f(*xs):
        r, k, v, ld, s0, *u = xs
        return jfn(r, k, v, ld, s0, bonus=u[0] if rwkv else None, **kw)
    _, vjp = jax.vjp(f, *used)
    return [np.asarray(g) for g in vjp(tuple(jnp.asarray(c)
                                             for c in cots))]


def _held(got, want, tol):
    for name, g, w in zip(NAMES, got, want):
        w = np.asarray(w, np.float64)
        scale = max(1.0, float(np.abs(w).max()))
        err = float(np.abs(g.detach().double().numpy() - w).max())
        assert err <= tol * scale, (name, err, scale)


def _kw(mode):
    return dict(include_current=mode == "mamba")


@pytest.mark.parametrize("B,T,H,K,V,chunk", SWEEP)
@pytest.mark.parametrize("mode", MODES)
def test_gradients_match_jax(B, T, H, K, V, chunk, mode):
    arrs, cots = _inputs(B, T, H, K, V, mode, seed=1)
    *_, got = _torch_grads(S.chunked_scan, arrs, cots, chunk=chunk,
                           **_kw(mode))
    want = _jax_grads(JS.chunked_scan, arrs, cots, chunk=chunk, **_kw(mode))
    _held(got, want, F32_TOL)


@pytest.mark.parametrize("ld_const", [-0.999, -1.5])
@pytest.mark.parametrize("mode", MODES)
def test_gradients_at_the_clamp_match_jax_recurrence(mode, ld_const):
    """Chunks of 128 with every step at or past the clamp: the JAX
    package's chunked form overflows (C-ref 3), its recurrence does not.
    Just inside the clamp the log-decay's gradient passes; past it, it is
    zero in both packages.  (On the clamp itself the packages differ by
    convention: torch's clamp passes the whole gradient, JAX's clip half.)
    """
    arrs, cots = _inputs(1, 256, 2, 16, 24, mode, seed=2, ld_const=ld_const)
    *_, got = _torch_grads(S.chunked_scan, arrs, cots, chunk=128,
                           **_kw(mode))
    assert all(torch.isfinite(g).all() for g in got)
    bad = _jax_grads(JS.chunked_scan, arrs, cots, chunk=128, **_kw(mode))
    assert not all(np.isfinite(g).all() for g in bad)
    want = _jax_grads(JS.recurrent_scan, arrs, cots, **_kw(mode))
    _held(got, want, F32_TOL)


@pytest.mark.parametrize("mode", MODES)
def test_detached_state_control_misses_the_tolerance(mode, monkeypatch):
    """The state handed between chunks detached in the backward (the
    recomputed chunk reads a detached entering state): the gradients of
    every chunk but the last lose the later chunks' share."""
    arrs, cots = _inputs(2, 128, 3, 16, 32, mode, seed=1)
    want = _jax_grads(JS.chunked_scan, arrs, cots, chunk=32, **_kw(mode))
    chunk_fn = S._chunk
    monkeypatch.setattr(S, "_chunk", lambda rq, kq, vq, ldq, St, *a:
                        chunk_fn(rq, kq, vq, ldq, St.detach(), *a))
    *_, got = _torch_grads(S.chunked_scan, arrs, cots, chunk=32,
                           **_kw(mode))
    with pytest.raises(AssertionError):
        _held(got, want, F32_TOL)


@pytest.mark.parametrize("B,T,H,K,V,chunk", SWEEP + [(1, 256, 2, 16, 24,
                                                      128)])
@pytest.mark.parametrize("mode", MODES)
def test_float64_gradients_match_the_recurrence(B, T, H, K, V, chunk, mode):
    arrs, cots = _inputs(B, T, H, K, V, mode, seed=3)
    y, s_fin, got = _torch_grads(S.chunked_scan, arrs, cots, torch.float64,
                                 chunk=chunk, **_kw(mode))
    assert y.dtype == s_fin.dtype == torch.float64
    assert all(g.dtype == torch.float64 for g in got)
    *_, want = _torch_grads(S.recurrent_scan, arrs, cots, torch.float64,
                            **_kw(mode))
    _held(got, [w.numpy() for w in want], F64_TOL)


# ---- the sub-block form as it was, frozen ----------------------------------

def chunked_scan_before(r, k, v, log_decay, state0=None, *,
                        include_current=True, bonus=None, chunk=64):
    """``scan_ops.chunked_scan``'s plain route before its backward was
    written out: every sub-block's products under autograd's own graph."""
    B, T, H, K = r.shape
    V = v.shape[-1]
    nc, Lc = T // chunk, chunk
    dev = r.device
    acc = S.acc_dtype(r)
    ld = S._prep_decay(log_decay, K)
    St = (torch.zeros((B, H, K, V), dtype=acc, device=dev)
          if state0 is None else state0.to(acc))
    u = None if include_current else bonus.to(acc)
    rows = torch.arange(Lc, device=dev)
    keep = (rows[:, None] >= rows[None, :] if include_current
            else rows[:, None] > rows[None, :])                # (Lc, Lc)
    ys = []
    for c in range(nc):
        sl = slice(c * Lc, (c + 1) * Lc)
        rq, kq, vq = r[:, sl].to(acc), k[:, sl].to(acc), v[:, sl].to(acc)
        L = torch.cumsum(ld[:, sl], dim=1)                     # (B,Lc,H,K)
        excl = torch.cat([torch.zeros_like(L[:, :1]), L[:, :-1]], dim=1)
        M = L if include_current else excl
        L_end = L[:, -1]                                       # (B,H,K)

        y = torch.einsum("blhk,bhkv->blhv", rq * torch.exp(M), St)
        parts = []
        for a in range(0, Lc, S.SUB_BLOCK):
            b = min(a + S.SUB_BLOCK, Lc)
            ref = excl[:, a:a + 1]                             # (B,1,H,K)
            q_t = rq[:, a:b] * torch.exp(M[:, a:b] - ref)
            k_t = kq[:, :b] * torch.exp(ref - L[:, :b])
            A = torch.einsum("blhk,bshk->bhls", q_t, k_t)
            A = torch.where(keep[a:b, :b], A, 0.0)
            parts.append(torch.einsum("bhls,bshv->blhv", A, vq[:, :b]))
        y = y + torch.cat(parts, dim=1)
        if not include_current:
            diag = torch.einsum("blhk,blhk->blh", rq * u, kq)
            y = y + diag[..., None] * vq
        k_carry = kq * torch.exp(L_end[:, None] - L)
        St = (torch.exp(L_end)[..., None] * St
              + torch.einsum("blhk,blhv->bhkv", k_carry, vq))
        ys.append(y)
    y = (torch.cat(ys, dim=1) if ys
         else torch.zeros((B, 0, H, V), device=dev))
    return y.to(v.dtype), St


DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float64": torch.float64}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("mode", MODES)
def test_forward_and_gradients_bit_equal_to_the_frozen_form(dtype, mode):
    arrs, cots = _inputs(2, 128, 3, 16, 24, mode, seed=4)
    dt = DTYPES[dtype]
    # r, k, v in the dtype under test; the log-decay, state0 and bonus in
    # f32, as the models pass them (float64 throughout for float64)
    side = torch.float64 if dt == torch.float64 else torch.float32

    def run(fn):
        leaves = [None if a is None else
                  torch.tensor(a, dtype=dt if i < 3 else side)
                  .requires_grad_(True) for i, a in enumerate(arrs)]
        r, k, v, ld, s0, u = leaves
        y, s_fin = fn(r, k, v, ld, s0, bonus=u, chunk=32, **_kw(mode))
        used = [t for t in leaves if t is not None]
        got = torch.autograd.grad((y, s_fin), used,
                                  [torch.tensor(cots[0], dtype=y.dtype),
                                   torch.tensor(cots[1], dtype=s_fin.dtype)])
        return y, s_fin, got
    y, s_fin, got = run(S.chunked_scan)
    y0, s0_fin, want = run(chunked_scan_before)
    assert y.dtype == y0.dtype == dt and s_fin.dtype == s0_fin.dtype
    assert torch.equal(y, y0) and torch.equal(s_fin, s0_fin)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), name
    with torch.no_grad():
        r, k, v, ld, s0, u = (None if a is None else torch.tensor(a)
                              for a in arrs)
        y1, s1 = S.chunked_scan(r, k, v, ld, s0, bonus=u, chunk=32,
                                **_kw(mode))
        y2, s2 = chunked_scan_before(r, k, v, ld, s0, bonus=u, chunk=32,
                                     **_kw(mode))
    assert torch.equal(y1, y2) and torch.equal(s1, s2)


# ---- saved bytes ------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_saved_bytes_are_operands_and_chunk_states(mode):
    B, T, H, K, V, chunk = 2, 512, 4, 64, 64, 128
    arrs, _ = _inputs(B, T, H, K, V, mode, seed=5)
    leaves = [t for t in _leaves(arrs) if t is not None]
    state = B * H * K * V * 4
    bound = (sum(t.untyped_storage().nbytes() for t in leaves)
             + (T // chunk + 1) * state + SAVED_SLACK)
    r, k, v, ld, s0, *u = leaves
    kw = dict(bonus=u[0] if u else None, chunk=chunk, **_kw(mode))
    new, (y, s_fin) = saved_bytes(S.chunked_scan, r, k, v, ld, s0, **kw)
    old, (y0, s0_fin) = saved_bytes(chunked_scan_before, r, k, v, ld, s0,
                                    **kw)
    assert torch.equal(y, y0) and torch.equal(s_fin, s0_fin)
    assert new <= bound < old, (new, bound, old)
    # the zero state that state0=None starts from is one of the states
    new0, _ = saved_bytes(S.chunked_scan, r, k, v, ld, None, **kw)
    assert new0 <= bound


# ---- remat and unused outputs -------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_scan_under_checkpoint(mode):
    arrs, cots = _inputs(2, 128, 3, 16, 24, mode, seed=6)
    kw = dict(chunk=32, **_kw(mode))

    def remat(r, k, v, ld, s0, bonus=None, **kw2):
        return checkpoint(S.chunked_scan, r, k, v, ld, s0, bonus=bonus,
                          use_reentrant=False, **kw2)
    y, s_fin, got = _torch_grads(remat, arrs, cots, **kw)
    y0, s0_fin, want = _torch_grads(S.chunked_scan, arrs, cots, **kw)
    assert torch.equal(y, y0) and torch.equal(s_fin, s0_fin)
    for name, g, w in zip(NAMES, got, want):
        assert torch.equal(g, w), name


@pytest.mark.parametrize("which", ["y", "state"])
@pytest.mark.parametrize("mode", MODES)
def test_one_output_used(mode, which):
    """Training uses y alone (the final state's gradient arrives as None);
    the state alone leaves r without a gradient in either form."""
    arrs, cots = _inputs(1, 96, 2, 8, 12, mode, seed=7)

    def run(fn):
        leaves = _leaves(arrs)
        r, k, v, ld, s0, u = leaves
        y, s_fin = fn(r, k, v, ld, s0, bonus=u, chunk=32, **_kw(mode))
        out, cot = (y, cots[0]) if which == "y" else (s_fin, cots[1])
        loss = (out * torch.tensor(cot)).sum()
        used = [t for t in leaves if t is not None]
        return torch.autograd.grad(loss, used, allow_unused=True)
    for name, g, w in zip(NAMES, run(S.chunked_scan),
                          run(chunked_scan_before)):
        if w is None:               # r's gradient through the state alone
            assert g is None or not g.any(), name
        else:
            torch.testing.assert_close(g, w, rtol=0, atol=1e-6)
