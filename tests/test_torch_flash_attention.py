"""Port vs JAX package: the flash_attention wrapper and its plain version.

On the CPU the port's wrapper takes its plain version (repeat the KV
heads, flatten, ``attention_ref``); it is held against the JAX package's
``flash_attention`` run through its Pallas kernel in interpret mode, on a
subset of that package's sweep (``tests/test_kernels.py``) that keeps the
ragged S = 200 with one KV head, the hd = 128 case, all three mask modes
and both dtypes.  Tolerances are the sweep's: f32 differs only in the
order of the sums (1e-5); bf16 outputs round to bf16, whose spacing near
the outputs' magnitude (about 0.5) is 2e-3, and both sides accumulate in
f32 (2e-2).  The CUDA kernel itself is held against the same plain
version on the card by ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jflash
from repro.kernels.flash_attention.ref import attention_ref as jref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _inputs(B, Sq, Sk, H, KV, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, hd)).astype(np.float32) * 0.5,
            rng.standard_normal((B, Sk, KV, hd)).astype(np.float32) * 0.5,
            rng.standard_normal((B, Sk, KV, hd)).astype(np.float32) * 0.5)


def _both(arrs, dtype):
    """The same values in both frameworks (bf16 rounds the same way)."""
    return ([jnp.asarray(a).astype(dtype) for a in arrs],
            [torch.tensor(a).to(getattr(torch, dtype)) for a in arrs])


@pytest.mark.parametrize("B,S,H,KV,hd", [
    (1, 200, 4, 1, 32),      # non-multiple-of-block seq, strong GQA
    (2, 64, 8, 8, 128),
])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 48),
                                           (False, 0)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_jax_kernel(B, S, H, KV, hd, causal, window,
                                            dtype):
    (jq, jk, jv), (q, k, v) = _both(_inputs(B, S, S, H, KV, hd), dtype)
    want = jflash(jq, jk, jv, causal=causal, window=window, interpret=True)
    got = flash_attention(q, k, v, causal=causal, window=window)
    assert got.dtype == q.dtype and got.shape == (B, S, H, hd)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("Sq,Sk,causal,window", [
    (33, 33, True, 0), (40, 40, True, 7), (16, 24, False, 0),
    (24, 24, False, 5)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_ref_matches_jax_ref(Sq, Sk, causal, window, dtype):
    rng = np.random.default_rng(1)
    arrs = [rng.standard_normal((3, s, 64)).astype(np.float32)
            for s in (Sq, Sk, Sk)]
    (jq, jk, jv), (q, k, v) = _both(arrs, dtype)
    want = jref(jq, jk, jv, causal=causal, window=window)
    got = attention_ref(q, k, v, causal=causal, window=window)
    assert got.dtype == v.dtype
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


def test_wrapper_reads_strided_views():
    """q/k/v as views into fused projections (the head dim contiguous,
    other strides not) give what contiguous copies give."""
    q, k, v = (torch.tensor(a) for a in _inputs(2, 20, 20, 4, 2, 32))
    fused = torch.cat([q.reshape(2, 20, -1), k.reshape(2, 20, -1),
                       v.reshape(2, 20, -1)], dim=-1)
    qv = fused[..., :128].view(2, 20, 4, 32)
    kv = fused[..., 128:192].view(2, 20, 2, 32)
    vv = fused[..., 192:].view(2, 20, 2, 32)
    assert not qv.is_contiguous()
    torch.testing.assert_close(flash_attention(qv, kv, vv, window=6),
                               flash_attention(q, k, v, window=6),
                               atol=0, rtol=0)


@pytest.mark.parametrize("change,match", [
    (dict(hd=80), "head dim"),
    (dict(dtype=torch.float16), "float32 or all bfloat16"),
    (dict(kv_dtype=torch.bfloat16), "float32 or all bfloat16"),
    (dict(KV=3), "H % KV"),
    (dict(window=-1), "window"),
    (dict(transposed=True), "contiguous head dim"),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(change, match):
    hd, KV = change.get("hd", 32), change.get("KV", 2)
    dtype = change.get("dtype", torch.float32)
    q = torch.zeros((1, 8, 4, hd), dtype=dtype)
    k = torch.zeros((1, 8, KV, hd), dtype=change.get("kv_dtype", dtype))
    if change.get("transposed"):
        q = torch.zeros((1, 8, hd, 4), dtype=dtype).transpose(2, 3)
    with pytest.raises(ValueError, match=match):
        flash_attention(q, k, k.clone(), window=change.get("window", 0))


def test_cpu_route_never_counts_a_launch():
    before = flash_attention.launches
    q, k, v = (torch.tensor(a) for a in _inputs(1, 8, 8, 2, 2, 32))
    flash_attention(q, k, v)
    assert flash_attention.launches == before
