"""Port vs JAX package: the flash_attention wrapper and its plain version.

On the CPU the port's wrapper takes its plain version (repeat the KV
heads, flatten, ``attention_ref``); it is held against the JAX package's
``flash_attention`` run through its Pallas kernel in interpret mode, on a
subset of that package's sweep (``tests/test_kernels.py``) that keeps the
ragged S = 200 with one KV head, the hd = 128 case, all three mask modes
and both dtypes, plus hubert-xlarge's head dim 80 at a small S, and the
kernel's whole domain (head dims 1 to ``MAX_HEAD_DIM`` = 256: 1, 8, 36,
40, 96, 192 and 256 at S = 200).  Tolerances are the sweep's: f32 differs
only in the order of the sums (2e-6); bf16 outputs round to bf16, whose
spacing near the outputs' magnitude (about 0.5) is 2e-3, and both sides
accumulate in f32 (2e-2).  The CUDA kernel itself is held against the
same plain version on the card by ``chip_smoke.py``.  The wrapper refuses
head dims past the cap on every device, and ``takes_tma`` sends to the
wgmma kernel only what TMA can map.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jflash
from repro.kernels.flash_attention.ref import attention_ref as jref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ops import (MAX_HEAD_DIM,
                                                     takes_tma,
                                                     tensor_map_spec)
from repro_torch.kernels.flash_attention.ref import attention_ref

TOL = {"float32": 2e-6, "bfloat16": 2e-2}


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
    (1, 72, 2, 1, 80),       # hubert-xlarge's head dim (1280 / 16)
    # the whole domain: head dims off the serving ones, on the kernels'
    # padded tiles (1, 8 on the 32-wide; 36, 40 on 64; 96; 192; 256)
    *((1, 200, 4, 2, hd) for hd in (1, 8, 36, 40, 96, 192, 256)),
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


@pytest.mark.parametrize("make,wgmma", [
    (lambda: torch.zeros((2, 8, 4, 64), dtype=torch.bfloat16), True),
    (lambda: torch.zeros((2, 8, 4, 128), dtype=torch.bfloat16), True),
    (lambda: torch.zeros((2, 8, 4, 80), dtype=torch.bfloat16), True),
    (lambda: torch.zeros((2, 8, 4, 96), dtype=torch.bfloat16), False),
    (lambda: torch.zeros((2, 8, 4, 64)), False),           # f32
    # the base 2 bytes off 16
    (lambda: torch.zeros(2 * 8 * 4 * 64 + 1, dtype=torch.bfloat16)[1:]
     .view(2, 8, 4, 64), False),
    # a sequence stride of 264 bytes
    (lambda: torch.zeros((2, 8, 4 * 64 + 4), dtype=torch.bfloat16)[
        ..., :256].view(2, 8, 4, 64), False),
    # B * H = 65,600 past the wgmma kernel's grid.y
    (lambda: torch.zeros((1025, 1, 64, 64), dtype=torch.bfloat16), False),
])
def test_takes_tma_routes_only_what_tma_maps(make, wgmma):
    t = make()
    assert takes_tma(t, t, t) is wgmma


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
    (dict(hd=MAX_HEAD_DIM + 8), "head dim"),
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


@pytest.mark.parametrize("B,S,heads,hd,rows,cols", [
    (4, 2048, 32, 128, 64, 64), (2, 300, 8, 64, 128, 64),
    (1, 5, 1, 64, 128, 64), (4, 2048, 16, 80, 128, 16)])
def test_tensor_map_spec_of_a_contiguous_tensor(B, S, heads, hd, rows,
                                                cols):
    """dims innermost first (hd, S, heads, B), the byte strides of S,
    heads and B, and a box of one swizzle row's columns (64 bf16, 128
    bytes; at hd 80 16 bf16, 32 bytes) by ``rows``."""
    t = torch.zeros((B, S, heads, hd), dtype=torch.bfloat16)
    dims, strides, box = tensor_map_spec(t, rows)
    assert dims == (hd, S, heads, B)
    assert strides == (heads * hd * 2, hd * 2, S * heads * hd * 2)
    assert box == (cols, rows, 1, 1) and hd % cols == 0


def test_tensor_map_spec_of_fused_projection_views():
    """q, k and v as views into one (B, S, (H + 2 KV) hd) projection: the
    maps step over the whole fused row, and each starts at its own
    columns (the launcher takes the view's data pointer)."""
    B, S, H, KV, hd = 2, 300, 8, 2, 64
    fused = torch.zeros((B, S, (H + 2 * KV) * hd), dtype=torch.bfloat16)
    row = (H + 2 * KV) * hd * 2
    k = fused[..., H * hd:(H + KV) * hd].view(B, S, KV, hd)
    dims, strides, _ = tensor_map_spec(k, 128)
    assert dims == (hd, S, KV, B)
    assert strides == (row, hd * 2, S * row)
    assert k.data_ptr() - fused.data_ptr() == H * hd * 2


@pytest.mark.parametrize("make", [
    lambda: torch.zeros((1, 8, 2, 64 + 4), dtype=torch.bfloat16)[..., :64],
    lambda: torch.zeros((1, 8, 2, 64), dtype=torch.bfloat16).transpose(
        2, 3),
    lambda: torch.zeros((3, 8, 2 * 64 + 4), dtype=torch.bfloat16)[
        :, :, :128].view(3, 8, 2, 64)[:, :, :1],
])
def test_tensor_map_spec_refuses_strides_tma_cannot_take(make):
    """a head stride of 136 bytes, a head dim that is not contiguous, a
    sequence stride of 264 bytes: none is a multiple of 16 bytes."""
    with pytest.raises(ValueError, match="multiples of 16"):
        tensor_map_spec(make(), 128)


def test_cpu_route_never_counts_a_launch():
    before = flash_attention.launches
    q, k, v = (torch.tensor(a) for a in _inputs(1, 8, 8, 2, 2, 32))
    flash_attention(q, k, v)
    assert flash_attention.launches == before
