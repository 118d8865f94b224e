"""Port vs JAX package: the flash_attention wrapper and its plain version.

On the CPU the port's wrapper takes its plain version (repeat the KV
heads, flatten, ``attention_ref``); it is held against the JAX package's
``flash_attention`` run through its Pallas kernel in interpret mode, on a
subset of that package's sweep (``tests/test_kernels.py``) that keeps the
ragged S = 200 with one KV head, the hd = 128 case, all three mask modes
and both dtypes, plus hubert-xlarge's head dim 80 at a small S, and the
kernel's whole domain (head dims 1, 8, 36, 40, 96, 192 and 256 at S =
200).  Tolerances are the sweep's: f32 differs only in the order of the
sums (2e-6); bf16 outputs round to bf16, whose spacing near the outputs'
magnitude (about 0.5) is 2e-3, and both sides accumulate in f32 (2e-2).

Beyond the sweep, every input the JAX wrapper takes: head dims past one
CTA's tile (264, 300, 512), f16, q, k and v in three dtypes, and a head
dim that is not contiguous, each against the JAX kernel in interpret
mode: f32 within 1e-5, f16 and bf16 outputs within one spacing of their
dtype (both sides compute in f32 and round once).  The CUDA kernel itself
is held against the same plain version on the card by ``chip_smoke.py``.
The wrapper refuses what the JAX kernel would not compute the same (float64,
which JAX narrows to f32), and ``takes_tma`` sends to the wgmma kernel only
what TMA can map.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jflash
from repro.kernels.flash_attention.ref import attention_ref as jref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels import widest_dtype
from repro_torch.kernels.flash_attention.ops import (takes_tma,
                                                     tensor_map_spec)
from repro_torch.kernels.flash_attention.ref import attention_ref
from torch_spacing import assert_within_one_spacing

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
    (dict(KV=3), "H % KV"),
    (dict(window=-1), "window"),
    (dict(dtype=torch.float64), "float32, bfloat16 or float16"),
    (dict(device="meta"), "no kernel for device"),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(change, match):
    hd, KV = change.get("hd", 32), change.get("KV", 2)
    dtype = change.get("dtype", torch.float32)
    dev = change.get("device", "cpu")
    q = torch.zeros((1, 8, 4, hd), dtype=dtype, device=dev)
    k = torch.zeros((1, 8, KV, hd), dtype=dtype, device=dev)
    with pytest.raises(ValueError, match=match):
        flash_attention(q, k, k.clone(), window=change.get("window", 0))


# head dims past one CTA's tile (the column-group kernels): the sweep's
# S 40, H 4, KV 2 shapes at 264 (one group of 256 and one of 8), 300 and
# 512 (two of 256)
WIDE = [(1, 40, 4, 2, hd) for hd in (264, 300, 512)]
# q, k, v of three dtypes: widened to f32 (f16 and bf16 have no common
# narrower type), the output rounded once to q's dtype
MIXED = ("float16", "bfloat16", "float32")


@pytest.mark.parametrize("B,S,H,KV,hd", WIDE)
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 6),
                                           (False, 0)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_flash_attention_wide_head_dims_match_jax_kernel(B, S, H, KV, hd,
                                                         causal, window,
                                                         dtype):
    """The head dims the wrapper once refused, against the JAX kernel in
    interpret mode: f32 within 1e-5 (the order of the sums), f16 and bf16
    within one spacing of the output dtype."""
    (jq, jk, jv), (q, k, v) = _both(_inputs(B, S, S, H, KV, hd), dtype)
    want = jflash(jq, jk, jv, causal=causal, window=window, interpret=True)
    got = flash_attention(q, k, v, causal=causal, window=window)
    assert got.dtype == q.dtype and got.shape == (B, S, H, hd)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-5, rtol=1e-5)
    else:
        assert_within_one_spacing(got, want, dtype, TOL["float32"])


@pytest.mark.parametrize("B,S,H,KV,hd", [(1, 200, 4, 1, 32),
                                         (2, 64, 8, 8, 128),
                                         (1, 72, 2, 1, 80),
                                         (1, 40, 4, 2, 300)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 6),
                                           (False, 0)])
@pytest.mark.parametrize("dtypes", [("float16",) * 3, MIXED,
                                    MIXED[::-1]],
                         ids=["f16", "f16-bf16-f32", "f32-bf16-f16"])
def test_flash_attention_f16_and_mixed_dtypes_match_jax_kernel(
        B, S, H, KV, hd, causal, window, dtypes):
    """f16, and q, k, v in three dtypes (the JAX kernel widens each to f32
    and writes q's dtype), within one spacing of the output dtype, or 1e-5
    where the output is f32."""
    arrs = _inputs(B, S, S, H, KV, hd)
    jargs = [jnp.asarray(a).astype(d) for a, d in zip(arrs, dtypes)]
    targs = [torch.tensor(a).to(getattr(torch, d))
             for a, d in zip(arrs, dtypes)]
    want = jflash(*jargs, causal=causal, window=window, interpret=True)
    got = flash_attention(*targs, causal=causal, window=window)
    assert got.dtype == targs[0].dtype and got.shape == (B, S, H, hd)
    if dtypes[0] == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-5, rtol=1e-5)
    else:
        assert_within_one_spacing(got, want, dtypes[0], TOL["float32"])


@pytest.mark.parametrize("hd", [32, 300])
def test_wrapper_takes_a_head_dim_that_is_not_contiguous(hd):
    """q, k and v with the head dim strided (a transposed layout), as the
    JAX function takes any array: the same result as contiguous copies."""
    q, k, v = (torch.tensor(a) for a in _inputs(1, 8, 8, 4, 2, hd))
    qt, kt, vt = (x.transpose(2, 3).contiguous().transpose(2, 3)
                  for x in (q, k, v))
    assert qt.stride(3) != 1
    want = jflash(*(jnp.asarray(x.numpy()) for x in (q, k, v)),
                  causal=True, window=0, interpret=True)
    got = flash_attention(qt, kt, vt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    torch.testing.assert_close(got, flash_attention(q, k, v), atol=0,
                               rtol=0)


def test_widest_dtype_widens_exactly():
    """The dtype the kernel runs in: the widest present; bf16 and f16,
    neither of which holds the other, widen to f32."""
    def t(dt):
        return torch.zeros(1, dtype=dt)
    f16, bf16, f32 = torch.float16, torch.bfloat16, torch.float32
    assert widest_dtype(t(f16), t(f16), t(f16)) == f16
    assert widest_dtype(t(bf16), t(bf16), t(bf16)) == bf16
    assert widest_dtype(t(f16), t(bf16), t(bf16)) == f32
    assert widest_dtype(t(bf16), t(f32), t(bf16)) == f32


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
