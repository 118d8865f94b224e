"""The flash_attention wrapper: GQA attention over the model's
(B, S, H, hd) layout.

A tensor on the CPU takes the plain version (``ref.attention_ref_bshd``:
repeat the KV heads and flatten, as the JAX package's wrapper does); a CUDA
tensor launches the CUDA kernel (``csrc/flash_attention.cu``), which maps
query head h to KV head h // (H // KV) and reads every operand through
its strides, or raises.  ``flash_attention.launches`` counts kernel
launches, and ``flash_attention.wide_launches`` those of them that ran the
column-group kernels (a head dim above 256).

bf16 at hd 64, 80 and 128 runs the warp-specialised wgmma kernel, which loads
q, k and v by TMA through 4-D tensor maps; ``tensor_map_spec`` computes
their dims, byte strides and boxes here, and the launcher encodes them.
Every other head dim up to 256, f16, a view TMA cannot map,
and a B * H above grid.y's 65,535 run the mma.sync kernel (bf16 or f16) or
the f32 kernel on the smallest tile that holds hd, zero-filled past it in
shared memory; rows that are not 16-byte aligned take its element loads.
A head dim above 256 runs the column-group kernels: each CTA
owns at most 256 of the output's columns and builds the whole score tile
from pieces of the head dim.

The kernel takes every input the JAX package's wrapper takes: q, k and v
of mixed dtypes are widened, exactly, to the widest of them (a bf16 and f16
mix to f32), the kernel runs on the widened operands, and its output is
rounded once to q's dtype, as the JAX kernel computes in f32 and rounds
once; a head dim that is not contiguous is copied once.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch import kernels
from repro_torch.kernels.flash_attention.ref import attention_ref_bshd

TMA_HEAD_DIMS = (64, 80, 128)  # bf16 through the wgmma kernel's tensor maps
TMA_Q_ROWS = 64                # query rows of one consumer warpgroup
TMA_KV_ROWS = 128              # keys of one K or V stage
TMA_MAX_BH = 65535             # the wgmma kernel's grid.y: one (b, h) a row
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_SIGNATURES = {
    "flash_attention_launch": ([_PTR, _PTR, _PTR, _PTR, _INT, _INT, _INT,
                                _INT, _INT, _INT, _INT, _PTR, _PTR, _INT,
                                _INT, ctypes.c_float, _PTR], _INT),
    "flash_attention_column_groups": ([_INT], _INT),
}


def tma_box_cols(hd: int) -> int:
    """The columns of one TMA box: a 128-byte swizzle row (64 bf16) where
    hd is a multiple of 64, else a 32-byte one (16: hd 80 is 5 boxes)."""
    return 64 if hd % 64 == 0 else 16


def tensor_map_spec(t: torch.Tensor, rows: int):
    """The TMA map of a (B, S, heads, hd) view as the launcher encodes it:
    dims innermost first (hd, S, heads, B), the byte strides of S, heads
    and B, and the box (``tma_box_cols(hd)``, ``rows``, 1, 1).  TMA takes
    strides that are multiples of 16 bytes only."""
    B, S, heads, hd = t.shape
    es = t.element_size()
    strides = (t.stride(1) * es, t.stride(2) * es, t.stride(0) * es)
    if t.stride(3) != 1 or any(s % 16 for s in strides):
        raise ValueError(f"flash_attention: a tensor map needs a contiguous "
                         f"head dim and byte strides that are multiples of "
                         f"16, got strides {t.stride()} of {es}-byte "
                         f"elements")
    return (hd, S, heads, B), strides, (tma_box_cols(hd), rows, 1, 1)


def takes_tma(q, k, v) -> bool:
    """Whether the wgmma kernel takes these operands: bf16 at a head dim
    of ``TMA_HEAD_DIMS``, B * H within its grid, and views whose bases and
    byte strides are multiples of 16 (what TMA maps)."""
    B, _, H, hd = q.shape
    if q.dtype != torch.bfloat16 or hd not in TMA_HEAD_DIMS \
            or B * H > TMA_MAX_BH:
        return False
    return all(t.stride(3) == 1 and t.data_ptr() % 16 == 0
               and not any(s * t.element_size() % 16 for s in t.stride()[:3])
               for t in (q, k, v))


def _check(q, k, v, window):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: q must be (B, Sq, H, hd) and k, "
                         f"v (B, Sk, KV, hd), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, hd = q.shape
    _, Sk, KV, _ = k.shape
    if k.shape[0] != B or k.shape[3] != hd or KV == 0 or H % KV:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not fit "
                         f"q {tuple(q.shape)} (same B and hd, H % KV == 0)")
    if hd == 0:
        raise ValueError("flash_attention: head dim 0")
    if any(t.dtype not in _DTYPES for t in (q, k, v)):
        raise ValueError(f"flash_attention: q, k, v must be float32, "
                         f"bfloat16 or float16, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"flash_attention: q, k, v on {q.device}, "
                         f"{k.device}, {v.device}")
    if Sk == 0 or window < 0:
        raise ValueError(f"flash_attention: need Sk > 0 and window >= 0, got "
                         f"Sk={Sk}, window={window}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd) with H % KV == 0, each
    float32, bfloat16 or float16, any head dim and any strides.
    Returns (B, Sq, H, hd) in q's dtype: softmax(q k^T / sqrt(hd)) v under
    the causal (kpos <= qpos) and window (qpos - kpos < window) masks, by
    row and column index, computed in f32 on the operands widened to
    ``kernels.widest_dtype`` and rounded once.  Forward only: with grad mode on
    and an input that requires grad it raises ``RuntimeError`` on every
    device (the kernel has no backward; training takes
    ``impl="plain"``)."""
    _check(q, k, v, window)
    kernels.refuse_grad("flash_attention", q, k, v)
    dev, q_dtype = q.device, q.dtype
    if dev.type == "cpu":
        return attention_ref_bshd(q, k, v, causal=causal, window=window)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {dev}")
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if Sq == 0 or B == 0:
        return torch.empty((B, Sq, H, hd), dtype=q.dtype, device=dev)
    dt = kernels.widest_dtype(q, k, v)
    q, k, v = (t.to(dt) if t.stride(3) == 1 else t.to(dt).contiguous()
               for t in (q, k, v))
    out = torch.empty((B, Sq, H, hd), dtype=dt, device=dev)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3])
    tma = None
    if takes_tma(q, k, v):
        specs = [tensor_map_spec(t, rows) for t, rows in (
            (q, TMA_Q_ROWS), (k, TMA_KV_ROWS), (v, TMA_KV_ROWS))]
        tma = (ctypes.c_longlong * 33)(
            *(x for spec in specs for part in spec for x in part))
    lib = kernels.library("flash_attention", _SIGNATURES)
    with torch.cuda.device(dev):
        rc = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[dt], B, Sq, Sk, H, KV, hd,
            ctypes.cast(strides, _PTR),
            None if tma is None else ctypes.cast(tma, _PTR),
            int(bool(causal)), int(window), 1.0 / math.sqrt(hd),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise kernels.launch_error(lib, "flash_attention", rc)
    flash_attention.launches += 1
    if lib.flash_attention_column_groups(hd):
        flash_attention.wide_launches += 1
    return out.to(q_dtype)


flash_attention.launches = 0
flash_attention.wide_launches = 0
