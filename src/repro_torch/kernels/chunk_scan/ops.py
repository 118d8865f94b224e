"""The chunk_scan wrapper: the chunked linear recurrence over the model's
(B, T, H, ·) layout, as the JAX package's ``kernels/chunk_scan/ops.py``.

A tensor on the CPU takes the plain version (``ref.chunk_scan_ref``, the
sequential recurrence, which clamps the log-decay through
``scan_ops._prep_decay`` as the JAX package does); a CUDA tensor launches
the CUDA kernel (``csrc/chunk_scan.cu``), or raises.  It reads r, k, v
and the raw log-decay through their strides (a scalar per-head decay with
a channel stride of 0) and clamps the decay as it loads it, so no clamped
copy is made.  ``chunk_scan.launches`` counts calls, one a layer: each is
one kernel launch, after the zeroing of its small sync buffer;
``chunk_scan.wide_launches`` counts those of them that ran the
channel-block kernel (K above 128).

The kernel takes any K, any V and any chunk that divides T: a chunk longer
than a sub-block of the kernel (``chunk_scan_sub_steps``: 128 steps at K
<= 64, fewer at wider K, where the tiles take more shared memory) runs as
sub-blocks of it, in order; K above 128 streams through 256-channel
tiles in blocks of 256; K or V that is not a multiple of 16 bytes takes the
kernel's element loads.

It takes every input the JAX package's wrapper takes: r, k and v of mixed
dtypes are widened, exactly, to the widest of them (a bf16 and f16 mix to
f32), the kernel runs on the widened operands, and y is rounded once to
v's dtype, as the JAX kernel computes in f32 and rounds once; RWKV6 mode
without a bonus takes a zero bonus, as the JAX wrapper does.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.kernels.chunk_scan.ref import chunk_scan_ref
from repro_torch.models.scan_ops import check_chunk

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_SIGNATURES = {
    "chunk_scan_launch": ([_PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR,
                           _PTR, _PTR, _INT, _INT, _INT, _INT, _INT, _INT,
                           _INT, _INT, _INT, _PTR, _PTR], _INT),
    "chunk_scan_sub_steps": ([_INT, _INT], _INT),
    "chunk_scan_channel_blocks": ([_INT], _INT),
}


def _check(r, k, v, log_decay, state0, bonus, include_current, chunk):
    if r.dim() != 4 or k.shape != r.shape or v.dim() != 4 \
            or v.shape[:3] != r.shape[:3]:
        raise ValueError(f"chunk_scan: r, k must be (B, T, H, K) and v (B, "
                         f"T, H, V), got {tuple(r.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, T, H, K = r.shape
    V = v.shape[-1]
    if tuple(log_decay.shape) not in ((B, T, H), (B, T, H, K)):
        raise ValueError(f"chunk_scan: log_decay must be (B, T, H) or (B, T, "
                         f"H, K), got {tuple(log_decay.shape)}")
    if K == 0 or V == 0:
        raise ValueError(f"chunk_scan: need K > 0 and V > 0, got K={K}, "
                         f"V={V}")
    if T == 0 or chunk < 1:
        raise ValueError(f"chunk_scan: need T > 0 and a chunk of at least "
                         f"one step, got T={T}, chunk={chunk}")
    check_chunk(T, min(chunk, T))
    if any(t.dtype not in _DTYPES for t in (r, k, v)):
        raise ValueError(f"chunk_scan: r, k, v must be float32, bfloat16 "
                         f"or float16, got {r.dtype}, {k.dtype}, {v.dtype}")
    if state0 is not None and tuple(state0.shape) != (B, H, K, V):
        raise ValueError(f"chunk_scan: state0 must be {(B, H, K, V)}, got "
                         f"{tuple(state0.shape)}")
    if bonus is not None and tuple(bonus.shape) != (H, K):
        raise ValueError(f"chunk_scan: the bonus must be {(H, K)}, got "
                         f"{tuple(bonus.shape)}")
    devs = {t.device for t in (r, k, v, log_decay, state0, bonus)
            if t is not None}
    if len(devs) != 1:
        raise ValueError(f"chunk_scan: operands on {sorted(map(str, devs))}")


def chunk_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               log_decay: torch.Tensor, state0=None, *,
               include_current: bool = True, bonus=None, chunk: int = 64):
    """Same contract as ``models.scan_ops.chunked_scan`` (B, T, H, ·):
    r, k (B, T, H, K), v (B, T, H, V), each float32, bfloat16 or float16;
    log_decay (B, T, H, K) or (B, T, H); state0 (B, H, K, V); bonus (H, K)
    (RWKV6 mode, ``include_current=False``; zero where not given).  Chunks
    of ``min(chunk, T)`` steps, which must divide T.  Returns (y (B, T, H,
    V) in v's dtype, final state (B, H, K, V) f32), computed in f32 on the
    operands widened to ``kernels.widest_dtype``.  Forward only: with grad
    mode on and an operand that requires grad it raises ``RuntimeError``
    on every device (the kernel has no backward; training takes
    ``impl="plain"``)."""
    _check(r, k, v, log_decay, state0, bonus, include_current, chunk)
    kernels.refuse_grad("chunk_scan", r, k, v, log_decay, state0, bonus)
    dev = r.device
    if dev.type == "cpu":
        return chunk_scan_ref(r, k, v, log_decay, state0,
                              include_current=include_current, bonus=bonus)
    if dev.type != "cuda":
        raise ValueError(f"chunk_scan: no kernel for device {dev}")
    B, T, H, K = r.shape
    V = v.shape[-1]
    Lc = min(chunk, T)
    v_dtype = v.dtype
    dt = kernels.widest_dtype(r, k, v)
    r, k, v = (t.to(dt) for t in (r, k, v))
    ld = log_decay.float()             # no copy for the model's f32 decay
    ld_strides = ld.stride() if ld.dim() == 4 else (*ld.stride(), 0)
    s0 = (torch.zeros((B, H, K, V), dtype=torch.float32, device=dev)
          if state0 is None else state0.float().contiguous())
    u = None if include_current else (
        torch.zeros((H, K), dtype=torch.float32, device=dev) if bonus is None
        else bonus.float().contiguous())
    y = torch.empty((B, T, H, V), dtype=dt, device=dev)
    s_fin = torch.empty((B, H, K, V), dtype=torch.float32, device=dev)
    lib = kernels.library("chunk_scan", _SIGNATURES)
    # chunks as sub-blocks of at most the kernel's steps at this K, in order
    sub = min(Lc, lib.chunk_scan_sub_steps(_DTYPES[dt], K))
    nc = T // Lc * -(-Lc // sub)
    # the state after each sub-block, handed to the next sub-block's CTA;
    # the kernel's work-item counter and one flag per (sub-block, head, 64
    # columns)
    work = torch.empty((B * H, nc, K, V), dtype=torch.float32, device=dev)
    sync = torch.zeros(1 + B * H * nc * -(-V // 64), dtype=torch.int32,
                       device=dev)
    strides = (ctypes.c_longlong * 16)(*r.stride(), *k.stride(),
                                       *v.stride(), *ld_strides)
    with torch.cuda.device(dev):
        rc = lib.chunk_scan_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), ld.data_ptr(),
            s0.data_ptr(), None if u is None else u.data_ptr(),
            y.data_ptr(), s_fin.data_ptr(), work.data_ptr(), sync.data_ptr(),
            _DTYPES[dt], B, T, H, K, V, Lc, sub,
            int(bool(include_current)),
            ctypes.cast(strides, _PTR),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise kernels.launch_error(lib, "chunk_scan", rc)
    chunk_scan.launches += 1
    if lib.chunk_scan_channel_blocks(K):
        chunk_scan.wide_launches += 1
    return y.to(v_dtype), s_fin


chunk_scan.launches = 0
chunk_scan.wide_launches = 0
