"""The fed_agg wrapper: eq. 14's contraction over a (C, N) model stack.

A tensor on the CPU takes the plain version (``ref.py``); a CUDA tensor
launches the CUDA kernel (``csrc/fed_agg.cu``) or raises.  ``fed_agg.launches``
counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch import kernels
from repro_torch.kernels.fed_agg.ref import fed_agg_ref

_PTR = ctypes.c_void_p
_SIGNATURES = {
    "fed_agg_launch": ([_PTR, _PTR, _PTR, ctypes.c_float, _PTR, ctypes.c_int,
                        ctypes.c_longlong, _PTR], ctypes.c_int),
}


def _check_vector(name: str, t: torch.Tensor, n: int,
                  device: torch.device) -> None:
    if t.dim() != 1 or t.shape[0] != n:
        raise ValueError(f"fed_agg: {name} must have shape ({n},), "
                         f"got {tuple(t.shape)}")
    if t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"fed_agg: {name} must be contiguous float32")
    if t.device != device:
        raise ValueError(f"fed_agg: {name} is on {t.device}, the stack on "
                         f"{device}")


def _span(t: torch.Tensor):
    start = t.data_ptr()
    return start, start + t.numel() * t.element_size()


def _overlaps(a: torch.Tensor, b: torch.Tensor) -> bool:
    (a0, a1), (b0, b1) = _span(a), _span(b)
    return a0 < b1 and b0 < a1


def fed_agg(stack: torch.Tensor, gamma: torch.Tensor,
            base: Optional[torch.Tensor] = None, base_weight: float = 0.0,
            *, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out = base_weight * base + sum_c gamma[c] * stack[c]``.

    ``stack`` (C, N), ``gamma`` (C,), ``base`` and ``out`` (N,): contiguous
    float32 on one device.  ``base=None`` drops the base term.  ``out`` may
    be ``base`` itself (an in-place update) but must not overlap anything
    else; ``out=None`` allocates the result.  C = 0 gives
    ``base_weight * base``.
    """
    if stack.dim() != 2:
        raise ValueError(f"fed_agg: stack must be 2-D (C, N), got "
                         f"{tuple(stack.shape)}")
    if stack.dtype != torch.float32 or not stack.is_contiguous():
        raise ValueError("fed_agg: stack must be contiguous float32")
    C, N = stack.shape
    dev = stack.device
    _check_vector("gamma", gamma, C, dev)
    if base is not None:
        _check_vector("base", base, N, dev)
    if out is not None:
        _check_vector("out", out, N, dev)
        for name, t in (("stack", stack), ("gamma", gamma)):
            if t.numel() and _overlaps(out, t):
                raise ValueError(f"fed_agg: out overlaps {name}")
        if (base is not None and _overlaps(out, base)
                and out.data_ptr() != base.data_ptr()):
            raise ValueError("fed_agg: out overlaps base without being it")
    if base is None:
        base_weight = 0.0
    if dev.type == "cpu":
        res = fed_agg_ref(stack, gamma, base, base_weight)
        return res if out is None else out.copy_(res)
    if dev.type != "cuda":
        raise ValueError(f"fed_agg: no kernel for device {dev}")
    lib = kernels.library("fed_agg", _SIGNATURES)
    if out is None:
        out = torch.empty(N, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.fed_agg_launch(
            stack.data_ptr(), gamma.data_ptr(),
            None if base is None else base.data_ptr(),
            float(base_weight), out.data_ptr(), C, N,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise kernels.launch_error(lib, "fed_agg", rc)
    fed_agg.launches += 1
    return out


fed_agg.launches = 0
