"""The fed_agg wrapper: eq. 14's contraction over a (C, N) model stack and,
in the same launch, an optional second (C2, N) stack; and its bank and
pytree forms, which flatten and stack on the device, then make one
``fed_agg`` call.

A tensor on the CPU takes the plain version (``ref.py``); a CUDA tensor
launches the CUDA kernel (``csrc/fed_agg.cu``) or raises.  ``fed_agg.launches``
counts kernel launches: a bare counter, exact where one thread launches.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.core.modelbank import FlatSpec, flat_base
from repro_torch.kernels.fed_agg.ref import fed_agg_ref

_PTR = ctypes.c_void_p
_SIGNATURES = {
    "fed_agg_launch": ([_PTR, _PTR, ctypes.c_int, _PTR, _PTR, ctypes.c_int,
                        _PTR, ctypes.c_float, _PTR, ctypes.c_longlong, _PTR],
                       ctypes.c_int),
}


def load() -> None:
    """Load the kernel's library (building it if needed) without a launch:
    code that launches from several threads loads it first, since the
    library table has no lock."""
    kernels.library("fed_agg", _SIGNATURES)


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


def _check_stack(name: str, t: torch.Tensor) -> None:
    if t.dim() != 2:
        raise ValueError(f"fed_agg: {name} must be 2-D (C, N), got "
                         f"{tuple(t.shape)}")
    if t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"fed_agg: {name} must be contiguous float32")


def _span(t: torch.Tensor):
    start = t.data_ptr()
    return start, start + t.numel() * t.element_size()


def _overlaps(a: torch.Tensor, b: torch.Tensor) -> bool:
    (a0, a1), (b0, b1) = _span(a), _span(b)
    return a0 < b1 and b0 < a1


def fed_agg(stack: torch.Tensor, gamma: torch.Tensor,
            base: Optional[torch.Tensor] = None, base_weight: float = 0.0,
            *, out: Optional[torch.Tensor] = None,
            stack2: Optional[torch.Tensor] = None,
            gamma2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out = base_weight * base + gamma @ stack + gamma2 @ stack2``.

    ``stack`` (C, N), ``gamma`` (C,), ``base`` and ``out`` (N,): contiguous
    float32 on one device.  ``stack2`` (C2, N) with ``gamma2`` (C2,) is an
    optional second segment (the epoch's carried stragglers beside its
    bank), summed in the same launch; both or neither are given.
    ``base=None`` drops the base term.  ``out`` may be ``base`` itself (an
    in-place update) but must not overlap anything else; ``out=None``
    allocates the result.  C = C2 = 0 gives ``base_weight * base``.
    """
    _check_stack("stack", stack)
    C, N = stack.shape
    dev = stack.device
    _check_vector("gamma", gamma, C, dev)
    if (stack2 is None) != (gamma2 is None):
        raise ValueError("fed_agg: stack2 and gamma2 come together")
    C2 = 0
    if stack2 is not None:
        _check_stack("stack2", stack2)
        C2 = stack2.shape[0]
        if stack2.shape[1] != N:
            raise ValueError(f"fed_agg: stack2 has {stack2.shape[1]} "
                             f"columns, stack {N}")
        if stack2.device != dev:
            raise ValueError(f"fed_agg: stack2 is on {stack2.device}, the "
                             f"stack on {dev}")
        _check_vector("gamma2", gamma2, C2, dev)
    if base is not None:
        _check_vector("base", base, N, dev)
    if out is not None:
        _check_vector("out", out, N, dev)
        for name, t in (("stack", stack), ("gamma", gamma),
                        ("stack2", stack2), ("gamma2", gamma2)):
            if t is not None and t.numel() and _overlaps(out, t):
                raise ValueError(f"fed_agg: out overlaps {name}")
        if (base is not None and _overlaps(out, base)
                and out.data_ptr() != base.data_ptr()):
            raise ValueError("fed_agg: out overlaps base without being it")
    if base is None:
        base_weight = 0.0
    if dev.type == "cpu":
        res = fed_agg_ref(stack, gamma, base, base_weight, stack2, gamma2)
        return res if out is None else out.copy_(res)
    if dev.type != "cuda":
        raise ValueError(f"fed_agg: no kernel for device {dev}")
    lib = kernels.library("fed_agg", _SIGNATURES)
    if out is None:
        out = torch.empty(N, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.fed_agg_launch(
            stack.data_ptr(), gamma.data_ptr(), C,
            None if C2 == 0 else stack2.data_ptr(),
            None if C2 == 0 else gamma2.data_ptr(), C2,
            None if base is None else base.data_ptr(),
            float(base_weight), out.data_ptr(), N,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise kernels.launch_error(lib, "fed_agg", rc)
    fed_agg.launches += 1
    return out


fed_agg.launches = 0


def _weights(gamma, device: torch.device) -> torch.Tensor:
    """A host vector or a tensor of weights as contiguous float32 on
    ``device``."""
    if not isinstance(gamma, torch.Tensor):
        gamma = np.asarray(gamma, np.float32)
    return torch.as_tensor(gamma, dtype=torch.float32,
                           device=device).contiguous()


def fed_agg_bank(bank, gamma, base=None,
                 base_weight: float = 0.0) -> torch.Tensor:
    """Aggregate a ``ModelBank`` in one ``fed_agg`` call: ``bank.stack`` is
    already the kernel's (C, N) layout.  ``gamma`` is a host vector or a
    tensor; ``base`` a flat (N,) tensor or a parameter dict (flattened
    through the bank's spec).  Returns the flat (N,) model."""
    dev = bank.stack.device
    return fed_agg(bank.stack, _weights(gamma, dev),
                   flat_base(bank.spec, base), base_weight)


def fed_agg_pytree(models: Sequence[Dict[str, torch.Tensor]], gamma,
                   base: Optional[Dict[str, torch.Tensor]] = None,
                   base_weight: float = 0.0) -> Dict[str, torch.Tensor]:
    """Aggregate a list of parameter dicts into one (paper eq. 14): every
    model flattened once and stacked on the device, one ``fed_agg`` call
    over the stack, the result unflattened to the models' keys and shapes
    (views into one new flat tensor)."""
    spec = FlatSpec.of(models[0])
    stack = torch.stack([spec.flatten(m) for m in models])
    out = fed_agg(stack, _weights(gamma, stack.device),
                  None if base is None else spec.flatten(base), base_weight)
    return spec.unflatten(out)
