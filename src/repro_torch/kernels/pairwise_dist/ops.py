"""The pairwise_dist wrapper: squared L2 distances between the rows of an
(M, N) stack of flattened models, and the grouping step's distance to w0.

A tensor on the CPU takes the plain version (``ref.py``); a CUDA tensor
launches the CUDA kernel (``csrc/pairwise_dist.cu``) or raises.
``pairwise_dist_sq.launches`` counts calls that launched the kernel (one
per call: the tiled design's three launches count once).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch import kernels
from repro_torch.kernels.pairwise_dist.ref import pairwise_dist_sq_ref

_PTR = ctypes.c_void_p
_SIGNATURES = {
    "pairwise_dist_workspace_bytes": ([ctypes.c_int, ctypes.c_longlong],
                                      ctypes.c_longlong),
    "pairwise_dist_launch": ([_PTR, _PTR, ctypes.c_int, ctypes.c_longlong,
                              _PTR, _PTR, _PTR, _PTR], ctypes.c_int),
}

# The kernel's ticket counter, one zeroed word per (device, stream): the
# kernel leaves it 0, so it is allocated and zeroed once, never per call.
# Calls on one stream run in order; a second stream gets its own word.
_COUNTERS: Dict[Tuple[int, int], torch.Tensor] = {}


def _counter(dev: torch.device, stream: int) -> torch.Tensor:
    key = (dev.index, stream)
    c = _COUNTERS.get(key)
    if c is None:
        c = _COUNTERS[key] = torch.zeros(1, dtype=torch.int32, device=dev)
    return c


def _check_f32(name: str, t: torch.Tensor) -> None:
    if t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"pairwise_dist_sq: {name} must be contiguous "
                         "float32")


def pairwise_dist_sq(x: torch.Tensor, *,
                     ref: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(M, N) contiguous float32 -> (M, M) squared distances
    ``max(n_i + n_j - 2 x_i·x_j, 0)``, M >= 1.

    With ``ref`` (N,), the rows are ``ref`` then the rows of ``x``: the
    result is (M + 1, M + 1) and the kernel reads ``ref`` in place (the CPU
    route concatenates).  The kernel takes few rows (M <= 8) in one
    launch and more through a register-tiled Gram
    (``csrc/pairwise_dist.cu``)."""
    if x.dim() != 2:
        raise ValueError(f"pairwise_dist_sq: x must be (M, N), got "
                         f"{tuple(x.shape)}")
    _check_f32("x", x)
    dev = x.device
    if ref is not None:
        if ref.dim() != 1 or ref.shape[0] != x.shape[1]:
            raise ValueError(f"pairwise_dist_sq: ref must have shape "
                             f"({x.shape[1]},), got {tuple(ref.shape)}")
        _check_f32("ref", ref)
        if ref.device != dev:
            raise ValueError(f"pairwise_dist_sq: ref is on {ref.device}, x "
                             f"on {dev}")
    M = x.shape[0] + (ref is not None)
    N = x.shape[1]
    if M < 1:
        raise ValueError("pairwise_dist_sq: no rows")
    if dev.type == "cpu":
        return pairwise_dist_sq_ref(x if ref is None
                                    else torch.cat([ref[None, :], x]))
    if dev.type != "cuda":
        raise ValueError(f"pairwise_dist_sq: no kernel for device {dev}")
    lib = kernels.library("pairwise_dist", _SIGNATURES)
    out = torch.empty((M, M), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        ws = torch.empty(lib.pairwise_dist_workspace_bytes(M, N),
                         dtype=torch.uint8, device=dev)
        rc = lib.pairwise_dist_launch(
            x.data_ptr(), None if ref is None else ref.data_ptr(), M, N,
            ws.data_ptr(), _counter(dev, stream).data_ptr(), out.data_ptr(),
            stream)
    if rc != 0:
        raise kernels.launch_error(lib, "pairwise_dist", rc)
    pairwise_dist_sq.launches += 1
    return out


pairwise_dist_sq.launches = 0


def dist_to_ref(stack: torch.Tensor, ref: torch.Tensor, *,
                squared: bool = False) -> torch.Tensor:
    """L2 distance of each row of an (M, N) stack to one (N,) reference
    (the grouping step's distance to w0, paper Fig. 5b).

    Up to 64 rows go through ``pairwise_dist_sq`` with ``ref`` as row 0
    (read in place on the card); larger stacks take a direct row-wise
    reduction, as in the JAX package (``repro/kernels/pairwise_dist/ops.py``).
    """
    if stack.shape[0] > 64:
        d2 = ((stack - ref[None, :]) ** 2).sum(dim=1)
    else:
        d2 = pairwise_dist_sq(stack, ref=ref)[0, 1:]
    return d2 if squared else torch.sqrt(d2)
