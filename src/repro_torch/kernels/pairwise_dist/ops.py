"""The pairwise_dist wrapper: squared L2 distances between the rows of an
(M, N) stack of flattened models, and the grouping step's distance to w0.

A tensor on the CPU takes the plain version (``ref.py``); a CUDA tensor
launches the CUDA kernel (``csrc/pairwise_dist.cu``) or raises.
``pairwise_dist_sq.launches`` counts kernel launches (one per call: the
call's two passes count once).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.kernels.pairwise_dist.ref import pairwise_dist_sq_ref

MAX_ROWS = 65            # dist_to_ref's largest kernel stack: 64 rows + ref

_PTR = ctypes.c_void_p
_SIGNATURES = {
    "pairwise_dist_workspace_floats": ([ctypes.c_int, ctypes.c_longlong],
                                       ctypes.c_longlong),
    "pairwise_dist_launch": ([_PTR, ctypes.c_int, ctypes.c_longlong, _PTR,
                              _PTR, _PTR], ctypes.c_int),
}


def pairwise_dist_sq(x: torch.Tensor) -> torch.Tensor:
    """(M, N) contiguous float32 -> (M, M) squared distances
    ``max(n_i + n_j - 2 x_i·x_j, 0)``, 1 <= M <= 65."""
    if x.dim() != 2 or not 1 <= x.shape[0] <= MAX_ROWS:
        raise ValueError(f"pairwise_dist_sq: x must be (M, N) with 1 <= M <= "
                         f"{MAX_ROWS}, got {tuple(x.shape)}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("pairwise_dist_sq: x must be contiguous float32")
    M, N = x.shape
    dev = x.device
    if dev.type == "cpu":
        return pairwise_dist_sq_ref(x)
    if dev.type != "cuda":
        raise ValueError(f"pairwise_dist_sq: no kernel for device {dev}")
    lib = kernels.library("pairwise_dist", _SIGNATURES)
    out = torch.empty((M, M), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        ws = torch.empty(lib.pairwise_dist_workspace_floats(M, N),
                         dtype=torch.float32, device=dev)
        rc = lib.pairwise_dist_launch(
            x.data_ptr(), M, N, ws.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise kernels.launch_error(lib, "pairwise_dist", rc)
    pairwise_dist_sq.launches += 1
    return out


pairwise_dist_sq.launches = 0


def dist_to_ref(stack: torch.Tensor, ref: torch.Tensor, *,
                squared: bool = False) -> torch.Tensor:
    """L2 distance of each row of an (M, N) stack to one (N,) reference
    (the grouping step's distance to w0, paper Fig. 5b).

    Up to 64 rows go through ``pairwise_dist_sq`` with ``ref`` prepended as
    row 0; larger stacks take a direct row-wise reduction, as in the JAX
    package (``repro/kernels/pairwise_dist/ops.py``)."""
    if stack.shape[0] > MAX_ROWS - 1:
        d2 = ((stack - ref[None, :]) ** 2).sum(dim=1)
    else:
        d2 = pairwise_dist_sq(torch.cat([ref[None, :], stack]))[0, 1:]
    return d2 if squared else torch.sqrt(d2)
