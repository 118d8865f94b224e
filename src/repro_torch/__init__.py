"""PyTorch port of the AsyncFLEO reproduction, for one NVIDIA H100.

The JAX package ``repro`` beside this one is the reference; this package
imports nothing of it.  Subpackages mirror ``repro``'s layout.  Host-side
orbital and timing math is numpy, copied from the reference; tensor code
is PyTorch; the reference's Pallas TPU kernels on the ported path are CUDA
C++ kernels for Hopper under ``csrc/`` (see ``repro_torch.kernels``).

Every entry point takes ``device`` (default ``"cuda"``).  Asking for CUDA
where there is no card raises ``RuntimeError``; nothing moves to the CPU on
its own.  Matrix products and convolutions run in full float32: TF32 is
switched off here, once, for the whole process.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device="cuda") -> torch.device:
    """The ``torch.device`` for ``device``; raises ``RuntimeError`` when it
    names CUDA and no card is visible (the port never falls back to the
    CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} asked for, but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    return dev
