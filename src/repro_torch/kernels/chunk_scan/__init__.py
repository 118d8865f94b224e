"""Chunked linear recurrence (RWKV6 / Mamba2-SSD): a CUDA kernel and its
plain PyTorch version."""
from repro_torch.kernels.chunk_scan.ops import chunk_scan
