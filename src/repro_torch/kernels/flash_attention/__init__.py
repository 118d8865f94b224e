"""Online-softmax attention (flash-style): a CUDA kernel and its plain
PyTorch version."""
from repro_torch.kernels.flash_attention.ops import flash_attention
