"""Staleness-discounted model aggregation (paper eq. 14): a CUDA kernel and
its plain PyTorch version."""
from repro_torch.kernels.fed_agg.ops import (fed_agg, fed_agg_bank,
                                             fed_agg_pytree)
