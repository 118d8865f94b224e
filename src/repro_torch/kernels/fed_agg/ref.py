"""Plain PyTorch version of the fed_agg kernel (the CPU route and the
kernel's yardstick in the tests and ``chip_smoke.py``)."""
from typing import Optional

import torch


def fed_agg_ref(stack: torch.Tensor, gamma: torch.Tensor,
                base: Optional[torch.Tensor],
                base_weight: float) -> torch.Tensor:
    """``base_weight * base + gamma @ stack``; ``base=None`` drops the
    base term."""
    out = gamma @ stack
    if base is not None:
        out = base_weight * base + out
    return out
