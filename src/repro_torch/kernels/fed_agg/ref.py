"""Plain PyTorch version of the fed_agg kernel (the CPU route and the
kernel's yardstick in the tests and ``chip_smoke.py``)."""
from typing import Optional

import torch


def fed_agg_ref(stack: torch.Tensor, gamma: torch.Tensor,
                base: Optional[torch.Tensor], base_weight: float,
                stack2: Optional[torch.Tensor] = None,
                gamma2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``base_weight * base + gamma @ stack + gamma2 @ stack2``;
    ``base=None`` drops the base term, ``stack2=None`` the second
    segment."""
    out = gamma @ stack
    if stack2 is not None:
        out = out + gamma2 @ stack2
    if base is not None:
        out = base_weight * base + out
    return out


def fed_agg_flat_ref(stack: torch.Tensor, gamma: torch.Tensor,
                     base: torch.Tensor, base_weight: float) -> torch.Tensor:
    """The JAX package's oracle of the kernel: ``base_weight * base +
    gamma @ stack`` in float32, every operand cast to float32 first."""
    stack = stack.to(torch.float32)
    return (torch.as_tensor(base_weight, dtype=torch.float32)
            * base.to(torch.float32)
            + torch.einsum("c,cn->n", gamma.to(torch.float32), stack))
