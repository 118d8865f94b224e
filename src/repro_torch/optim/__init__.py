"""Optimizers over parameter trees of tensors."""
from repro_torch.optim.optimizers import (Optimizer, adamw, apply_updates,
                                          clip_by_global_norm, global_norm,
                                          sgd)

__all__ = ["Optimizer", "sgd", "adamw", "apply_updates", "global_norm",
           "clip_by_global_norm"]
