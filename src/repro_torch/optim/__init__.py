"""Optimizers over parameter dicts of tensors."""
from repro_torch.optim.optimizers import Optimizer, apply_updates, sgd
