"""SGD(+momentum) over parameter dicts of tensors.

API mirrors the JAX package's (and optax's): ``opt.init(params) -> state``;
``opt.update(grads, state, params) -> (updates, state)``; apply with
:func:`apply_updates`.  AdamW comes with the LM slice.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable


def sgd(lr: float, momentum: float = 0.0) -> Optimizer:
    def init(params: Params):
        if momentum:
            return {"mu": {k: torch.zeros_like(v) for k, v in params.items()}}
        return {}

    def update(grads: Params, state, params: Params = None):
        if momentum:
            mu = {k: momentum * state["mu"][k] + g for k, g in grads.items()}
            return {k: -lr * m for k, m in mu.items()}, {"mu": mu}
        return {k: -lr * g for k, g in grads.items()}, state

    return Optimizer(init, update)


def apply_updates(params: Params, updates: Params) -> Params:
    return {k: p + updates[k] for k, p in params.items()}
