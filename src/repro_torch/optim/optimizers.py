"""SGD(+momentum) and AdamW over parameter trees (nested dicts of tensors).

API mirrors the JAX package's (and optax's): ``opt.init(params) -> state``;
``opt.update(grads, state, params) -> (updates, state)``; apply with
:func:`apply_updates`.  States are dicts of tensor trees, so a checkpoint
(``repro_torch.checkpoint``) holds them as it holds parameters.  The
arithmetic is the reference's, operation for operation: AdamW keeps f32
moments, an int32 step, bias corrections ``1 - b**t`` on the f32 step and
decoupled weight decay, and casts each update to its parameter's dtype.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32 (a 0-dim tensor)."""
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float()))
                          for leaf in tree_leaves(tree)))


def clip_by_global_norm(tree, max_norm: float):
    """(``tree`` scaled by ``min(1, max_norm / max(norm, 1e-9))``, the
    global norm)."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale, tree), norm


def sgd(lr: float, momentum: float = 0.0) -> Optimizer:
    def init(params):
        if momentum:
            return {"mu": tree_map(torch.zeros_like, params)}
        return {}

    def update(grads, state, params=None):
        if momentum:
            mu = tree_map(lambda m, g: momentum * m + g, state["mu"], grads)
            return tree_map(lambda m: -lr * m, mu), {"mu": mu}
        return tree_map(lambda g: -lr * g, grads), state

    return Optimizer(init, update)


def adamw(lr: float, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    def init(params):
        first = tree_leaves(params)[0]
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "step": torch.zeros((), dtype=torch.int32,
                                    device=first.device)}

    def update(grads, state, params):
        step = state["step"] + 1
        t = step.float()
        bc1 = 1.0 - b1 ** t
        bc2 = 1.0 - b2 ** t
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.float(),
                     state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * torch.square(
            g.float()), state["v"], grads)

        def upd(m_, v_, p):
            u = -lr * (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps)
            if weight_decay:
                u = u - lr * weight_decay * p.float()
            return u.to(p.dtype)
        updates = tree_map(upd, m, v, params)
        return updates, {"m": m, "v": v, "step": step}

    return Optimizer(init, update)


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p.float() + u.float()).to(p.dtype),
                    params, updates)
