"""Step functions of the training and serving entry points, as in the JAX
package's ``launch/steps.py``:

  train_step(params, opt_state, batch)   -> (params, opt_state, loss)
  prefill_step(params, batch)            -> logits
  decode_step(params, cache, tokens)     -> (logits, cache)   [serve_step]
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import (LONG_CONTEXT_WINDOW, ModelConfig,
                                      ShapeConfig)
from repro_torch.models import registry as R
from repro_torch.models import spmd
from repro_torch.optim import Optimizer, adamw, apply_updates
from repro_torch.tree import tree_paths, tree_unflatten


def window_for(cfg: ModelConfig, shape: ShapeConfig) -> int:
    """Sliding-window size: full-attention archs (GQA or MLA) get a window
    only for long_500k (the sub-quadratic carve-out); SSM/hybrid run
    native — the hybrid's shared-attention cache is itself windowed at
    long context."""
    if shape.name == "long_500k" and (cfg.num_heads > 0 or cfg.use_mla):
        return LONG_CONTEXT_WINDOW
    return 0


def cache_len_for(cfg: ModelConfig, shape: ShapeConfig) -> int:
    w = window_for(cfg, shape)
    return min(shape.seq_len, w) if w else shape.seq_len


def make_optimizer(lr: float = 3e-4) -> Optimizer:
    return adamw(lr, weight_decay=0.1)


def loss_and_grads(params, cfg: ModelConfig, batch, *, window: int = 0,
                   impl: str = "plain", q_chunks: int = 1):
    """(loss, metrics, gradients): ``R.train_loss`` (its total, with the
    moe family's ``0.01 * aux``) and its gradient with respect to every
    leaf of ``params``, as a tree of the same structure (the reference's
    ``jax.value_and_grad(R.train_loss, has_aux=True)``).  The leaves are
    differentiated as they are, so they must require grad or be detached
    leaves: ``params`` is not modified."""
    pairs = tree_paths(params)
    leaves = [leaf.detach().requires_grad_(True) for _, leaf in pairs]
    p = tree_unflatten([path for path, _ in pairs], leaves)
    with torch.enable_grad():
        loss, metrics = R.train_loss(p, cfg, batch, window=window,
                                     impl=impl, q_chunks=q_chunks)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    # a leaf the loss does not reach (an encoder's token table) gets zeros,
    # as jax.grad gives it; a DTensor gradient's partial sums are reduced
    # once here, not at each use
    grads = [torch.zeros_like(x) if g is None else spmd.reduced_once(g)
             for x, g in zip(leaves, grads)]
    return (spmd.reduced_once(loss.detach()),
            {k: v.detach() for k, v in metrics.items()},
            tree_unflatten([path for path, _ in pairs], grads))


def make_train_step(cfg: ModelConfig, opt: Optional[Optimizer] = None,
                    window: int = 0, impl: str = "plain", q_chunks: int = 1):
    """One optimizer step on ``R.train_loss``.  Training differentiates the
    plain route (the reference's default ``impl="xla"``): the kernels are
    forward-only, so ``impl="kernel"`` raises ``RuntimeError`` in the
    first attention or scan call."""
    opt = opt or make_optimizer()

    def train_step(params, opt_state, batch):
        loss, _metrics, grads = loss_and_grads(
            params, cfg, batch, window=window, impl=impl, q_chunks=q_chunks)
        with torch.no_grad():
            updates, opt_state2 = opt.update(grads, opt_state, params)
            del grads
            params2 = apply_updates(params, updates)
        return params2, opt_state2, loss

    return train_step


def make_prefill_step(cfg: ModelConfig, window: int = 0,
                      impl: str = "kernel", q_chunks: int = 1):
    """``impl``: "kernel" (the JAX package's "pallas"), the family's CUDA
    kernels (flash_attention, kimi-k2's MoE layers included; chunk_scan
    for RWKV6; both for the hybrid; none for deepseek-v2, whose MLA
    attends in plain PyTorch on both routes), or "plain" (its "xla"),
    which only comparisons ask for."""
    def prefill_step(params, batch):
        logits, _aux = R.apply(params, cfg, batch, window=window, impl=impl,
                               q_chunks=q_chunks)
        return logits
    return prefill_step


def check_prefill_len(cfg: ModelConfig, prefill_len: int) -> None:
    """The RWKV6 and Mamba2 prefills run in chunks of
    ``min(cfg.chunk_size, S)`` steps, which must divide S (the JAX package
    asserts): raise ``ValueError`` for a length they do not divide."""
    c = cfg.chunk_size
    if (cfg.family in ("ssm", "hybrid") and prefill_len > c
            and prefill_len % c):
        raise ValueError(f"{cfg.name}: a prefill of {prefill_len} tokens is "
                         f"not a multiple of the chunk length {c}")


def make_decode_step(cfg: ModelConfig, window: int = 0):
    def decode_step(params, cache, batch):
        tokens = batch["tokens"] if isinstance(batch, dict) else batch
        return R.decode_step(params, cfg, cache, tokens, window=window)
    return decode_step
