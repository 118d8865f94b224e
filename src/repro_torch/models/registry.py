"""Unified model API over the ported architecture families (dense, vlm,
audio), one for one with the JAX package's ``models/registry.py``.

    init_params(seed, cfg, device)               -> params tree
    apply(params, cfg, batch, ...)               -> (logits, aux)  # prefill
    init_cache(cfg, batch, cache_len, dtype)     -> cache          # decode
    decode_step(params, cfg, cache, tokens, ...) -> (logits, cache)
    train_loss(params, cfg, batch, ...)          -> (loss, metrics)  # forward
    analytic_param_count(cfg)                    -> int

The SSM (RWKV6) and hybrid (Mamba2) families raise
``NotImplementedError`` until their slice is ported; so do MoE and MLA
(``models/transformer.py``).
"""
from __future__ import annotations

import math

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as TF


_UNPORTED = {"ssm": "RWKV6 with chunk_scan, ROADMAP queue A item 14b",
             "hybrid": "Mamba2 with chunk_scan, ROADMAP queue A item 14c"}


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family in _UNPORTED:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet "
            f"({_UNPORTED[cfg.family]})")


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def init_params(seed: int, cfg: ModelConfig, *, device="cuda"):
    """Parameters drawn from ``seed`` by a ``torch.Generator`` on
    ``device`` (the JAX package's key gives other numbers: tests carry
    weights across with ``core.modelbank.params_from_jax``).
    ``device="meta"`` gives shapes only."""
    _check_family(cfg)
    dev = torch.device(device)
    if dev.type != "meta":
        dev = resolve_device(dev)
    gen = torch.Generator(device="cpu" if dev.type == "meta" else dev)
    gen.manual_seed(int(seed))
    return TF.init_params(gen, cfg, device=dev)


# --------------------------------------------------------------------------
# forward (prefill) and decode
# --------------------------------------------------------------------------

def apply(params, cfg: ModelConfig, batch, *, window: int = 0,
          impl: str = "flash", q_chunks: int = 1):
    """``impl``: "flash" (the JAX package's "pallas"), the flash_attention
    kernel, or "plain" (its "xla"), which only comparisons ask for."""
    _check_family(cfg)
    return TF.forward(params, cfg, batch, window=window, impl=impl,
                      q_chunks=q_chunks)


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype, *,
               device="cuda"):
    _check_family(cfg)
    return TF.init_cache(cfg, batch, cache_len, dtype,
                         device=resolve_device(device))


def decode_step(params, cfg: ModelConfig, cache, tokens, *, window: int = 0):
    _check_family(cfg)
    return TF.decode_step(params, cfg, cache, tokens, window=window)


# --------------------------------------------------------------------------
# losses (forward only: the port has no LM training yet)
# --------------------------------------------------------------------------

def _ce(logits, labels, mask=None):
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / mask.sum().clamp(min=1.0)


def train_loss(params, cfg: ModelConfig, batch, *, window: int = 0,
               impl: str = "flash", q_chunks: int = 1):
    logits, aux = apply(params, cfg, batch, window=window, impl=impl,
                        q_chunks=q_chunks)
    if cfg.family == "audio":
        loss = _ce(logits, batch["labels"], batch.get("mask"))
    elif cfg.family == "vlm":
        P = batch["prefix_embeds"].shape[1]
        text_logits = logits[:, P:]
        loss = _ce(text_logits[:, :-1], batch["tokens"][:, 1:])
    else:
        loss = _ce(logits[:, :-1], batch["tokens"][:, 1:])
    return loss, {"ce": loss, "aux": aux}


# --------------------------------------------------------------------------
# parameter counting (exact, on the meta device: no allocation)
# --------------------------------------------------------------------------

def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def analytic_param_count(cfg: ModelConfig) -> int:
    return sum(math.prod(t.shape)
               for t in _leaves(init_params(0, cfg, device="meta")))
