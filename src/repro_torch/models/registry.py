"""Unified model API over the ported architecture families (dense, vlm,
audio, ssm), one for one with the JAX package's ``models/registry.py``.

    init_params(seed, cfg, device)               -> params tree
    apply(params, cfg, batch, ...)               -> (logits, aux)  # prefill
    init_cache(cfg, batch, cache_len, dtype)     -> cache          # decode
    decode_step(params, cfg, cache, tokens, ...) -> (logits, cache)
    train_loss(params, cfg, batch, ...)          -> (loss, metrics)  # forward
    analytic_param_count(cfg)                    -> int

The kernel route is ``impl="kernel"`` (the JAX package's ``"pallas"``):
flash_attention for the transformer families, chunk_scan for RWKV6;
``impl="plain"`` (its ``"xla"``) is the plain PyTorch route, which only
comparisons ask for.  The hybrid family (Mamba2) raises
``NotImplementedError`` until its slice is ported; so do MoE and MLA
(``models/transformer.py``).
"""
from __future__ import annotations

import math

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import rwkv as RW
from repro_torch.models import transformer as TF


_UNPORTED = {"hybrid": "its Mamba2 layers (models/mamba.py), ROADMAP queue A "
             "item 14c"}


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family in _UNPORTED:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet: it "
            f"waits for {_UNPORTED[cfg.family]}")


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
    if cfg.family == "ssm":
        return {"embed": L.init_embedding(gen, cfg, device=dev),
                "final_norm": torch.ones((cfg.d_model,), device=dev),
                "layers": RW.init_layer(gen, cfg, device=dev,
                                        lead=(cfg.num_layers,))}
    return TF.init_params(gen, cfg, device=dev)


# --------------------------------------------------------------------------
# forward (prefill) and decode
# --------------------------------------------------------------------------

def apply(params, cfg: ModelConfig, batch, *, window: int = 0,
          impl: str = "kernel", q_chunks: int = 1):
    """``impl``: "kernel" (the JAX package's "pallas"), the family's CUDA
    kernel, or "plain" (its "xla"), which only comparisons ask for."""
    _check_family(cfg)
    if cfg.family == "ssm":
        dtype = getattr(torch, cfg.dtype)
        x, _ = TF._embed_inputs(params, cfg, batch, dtype)
        state = RW.init_state(cfg, x.shape[0], dtype, device=x.device)
        layers = params["layers"]
        for l in range(cfg.num_layers):
            x, _ = RW.block(TF.layer_view(layers, l), cfg, x,
                            TF.layer_view(state, l), impl=impl)
        x = L.rms_norm(x, params["final_norm"])
        return (L.unembed(params["embed"], cfg, x),
                torch.zeros((), dtype=torch.float32, device=x.device))
    return TF.forward(params, cfg, batch, window=window, impl=impl,
                      q_chunks=q_chunks)


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype, *,
               device="cuda"):
    """The decode cache: the ring-buffer KV cache of the transformer
    families, or the RWKV state (``cache_len`` unused)."""
    _check_family(cfg)
    dev = resolve_device(device)
    if cfg.family == "ssm":
        return RW.init_state(cfg, batch, dtype, device=dev)
    return TF.init_cache(cfg, batch, cache_len, dtype, device=dev)


def decode_step(params, cfg: ModelConfig, cache, tokens, *, window: int = 0):
    """One decode step.  The RWKV state is updated in place (the returned
    cache holds the same tensors); the JAX package returns new arrays."""
    _check_family(cfg)
    if cfg.family == "ssm":
        x = L.embed(params["embed"], cfg, tokens, getattr(torch, cfg.dtype))
        layers = params["layers"]
        for l in range(cfg.num_layers):
            x, st = RW.block(TF.layer_view(layers, l), cfg, x,
                             TF.layer_view(cache, l))
            for k, v in st.items():
                cache[k][l].copy_(v)
        x = L.rms_norm(x, params["final_norm"])
        return L.unembed(params["embed"], cfg, x), cache
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
               impl: str = "kernel", q_chunks: int = 1):
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
