"""Unified model API over every architecture family (dense, vlm, audio,
moe, ssm, hybrid), one for one with the JAX package's
``models/registry.py``.

    init_params(seed, cfg, device)               -> params tree
    apply(params, cfg, batch, ...)               -> (logits, aux)  # prefill
    init_cache(cfg, batch, cache_len, dtype)     -> cache          # decode
    decode_step(params, cfg, cache, tokens, ...) -> (logits, cache)
    train_loss(params, cfg, batch, ...)          -> (loss, metrics)  # forward
    analytic_param_count(cfg, active_only)       -> int

The kernel route is ``impl="kernel"`` (the JAX package's ``"pallas"``):
flash_attention for the transformer families with GQA attention (the
moe family's kimi-k2 too), chunk_scan for RWKV6, both for the hybrid
family (chunk_scan in each Mamba2 layer, flash_attention in the shared
block once a group); ``impl="plain"`` (its ``"xla"``) is the plain
PyTorch route, which only comparisons ask for.  MLA (deepseek-v2)
attends in plain PyTorch on both routes, as the JAX package attends in
XLA: no kernel is on its path.
"""
from __future__ import annotations

import math

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import mamba as MB
from repro_torch.models import rwkv as RW
from repro_torch.models import spmd
from repro_torch.models import transformer as TF
from repro_torch.tree import tree_leaves

MOE_AUX_WEIGHT = 0.01


def _groups(cfg: ModelConfig):
    """The hybrid stack's (groups, Mamba2 layers a group)."""
    return cfg.num_layers // cfg.attn_every, cfg.attn_every


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def init_params(seed: int, cfg: ModelConfig, *, device="cuda"):
    """Parameters drawn from ``seed`` by a ``torch.Generator`` on
    ``device`` (the JAX package's key gives other numbers: tests carry
    weights across with ``core.modelbank.params_from_jax``).
    ``device="meta"`` gives shapes only."""
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
    if cfg.family == "hybrid":
        return {"embed": L.init_embedding(gen, cfg, device=dev),
                "final_norm": torch.ones((cfg.d_model,), device=dev),
                "mamba": MB.init_layer(gen, cfg, device=dev,
                                       lead=_groups(cfg)),
                "shared": MB.init_shared_attn(gen, cfg, device=dev)}
    return TF.init_params(gen, cfg, device=dev)


# --------------------------------------------------------------------------
# forward (prefill) and decode
# --------------------------------------------------------------------------

def apply(params, cfg: ModelConfig, batch, *, window: int = 0,
          impl: str = "kernel", q_chunks: int = 1):
    """``impl``: "kernel" (the JAX package's "pallas"), the family's CUDA
    kernels, or "plain" (its "xla"), which only comparisons ask for."""
    if cfg.family == "ssm":
        dtype = getattr(torch, cfg.dtype)
        x, _ = TF._embed_inputs(params, cfg, batch, dtype)
        state = spmd.batch_state(
            lambda b: RW.init_state(cfg, b, dtype, device=x.device), x, 1)
        layers = params["layers"]
        for l in range(cfg.num_layers):
            x, _ = TF.remat_call(cfg, RW.block, TF.layer_view(layers, l), cfg,
                                 x, TF.layer_view(state, l), impl=impl)
        x = L.rms_norm(spmd.batch_only(x), params["final_norm"])
        return (L.unembed(params["embed"], cfg, x),
                torch.zeros((), dtype=torch.float32, device=x.device))
    if cfg.family == "hybrid":
        dtype = getattr(torch, cfg.dtype)
        x, positions = TF._embed_inputs(params, cfg, batch, dtype)
        G, A = _groups(cfg)
        state = spmd.batch_state(
            lambda b: MB.init_state(cfg, b, dtype, device=x.device,
                                    lead=(G, A)), x, 2)
        shared, mamba = params["shared"], params["mamba"]
        for g in range(G):
            x = TF.remat_call(cfg, _hybrid_group, shared,
                              TF.layer_view(mamba, g),
                              TF.layer_view(state, g), cfg, x, positions,
                              window=window, impl=impl)
        x = L.rms_norm(spmd.batch_only(x), params["final_norm"])
        return (L.unembed(params["embed"], cfg, x),
                torch.zeros((), dtype=torch.float32, device=x.device))
    return TF.forward(params, cfg, batch, window=window, impl=impl,
                      q_chunks=q_chunks)


def _hybrid_group(shared, mp_g, st_g, cfg: ModelConfig, x, positions, *,
                  window: int, impl: str):
    """One hybrid group of the prefill: the shared attention block, then
    the group's Mamba2 layers."""
    x, _ = MB.shared_attn_block(shared, cfg, x, positions, None,
                                window=window, impl=impl)
    for j in range(cfg.attn_every):
        x, _ = MB.block(TF.layer_view(mp_g, j), cfg, x,
                        TF.layer_view(st_g, j), impl=impl)
    return x


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype, *,
               device="cuda"):
    """The decode cache: the ring-buffer KV cache of the transformer
    families, the RWKV state (``cache_len`` unused), or the hybrid's
    Mamba2 states stacked (groups, layers a group, ...) beside one
    ring-buffer KV cache a group for the shared block."""
    dev = resolve_device(device)
    if cfg.family == "ssm":
        return RW.init_state(cfg, batch, dtype, device=dev)
    if cfg.family == "hybrid":
        G, A = _groups(cfg)
        shape = (G, batch, cache_len, cfg.num_kv_heads,
                 cfg.resolved_head_dim)
        return {"mamba": MB.init_state(cfg, batch, dtype, device=dev,
                                       lead=(G, A)),
                "attn_k": torch.zeros(shape, dtype=dtype, device=dev),
                "attn_v": torch.zeros(shape, dtype=dtype, device=dev),
                "index": 0}
    return TF.init_cache(cfg, batch, cache_len, dtype, device=dev)


def decode_step(params, cfg: ModelConfig, cache, tokens, *, window: int = 0):
    """One decode step.  The RWKV state, the hybrid's Mamba2 states and
    every KV cache are updated in place (the returned cache holds the same
    tensors); the JAX package returns new arrays."""
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
    if cfg.family == "hybrid":
        x = L.embed(params["embed"], cfg, tokens, getattr(torch, cfg.dtype))
        idx = cache["index"]
        k_pos = L.ring_positions(idx, cache["attn_k"].shape[2], x.device)
        G, A = _groups(cfg)
        shared, mamba = params["shared"], params["mamba"]
        states = cache["mamba"]
        for g in range(G):
            attn_cache = {"k": cache["attn_k"][g], "v": cache["attn_v"][g],
                          "index": idx, "k_pos": k_pos}
            x, _ = MB.shared_attn_block(shared, cfg, x, None, attn_cache,
                                        window=window, impl="plain")
            mp_g, st_g = TF.layer_view(mamba, g), TF.layer_view(states, g)
            for j in range(A):
                x, st = MB.block(TF.layer_view(mp_g, j), cfg, x,
                                 TF.layer_view(st_g, j))
                for k, v in st.items():
                    st_g[k][j].copy_(v)
        x = L.rms_norm(x, params["final_norm"])
        return L.unembed(params["embed"], cfg, x), {
            "mamba": states, "attn_k": cache["attn_k"],
            "attn_v": cache["attn_v"], "index": idx + 1}
    return TF.decode_step(params, cfg, cache, tokens, window=window)


# --------------------------------------------------------------------------
# losses (``launch.steps.make_train_step`` differentiates ``train_loss``)
# --------------------------------------------------------------------------

def _ce(logits, labels, mask=None):
    nll = spmd.token_nll(logits, labels)
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
    total = loss + MOE_AUX_WEIGHT * aux
    return total, {"ce": loss, "aux": aux}


# --------------------------------------------------------------------------
# parameter counting (exact, on the meta device: no allocation)
# --------------------------------------------------------------------------

def analytic_param_count(cfg: ModelConfig, active_only: bool = False) -> int:
    """Parameters of ``cfg``; ``active_only``: those one token uses (an
    MoE model counted with ``top_k`` experts a layer)."""
    if active_only and cfg.is_moe:
        cfg = cfg.replace(num_experts=cfg.top_k)
    return sum(math.prod(t.shape)
               for t in tree_leaves(init_params(0, cfg, device="meta")))
