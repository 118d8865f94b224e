"""Decoder/encoder transformer assembly, one for one with the JAX package's
``models/transformer.py`` for the dense, vlm and audio families.

Layer params are stacked with a leading ``L`` axis under the JAX
package's keys; where it scans over layers, this module loops over views
``p[k][l]`` of the stacks.  MoE and MLA are not ported yet: they raise
``NotImplementedError``.  ``cfg.remat`` only matters for gradients and
is ignored (the port has no LM training yet).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

MAX_POS_EMBED = 32768     # learned abs-pos table for non-RoPE encoders


def _check_ported(cfg: ModelConfig) -> None:
    if cfg.is_moe or cfg.use_mla:
        raise NotImplementedError(
            f"{cfg.name}: MoE and MLA layers are not ported yet (ROADMAP "
            "queue A item 14c)")


def layer_view(tree, l: int):
    """Layer ``l`` of a layer-stacked param tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: layer_view(v, l) for k, v in tree.items()}
    return tree[l]


def init_layer(gen: torch.Generator, cfg: ModelConfig, *, device,
               lead=()):
    """One layer's params, or ``lead``-shaped stacks of them."""
    lead = tuple(lead)
    return {"ln1": torch.ones(lead + (cfg.d_model,), device=device),
            "ln2": torch.ones(lead + (cfg.d_model,), device=device),
            "attn": L.init_attention(gen, cfg, device=device, lead=lead),
            "ffn": L.init_mlp(gen, cfg.d_model, cfg.d_ff, device=device,
                              lead=lead)}


def init_params(gen: torch.Generator, cfg: ModelConfig, *, device):
    _check_ported(cfg)
    p = {"embed": L.init_embedding(gen, cfg, device=device),
         "final_norm": torch.ones((cfg.d_model,), device=device),
         "layers": init_layer(gen, cfg, device=device,
                              lead=(cfg.num_layers,))}
    if not cfg.use_rope and cfg.is_encoder_only:
        p["pos_embed"] = L.embed_init(gen, (MAX_POS_EMBED, cfg.d_model),
                                      device=device)
    return p


def _layer_apply(lp, cfg: ModelConfig, x, positions, cache, *, window: int,
                 impl: str, q_chunks: int = 1):
    h = L.rms_norm(x, lp["ln1"])
    att, new_cache = L.attention(lp["attn"], cfg, h, positions, cache,
                                 window=window, impl=impl, q_chunks=q_chunks)
    x = x + att
    h = L.rms_norm(x, lp["ln2"])
    return x + L.mlp(lp["ffn"], h), new_cache


def _embed_inputs(params, cfg: ModelConfig, batch, dtype):
    """Returns (x (B,S,d), positions (B,S))."""
    if cfg.frontend == "audio_stub":
        x = batch["frame_embeds"].to(dtype)      # conv frontend is a stub
    else:
        x = L.embed(params["embed"], cfg, batch["tokens"], dtype)
        if cfg.frontend == "vision_stub" and "prefix_embeds" in batch:
            x = torch.cat([batch["prefix_embeds"].to(dtype), x], dim=1)
    B, S = x.shape[0], x.shape[1]
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
    if "pos_embed" in params:
        x = x + params["pos_embed"][positions].to(dtype)
    return x, positions


def forward(params, cfg: ModelConfig, batch, *, window: int = 0,
            impl: str = "kernel", q_chunks: int = 1):
    """Full-sequence forward (train / prefill without cache).
    Returns (logits (B,S,V), aux_loss)."""
    _check_ported(cfg)
    dtype = getattr(torch, cfg.dtype)
    x, positions = _embed_inputs(params, cfg, batch, dtype)
    layers = params["layers"]
    for l in range(layers["ln1"].shape[0]):
        x, _ = _layer_apply(layer_view(layers, l), cfg, x, positions, None,
                            window=window, impl=impl, q_chunks=q_chunks)
    x = L.rms_norm(x, params["final_norm"])
    logits = L.unembed(params["embed"], cfg, x)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype, *,
               device):
    """Stacked per-layer decode cache; ``index`` (decode steps so far) is a
    host int."""
    _check_ported(cfg)
    KV, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    shape = (cfg.num_layers, batch, cache_len, KV, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "index": 0}


def decode_step(params, cfg: ModelConfig, cache, tokens, *, window: int = 0):
    """One decode step. tokens: (B,1). Returns (logits (B,1,V), new_cache).

    The cache's k/v tensors are updated in place (the returned cache holds
    the same tensors, with ``index`` one higher); the JAX package returns
    new arrays instead."""
    _check_ported(cfg)
    dtype = getattr(torch, cfg.dtype)
    x = L.embed(params["embed"], cfg, tokens, dtype)
    idx = cache["index"]
    k_pos = L.ring_positions(idx, cache["k"].shape[2], x.device)
    layers = params["layers"]
    for l in range(layers["ln1"].shape[0]):
        cache_l = {"k": cache["k"][l], "v": cache["v"][l], "index": idx,
                   "k_pos": k_pos}
        x, _ = _layer_apply(layer_view(layers, l), cfg, x, None, cache_l,
                            window=window, impl="plain")
    x = L.rms_norm(x, params["final_norm"])
    logits = L.unembed(params["embed"], cfg, x)
    return logits, {"k": cache["k"], "v": cache["v"], "index": idx + 1}
