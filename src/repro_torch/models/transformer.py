"""Decoder/encoder transformer assembly, one for one with the JAX package's
``models/transformer.py``: the dense, vlm, audio and moe (with MLA for
DeepSeek-V2) families.

Layer params are stacked with a leading ``L`` axis under the JAX
package's keys: an MoE model keeps its ``first_dense_layers`` dense
layers under ``lead_layers`` and the MoE layers under ``layers``.  Where
the JAX package scans over layers, this module loops over views
``p[k][l]`` of the stacks.  With ``cfg.remat`` set and grad mode on, each
layer runs under ``torch.utils.checkpoint`` (its activations recomputed in
the backward pass), where the JAX package wraps its scan body in
``jax.checkpoint``; without grad it changes nothing.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import spmd
from repro_torch.tree import tree_map

MAX_POS_EMBED = 32768     # learned abs-pos table for non-RoPE encoders


def remat_call(cfg: ModelConfig, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, under ``torch.utils.checkpoint`` when
    ``cfg.remat`` is set and grad mode is on (the layer's activations are
    recomputed in the backward pass instead of kept)."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False, **kwargs)
    return fn(*args, **kwargs)


def layer_view(tree, l: int):
    """Layer ``l`` of a layer-stacked param tree (views, no copies)."""
    return tree_map(lambda t: t[l], tree)


def init_layer(gen: torch.Generator, cfg: ModelConfig, *, moe_layer: bool,
               device, lead=()):
    """One layer's params, or ``lead``-shaped stacks of them."""
    lead = tuple(lead)
    attn = MOE.init_mla if cfg.use_mla else L.init_attention
    ffn = (MOE.init_moe_ffn(gen, cfg, device=device, lead=lead) if moe_layer
           else L.init_mlp(gen, cfg.d_model, cfg.d_ff, device=device,
                           lead=lead))
    return {"ln1": torch.ones(lead + (cfg.d_model,), device=device),
            "ln2": torch.ones(lead + (cfg.d_model,), device=device),
            "attn": attn(gen, cfg, device=device, lead=lead),
            "ffn": ffn}


def init_params(gen: torch.Generator, cfg: ModelConfig, *, device):
    n_lead = cfg.first_dense_layers if cfg.is_moe else 0
    p = {"embed": L.init_embedding(gen, cfg, device=device),
         "final_norm": torch.ones((cfg.d_model,), device=device)}
    if n_lead:
        p["lead_layers"] = init_layer(gen, cfg, moe_layer=False,
                                      device=device, lead=(n_lead,))
    p["layers"] = init_layer(gen, cfg, moe_layer=cfg.is_moe, device=device,
                             lead=(cfg.num_layers - n_lead,))
    if not cfg.use_rope and cfg.is_encoder_only:
        p["pos_embed"] = L.embed_init(gen, (MAX_POS_EMBED, cfg.d_model),
                                      device=device)
    return p


def _layer_views(params):
    """Views of every layer's params, the lead (dense) layers first."""
    for key in ("lead_layers", "layers"):
        if key in params:
            stack = params[key]
            for l in range(stack["ln1"].shape[0]):
                yield layer_view(stack, l)


def _layer_apply(lp, cfg: ModelConfig, x, positions, cache, *, window: int,
                 impl: str, q_chunks: int = 1):
    """One layer; returns (x, new_cache, the MoE aux loss or None).  The
    layer is an MoE layer when its FFN has a router, as in the JAX
    package's decode."""
    x = spmd.batch_only(x)
    h = L.rms_norm(x, lp["ln1"])
    if cfg.use_mla:
        att, new_cache = MOE.mla_attention(lp["attn"], cfg, h, positions,
                                           cache, window=window,
                                           q_chunks=q_chunks)
    else:
        att, new_cache = L.attention(lp["attn"], cfg, h, positions, cache,
                                     window=window, impl=impl,
                                     q_chunks=q_chunks)
    x = spmd.batch_only(x + att)
    h = L.rms_norm(x, lp["ln2"])
    if "router" in lp["ffn"]:
        f, aux = MOE.moe_ffn(lp["ffn"], cfg, h)
    else:
        f, aux = L.mlp(lp["ffn"], h), None
    return x + f, new_cache, aux


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
        x = x + spmd.take_rows(params["pos_embed"],
                               spmd.along_batch(positions, x)).to(dtype)
    return x, positions


def forward(params, cfg: ModelConfig, batch, *, window: int = 0,
            impl: str = "kernel", q_chunks: int = 1):
    """Full-sequence forward (train / prefill without cache).
    Returns (logits (B,S,V), aux_loss)."""
    dtype = getattr(torch, cfg.dtype)
    x, positions = _embed_inputs(params, cfg, batch, dtype)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in _layer_views(params):
        x, _, aux = remat_call(cfg, _layer_apply, lp, cfg, x, positions,
                               None, window=window, impl=impl,
                               q_chunks=q_chunks)
        if aux is not None:
            aux_total = aux_total + aux
    x = L.rms_norm(spmd.batch_only(x), params["final_norm"])
    logits = L.unembed(params["embed"], cfg, x)
    return logits, aux_total


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype, *,
               device):
    """Stacked per-layer decode cache over all ``num_layers`` layers (the
    lead layers first): K/V, or MLA's latents ``c_kv`` and ``k_rope``.
    ``index`` (decode steps so far) is a host int."""
    lead = (cfg.num_layers, batch, cache_len)
    if cfg.use_mla:
        return {"c_kv": torch.zeros(lead + (cfg.kv_lora_rank,), dtype=dtype,
                                    device=device),
                "k_rope": torch.zeros(lead + (cfg.rope_head_dim,),
                                      dtype=dtype, device=device),
                "index": 0}
    shape = lead + (cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "index": 0}


def decode_step(params, cfg: ModelConfig, cache, tokens, *, window: int = 0):
    """One decode step. tokens: (B,1). Returns (logits (B,1,V), new_cache).

    The cache's tensors (k/v, or MLA's c_kv/k_rope) are updated in place
    (the returned cache holds the same tensors, with ``index`` one
    higher); the JAX package returns new arrays instead."""
    dtype = getattr(torch, cfg.dtype)
    x = L.embed(params["embed"], cfg, tokens, dtype)
    idx = cache["index"]
    leaves = {k: v for k, v in cache.items() if k != "index"}
    cache_len = next(iter(leaves.values())).shape[2]
    k_pos = L.ring_positions(idx, cache_len, x.device)
    for l, lp in enumerate(_layer_views(params)):
        cache_l = {k: v[l] for k, v in leaves.items()}
        cache_l.update(index=idx, k_pos=k_pos)
        x, _, _ = _layer_apply(lp, cfg, x, None, cache_l, window=window,
                               impl="plain")
    x = L.rms_norm(x, params["final_norm"])
    logits = L.unembed(params["embed"], cfg, x)
    return logits, dict(leaves, index=idx + 1)
