"""Shared building blocks of the LM families (PyTorch, functional, dict
params), one for one with the JAX package's ``models/layers.py``.

Conventions
-----------
* Params are nested dicts of tensors under the JAX package's keys and in
  its layouts.  Layer-stacked params carry a leading ``L`` axis; the
  transformer loops over views ``p[k][l]`` of them.
* Compute dtype is ``cfg.dtype`` (bf16 by default); params are kept in
  ``cfg.param_dtype`` (f32 master copies) and cast at every use, as the
  JAX package does.
* Attention weights are stored 3-D ``(embed, heads, head_dim)`` and
  ``(heads, head_dim, embed)``, so weights carry across one to one.
* Attention has two routes: ``impl="kernel"`` (the JAX package's
  ``"pallas"``), the hand-written CUDA kernel ``kernels.flash_attention``
  and the default, and ``impl="plain"`` (the JAX package's ``"xla"``),
  the einsum-and-softmax ``attention_scores``, which only comparisons ask
  for.  Decode always takes the plain route over the ring-buffer cache, as
  in the JAX package.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import spmd
from repro_torch.models.scan_ops import IMPLS, acc_dtype

UNWRITTEN_POS = 10 ** 9         # position of a ring slot never written


# --------------------------------------------------------------------------
# init helpers
# --------------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape, in_axis_size=None, *,
               device) -> torch.Tensor:
    """Truncated-normal fan-in init: N(0, 1) cut at ±2, times
    1/sqrt(fan_in), drawn from ``gen`` into a new f32 tensor on
    ``device``."""
    fan_in = in_axis_size if in_axis_size is not None else shape[0]
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return w.mul_(1.0 / math.sqrt(max(fan_in, 1)))


def embed_init(gen: torch.Generator, shape, *, device) -> torch.Tensor:
    w = torch.empty(shape, dtype=torch.float32, device=device)
    return w.normal_(0.0, 0.02, generator=gen)


# --------------------------------------------------------------------------
# normalization
# --------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt, acc = x.dtype, acc_dtype(x)
    x = x.to(acc)
    var = x.square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * scale.to(acc)).to(dt)


def group_norm_heads(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     eps: float = 64e-5) -> torch.Tensor:
    """Per-head group norm used by RWKV time-mix output. x: (..., H, hd);
    computed in f32, returned in x's dtype."""
    dt, acc = x.dtype, acc_dtype(x)
    x = x.to(acc)
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.to(acc) + bias.to(acc)).to(dt)


# --------------------------------------------------------------------------
# rotary embeddings
# --------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd) or (..., S, hd); positions broadcastable to
    (..., S).  Rotates the two halves of hd (not interleaved pairs)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                   # (hd/2,)
    angles = positions[..., None].float() * freqs             # (..., S, hd/2)
    if x.dim() == angles.dim() + 1:                           # heads axis
        angles = angles[..., None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# attention (GQA, optional qk_norm / sliding window / bidirectional)
# --------------------------------------------------------------------------

def init_attention(gen: torch.Generator, cfg: ModelConfig, *, device,
                   lead=()):
    """One layer's attention params, or ``lead``-shaped stacks of them."""
    d, H, KV, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                    cfg.resolved_head_dim)
    lead = tuple(lead)
    p = {
        "wq": dense_init(gen, lead + (d, H, hd), in_axis_size=d,
                         device=device),
        "wk": dense_init(gen, lead + (d, KV, hd), in_axis_size=d,
                         device=device),
        "wv": dense_init(gen, lead + (d, KV, hd), in_axis_size=d,
                         device=device),
        "wo": dense_init(gen, lead + (H, hd, d), in_axis_size=H * hd,
                         device=device),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(lead + (hd,), device=device)
        p["k_norm"] = torch.ones(lead + (hd,), device=device)
    return p


def _mask_bias(q_pos, k_pos, causal: bool, window: int, dtype):
    """Additive mask bias (..., Sq, Sk) from query/key positions."""
    diff = q_pos[..., :, None] - k_pos[..., None, :]
    ok = torch.ones_like(diff, dtype=torch.bool)
    if causal:
        ok &= diff >= 0
    if window:
        ok &= diff < window
    return torch.where(ok, 0.0, -1e30).to(dtype)


def attention_scores(q, k, v, q_pos, k_pos, *, causal, window, kv_groups):
    """Plain attention. q:(B,Sq,H,hd) k,v:(B,Sk,KV,hd).  In bf16 the
    scores and probabilities round to bf16, as in the JAX package.  On
    DTensors (the dry-runs) each rank attends with its own heads and batch
    rows (``models/spmd.py``)."""
    k, v, kv_groups = spmd.kv_for_local_heads(q, k, v, kv_groups)
    q_pos, k_pos = spmd.along_batch(q_pos, q), spmd.along_batch(k_pos, q)

    def bias():
        b = _mask_bias(q_pos, k_pos, causal, window, torch.float32)
        # broadcast over the scores' (B, KV, G, Sq, Sk)
        return b.reshape(b.shape[:-2] + (1,) * (5 - b.dim()) + b.shape[-2:])
    if spmd.split(q):
        return spmd.local_attention(q, k, v, bias(), kv_groups)
    return spmd.attend(q, k, v, bias, kv_groups)


def ring_positions(index: int, cache_len: int, device) -> torch.Tensor:
    """Absolute position of each ring-buffer slot at decode step ``index``
    (the step whose k/v goes into slot ``index % cache_len``): slots never
    written get ``UNWRITTEN_POS``, which the causal mask removes.
    ``index`` is a host int, so no step waits on the device."""
    slot = index % cache_len
    slots = torch.arange(cache_len, device=device)
    written = min(index + 1, cache_len)
    age = torch.remainder(slot - slots, cache_len)   # 0 = this step's slot
    return torch.where(age < written, index - age, UNWRITTEN_POS)


def _proj(x, w, dt):
    """``einsum("bsd,d...->bs...")``: x (B, S, d) times w (d, *rest)."""
    return (x @ w.reshape(w.shape[0], -1).to(dt)).view(
        *x.shape[:-1], *w.shape[1:])


def attention(p, cfg: ModelConfig, x, positions, kv_cache=None, *,
              window: int = 0, impl: str = "kernel", q_chunks: int = 1):
    """Full GQA attention block.

    ``kv_cache``: None for train/prefill over the whole sequence; else a
    dict ``{"k", "v", "index", "k_pos"}`` holding one layer's (possibly
    ring-buffered) cache ``(B, cache_len, KV, hd)`` for decode, the
    decode step's ``index`` as a host int and its slots' positions
    ``ring_positions(index, cache_len)`` (computed once per step for all
    layers).  This step's k/v are written into the cache tensors in
    place (the JAX package rebuilds them).  Returns (out,
    new_cache_or_None).
    """
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    dt = x.dtype
    B, S = x.shape[:2]
    if kv_cache is not None and positions is None:
        positions = torch.full((B, S), kv_cache["index"], dtype=torch.long,
                               device=x.device)
    q = _proj(x, p["wq"], dt)
    k = _proj(x, p["wk"], dt)
    v = _proj(x, p["wv"], dt)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    new_cache = None
    if kv_cache is None:
        k_pos = q_pos = positions
        kk, vv = k, v
    else:
        # decode: write this step's k/v into the ring buffer, in place
        kc, vc, idx = kv_cache["k"], kv_cache["v"], kv_cache["index"]
        cache_len = kc.shape[1]
        slot = idx % cache_len
        kc[:, slot:slot + S].copy_(k)
        vc[:, slot:slot + S].copy_(v)
        new_cache = {"k": kc, "v": vc, "index": idx + 1}
        k_pos = kv_cache["k_pos"].expand(B, cache_len)
        q_pos = torch.full((B, 1), idx, dtype=torch.long, device=x.device)
        kk, vv = kc.to(dt), vc.to(dt)

    if impl == "kernel" and kv_cache is None:
        out = flash_attention(q, kk, vv, causal=cfg.causal, window=window)
    elif (q_chunks > 1 and kv_cache is None and cfg.causal
          and S % q_chunks == 0):
        # chunked causal prefill: chunk i attends to keys [0, (i+1)*S/n)
        cs = S // q_chunks
        outs = []
        for i in range(q_chunks):
            hi = (i + 1) * cs
            outs.append(attention_scores(
                q[:, i * cs:hi], kk[:, :hi], vv[:, :hi],
                q_pos[..., i * cs:hi], k_pos[..., :hi],
                causal=True, window=window, kv_groups=H // KV))
        out = torch.cat(outs, dim=1)
    else:
        out = attention_scores(q, kk, vv, q_pos, k_pos,
                               causal=cfg.causal or kv_cache is not None,
                               window=window, kv_groups=H // KV)
    out = out.reshape(B, S, H * hd) @ p["wo"].reshape(H * hd, -1).to(dt)
    return out, new_cache


# --------------------------------------------------------------------------
# SwiGLU MLP
# --------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, *, device,
             lead=()):
    """One layer's SwiGLU params, or ``lead``-shaped stacks of them."""
    lead = tuple(lead)
    return {
        "w1": dense_init(gen, lead + (d_model, d_ff), in_axis_size=d_model,
                         device=device),
        "w3": dense_init(gen, lead + (d_model, d_ff), in_axis_size=d_model,
                         device=device),
        "w2": dense_init(gen, lead + (d_ff, d_model), in_axis_size=d_ff,
                         device=device),
    }


def mlp(p, x):
    dt = x.dtype
    h = F.silu(x @ p["w1"].to(dt)) * (x @ p["w3"].to(dt))
    return h @ p["w2"].to(dt)


# --------------------------------------------------------------------------
# embeddings / head
# --------------------------------------------------------------------------

def init_embedding(gen: torch.Generator, cfg: ModelConfig, *, device):
    p = {"embedding": embed_init(gen, (cfg.vocab_size, cfg.d_model),
                                 device=device)}
    if not cfg.tie_embeddings:
        p["unembed"] = dense_init(gen, (cfg.d_model, cfg.vocab_size),
                                  device=device)
    return p


def embed(p, cfg: ModelConfig, tokens, dtype):
    """Gathers the rows, then casts them: the same numbers as the JAX
    package's cast-then-gather, without casting the whole table."""
    return spmd.take_rows(p["embedding"], tokens).to(dtype)


def unembed(p, cfg: ModelConfig, x):
    if cfg.tie_embeddings:
        return x @ p["embedding"].to(x.dtype).T
    return x @ p["unembed"].to(x.dtype)
