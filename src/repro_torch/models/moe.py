"""Mixture-of-Experts FFN (token-choice top-k, sort-based dispatch) and
Multi-head Latent Attention (MLA, DeepSeek-V2 style), one for one with the
JAX package's ``models/moe.py``.

MoE dispatch is the sort-based formulation: assignments are sorted by
expert id, placed into a per-expert capacity buffer ``(E, C, d)``, the
expert products run as batched matmuls over ``(E, C, .)``, and each
token's k results are gathered back and summed.  Tokens beyond an
expert's capacity are dropped; the router aux loss keeps load balanced.
The combine is deterministic: every contribution goes to its own
``(token, j)`` slot and the k slots are summed, where the JAX package
scatter-adds (``index_add_`` on CUDA would add with atomics, in an order
that changes from run to run).

MLA attends in plain PyTorch, as the JAX package does in XLA: prefill in
the expanded form, decode in the absorbed form over a ring-buffer latent
cache ``(c_kv, k_rope)``.  No kernel is on either path.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.scan_ops import acc_dtype

CAPACITY_FACTOR = 1.25


def moe_capacity(tokens: int, num_experts: int, top_k: int,
                 factor: float = CAPACITY_FACTOR) -> int:
    """Slots an expert has for ``tokens`` tokens: rounded up to a multiple
    of 8, at least 8."""
    c = int(math.ceil(tokens * top_k * factor / num_experts))
    return max(8, -(-c // 8) * 8)


def init_moe_ffn(gen: torch.Generator, cfg: ModelConfig, *, device,
                 lead=()):
    """One layer's MoE FFN params, or ``lead``-shaped stacks of them."""
    d, E, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff or cfg.d_ff
    lead = tuple(lead)
    p = {
        "router": L.dense_init(gen, lead + (d, E), in_axis_size=d,
                               device=device),
        "we1": L.dense_init(gen, lead + (E, d, f), in_axis_size=d,
                            device=device),
        "we3": L.dense_init(gen, lead + (E, d, f), in_axis_size=d,
                            device=device),
        "we2": L.dense_init(gen, lead + (E, f, d), in_axis_size=f,
                            device=device),
    }
    if cfg.num_shared_experts:
        p["shared"] = L.init_mlp(gen, d, f * cfg.num_shared_experts,
                                 device=device, lead=lead)
    return p


def route(p, cfg: ModelConfig, xf):
    """Router of tokens ``xf`` (T, d): (probs (T, E), gate (T, k), ids
    (T, k)), the gates renormalised over the top k, in ``acc_dtype``."""
    logits = (xf @ p["router"].to(xf.dtype)).to(acc_dtype(xf))
    probs = torch.softmax(logits, dim=-1)
    gate, ids = torch.topk(probs, cfg.top_k, dim=-1)
    gate = gate / gate.sum(dim=-1, keepdim=True).clamp(min=1e-9)
    return probs, gate, ids


def moe_ffn(p, cfg: ModelConfig, x, *, capacity_factor: float = None):
    """x: (B, S, d) -> (out (B, S, d), aux_loss scalar).  The capacity is
    that of this call's B * S tokens."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.top_k
    T = B * S
    dt = x.dtype
    xf = x.reshape(T, d)
    if capacity_factor is None:
        capacity_factor = cfg.moe_capacity_factor
    probs, gate, ids = route(p, cfg, xf)

    # load-balance aux loss (Switch-style): E * sum_e f_e * p_e
    me = probs.mean(dim=0)                                          # (E,)
    ce = torch.bincount(ids.reshape(-1), minlength=E).to(probs.dtype)
    ce = ce / (T * k)
    aux = E * (me * ce).sum()

    C = moe_capacity(T, E, k, capacity_factor)
    flat_ids = ids.reshape(-1)                                      # (T*k,)
    sort_idx = torch.argsort(flat_ids, stable=True)
    sorted_eids = flat_ids[sort_idx]
    start = torch.searchsorted(sorted_eids,
                               torch.arange(E, device=x.device), side="left")
    pos_in_expert = torch.arange(T * k, device=x.device) - start[sorted_eids]
    tok = sort_idx // k                                       # source token
    valid = pos_in_expert < C
    dest = torch.where(valid, sorted_eids * C + pos_in_expert, E * C)

    # every dropped assignment writes row E*C, the drop slot, which is
    # never read: the order of those writes does not matter
    buf = x.new_zeros((E * C + 1, d))
    buf[dest] = xf[tok]
    h = buf[:E * C].view(E, C, d)
    a = torch.bmm(h, p["we1"].to(dt))
    b = torch.bmm(h, p["we3"].to(dt))
    del buf, h
    a = F.silu(a).mul_(b)
    del b
    y = torch.bmm(a, p["we2"].to(dt)).view(E * C, d)
    del a

    gate_sorted = gate.reshape(-1)[sort_idx].to(dt)
    contrib = (y[torch.where(valid, dest, 0)]
               * torch.where(valid, gate_sorted, 0.0)[:, None])
    slots = torch.empty_like(contrib)          # (T*k, d): (token, j) rows
    slots[sort_idx] = contrib                  # a permutation: no collisions
    out = slots.view(T, k, d).sum(dim=1)

    if "shared" in p:
        out = out + L.mlp(p["shared"], xf)
    return out.view(B, S, d), aux


def moe_ffn_reference(p, cfg: ModelConfig, x):
    """Oracle: every expert on every token, weighted by the gates (tiny
    configs only; the tests hold ``moe_ffn`` against it)."""
    B, S, d = x.shape
    dt = x.dtype
    xf = x.reshape(-1, d)
    _, gate, ids = route(p, cfg, xf)
    a = torch.einsum("td,edf->etf", xf, p["we1"].to(dt))
    b = torch.einsum("td,edf->etf", xf, p["we3"].to(dt))
    y = torch.einsum("etf,efd->etd", F.silu(a) * b, p["we2"].to(dt))
    w = torch.zeros((xf.shape[0], cfg.num_experts), dtype=gate.dtype,
                    device=x.device).scatter_add_(1, ids, gate).to(dt)
    out = torch.einsum("te,etd->td", w, y)
    if "shared" in p:
        out = out + L.mlp(p["shared"], xf)
    return out.view(B, S, d)


# ==========================================================================
# MLA — multi-head latent attention (DeepSeek-V2)
# ==========================================================================

def init_mla(gen: torch.Generator, cfg: ModelConfig, *, device, lead=()):
    """One layer's MLA params, or ``lead``-shaped stacks of them."""
    d, H = cfg.d_model, cfg.num_heads
    dn, dr = cfg.nope_head_dim, cfg.rope_head_dim
    r_kv, r_q = cfg.kv_lora_rank, cfg.q_lora_rank
    lead = tuple(lead)

    def dense(shape, in_axis_size):
        return L.dense_init(gen, lead + shape, in_axis_size=in_axis_size,
                            device=device)

    p = {
        "w_dkv": dense((d, r_kv), d),                  # x -> latent
        "w_kr": dense((d, dr), d),                     # x -> shared rope key
        "w_uk": dense((r_kv, H, dn), r_kv),
        "w_uv": dense((r_kv, H, dn), r_kv),
        "wo": dense((H, dn, d), H * dn),
        "kv_norm": torch.ones(lead + (r_kv,), device=device),
    }
    if r_q:
        p["w_dq"] = dense((d, r_q), d)
        p["w_uq"] = dense((r_q, H, dn + dr), r_q)
        p["q_norm"] = torch.ones(lead + (r_q,), device=device)
    else:
        p["wq"] = dense((d, H, dn + dr), d)
    return p


def _mla_queries(p, cfg: ModelConfig, x, positions):
    dn = cfg.nope_head_dim
    dt = x.dtype
    if cfg.q_lora_rank:
        cq = L.rms_norm(x @ p["w_dq"].to(dt), p["q_norm"])
        q = L._proj(cq, p["w_uq"], dt)
    else:
        q = L._proj(x, p["wq"], dt)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    return q_nope, L.apply_rope(q_rope, positions, cfg.rope_theta)


def _attn_probs(nope_spec: str, q1, k1, q_rope, k_rope, bias, scale, dt):
    """softmax((q1 . k1 + q_rope . k_rope) * scale + bias) over the keys,
    (B, H, Sq, Sk) in ``dt``.  The two score terms are summed in the
    compute dtype, then scaled, masked and normalised in ``acc_dtype``, as
    in the JAX package.  At prefill the scores are the layer's largest
    tensor (8.6 GB of f32 for deepseek-v2 at B 4 x 2048), so each copy is
    freed as soon as the next exists."""
    s = torch.einsum(nope_spec, q1, k1)
    s += torch.einsum("bqhk,bsk->bhqs", q_rope, k_rope)
    s = s.to(acc_dtype(s))
    s.mul_(scale).add_(bias)
    probs = torch.softmax(s, dim=-1)
    del s
    return probs.to(dt)


def mla_attention(p, cfg: ModelConfig, x, positions, cache=None, *,
                  window: int = 0, q_chunks: int = 1):
    """MLA block.  Prefill: the expanded form.  Decode: the absorbed form
    over a latent cache of ``(c_kv, k_rope)``, O(S (r_kv + dr)) a step.

    ``cache``: None for prefill over the whole sequence; else a dict
    ``{"c_kv", "k_rope", "index", "k_pos"}`` holding one layer's ring
    buffers ``(B, cache_len, r_kv)`` and ``(B, cache_len, dr)``, the
    step's ``index`` as a host int and the slots' positions
    ``L.ring_positions(index, cache_len)``.  This step's latents are
    written into the cache tensors in place (the JAX package rebuilds
    them).  ``q_chunks > 1`` (prefill, S divisible by it): query chunk i
    attends to keys [0, (i+1) S / n) only.  Returns (out,
    new_cache_or_None)."""
    B, S, d = x.shape
    H = cfg.num_heads
    dn, dr = cfg.nope_head_dim, cfg.rope_head_dim
    dt = x.dtype
    scale = 1.0 / math.sqrt(dn + dr)

    if cache is not None and positions is None:
        positions = torch.full((B, S), cache["index"], dtype=torch.long,
                               device=x.device)
    q_nope, q_rope = _mla_queries(p, cfg, x, positions)
    c_kv = L.rms_norm(x @ p["w_dkv"].to(dt), p["kv_norm"])      # (B,S,r_kv)
    k_rope = L.apply_rope(x @ p["w_kr"].to(dt), positions, cfg.rope_theta)

    if cache is None:
        k_nope = L._proj(c_kv, p["w_uk"], dt)                   # (B,S,H,dn)
        v = L._proj(c_kv, p["w_uv"], dt)

        def attend(lo, hi):
            """Queries [lo, hi) over keys [0, hi)."""
            bias = L._mask_bias(positions[:, lo:hi], positions[:, :hi],
                                True, window, acc_dtype(x))
            probs = _attn_probs("bqhk,bshk->bhqs", q_nope[:, lo:hi],
                                k_nope[:, :hi], q_rope[:, lo:hi],
                                k_rope[:, :hi], bias[:, None], scale, dt)
            return torch.einsum("bhqs,bshk->bqhk", probs, v[:, :hi])

        if q_chunks > 1 and S % q_chunks == 0:
            cs = S // q_chunks
            out = torch.cat([attend(i * cs, (i + 1) * cs)
                             for i in range(q_chunks)], dim=1)
        else:
            out = attend(0, S)
        new_cache = None
    else:
        # ---- absorbed decode: scores via the latent, K/V never expanded --
        ckv_c, kr_c, idx = cache["c_kv"], cache["k_rope"], cache["index"]
        cache_len = ckv_c.shape[1]
        slot = idx % cache_len
        ckv_c[:, slot:slot + S].copy_(c_kv)
        kr_c[:, slot:slot + S].copy_(k_rope)
        new_cache = {"c_kv": ckv_c, "k_rope": kr_c, "index": idx + 1}
        k_pos = cache["k_pos"].expand(B, cache_len)
        q_pos = torch.full((B, 1), idx, dtype=torch.long, device=x.device)
        ckv, kr = ckv_c.to(dt), kr_c.to(dt)

        q_lat = torch.einsum("bqhk,rhk->bqhr", q_nope, p["w_uk"].to(dt))
        bias = L._mask_bias(q_pos, k_pos, True, window, acc_dtype(x))
        probs = _attn_probs("bqhr,bsr->bhqs", q_lat, ckv, q_rope, kr,
                            bias[:, None], scale, dt)
        out_lat = torch.einsum("bhqs,bsr->bqhr", probs, ckv)
        out = torch.einsum("bqhr,rhk->bqhk", out_lat, p["w_uv"].to(dt))

    out = out.reshape(B, S, H * dn) @ p["wo"].reshape(H * dn, d).to(dt)
    return out, new_cache
