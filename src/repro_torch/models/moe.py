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
from repro_torch.models import spmd
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


def _logits(p, xf):
    return (xf @ p["router"].to(xf.dtype)).to(acc_dtype(xf))


def _top_k(probs, k: int):
    gate, ids = torch.topk(probs, k, dim=-1)
    return gate / gate.sum(dim=-1, keepdim=True).clamp(min=1e-9), ids


def route(p, cfg: ModelConfig, xf):
    """Router of tokens ``xf`` (T, d): (probs (T, E), gate (T, k), ids
    (T, k)), the gates renormalised over the top k, in ``acc_dtype``."""
    probs = torch.softmax(_logits(p, xf), dim=-1)
    return (probs, *_top_k(probs, cfg.top_k))


def expert_counts(ids: torch.Tensor, E: int, dtype) -> torch.Tensor:
    """(E,) assignments of ``ids`` to each expert, in ``dtype``:
    ``bincount``'s counts (exact below 2^24), written as a sum of ones so
    that the length is E without reading the ids (the dry-run's meta
    tensors hold none)."""
    flat = ids.reshape(-1)
    return torch.zeros(E, dtype=dtype, device=ids.device).index_add(
        0, flat, torch.ones_like(flat, dtype=dtype))


def _aux_loss(probs, ids, E: int):
    """The load-balance aux loss (Switch-style): E * sum_e f_e * p_e."""
    me = probs.mean(dim=0)                                          # (E,)
    ce = expert_counts(ids, E, probs.dtype) / ids.numel()
    return E * (me * ce).sum()


def _assignments(ids, E: int, C: int):
    """The sort dispatch of ``ids`` (T, k): the assignments sorted by
    expert id (stably), and for each sorted one its source token, whether
    it fits its expert's C slots, and its row of the (E * C, d) buffer
    (E * C, the drop slot, where it does not)."""
    T, k = ids.shape
    flat_ids = ids.reshape(-1)                                      # (T*k,)
    sort_idx = torch.argsort(flat_ids, stable=True)
    sorted_eids = flat_ids[sort_idx]
    start = torch.searchsorted(sorted_eids,
                               torch.arange(E, device=ids.device),
                               side="left")
    pos_in_expert = torch.arange(T * k, device=ids.device) \
        - start[sorted_eids]
    tok = sort_idx // k                                       # source token
    valid = pos_in_expert < C
    dest = torch.where(valid, sorted_eids * C + pos_in_expert, E * C)
    return sort_idx, tok, valid, dest


def moe_ffn(p, cfg: ModelConfig, x, *, capacity_factor: float = None):
    """x: (B, S, d) -> (out (B, S, d), aux_loss scalar).  The capacity is
    that of this call's B * S tokens.  On DTensors over more than one rank
    (the dry-runs) the dispatch runs on each rank's local tensors as the
    reference's GSPMD places it (``_dispatch_local``)."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.top_k
    T = B * S
    dt = x.dtype
    xf = x.reshape(T, d)
    if capacity_factor is None:
        capacity_factor = cfg.moe_capacity_factor
    C = moe_capacity(T, E, k, capacity_factor)
    if spmd.split(x):
        xf = spmd.batch_only(xf)    # its gradient reduced here, as GSPMD's
        out, aux = spmd.experts_call(
            _dispatch_local, _logits(p, xf), xf,
            [p["we1"], p["we3"], p["we2"]], k=k, C=C)
        if "shared" in p:           # reduced where made, as GSPMD does
            out = out + spmd.batch_only(L.mlp(p["shared"], xf))
        return out.view(B, S, d), aux
    probs, gate, ids = route(p, cfg, xf)
    aux = _aux_loss(probs, ids, E)
    sort_idx, tok, valid, dest = _assignments(ids, E, C)

    y = _experts(xf[tok], dest, C, p["we1"], p["we3"], p["we2"])
    gate_sorted = gate.reshape(-1)[sort_idx].to(dt)
    contrib = (y[torch.where(valid, dest, 0)]
               * torch.where(valid, gate_sorted, 0.0)[:, None])
    slots = torch.empty_like(contrib)          # (T*k, d): (token, j) rows
    slots[sort_idx] = contrib                  # a permutation: no collisions
    out = slots.view(T, k, d).sum(dim=1)

    if "shared" in p:
        out = out + L.mlp(p["shared"], xf)
    return out.view(B, S, d), aux


def _experts(rows, dest, C: int, we1, we3, we2):
    """The SwiGLU experts ``we1``, ``we3`` (n, d, f) and ``we2`` (n, f, d)
    on their C slots each: ``rows`` (R, d) written to the slots ``dest``
    -> (n * C, d).  Every dropped row writes slot n * C, the drop slot,
    which is never read: the order of those writes does not matter.
    Callers pass ``rows`` as a temporary, which the call then holds
    alone: it is freed once written, and the slots once the products
    have read them."""
    n, d = we1.shape[0], rows.shape[1]
    dt = rows.dtype
    buf = rows.new_zeros((n * C + 1, d))
    buf[dest] = rows
    del rows
    h = buf[:n * C].view(n, C, d)
    a = torch.bmm(h, we1.to(dt))
    b = torch.bmm(h, we3.to(dt))
    del buf, h
    a = F.silu(a).mul_(b)
    del b
    return torch.bmm(a, we2.to(dt)).view(n * C, d)


def _own_rows(xf, tok, mine, first, axes):
    """The rows of the sorted assignments' tokens ``tok``, each from the
    rank of ``rows`` that holds it (``mine``: this rank's, from
    ``first``): summed over ``rows``, every row one non-zero term; the
    gradient summed over ``split``."""
    mesh, rows, split = axes
    got = xf[torch.where(mine, tok - first, 0)]
    got.mul_(mine[:, None])
    return spmd.sum_grad(spmd.sum_partial(got, mesh, rows), mesh, split)


def _dispatch_local(logits, xf, we1, we3, we2, *, axes, k: int, C: int):
    """``moe_ffn``'s routed experts on one rank's local tensors, as the
    reference's GSPMD program runs them (``spmd.experts_call``): this
    rank's tokens ``xf`` (T_r, d) and logits (T_r, E_r), and its E_r
    experts.  The logits are gathered over the experts' axes (``split``)
    and the tokens' (``rows``): every rank routes, sorts and drops all T
    tokens.  Each rank gathers the rows of its own tokens, and the (T * k,
    d) rows are summed over ``rows``; it fills its experts' slots and runs
    their products (repeated on each rank of ``rows``); the results are
    gathered by summing each rank's rows over ``split``, and each rank
    combines its own tokens.  In the backward the combined rows' gradient
    is summed over ``rows`` and the slots' over ``split``.  The values are
    ``moe_ffn``'s: every summed row has one non-zero term."""
    mesh, rows, split = axes
    T_r, d = xf.shape
    dt = xf.dtype
    probs = torch.softmax(spmd.gather_whole(spmd.gather_whole(
        logits, mesh, split, 1), mesh, rows, 0), dim=-1)
    gate, ids = _top_k(probs, k)
    E = probs.shape[1]
    aux = _aux_loss(probs, ids, E)
    sort_idx, tok, valid, dest = _assignments(ids, E, C)

    first = spmd.shard_index(mesh, rows) * T_r        # this rank's tokens
    mine = (tok >= first) & (tok < first + T_r)
    EC = we1.shape[0] * C                             # this rank's slots
    lo = spmd.shard_index(mesh, split) * EC
    here = valid & (dest >= lo) & (dest < lo + EC)
    slot = torch.where(here, dest - lo, EC)           # EC: the drop slot
    y = _experts(_own_rows(xf, tok, mine, first, axes), slot, C,
                 we1, we3, we2)
    got = y[torch.where(here, slot, 0)]
    del y
    got.mul_(here[:, None])
    got = spmd.sum_partial(got, mesh, split)

    gate_sorted = gate.reshape(-1)[sort_idx].to(dt)
    contrib = spmd.sum_grad(
        got * torch.where(valid, gate_sorted, 0.0)[:, None], mesh, rows)
    del got
    # (token, j) slot -> its place in the sorted order: this rank's slots
    inv = torch.empty_like(sort_idx)
    inv[sort_idx] = torch.arange(sort_idx.numel(), device=inv.device)
    out = contrib[inv[first * k:(first + T_r) * k]].view(T_r, k, d)
    return out.sum(dim=1), aux


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
        # the latents' gradients (partial over the heads' axis in the
        # dry-runs) reduced where made, as GSPMD reduces them
        cq = spmd.grad_like(L.rms_norm(x @ p["w_dq"].to(dt), p["q_norm"]))
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


def _expanded(q_nope, q_rope, k_nope, k_rope, v, positions, *, scale,
              window: int, q_chunks: int):
    """MLA's prefill core in the expanded form: queries (B, S, H, dn +
    dr, split in two) over keys ``k_nope`` (B, S, H, dn) and the shared
    ``k_rope`` (B, S, dr), values ``v``; (B, S, H, dn)."""
    S, dt = q_nope.shape[1], q_nope.dtype

    def attend(lo, hi):
        """Queries [lo, hi) over keys [0, hi)."""
        bias = L._mask_bias(positions[:, lo:hi], positions[:, :hi],
                            True, window, acc_dtype(q_nope))
        probs = _attn_probs("bqhk,bshk->bhqs", q_nope[:, lo:hi],
                            k_nope[:, :hi], q_rope[:, lo:hi],
                            k_rope[:, :hi], bias[:, None], scale, dt)
        return torch.einsum("bhqs,bshk->bqhk", probs, v[:, :hi])

    if q_chunks > 1 and S % q_chunks == 0:
        cs = S // q_chunks
        return torch.cat([attend(i * cs, (i + 1) * cs)
                          for i in range(q_chunks)], dim=1)
    return attend(0, S)


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
    c_kv = spmd.grad_like(L.rms_norm(x @ p["w_dkv"].to(dt),
                                     p["kv_norm"]))             # (B,S,r_kv)
    k_rope = spmd.grad_like(L.apply_rope(x @ p["w_kr"].to(dt), positions,
                                         cfg.rope_theta))

    if cache is None:
        k_nope = L._proj(c_kv, p["w_uk"], dt)                   # (B,S,H,dn)
        v = L._proj(c_kv, p["w_uv"], dt)
        kw = dict(scale=scale, window=window, q_chunks=q_chunks)
        if spmd.split(q_nope):      # the dry-runs: each rank's own heads
            pos = spmd.along_batch(positions, x)
            [out] = spmd.heads_call(
                lambda *a, **k: (_expanded(*a, **k),),
                [q_nope, q_rope, k_nope, k_rope, v, pos],
                [(True, 2), (True, 2), (True, 2), (True, None), (True, 2),
                 (pos.shape[0] == B, None)], [(True, 2)], [q_nope.shape],
                **kw)
        else:
            out = _expanded(q_nope, q_rope, k_nope, k_rope, v, positions,
                            **kw)
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
