"""The MoE dispatch and MLA as they were before the dry-runs placed them
(``models/moe.py``), frozen: ``tests/test_torch_dryrun_parity.py`` holds
today's code to their bits on plain tensors (c), and their dry-run, which
replicated the dispatch and MLA's heads on every rank, is the known-bad
control its gates refuse (b).  Imports no JAX."""
import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.moe import moe_capacity
from repro_torch.models.scan_ops import acc_dtype


def route(p, cfg: ModelConfig, xf):
    """Router of tokens ``xf`` (T, d): (probs (T, E), gate (T, k), ids
    (T, k)), the gates renormalised over the top k, in ``acc_dtype``."""
    logits = (xf @ p["router"].to(xf.dtype)).to(acc_dtype(xf))
    probs = torch.softmax(logits, dim=-1)
    gate, ids = torch.topk(probs, cfg.top_k, dim=-1)
    gate = gate / gate.sum(dim=-1, keepdim=True).clamp(min=1e-9)
    return probs, gate, ids


def expert_counts(ids: torch.Tensor, E: int, dtype) -> torch.Tensor:
    """(E,) assignments of ``ids`` to each expert, in ``dtype``:
    ``bincount``'s counts (exact below 2^24), written as a sum of ones so
    that the length is E without reading the ids (the dry-run's meta
    tensors hold none)."""
    flat = ids.reshape(-1)
    return torch.zeros(E, dtype=dtype, device=ids.device).index_add(
        0, flat, torch.ones_like(flat, dtype=dtype))


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
    ce = expert_counts(ids, E, probs.dtype) / (T * k)
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
