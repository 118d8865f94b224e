"""Expert-parallel MoE with explicit all-to-all over ``torch.distributed``
(beyond-paper), as the JAX package's ``models/moe_ep.py``.

``models/moe.py`` computes every expert on one device.  Here each rank of
the mesh's ``model`` axis owns E/n experts and its (data, model) block of
the tokens (batch over "data", sequence over "model"), and dispatch and
return are one ``all_to_all_single`` each over the model axis's group: the
schedule of Switch/GShard-class systems, and the pattern AsyncFLEO's
ring-of-stars maps onto when satellites hold expert shards (DESIGN.md §3).

Per rank:
  x_loc   : (T_loc, d)        tokens of my block
  we*_loc : (E_loc, d, f)     my experts
  send    : (n, C, row)       capacity-C buckets per destination rank; a
                              row is a token's bytes and its expert id
                              (int32; -1 marks an empty slot), so the ids
                              travel with the tokens in one all-to-all
  recv    = all_to_all(send)  tokens routed to my experts from every rank
  y       = expert products   per-expert capacity buffers, batched matmuls
  return  = all_to_all(y)     back to the token owners, combined by gate.

The router is replicated; the load-balancing ``aux`` is averaged over the
model axis, and every rank returns data row 0's (what the reference's
replicated output spec returns).  The layer takes the full ``params`` and
``x`` on every rank and returns the full output, so it stands in for
``moe_ffn``.  No kernel is on this path: the expert products are plain
PyTorch, as the reference's einsums are.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.moe import expert_counts, route


def ep_capacity(tokens_local: int, top_k: int, n_ranks: int,
                factor: float) -> int:
    """Slots a destination rank has for one rank's ``tokens_local``
    tokens: rounded up to a multiple of 8, at least 8."""
    c = int(math.ceil(tokens_local * top_k * factor / n_ranks))
    return max(8, -(-c // 8) * 8)


def _expert_ffn(p_local, rx: torch.Tensor, eid: torch.Tensor) -> torch.Tensor:
    """SwiGLU of each row of ``rx`` (R, d) through its local expert
    ``eid`` (-1: an empty slot, whose output is 0).  The rows are sorted
    by expert into per-expert buffers (E_loc, cap, d) and multiplied
    there; every shape but ``cap`` is fixed by R.  ``cap`` is the busiest
    expert's rows, read from the data; a meta tensor (the dry-run) holds
    none, so there it is R, the most any data could need (the reference's
    static one-hot buffers have that size too)."""
    E_loc = p_local["we1"].shape[0]
    R, d = rx.shape
    dt, dev = rx.dtype, rx.device
    e = torch.where(eid >= 0, eid.long(), E_loc)    # empty slots sort last
    order = torch.argsort(e, stable=True)
    e = e[order]
    start = torch.searchsorted(e, torch.arange(E_loc + 1, device=dev),
                               side="left")
    cap = R if dev.type == "meta" else int((start[1:] - start[:-1]).max())
    if cap == 0:
        return torch.zeros_like(rx)
    filled = e < E_loc
    pos = torch.arange(R, device=dev) - start[e]
    # every empty slot writes row E_loc * cap, which is never read
    dest = torch.where(filled, e * cap + pos, E_loc * cap)
    h = rx.new_zeros((E_loc * cap + 1, d))
    h[dest] = rx[order]
    h = h[:E_loc * cap].view(E_loc, cap, d)
    a = torch.bmm(h, p_local["we1"].to(dt))
    b = torch.bmm(h, p_local["we3"].to(dt))
    del h
    a = F.silu(a).mul_(b)
    del b
    yb = torch.bmm(a, p_local["we2"].to(dt)).view(E_loc * cap, d)
    del a
    y = torch.empty_like(rx)
    y[order] = torch.where(filled[:, None], yb[torch.where(filled, dest, 0)],
                           0.0)
    return y


def moe_ffn_ep_local(p_local, cfg: ModelConfig, x_loc, *, group,
                     n_ranks: int, capacity_factor: float = None):
    """One rank's part.  ``x_loc``: (T_loc, d) this rank's tokens;
    ``p_local``: the replicated router, this rank's expert shards (E_loc,
    d, f) and the shared experts.  Returns (out (T_loc, d), aux averaged
    over ``group``, the number of this rank's token-to-expert assignments
    beyond capacity as a 0-dim tensor)."""
    if capacity_factor is None:
        capacity_factor = cfg.moe_capacity_factor
    T_loc, d = x_loc.shape
    E, k = cfg.num_experts, cfg.top_k
    E_loc = E // n_ranks
    dt, dev = x_loc.dtype, x_loc.device

    probs, gate, ids = route(p_local, cfg, x_loc)
    me = probs.mean(dim=0)
    ce = expert_counts(ids, E, probs.dtype)
    aux = E * (me * ce / (T_loc * k)).sum()
    dist.all_reduce(aux, group=group)
    aux = aux / n_ranks

    C = ep_capacity(T_loc, k, n_ranks, capacity_factor)
    flat_ids = ids.reshape(-1)                                # (T_loc*k,)
    dest_rank = flat_ids // E_loc
    # position within the destination rank's bucket: stable sort by rank
    sort_idx = torch.argsort(dest_rank, stable=True)
    sorted_rank = dest_rank[sort_idx]
    start = torch.searchsorted(sorted_rank,
                               torch.arange(n_ranks, device=dev), side="left")
    pos = torch.arange(T_loc * k, device=dev) - start[sorted_rank]
    tok = sort_idx // k
    valid = pos < C
    slot = torch.where(valid, sorted_rank * C + pos, n_ranks * C)

    # ---- dispatch: token bytes and expert ids in one all-to-all ----------
    xb = d * x_loc.element_size()
    eid = (flat_ids[sort_idx] % E_loc).to(torch.int32)
    payload = torch.cat([x_loc[tok].view(torch.uint8),
                         eid[:, None].view(torch.uint8)], dim=1)
    send = torch.zeros((n_ranks * C + 1, xb + 4), dtype=torch.uint8,
                       device=dev)
    send[:, xb:] = 255                      # expert id -1: an empty slot
    # every dropped assignment writes row n*C, which is never sent
    send[slot] = payload
    recv = torch.empty_like(send[:-1])
    dist.all_to_all_single(recv, send[:-1], group=group)
    rx = recv[:, :xb].contiguous().view(dt)
    reid = recv[:, xb:].contiguous().view(torch.int32)[:, 0]

    y = _expert_ffn(p_local, rx, reid)

    # ---- return trip -----------------------------------------------------
    y_back = torch.empty_like(y)
    dist.all_to_all_single(y_back, y, group=group)
    gate_sorted = gate.reshape(-1)[sort_idx].to(dt)
    contrib = (y_back[torch.where(valid, slot, 0)]
               * torch.where(valid, gate_sorted, 0.0)[:, None])
    slots = torch.empty_like(contrib)       # (T_loc*k, d): (token, j) rows
    slots[sort_idx] = contrib               # a permutation: no collisions
    out = slots.view(T_loc, k, d).sum(dim=1)

    if "shared" in p_local:
        out = out + L.mlp(p_local["shared"], x_loc)
    return out, aux, (~valid).sum()


def _gather(t: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """The blocks of ``t`` of every rank of ``group``, concatenated along
    ``dim`` in rank order."""
    if n == 1:
        return t
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def make_ep_moe_layer(cfg: ModelConfig, mesh, *, axis_name: str = "model",
                      capacity_factor: float = None):
    """Returns ``moe(params, x (B, S, d)) -> (out, aux)`` over ``mesh``.

    ``params``: the full moe params on every rank (each rank takes its
    experts); ``x``: the full input on every rank (each rank takes its
    (data, model) block).  Every rank gets the full output.  After a call
    ``moe.dropped`` holds this rank's assignments beyond capacity (a 0-dim
    tensor)."""
    n = mesh.size(axis_name)
    if cfg.num_experts % n:
        raise ValueError(f"{cfg.num_experts} experts over {n} ranks")
    E_loc = cfg.num_experts // n
    nd = mesh.size("data") if axis_name != "data" else 1

    def moe(params, x):
        B, S, d = x.shape
        if B % nd or S % n:
            raise ValueError(f"x {tuple(x.shape)} does not split over the "
                             f"mesh's data ({nd}) and {axis_name} ({n}) axes")
        mi = mesh.coord(axis_name)
        di = mesh.coord("data") if nd > 1 else 0
        B_loc, S_loc = B // nd, S // n
        x_loc = x[di * B_loc:(di + 1) * B_loc, mi * S_loc:(mi + 1) * S_loc]
        p_local = {k: params[k][mi * E_loc:(mi + 1) * E_loc]
                   for k in ("we1", "we3", "we2")}
        p_local["router"] = params["router"]
        if "shared" in params:
            p_local["shared"] = params["shared"]
        out, aux, moe.dropped = moe_ffn_ep_local(
            p_local, cfg, x_loc.reshape(B_loc * S_loc, d),
            group=mesh.group(axis_name), n_ranks=n,
            capacity_factor=capacity_factor)
        out = _gather(out.view(B_loc, S_loc, d), 1, mesh.group(axis_name), n)
        if nd > 1:
            out = _gather(out, 0, mesh.group("data"), nd)
            dist.broadcast(aux, src=mesh.ranks("data")[0],
                           group=mesh.group("data"))
        return out, aux

    moe.dropped = None
    return moe
