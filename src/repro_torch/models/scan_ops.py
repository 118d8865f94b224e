"""Chunked linear-recurrence scan — the shared math under RWKV6 (vector,
per-channel decay) and Mamba2/SSD (scalar, per-head decay), one for one
with the JAX package's ``models/scan_ops.py``.

Recurrence (per batch b, head h):
    S_t = diag(exp(ld_t)) . S_{t-1} + k_t v_t^T          S in R^{K x V}
    y_t = r_t . (S_t)                        if include_current (Mamba2/SSD)
    y_t = r_t . (S_{t-1}) + (r_t*bonus . k_t) v_t         else (RWKV6 w/ u)

The chunked form computes, per chunk of length Lc with L = cumsum(ld):
    carry   : y_cross = (r * exp(M)) @ S_in
    intra   : A[t,s]  = sum_k r_tk k_sk exp(M_tk - L_sk),  masked s<t|s<=t
    update  : S_out   = exp(L_end) * S_in + sum_s exp(L_end - L_s) k_s v_s^T

where M_t = L_t (include_current) or L_{t-1} (not).  Every exponent there
is <= 0.  The JAX package factors the intra term as (r exp(M)) . (k
exp(-L)); with the per-step log-decay clamped to [-1, 0], exp(-L) reaches
exp(Lc) — not a finite f32 at Lc = 128, where exp(M) underflows to 0 and A
holds 0 * inf = NaN.  Here the chunk's query rows go in sub-blocks of
``SUB_BLOCK`` steps, and each sub-block i takes its exponents relative to
the exclusive cumulative sum ``Lref_i`` at its first row:

    A[t,s] = (r_t exp(M_t - Lref_i)) . (k_s exp(Lref_i - L_s))

so no factor exceeds exp(SUB_BLOCK * LOG_DECAY_CLAMP); a factor that
underflows to 0 stands for a term that is itself below f32's range.  In
exact arithmetic it is the same function.

All exponentials run in f32 (in float64 for float64 inputs, which the
JAX package never sees: the port's model-level checks use them to hold
decode against the full forward free of f32 rounding); inputs/outputs
keep their dtype.
"""
from __future__ import annotations

import torch

from repro_torch.models import spmd

LOG_DECAY_CLAMP = 1.0   # per-step |log decay| cap for the factorized form
SUB_BLOCK = 16          # query rows sharing one exponent reference
# the routes of every family: the JAX package's "jnp"/"xla" and "pallas"
IMPLS = ("plain", "kernel")


def acc_dtype(t: torch.Tensor) -> torch.dtype:
    """The compute dtype of the scans and norms for ``t``: float32, or
    float64 for float64."""
    return torch.promote_types(t.dtype, torch.float32)


def _prep_decay(log_decay: torch.Tensor, K: int) -> torch.Tensor:
    """Broadcast scalar-per-head decay (B,T,H) to (B,T,H,K); clamp.
    Returns a new contiguous tensor in ``acc_dtype``."""
    ld = log_decay.to(acc_dtype(log_decay))
    if ld.dim() == 3:
        ld = ld[..., None]
    ld = ld.expand(*ld.shape[:-1], K)
    return torch.clamp(ld, -LOG_DECAY_CLAMP, 0.0)


def check_chunk(T: int, chunk: int) -> None:
    """The chunked forms need whole chunks (the JAX package asserts)."""
    if chunk <= 0 or T % chunk:
        raise ValueError(f"sequence length {T} is not a multiple of the "
                         f"chunk length {chunk}")


def recurrent_scan(r, k, v, log_decay, state0=None, *, include_current=True,
                   bonus=None):
    """Oracle: the plain sequential recurrence over time.  Shapes:
    r, k: (B,T,H,K); v: (B,T,H,V); log_decay: (B,T,H,K) or (B,T,H).
    Returns (y (B,T,H,V), final_state (B,H,K,V) in ``acc_dtype``)."""
    B, T, H, K = r.shape
    V = v.shape[-1]
    if spmd.split(r):               # the dry-runs: each rank's own heads
        return spmd.heads_call(
            _recurrent_scan_args, [r, k, v, log_decay, state0, bonus],
            [(True, 2)] * 4 + [(True, 1), (False, 0)],
            [(True, 2), (True, 1)], [(B, T, H, V), (B, H, K, V)],
            include_current=include_current)
    acc = acc_dtype(r)
    ld = _prep_decay(log_decay, K)
    S = (torch.zeros((B, H, K, V), dtype=acc, device=r.device)
         if state0 is None else state0.to(acc))
    r32, k32, v32 = r.to(acc), k.to(acc), v.to(acc)
    u = None if include_current else bonus.to(acc)
    ys = []
    for t in range(T):
        rt, kt, vt = r32[:, t], k32[:, t], v32[:, t]          # (B,H,K/V)
        S_new = torch.exp(ld[:, t])[..., None] * S + kt[..., None] * vt[
            ..., None, :]
        if include_current:
            y = torch.einsum("bhk,bhkv->bhv", rt, S_new)
        else:
            y = torch.einsum("bhk,bhkv->bhv", rt, S)
            y = y + torch.einsum("bhk,bhk->bh", rt * u, kt)[..., None] * vt
        ys.append(y)
        S = S_new
    y = (torch.stack(ys, 1) if ys
         else torch.zeros((B, 0, H, V), device=r.device))
    return y.to(v.dtype), S


def chunked_scan(r, k, v, log_decay, state0=None, *, include_current=True,
                 bonus=None, chunk=64, impl: str = "plain"):
    """Chunk-parallel scan.  Same contract as :func:`recurrent_scan`;
    ``T % chunk != 0`` raises ``ValueError``.

    ``impl="kernel"`` (the JAX package's ``"pallas"``) routes the chunk
    compute through ``kernels.chunk_scan`` (the CUDA kernel for a CUDA
    tensor, its plain version for a CPU one); ``impl="plain"`` (its
    ``"jnp"``) is the sub-block form above in PyTorch ops.  Under autograd
    the plain route is ``_ChunkedScan``: it saves its operands as passed
    and the state entering each chunk, and recomputes one chunk at a time
    in its backward.
    """
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "kernel":
        from repro_torch.kernels.chunk_scan import chunk_scan
        return chunk_scan(r, k, v, log_decay, state0,
                          include_current=include_current, bonus=bonus,
                          chunk=chunk)
    B, T, H, K = r.shape
    V = v.shape[-1]
    check_chunk(T, chunk)
    if spmd.split(r):               # the dry-runs: each rank's own heads
        return spmd.heads_call(
            _chunked_scan_args, [r, k, v, log_decay, state0, bonus],
            [(True, 2)] * 4 + [(True, 1), (False, 0)],
            [(True, 2), (True, 1)], [(B, T, H, V), (B, H, K, V)],
            include_current=include_current, chunk=chunk)
    operands = (r, k, v, log_decay, state0, bonus)
    if T and torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in operands):
        return _ChunkedScan.apply(*operands, include_current, chunk)
    return _scan(*operands, include_current, chunk)


def _keep(Lc: int, include_current: bool, device) -> torch.Tensor:
    """The intra-chunk mask (Lc, Lc): s <= t (include_current) or s < t."""
    rows = torch.arange(Lc, device=device)
    return (rows[:, None] >= rows[None, :] if include_current
            else rows[:, None] > rows[None, :])


def _chunk(rq, kq, vq, ldq, S, u, keep, include_current: bool):
    """One chunk of the sub-block form: ``rq``, ``kq`` (B, Lc, H, K),
    ``vq`` (B, Lc, H, V) and the log-decay ``ldq`` (B, Lc, H[, K]) as
    passed, ``S`` (B, H, K, V) the state entering it and ``u`` the bonus,
    both in ``acc_dtype``.  Returns (y (B, Lc, H, V), the state leaving
    it), both in ``acc_dtype``."""
    acc = S.dtype
    rq, kq, vq = rq.to(acc), kq.to(acc), vq.to(acc)
    L = torch.cumsum(_prep_decay(ldq, rq.shape[-1]), dim=1)   # (B,Lc,H,K)
    excl = torch.cat([torch.zeros_like(L[:, :1]), L[:, :-1]], dim=1)
    M = L if include_current else excl
    L_end = L[:, -1]                                          # (B,H,K)

    y = torch.einsum("blhk,bhkv->blhv", rq * torch.exp(M), S)
    parts = []
    Lc = rq.shape[1]
    for a in range(0, Lc, SUB_BLOCK):
        b = min(a + SUB_BLOCK, Lc)
        ref = excl[:, a:a + 1]                                # (B,1,H,K)
        q_t = rq[:, a:b] * torch.exp(M[:, a:b] - ref)
        k_t = kq[:, :b] * torch.exp(ref - L[:, :b])
        A = torch.einsum("blhk,bshk->bhls", q_t, k_t)
        A = torch.where(keep[a:b, :b], A, 0.0)
        parts.append(torch.einsum("bhls,bshv->blhv", A, vq[:, :b]))
    y = y + torch.cat(parts, dim=1)
    if not include_current:
        diag = torch.einsum("blhk,blhk->blh", rq * u, kq)
        y = y + diag[..., None] * vq
    k_carry = kq * torch.exp(L_end[:, None] - L)
    S = (torch.exp(L_end)[..., None] * S
         + torch.einsum("blhk,blhv->bhkv", k_carry, vq))
    return y, S


def _scan(r, k, v, log_decay, state0, bonus, include_current: bool,
          chunk: int, states=None):
    """The sub-block form over every chunk, (y in v's dtype, the final
    state in ``acc_dtype``); the state entering each chunk is appended to
    ``states`` when it is given."""
    B, T, H, K = r.shape
    V = v.shape[-1]
    dev = r.device
    acc = acc_dtype(r)
    S = (torch.zeros((B, H, K, V), dtype=acc, device=dev)
         if state0 is None else state0.to(acc))
    u = None if include_current else bonus.to(acc)
    keep = _keep(chunk, include_current, dev)
    ys = []
    for c in range(T // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        if states is not None:
            states.append(S)
        y, S = _chunk(r[:, sl], k[:, sl], v[:, sl], log_decay[:, sl], S, u,
                      keep, include_current)
        ys.append(y)
    y = (torch.cat(ys, dim=1) if ys
         else torch.zeros((B, 0, H, V), device=dev))
    return y.to(v.dtype), S


class _ChunkedScan(torch.autograd.Function):
    """``_scan`` under autograd, holding its operands as passed and one
    state a chunk where autograd's own graph of ``_scan`` would hold every
    sub-block's products (copies that grow with the chunk's square).  The
    backward walks the chunks from last to first: it recomputes a chunk's
    forward from its operands and entering state (the same ``_chunk``, so
    the same sub-block exponents) and takes the gradients of (y, the state
    leaving it), handing the state's on to the chunk before.  Its peak is
    one chunk's graph."""

    @staticmethod
    def forward(ctx, r, k, v, log_decay, state0, bonus, include_current,
                chunk):
        states = []
        y, S = _scan(r, k, v, log_decay, state0, bonus, include_current,
                     chunk, states)
        ctx.save_for_backward(r, k, v, log_decay, bonus, *states)
        ctx.meta = (include_current, chunk,
                    None if state0 is None else state0.dtype)
        ctx.set_materialize_grads(False)    # an unused output's is None
        return y, S

    @staticmethod
    def backward(ctx, gy, gS):
        r, k, v, log_decay, bonus, *states = ctx.saved_tensors
        include_current, chunk, state0_dtype = ctx.meta
        need = ctx.needs_input_grad
        acc = acc_dtype(r)
        u = (None if include_current
             else bonus.detach().to(acc).requires_grad_(need[5]))
        keep = _keep(chunk, include_current, r.device)
        parts, gu = [], None            # each chunk's (gr, gk, gv, gld)
        for c in reversed(range(len(states))):
            sl = slice(c * chunk, (c + 1) * chunk)
            with torch.enable_grad():
                ins = [t[:, sl].detach().requires_grad_(want)
                       for t, want in zip((r, k, v, log_decay), need)]
                S = states[c].detach().requires_grad_(c > 0 or need[4])
                y, S_out = _chunk(*ins, S, u, keep, include_current)
            outs, cots = zip(*[(o, g) for o, g in (
                (y, None if gy is None else gy[:, sl].to(acc)), (S_out, gS))
                if g is not None])
            wrt = [t for t in (*ins, S, u) if t is not None
                   and t.requires_grad]
            # an operand with no path to the outputs (r without y's
            # gradient) gets zeros
            got = dict(zip(map(id, wrt), torch.autograd.grad(
                outs, wrt, cots, materialize_grads=True)))
            parts.append([got.get(id(t)) for t in ins])
            gS, g = got.get(id(S)), got.get(id(u))
            if g is not None:
                gu = g if gu is None else gu + g
            del y, S_out, outs, ins, got
        grads = [torch.cat([p[i] for p in reversed(parts)], dim=1)
                 if need[i] else None for i in range(4)]
        g0 = gS.to(state0_dtype) if need[4] else None
        gb = gu.to(bonus.dtype) if gu is not None else None
        return (*grads, g0, gb, None, None)


def recurrent_step(r, k, v, log_decay, state, *, include_current=True,
                   bonus=None):
    """Single decode step. r,k:(B,H,K) v:(B,H,V) state:(B,H,K,V) f32;
    log_decay (B,H,K) or (B,H)."""
    if spmd.split(r):               # the dry-runs: each rank's own heads
        B, H, K = r.shape
        return spmd.heads_call(
            _recurrent_step_args, [r, k, v, log_decay, state, bonus],
            [(True, 1)] * 5 + [(False, 0)], [(True, 1), (True, 1)],
            [(B, H, v.shape[-1]), (B, H, K, v.shape[-1])],
            include_current=include_current)
    K = r.shape[-1]
    ld = _prep_decay(log_decay[:, None], K)[:, 0]    # add/strip a time axis
    acc = acc_dtype(r)
    r32, k32, v32 = r.to(acc), k.to(acc), v.to(acc)
    S_new = torch.exp(ld)[..., None] * state + k32[..., None] * v32[
        ..., None, :]
    if include_current:
        y = torch.einsum("bhk,bhkv->bhv", r32, S_new)
    else:
        y = torch.einsum("bhk,bhkv->bhv", r32, state)
        y = y + torch.einsum("bhk,bhk->bh", r32 * bonus.to(acc),
                             k32)[..., None] * v32
    return y.to(v.dtype), S_new


def _recurrent_scan_args(r, k, v, log_decay, state0, bonus, **kwargs):
    return recurrent_scan(r, k, v, log_decay, state0, bonus=bonus, **kwargs)


def _chunked_scan_args(r, k, v, log_decay, state0, bonus, **kwargs):
    return chunked_scan(r, k, v, log_decay, state0, bonus=bonus, **kwargs)


def _recurrent_step_args(r, k, v, log_decay, state, bonus, **kwargs):
    return recurrent_step(r, k, v, log_decay, state, bonus=bonus, **kwargs)
