"""Plain PyTorch versions of the chunk_scan kernel.

``chunk_scan_ref`` is the sequential recurrence
(``models.scan_ops.recurrent_scan``), as the JAX package's oracle is: the
CPU route of the wrapper and the kernel's yardstick in the tests and
``chip_smoke.py``.

``chunk_scan_blocked_ref`` runs the kernel's own decomposition, to
localise a disagreement: per-chunk state contributions, a sequential pass
over the chunks' states, and per-chunk outputs in sub-blocks of 16 query
rows whose exponents are re-referenced to the sub-block's first row.  Its
products can round their operands to TF32 as the tensor cores take them
(``tf32_passes``): each f32 operand splits as hi + lo, both rounded to
TF32 to nearest; 1 keeps only hi . hi, 3 adds hi . lo + lo . hi (the
kernel's products), 0 multiplies in f32.  (The kernel's bf16 route leaves
lo's low bits to the tensor core, which drops them; the difference is far
below the tolerances this version is held to.)
"""
import torch

from repro_torch.models.scan_ops import (SUB_BLOCK, _prep_decay, check_chunk,
                                         recurrent_scan)


def chunk_scan_ref(r, k, v, log_decay, state0=None, *, include_current=True,
                   bonus=None):
    """The sequential recurrence; RWKV6 mode without a bonus takes a zero
    one, as the JAX package's wrapper does."""
    return recurrent_scan(r, k, v, log_decay, state0,
                          include_current=include_current,
                          bonus=_bonus(r, bonus, include_current))


def _bonus(r, bonus, include_current):
    if include_current or bonus is not None:
        return bonus
    return torch.zeros(r.shape[2:], dtype=torch.float32, device=r.device)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 (10 mantissa bits) to nearest, ties away from
    zero, as ``cvt.rna.tf32.f32`` rounds."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _product(eq: str, a, b, passes: int):
    """``einsum(eq, a, b)`` with TF32 operands: ``passes`` 1 is hi . hi, 3
    adds hi . lo + lo . hi; 0 multiplies in f32."""
    if passes == 0:
        return torch.einsum(eq, a, b)
    a_hi, b_hi = tf32_round(a), tf32_round(b)
    out = torch.einsum(eq, a_hi, b_hi)
    if passes == 3:
        a_lo, b_lo = tf32_round(a - a_hi), tf32_round(b - b_hi)
        out = out + torch.einsum(eq, a_hi, b_lo) + torch.einsum(eq, a_lo,
                                                                b_hi)
    return out


def chunk_scan_blocked_ref(r, k, v, log_decay, state0=None, *,
                           include_current=True, bonus=None, chunk=64,
                           tf32_passes=0):
    """The wrapper's contract ((B, T, H, ·) layout, chunks of
    ``min(chunk, T)`` steps), computed as the kernel decomposes it:

      1. per chunk c, with L the inclusive cumulative log-decay:
         exp(L_end) and dS_c = (k exp(L_end - L))^T v;
      2. S_{c+1} = exp(L_end,c) S_c + dS_c from the initial state;
      3. per chunk, per sub-block of 16 rows with reference Lref (the
         exclusive cumsum at its first row) and M = L (Mamba2) or the
         exclusive cumsum (RWKV6): y = (r exp(M)) S_c + masked
         ((r exp(M - Lref)) (k exp(Lref - L))^T) v, plus the RWKV6 bonus.

    Returns (y (B, T, H, V) in v's dtype, final state (B, H, K, V) f32)."""
    if tf32_passes not in (0, 1, 3):
        raise ValueError(f"tf32_passes must be 0, 1 or 3, got {tf32_passes}")
    B, T, H, K = r.shape
    V = v.shape[-1]
    Lc = min(chunk, T)
    check_chunk(T, Lc)
    nc = T // Lc
    f32 = torch.float32

    def chunks(x):                     # (B, T, H, X) -> (B, nc, Lc, H, X)
        return x.to(f32).reshape(B, nc, Lc, H, x.shape[-1])

    rq, kq, vq = chunks(r), chunks(k), chunks(v)
    L = torch.cumsum(chunks(_prep_decay(log_decay, K)), dim=2)
    excl = torch.cat([torch.zeros_like(L[:, :, :1]), L[:, :, :-1]], dim=2)
    M = L if include_current else excl
    L_end = L[:, :, -1]                                     # (B, nc, H, K)

    dS = _product("bclhk,bclhv->bchkv", kq * torch.exp(L_end[:, :, None] - L),
                  vq, tf32_passes)
    S = (torch.zeros((B, H, K, V), dtype=f32, device=r.device)
         if state0 is None else state0.to(f32))
    starts = []
    for c in range(nc):
        starts.append(S)
        S = torch.exp(L_end[:, c])[..., None] * S + dS[:, c]
    S_c = torch.stack(starts, 1)                            # (B, nc, H, K, V)

    rows = torch.arange(Lc, device=r.device)
    keep = (rows[:, None] >= rows[None, :] if include_current
            else rows[:, None] > rows[None, :])
    parts = []
    for a in range(0, Lc, SUB_BLOCK):
        b = min(a + SUB_BLOCK, Lc)
        ref = excl[:, :, a:a + 1]
        q = rq[:, :, a:b] * torch.exp(M[:, :, a:b] - ref)
        kt = kq[:, :, :b] * torch.exp(ref - L[:, :, :b])
        A = _product("bclhk,bcshk->bchls", q, kt, tf32_passes)
        A = torch.where(keep[a:b, :b], A, 0.0)
        y = _product("bchls,bcshv->bclhv", A, vq[:, :, :b], tf32_passes)
        y = y + _product("bclhk,bchkv->bclhv",
                         rq[:, :, a:b] * torch.exp(M[:, :, a:b]), S_c,
                         tf32_passes)
        parts.append(y)
    y = torch.cat(parts, dim=2)
    if not include_current:
        u = _bonus(r, bonus, include_current).to(f32)
        diag = torch.einsum("bclhk,bclhk->bclh", rq * u, kq)
        y = y + diag[..., None] * vq
    return y.reshape(B, T, H, V).to(v.dtype), S
