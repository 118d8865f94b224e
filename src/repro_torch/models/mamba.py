"""Mamba2 (SSD) block and the Zamba2 hybrid wiring [arXiv:2411.15242], one
for one with the JAX package's ``models/mamba.py``.

Mamba2 block: in_proj -> (z | x | B | C | dt), causal depthwise conv over
(x,B,C), SSD linear recurrence with scalar-per-head decay
``a_t = exp(-softplus(dt_t + dt_bias) * exp(A_log))``, D skip, silu(z) gating,
RMSNorm, out_proj.  The SSD scan maps onto ``scan_ops`` with r=C, k=dt*B,
v=x_heads (include_current=True).

The scan's operands go in as the model makes them: ``r`` is C broadcast
over the heads (an ``expand`` view, head stride 0), ``v`` a view of the
conv output (row stride ``d_inner + 2 N``), the decay a scalar per head
``(B, S, H)``; only ``k = B * dt`` is materialised.  Prefill (S > 1)
runs ``scan_ops.chunked_scan`` (``impl="kernel"``: the chunk_scan kernel,
the JAX package's ``"pallas"``; ``impl="plain"``: its ``"jnp"``), decode
(S == 1) ``scan_ops.recurrent_step`` in plain PyTorch, as in the JAX
package.

Zamba2: Mamba2 layers with one *shared* attention(+MLP) block applied
before every ``attn_every`` layers (identical weights each call); the
registry loops over groups and layers where the JAX package scans.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import scan_ops

CONV_K = 4           # depthwise conv kernel size
N_GROUPS = 1         # B/C groups


def _dims(cfg: ModelConfig):
    H = cfg.ssm_heads
    hd = cfg.ssm_head_dim or (cfg.d_model // H)
    d_inner = H * hd
    N = cfg.ssm_state
    return H, hd, d_inner, N


def init_layer(gen: torch.Generator, cfg: ModelConfig, *, device, lead=()):
    """One layer's params, or ``lead``-shaped stacks of them, under the
    JAX package's keys and layouts."""
    d = cfg.d_model
    H, hd, d_inner, N = _dims(cfg)
    conv_dim = d_inner + 2 * N_GROUPS * N
    lead = tuple(lead)

    def const(shape, value):
        return torch.full(lead + shape, value, dtype=torch.float32,
                          device=device)

    def dense(shape, in_axis_size):
        return L.dense_init(gen, lead + shape, in_axis_size=in_axis_size,
                            device=device)

    return {
        "ln": const((d,), 1.0),
        "in_proj": dense((d, 2 * d_inner + 2 * N_GROUPS * N + H), d),
        "conv_w": dense((CONV_K, conv_dim), CONV_K),
        "conv_b": const((conv_dim,), 0.0),
        "A_log": const((H,), 0.0),                # A = -exp(A_log) ~ -1
        "D": const((H,), 1.0),
        "dt_bias": const((H,), -2.0),             # softplus^-1-ish small dt
        "out_norm": const((d_inner,), 1.0),
        "out_proj": dense((d_inner, d), d_inner),
    }


def _split_proj(cfg: ModelConfig, zxbcdt):
    H, hd, d_inner, N = _dims(cfg)
    z, xc, dt = torch.split(zxbcdt, [d_inner, d_inner + 2 * N_GROUPS * N, H],
                            dim=-1)
    return z, xc, dt      # xc = conv input (x | B | C)


def _causal_conv(xc, w, b, conv_state=None):
    """Depthwise causal conv, kernel CONV_K. xc: (B,S,C).
    Returns (out, new_conv_state (B, CONV_K-1, C))."""
    Bsz, S, C = xc.shape
    dt = xc.dtype
    pad = (conv_state.to(dt) if conv_state is not None
           else torch.zeros((Bsz, CONV_K - 1, C), dtype=dt, device=xc.device))
    xp = torch.cat([pad, xc], dim=1)                         # (B, S+K-1, C)
    out = xp[:, :S] * w[0].to(dt)
    for i in range(1, CONV_K):
        out = out + xp[:, i:i + S] * w[i].to(dt)
    out = F.silu(out + b.to(dt))
    return out, xp[:, S:]


def block(p, cfg: ModelConfig, x, state, *, impl="kernel"):
    """One Mamba2 layer. state = dict(conv (B,K-1,C), ssm (B,H,N,hd) f32).
    Returns (x_out, new_state)."""
    Bsz, S, d = x.shape
    H, hd, d_inner, N = _dims(cfg)
    dt_ = x.dtype
    acc = scan_ops.acc_dtype(x)
    h = L.rms_norm(x, p["ln"])
    z, xc, dt_raw = _split_proj(cfg, h @ p["in_proj"].to(dt_))
    xc, conv_state = _causal_conv(xc, p["conv_w"], p["conv_b"], state["conv"])
    xs, B_, C_ = torch.split(xc, [d_inner, N_GROUPS * N, N_GROUPS * N],
                             dim=-1)

    dt = F.softplus(dt_raw.to(acc) + p["dt_bias"].to(acc))       # (B,S,H)
    log_decay = -dt * torch.exp(p["A_log"].to(acc))              # (B,S,H)

    v = xs.view(Bsz, S, H, hd)                     # row stride d_inner + 2N
    k = B_.view(Bsz, S, N_GROUPS, N) * dt[..., None].to(dt_)     # (B,S,H,N)
    r = C_.view(Bsz, S, N_GROUPS, N).expand(Bsz, S, H, N)        # head stride 0

    if S > 1:
        y, ssm = scan_ops.chunked_scan(r, k, v, log_decay, state["ssm"],
                                       include_current=True,
                                       chunk=min(cfg.chunk_size, S), impl=impl)
    else:
        y1, ssm = scan_ops.recurrent_step(r[:, 0], k[:, 0], v[:, 0],
                                          log_decay[:, 0], state["ssm"],
                                          include_current=True)
        y = y1[:, None]

    y = y + v * p["D"].to(dt_)[None, None, :, None]
    y = y.reshape(Bsz, S, d_inner) * F.silu(z)
    y = L.rms_norm(y, p["out_norm"])
    out = y @ p["out_proj"].to(dt_)
    return x + out, {"conv": conv_state, "ssm": ssm}


def init_state(cfg: ModelConfig, batch: int, dtype, *, device, lead=()):
    """Zero states of ``lead``-shaped stacks of layers: conv (..., B, K-1,
    C) in ``dtype``, ssm (..., B, H, N, hd) in f32 (float64 for float64)."""
    H, hd, d_inner, N = _dims(cfg)
    conv_dim = d_inner + 2 * N_GROUPS * N
    lead = tuple(lead)
    return {
        "conv": torch.zeros(lead + (batch, CONV_K - 1, conv_dim), dtype=dtype,
                            device=device),
        "ssm": torch.zeros(lead + (batch, H, N, hd),
                           dtype=torch.promote_types(dtype, torch.float32),
                           device=device),
    }


# --------------------------------------------------------------------------
# shared attention block (zamba2)
# --------------------------------------------------------------------------

def init_shared_attn(gen: torch.Generator, cfg: ModelConfig, *, device):
    return {
        "ln_a": torch.ones((cfg.d_model,), device=device),
        "attn": L.init_attention(gen, cfg, device=device),
        "ln_m": torch.ones((cfg.d_model,), device=device),
        "mlp": L.init_mlp(gen, cfg.d_model, cfg.d_ff, device=device),
    }


def shared_attn_block(p, cfg: ModelConfig, x, positions, kv_cache=None, *,
                      window: int = 0, impl: str = "kernel"):
    """The shared block; ``impl="kernel"`` runs the prefill's attention
    through flash_attention (the JAX package's block always takes its XLA
    route; the two agree within the route-parity tolerance)."""
    h = L.rms_norm(x, p["ln_a"])
    att, new_cache = L.attention(p["attn"], cfg, h, positions, kv_cache,
                                 window=window, impl=impl)
    x = x + att
    x = x + L.mlp(p["mlp"], L.rms_norm(x, p["ln_m"]))
    return x, new_cache
