"""RWKV6 ("Finch") — attention-free with data-dependent decay
[arXiv:2404.05892], one for one with the JAX package's ``models/rwkv.py``.

Per layer: a time-mix block (token-shift interpolation with LoRA-produced
data-dependent mixing coefficients, data-dependent per-channel decay
``w = exp(-exp(w0 + lora(x)))``, WKV linear recurrence with bonus ``u``) and
a channel-mix block (squared-ReLU FFN with receptance gate).  RMSNorm where
upstream uses LayerNorm, as in the JAX package (its DESIGN.md).

Prefill (S > 1) runs the recurrence through ``scan_ops.chunked_scan``:
``impl="kernel"`` (the JAX package's ``"pallas"``) is the chunk_scan
kernel, ``impl="plain"`` (its ``"jnp"``) the chunked form in PyTorch ops.
Decode (S == 1) takes ``scan_ops.recurrent_scan`` in plain PyTorch, as in
the JAX package.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import scan_ops, spmd

TM_LORA = 32     # time-mix lora rank (5 heads of it)
TD_LORA = 64     # decay lora rank


def init_layer(gen: torch.Generator, cfg: ModelConfig, *, device, lead=()):
    """One layer's params, or ``lead``-shaped stacks of them, under the
    JAX package's keys and layouts."""
    d = cfg.d_model
    H = cfg.ssm_heads
    hd = d // H
    lead = tuple(lead)

    def const(shape, value):
        return torch.full(lead + shape, value, dtype=torch.float32,
                          device=device)

    def dense(shape, in_axis_size=None):
        return L.dense_init(gen, lead + shape, in_axis_size=in_axis_size
                            if in_axis_size is not None else shape[0],
                            device=device)

    return {
        "ln1": const((d,), 1.0), "ln2": const((d,), 1.0),
        # token-shift mixing
        "mu_base": const((d,), 0.0),
        "mu": const((5, d), 0.0),
        "tm_w1": dense((d, 5 * TM_LORA)),
        "tm_w2": dense((5, TM_LORA, d), in_axis_size=TM_LORA),
        # data-dependent decay
        "w0": const((d,), -0.6931),         # exp(-exp(w0)) ~ 0.5 halflife-ish
        "td_w1": dense((d, TD_LORA)),
        "td_w2": dense((TD_LORA, d), in_axis_size=TD_LORA),
        # projections
        "tm_wr": dense((d, d)),
        "tm_wk": dense((d, d)),
        "tm_wv": dense((d, d)),
        "tm_wg": dense((d, d)),
        "tm_wo": dense((d, d)),
        "u": const((H, hd), 0.0),           # bonus ("time_faaaa")
        "gn_scale": const((d,), 1.0), "gn_bias": const((d,), 0.0),
        # channel mix
        "cm_mu_r": const((d,), 0.0), "cm_mu_k": const((d,), 0.0),
        "cm_wr": dense((d, d)),
        "cm_wk": dense((d, cfg.d_ff)),
        "cm_wv": dense((cfg.d_ff, d), in_axis_size=cfg.d_ff),
    }


def _shift(x, prev):
    """Token shift: x_{t-1}, with ``prev`` (B,d) as the t=-1 value."""
    return torch.cat([prev[:, None], x[:, :-1]], dim=1)


def time_mix(p, cfg: ModelConfig, x, prev_x, wkv_state, *, chunked=True,
             impl="kernel"):
    """x: (B,S,d). Returns (out, last_x (B,d), new_wkv_state)."""
    B, S, d = x.shape
    H = cfg.ssm_heads
    hd = d // H
    dt = x.dtype

    xs = _shift(x, prev_x)
    dx = xs - x
    xxx = x + dx * p["mu_base"].to(dt)
    lora = torch.tanh(xxx @ p["tm_w1"].to(dt)).reshape(B, S, 5, TM_LORA)
    offs = torch.einsum("bsfr,frd->fbsd", lora, p["tm_w2"].to(dt))  # (5,B,S,d)
    mixed = x[None] + dx[None] * (p["mu"].to(dt)[:, None, None] + offs)
    xw, xk, xv, xr, xg = mixed

    acc = scan_ops.acc_dtype(x)
    ww = p["w0"].to(acc) + (torch.tanh(xw @ p["td_w1"].to(dt))
                            @ p["td_w2"].to(dt)).to(acc)
    log_decay = -torch.exp(ww)                                     # (B,S,d)

    r = (xr @ p["tm_wr"].to(dt)).reshape(B, S, H, hd)
    k = (xk @ p["tm_wk"].to(dt)).reshape(B, S, H, hd)
    v = (xv @ p["tm_wv"].to(dt)).reshape(B, S, H, hd)
    g = xg @ p["tm_wg"].to(dt)
    ld = log_decay.reshape(B, S, H, hd)

    if chunked:
        y, new_state = scan_ops.chunked_scan(
            r, k, v, ld, wkv_state, include_current=False, bonus=p["u"],
            chunk=min(cfg.chunk_size, S), impl=impl)
    else:
        y, new_state = scan_ops.recurrent_scan(
            r, k, v, ld, wkv_state, include_current=False, bonus=p["u"])

    y = L.group_norm_heads(y, p["gn_scale"].reshape(H, hd),
                           p["gn_bias"].reshape(H, hd))
    y = y.reshape(B, S, d) * F.silu(g)
    return y @ p["tm_wo"].to(dt), x[:, -1], new_state


def time_mix_step(p, cfg: ModelConfig, x, prev_x, wkv_state):
    """Single-token decode. x: (B,1,d)."""
    return time_mix(p, cfg, x, prev_x, wkv_state, chunked=False)


def channel_mix(p, x, prev_x):
    dt = x.dtype
    xs = _shift(x, prev_x)
    dx = xs - x
    xr = x + dx * p["cm_mu_r"].to(dt)
    xk = x + dx * p["cm_mu_k"].to(dt)
    h = torch.relu(xk @ p["cm_wk"].to(dt)).square()
    # on DTensors the row-parallel product is reduced and its gradient
    # gathered whole, as GSPMD does, before the gate split by columns
    out = torch.sigmoid(xr @ p["cm_wr"].to(dt)) * spmd.batch_only(
        h @ p["cm_wv"].to(dt))
    return out, x[:, -1]


def block(p, cfg: ModelConfig, x, state, *, impl="kernel"):
    """One RWKV layer. state = dict(tm_x, cm_x, wkv). Returns (x,
    new_state)."""
    x = spmd.batch_only(x)
    h = L.rms_norm(x, p["ln1"])
    att, tm_x, wkv = time_mix(p, cfg, h, state["tm_x"], state["wkv"],
                              chunked=x.shape[1] > 1, impl=impl)
    x = spmd.batch_only(x + att)
    h = L.rms_norm(x, p["ln2"])
    ffn, cm_x = channel_mix(p, h, state["cm_x"])
    x = x + ffn
    return x, {"tm_x": tm_x, "cm_x": cm_x, "wkv": wkv}


def init_state(cfg: ModelConfig, batch: int, dtype, *, device):
    d = cfg.d_model
    H = cfg.ssm_heads
    hd = d // H
    Lr = cfg.num_layers
    return {
        "tm_x": torch.zeros((Lr, batch, d), dtype=dtype, device=device),
        "cm_x": torch.zeros((Lr, batch, d), dtype=dtype, device=device),
        "wkv": torch.zeros((Lr, batch, H, hd, hd),
                           dtype=torch.promote_types(dtype, torch.float32),
                           device=device),
    }
