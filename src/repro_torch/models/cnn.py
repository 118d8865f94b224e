"""The paper's FL client models (§V-A): small CNN and MLP classifiers.

Params are dicts of tensors with the JAX package's names and shapes (HWIO
convolutions), so the two packages' models flatten into the same vector.
Every function here takes a leading participant axis C: ``params[k]`` is
(C, *shape) and images are (C, B, H, W, channels), so one call runs all of
an epoch's participants at once (the JAX package's ``vmap`` written out).
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from repro_torch import resolve_device
from repro_torch.configs.paper_models import SmallNetConfig

Params = Dict[str, torch.Tensor]


def dense_init(shape, generator: torch.Generator, in_axis_size=None,
               *, device) -> torch.Tensor:
    """Truncated-normal fan-in init: N(0, 1) cut at ±2, times
    1/sqrt(fan_in)."""
    fan_in = in_axis_size if in_axis_size is not None else shape[0]
    std = 1.0 / math.sqrt(max(fan_in, 1))
    w = torch.empty(shape, dtype=torch.float32)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (w * std).to(device)


def init_params(seed: int, cfg: SmallNetConfig, *, device="cuda") -> Params:
    """One model's parameters (no participant axis), drawn from ``seed``."""
    dev = resolve_device(device)
    g = torch.Generator().manual_seed(int(seed))

    def zeros(n):
        return torch.zeros((n,), dtype=torch.float32, device=dev)

    if cfg.kind == "mlp":
        d_in = cfg.image_size * cfg.image_size * cfg.channels
        return {
            "w1": dense_init((d_in, cfg.hidden), g, device=dev),
            "b1": zeros(cfg.hidden),
            "w2": dense_init((cfg.hidden, cfg.hidden), g, device=dev),
            "b2": zeros(cfg.hidden),
            "w3": dense_init((cfg.hidden, cfg.num_classes), g, device=dev),
            "b3": zeros(cfg.num_classes),
        }
    c1, c2 = cfg.conv_channels
    # two 3x3 convs with 2x2 pooling each
    flat = (cfg.image_size // 4) * (cfg.image_size // 4) * c2
    return {
        "conv1": dense_init((3, 3, cfg.channels, c1), g,
                            in_axis_size=9 * cfg.channels, device=dev),
        "bc1": zeros(c1),
        "conv2": dense_init((3, 3, c1, c2), g, in_axis_size=9 * c1,
                            device=dev),
        "bc2": zeros(c2),
        "w1": dense_init((flat, cfg.hidden), g, device=dev),
        "b1": zeros(cfg.hidden),
        "w2": dense_init((cfg.hidden, cfg.num_classes), g, device=dev),
        "b2": zeros(cfg.num_classes),
    }


def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """3x3 SAME convolution as im2col + one batched matmul, then ReLU.
    x (C, B, H, W, Cin), w (C, kh, kw, Cin, Cout), b (C, Cout)."""
    C, B, H, W, Cin = x.shape
    kh, kw, _, Cout = w.shape[1:]
    xp = torch.nn.functional.pad(
        x, (0, 0, kw // 2, kw // 2, kh // 2, kh // 2))
    patches = torch.stack([xp[:, :, i:i + H, j:j + W, :]
                           for i in range(kh) for j in range(kw)], dim=4)
    y = torch.bmm(patches.reshape(C, B * H * W, kh * kw * Cin),
                  w.reshape(C, kh * kw * Cin, Cout))
    return torch.relu(y.reshape(C, B, H, W, Cout) + b[:, None, None, None, :])


def _pool(x: torch.Tensor) -> torch.Tensor:
    """2x2 max-pool, stride 2, VALID (an odd last row/column is dropped).
    ``max`` over one axis at a time sends each window's gradient to one
    element, as the reference's ``reduce_window`` max does."""
    C, B, H, W, Ch = x.shape
    h2, w2 = H // 2, W // 2
    x = x[:, :, :2 * h2, :2 * w2].reshape(C, B, h2, 2, w2, 2, Ch)
    return x.max(dim=5).values.max(dim=3).values


def apply(params: Params, cfg: SmallNetConfig,
          images: torch.Tensor) -> torch.Tensor:
    """images (C, B, H, W, channels) in [0, 1] -> logits (C, B, classes)."""
    C, B = images.shape[:2]
    if cfg.kind == "mlp":
        x = images.reshape(C, B, -1)
        x = torch.relu(x @ params["w1"] + params["b1"][:, None, :])
        x = torch.relu(x @ params["w2"] + params["b2"][:, None, :])
        return x @ params["w3"] + params["b3"][:, None, :]
    x = _pool(_conv(images, params["conv1"], params["bc1"]))
    x = _pool(_conv(x, params["conv2"], params["bc2"]))
    x = x.reshape(C, B, -1)
    x = torch.relu(x @ params["w1"] + params["b1"][:, None, :])
    return x @ params["w2"] + params["b2"][:, None, :]


def loss_fn(params: Params, cfg: SmallNetConfig, images: torch.Tensor,
            labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy per participant: (C,)."""
    logits = apply(params, cfg, images)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return (logz - gold).mean(dim=-1)


def accuracy(params: Params, cfg: SmallNetConfig, images: torch.Tensor,
             labels: torch.Tensor) -> torch.Tensor:
    """Top-1 accuracy per participant: (C,)."""
    logits = apply(params, cfg, images)
    return (logits.argmax(dim=-1) == labels).float().mean(dim=-1)
