"""Synthetic datasets (offline container — no MNIST/CIFAR downloads).

``class_conditional_images`` builds an MNIST/CIFAR-like classification task:
each class c has a smooth prototype image; samples are prototype + structured
noise.  The ``separation`` knob controls achievable accuracy so the paper's
qualitative orderings (CNN > MLP, IID > non-IID) are reproducible.  Token
streams for LLM-scale federated pretraining come from a synthetic Zipf-Markov
source.
"""
from __future__ import annotations

import numpy as np


def _prototypes(rng, num_classes, size, channels, smooth=3):
    protos = rng.standard_normal((num_classes, size, size, channels))
    # cheap smoothing -> spatially-correlated "digit-like" blobs, which gives
    # conv nets a genuine edge over MLPs.
    for _ in range(smooth):
        protos = (protos
                  + np.roll(protos, 1, 1) + np.roll(protos, -1, 1)
                  + np.roll(protos, 1, 2) + np.roll(protos, -1, 2)) / 5.0
    protos -= protos.mean(axis=(1, 2, 3), keepdims=True)
    protos /= protos.std(axis=(1, 2, 3), keepdims=True) + 1e-9
    return protos


def class_conditional_images(seed: int, num_samples: int, *, num_classes=10,
                             size=28, channels=1, separation=1.6,
                             noise_smooth=1, proto_seed: int = 1234):
    """Returns (images (N,H,W,C) float32 in [0,1], labels (N,) int32).

    ``proto_seed`` fixes the class prototypes independently of the sample
    seed so train/test splits (different seeds) share the same task."""
    rng = np.random.default_rng(seed)
    protos = _prototypes(np.random.default_rng(proto_seed), num_classes,
                         size, channels)
    labels = rng.integers(0, num_classes, size=num_samples)
    noise = rng.standard_normal((num_samples, size, size, channels))
    for _ in range(noise_smooth):
        noise = (noise + np.roll(noise, 1, 1) + np.roll(noise, 1, 2)) / 3.0
    x = separation * protos[labels] + noise
    x = (x - x.min()) / (x.max() - x.min() + 1e-9)
    return x.astype(np.float32), labels.astype(np.int32)


def token_stream(seed: int, num_tokens: int, vocab_size: int,
                 *, zipf_a: float = 1.2) -> np.ndarray:
    """Zipf-distributed token stream with a light Markov structure."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    probs = ranks ** (-zipf_a)
    probs /= probs.sum()
    base = rng.choice(vocab_size, size=num_tokens, p=probs)
    # Markov flavor: with prob .3 repeat previous token's neighborhood
    rep = rng.random(num_tokens) < 0.3
    shifted = np.roll(base, 1) + rng.integers(0, 7, num_tokens)
    out = np.where(rep, shifted % vocab_size, base)
    return out.astype(np.int32)


def batches(images, labels, batch_size: int, seed: int):
    """Infinite shuffled batch generator."""
    rng = np.random.default_rng(seed)
    n = len(labels)
    while True:
        order = rng.permutation(n)
        for i in range(0, n - batch_size + 1, batch_size):
            sel = order[i:i + batch_size]
            yield images[sel], labels[sel]
