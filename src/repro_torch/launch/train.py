"""Training driver for the assigned archs (the port of the JAX package's
``launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \\
        --steps 20 [--batch 4] [--seq 128] [--lr 1e-3] [--device cuda]

Runs AdamW steps (``launch.steps.make_train_step``, weight decay 0.1) on
the arch's reduced float32 config with random weights from seed 0, each
step on a fresh ``make_batch`` of the synthetic token stream.  As in the
JAX package, ``--reduced`` is on whatever the flags say; ``train()`` takes
any config, e.g. a published one cut in depth.  Training differentiates
the plain route: the CUDA kernels are forward-only.  ``--device``
defaults to ``cuda``; asking for it without a card raises.
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.data.synthetic import token_stream
from repro_torch.launch.steps import make_optimizer, make_train_step
from repro_torch.models import registry as R
from repro_torch.tree import tree_leaves

SEED = 0


def make_batch(cfg: ModelConfig, batch: int, seq: int, seed: int = 0, *,
               device="cuda"):
    """The JAX package's ``make_batch``: ``(batch, seq)`` tokens of the
    synthetic stream, with the vision stub's prefix embeddings or the audio
    stub's frames, labels and mask drawn from ``seed`` by numpy, on
    ``device``."""
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    toks = token_stream(seed, batch * seq, cfg.vocab_size).reshape(batch, seq)
    b = {"tokens": torch.tensor(toks, dtype=torch.long, device=dev)}
    if cfg.frontend == "vision_stub":
        P = cfg.num_prefix_embeds
        b["prefix_embeds"] = torch.tensor(
            np.random.default_rng(seed).standard_normal(
                (batch, P, cfg.d_model)) * 0.02, dtype=dtype, device=dev)
    if cfg.frontend == "audio_stub":
        rng = np.random.default_rng(seed)
        b = {"frame_embeds": torch.tensor(
                rng.standard_normal((batch, seq, cfg.d_model)) * 0.02,
                dtype=dtype, device=dev),
             "labels": torch.tensor(rng.integers(0, cfg.vocab_size,
                                                 (batch, seq)),
                                    dtype=torch.long, device=dev),
             "mask": torch.tensor(rng.random((batch, seq)) < 0.3,
                                  device=dev)}
    return b


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def train(cfg: ModelConfig, *, steps: int, batch: int, seq: int,
          lr: float = 1e-3, device="cuda", log=print) -> dict:
    """``steps`` AdamW steps (``make_optimizer(lr)``) of ``cfg`` from
    random weights drawn from seed 0, step ``i`` on ``make_batch(cfg,
    batch, seq, seed=i)``.  Returns the final parameters and optimizer
    state, each step's loss and its wall seconds (each step ends in a
    device synchronise, as the reference's host read of the loss does).
    Raises ``RuntimeError`` on a non-finite loss."""
    dev = resolve_device(device)
    opt = make_optimizer(lr)
    step = make_train_step(cfg, opt)
    params = R.init_params(SEED, cfg, device=dev)
    opt_state = opt.init(params)
    losses, step_s = [], []
    for i in range(steps):
        b = make_batch(cfg, batch, seq, seed=i, device=dev)
        _sync(dev)
        t0 = time.perf_counter()
        params, opt_state, loss = step(params, opt_state, b)
        loss = float(loss)
        step_s.append(time.perf_counter() - t0)
        losses.append(loss)
        if log is not None:
            log(f"step {i:3d} loss {loss:.4f} ({step_s[-1]:.2f}s)")
        if not np.isfinite(loss):
            raise RuntimeError(f"{cfg.name}: loss diverged at step {i}")
    return dict(params=params, opt_state=opt_state, losses=losses,
                step_s=step_s)


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced().replace(remat=False, dtype="float32")
    n = sum(t.numel() for t in tree_leaves(
        R.init_params(SEED, cfg, device="meta")))
    print(f"{args.arch}: {n:,} params (reduced={args.reduced})")
    out = train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                lr=args.lr, device=dev)
    print("OK")
    out["cfg"] = cfg
    return out


if __name__ == "__main__":
    main()
