"""Step functions of the serving entry point, as in the JAX package's
``launch/steps.py``:

  prefill_step(params, batch)            -> logits
  decode_step(params, cache, tokens)     -> (logits, cache)   [serve_step]

``make_train_step`` waits for AdamW and the LM training slice.
"""
from __future__ import annotations

from repro_torch.configs.base import (LONG_CONTEXT_WINDOW, ModelConfig,
                                      ShapeConfig)
from repro_torch.models import registry as R


def window_for(cfg: ModelConfig, shape: ShapeConfig) -> int:
    """Sliding-window size: full-attention archs get a window only for
    long_500k (the sub-quadratic carve-out); SSM/hybrid run native — the
    hybrid's shared-attention cache is itself windowed at long context."""
    if shape.name == "long_500k" and (cfg.num_heads > 0 or cfg.use_mla):
        return LONG_CONTEXT_WINDOW
    return 0


def cache_len_for(cfg: ModelConfig, shape: ShapeConfig) -> int:
    w = window_for(cfg, shape)
    return min(shape.seq_len, w) if w else shape.seq_len


def make_prefill_step(cfg: ModelConfig, window: int = 0,
                      impl: str = "kernel", q_chunks: int = 1):
    """``impl``: "kernel" (the JAX package's "pallas"), the family's CUDA
    kernels (flash_attention; chunk_scan for RWKV6; both for the hybrid),
    or "plain" (its "xla"), which only comparisons ask for."""
    def prefill_step(params, batch):
        logits, _aux = R.apply(params, cfg, batch, window=window, impl=impl,
                               q_chunks=q_chunks)
        return logits
    return prefill_step


def check_prefill_len(cfg: ModelConfig, prefill_len: int) -> None:
    """The RWKV6 and Mamba2 prefills run in chunks of
    ``min(cfg.chunk_size, S)`` steps, which must divide S (the JAX package
    asserts): raise ``ValueError`` for a length they do not divide."""
    c = cfg.chunk_size
    if (cfg.family in ("ssm", "hybrid") and prefill_len > c
            and prefill_len % c):
        raise ValueError(f"{cfg.name}: a prefill of {prefill_len} tokens is "
                         f"not a multiple of the chunk length {c}")


def make_decode_step(cfg: ModelConfig, window: int = 0):
    def decode_step(params, cache, batch):
        tokens = batch["tokens"] if isinstance(batch, dict) else batch
        return R.decode_step(params, cfg, cache, tokens, window=window)
    return decode_step
