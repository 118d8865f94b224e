"""Serving entry point: batched greedy decoding over the ring-buffer KV
cache (transformer families; MLA's latent cache for deepseek-v2), the
O(1) recurrent state (RWKV6) or both (the hybrid zamba2: Mamba2 states
and one KV cache a shared-attention group), after an optional prefill
through the family's kernels — flash_attention, chunk_scan, or both;
deepseek-v2's MLA attends in plain PyTorch, as the JAX package does in
XLA (the port of ``examples/serve_decode.py``).

    PYTHONPATH=src python -m repro_torch.serve_decode --arch qwen3-4b \\
        --tokens 32 --device cuda
    PYTHONPATH=src python -m repro_torch.serve_decode --full-width \\
        --batch 4 --prefill-len 2048 --tokens 32 --cache-len 2048
    PYTHONPATH=src python -m repro_torch.serve_decode --full-width \\
        --arch rwkv6-7b --batch 4 --prefill-len 2048 --tokens 32
    PYTHONPATH=src python -m repro_torch.serve_decode --full-width \\
        --arch zamba2-2.7b --batch 4 --prefill-len 2048 --tokens 32
    PYTHONPATH=src python -m repro_torch.serve_decode \\
        --arch deepseek-v2-236b --device cpu

The model is the example's: the arch's ``reduced()`` config in float32,
with random weights from seed 0; ``--full-width`` takes the published
config as it is (bf16 compute over f32 master weights; at full depth
deepseek-v2-236b and kimi-k2-1t-a32b need more than one card, so
``serve()`` takes a config cut in depth instead).  ``--prefill-len
P`` first runs ``make_prefill_step(impl="kernel")`` on a (batch, P) prompt
of ``data.synthetic.token_stream``; for RWKV6 and zamba2 a P above the
arch's ``chunk_size`` must be a multiple of it (``ValueError`` otherwise,
before any weight is drawn).  Decode then starts from an empty cache, as in the
example: the JAX package has no prefill that fills the cache.
``--cache-len`` does nothing for RWKV6, whose state has no length; for
zamba2 it is the length of each group's KV cache.
``--device`` defaults to ``cuda``; asking for it without a card raises.
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import applicable, get_config, get_shape
from repro_torch.configs.base import ModelConfig
from repro_torch.data.synthetic import token_stream
from repro_torch.launch.steps import (check_prefill_len, make_decode_step,
                                     make_prefill_step)
from repro_torch.models import registry as R

SEED = 0


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(params, cfg: ModelConfig, *, batch: int, tokens: int,
          cache_len: int, window: int = 0, prefill_len: int = 0,
          device="cuda") -> dict:
    """One prefill of ``prefill_len`` prompt tokens (none for 0), then
    ``tokens`` greedy decode steps from an empty cache.  Returns the
    generated tokens (batch, tokens), the last decode logits, the prefill
    wall seconds and each decode step's wall seconds (each step ends in a
    device synchronise, as the example's host read of each token does)."""
    dev = resolve_device(device)
    out = {"prefill_s": None, "prefill_logits_shape": None}
    if prefill_len:
        prompt = token_stream(SEED, batch * prefill_len, cfg.vocab_size)
        prompt = torch.tensor(prompt.reshape(batch, prefill_len),
                              dtype=torch.long, device=dev)
        prefill = make_prefill_step(cfg, window=window, impl="kernel")
        _sync(dev)
        t0 = time.perf_counter()
        logits = prefill(params, {"tokens": prompt})
        _sync(dev)
        out["prefill_s"] = time.perf_counter() - t0
        out["prefill_logits_shape"] = tuple(logits.shape)
        if not bool(torch.isfinite(logits).all()):
            raise RuntimeError(f"{cfg.name}: non-finite prefill logits")
        del logits

    cache = R.init_cache(cfg, batch, cache_len, getattr(torch, cfg.dtype),
                         device=dev)
    step = make_decode_step(cfg, window=window)
    toks = torch.ones((batch, 1), dtype=torch.long, device=dev)
    gen, step_s = [], []
    logits = None
    for _ in range(tokens):
        t0 = time.perf_counter()
        logits, cache = step(params, cache, toks)
        toks = logits[:, -1:].argmax(dim=-1)
        gen.append(toks[:, 0])
        _sync(dev)
        step_s.append(time.perf_counter() - t0)
    if logits is not None and not bool(torch.isfinite(logits).all()):
        raise RuntimeError(f"{cfg.name}: non-finite decode logits")
    out.update(tokens=(torch.stack(gen, 1).cpu().numpy() if gen
                       else np.zeros((batch, 0), np.int64)),
               logits=logits, step_s=step_s)
    return out


def main(argv: Optional[List[str]] = None) -> Optional[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--cache-len", type=int, default=64)
    ap.add_argument("--window", type=int, default=0)
    ap.add_argument("--prefill-len", type=int, default=0,
                    help="prompt length of the prefill through the "
                    "family's kernel before decoding (0: none)")
    ap.add_argument("--full-width", action="store_true",
                    help="the published config (bf16 compute, f32 "
                    "weights) instead of the reduced float32 one")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    full_cfg = get_config(args.arch)
    if not applicable(full_cfg, get_shape("decode_32k")):
        print(f"{args.arch} is encoder-only: no decode step (DESIGN.md)")
        return None
    cfg = full_cfg if args.full_width else full_cfg.reduced().replace(
        remat=False, dtype="float32")
    check_prefill_len(cfg, args.prefill_len)
    params = R.init_params(SEED, cfg, device=dev)
    res = serve(params, cfg, batch=args.batch, tokens=args.tokens,
                cache_len=args.cache_len, window=args.window,
                prefill_len=args.prefill_len, device=dev)
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "CPU")
    what = "full width" if args.full_width else "reduced config"
    if res["prefill_s"] is not None:
        print(f"{args.arch}: prefill {args.batch}x{args.prefill_len} tokens "
              f"in {res['prefill_s']:.3f}s on {where} ({what})")
    dt = sum(res["step_s"])
    gen = res["tokens"]
    rate = args.batch * args.tokens / dt if dt else float("nan")
    print(f"{args.arch}: generated {gen.shape} tokens in {dt:.2f}s "
          f"({rate:.1f} tok/s on {where}, {what})")
    print("sample:", gen[0][:16].tolist())
    res.update(cfg=cfg, params=params)
    return res


if __name__ == "__main__":
    main()
