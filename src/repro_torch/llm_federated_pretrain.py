"""Federated LM pretraining across the LEO constellation (the port of
``examples/llm_federated_pretrain.py``).

Each satellite holds a shard of a synthetic token stream; AsyncFLEO
orchestrates local AdamW training (``fl.client.LMPool``) and
staleness-discounted aggregation over the real orbital timeline.  Any
assigned architecture works via ``--arch`` (its reduced config in
float32, widened or deepened by ``--layers`` / ``--d-model``; zamba2-2.7b
keeps 4 layers, as in the example).  ``run()`` takes any config, e.g. a
published one cut in depth.

    PYTHONPATH=src python -m repro_torch.llm_federated_pretrain \\
        --arch qwen3-4b --epochs 3 --sats 8 --device cuda

The evaluator is ``R.train_loss`` on 16 held-out sequences, negated
(higher is better for the simulator), on the port's normal route: on the
card its attention runs through the ``flash_attention`` kernel.  Local
training differentiates the plain route.  ``--device`` defaults to
``cuda``; asking for it without a card raises.
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.constellation import WalkerDelta
from repro_torch.core.simulator import FLSimulation, SimConfig
from repro_torch.data.synthetic import token_stream
from repro_torch.fl.client import LMPool
from repro_torch.fl.strategies import get_strategy
from repro_torch.models import registry as R
from repro_torch.tree import tree_leaves

SEED = 0
EVAL_SEQS = 16


def example_config(arch: str, layers: int = 4,
                   d_model: int = 256) -> ModelConfig:
    """The example's model: the arch's reduced config in float32 with
    ``layers`` layers (zamba2-2.7b: 4) and width ``d_model``."""
    return get_config(arch).reduced().replace(
        remat=False, dtype="float32",
        num_layers=layers if arch not in ("zamba2-2.7b",) else 4,
        d_model=d_model)


def make_evaluator(cfg: ModelConfig, seq: int, device):
    """params -> -loss of ``R.train_loss`` on ``EVAL_SEQS`` held-out
    sequences of the token stream (seed 7), on the normal route."""
    dev = resolve_device(device)
    toks = token_stream(7, EVAL_SEQS * seq, cfg.vocab_size)
    eval_toks = torch.tensor(toks.reshape(EVAL_SEQS, seq), dtype=torch.long,
                             device=dev)

    @torch.no_grad()
    def evaluator(p):
        loss, _ = R.train_loss(p, cfg, {"tokens": eval_toks})
        return float(-loss)            # higher is better for the simulator
    return evaluator


def run(cfg: ModelConfig, *, sats: int = 8, seq: int = 128,
        seqs_per_sat: int = 32, local_iters: int = 4, epochs: int = 3,
        size_mode: str = "on_board", device="cuda", params=None,
        batch_indices=None, sim_kw: Optional[dict] = None,
        log=print) -> dict:
    """The example's run: ``sats`` satellites (2 orbits of ``sats // 2``
    at 2000 km), ``seqs_per_sat`` sequences of ``seq`` tokens each, J =
    ``local_iters`` AdamW steps of 4 sequences, asyncfleo-hap for
    ``epochs`` epochs over one day.  ``params`` defaults to
    ``R.init_params(0, cfg)``; ``batch_indices`` is the pool's minibatch
    hook; ``sim_kw`` goes to ``SimConfig`` (e.g. ``use_fused_step=False``).
    Returns the simulation, its history, the initial parameters and the
    wall seconds of ``sim.run``."""
    dev = resolve_device(device)
    const = WalkerDelta(num_orbits=2, sats_per_orbit=sats // 2,
                        altitude_m=2000e3)
    toks = token_stream(0, sats * seqs_per_sat * seq,
                        cfg.vocab_size).reshape(-1, seq)
    shards = np.array_split(np.arange(len(toks)), const.num_sats)
    pool = LMPool(cfg, toks, shards, local_iters=local_iters, batch_size=4,
                  size_mode=size_mode, device=dev,
                  batch_indices=batch_indices)
    if params is None:
        params = R.init_params(SEED, cfg, device=dev)
    n_params = sum(t.numel() for t in tree_leaves(params))
    if log is not None:
        log(f"{cfg.name} reduced: {n_params/1e6:.1f}M params, "
            f"{const.num_sats} satellites, {len(toks)} sequences")
    sim = FLSimulation(get_strategy("asyncfleo-hap"), pool,
                       make_evaluator(cfg, seq, dev),
                       SimConfig(duration_s=86400.0, train_time_s=300.0,
                                 **(sim_kw or {})),
                       constellation=const)
    t0 = time.perf_counter()
    hist = sim.run(params, max_epochs=epochs)
    wall = time.perf_counter() - t0
    if log is not None:
        for r in hist:
            log(f"epoch {r.epoch}  sim {r.time_s/3600:.2f}h  "
                f"eval_loss {-r.accuracy:.4f}  models {r.num_models}")
        total_steps = sum(r.num_models for r in hist) * local_iters
        log(f"aggregate local steps: {total_steps}  wall {wall:.0f}s")
    if not (hist and np.isfinite(hist[-1].accuracy)):
        raise RuntimeError(f"{cfg.name}: no finite evaluation at the end")
    if log is not None:
        log("OK: federated LM pretraining converging "
            f"(loss {-hist[0].accuracy:.3f} -> {-hist[-1].accuracy:.3f})")
    return dict(sim=sim, history=hist, params=params, wall_s=wall,
                n_params=n_params)


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--sats", type=int, default=8,
                    help="satellites (2 orbits x N/2)")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--seqs-per-sat", type=int, default=32)
    ap.add_argument("--local-iters", type=int, default=4)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--size-mode", choices=["on_board", "trained"],
                    default="on_board",
                    help="what D_n the eq. 13/14 weights use: the full "
                         "on-board shard (paper) or the truncated count "
                         "the participants trained on (DESIGN.md §3)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = example_config(args.arch, args.layers, args.d_model)
    return run(cfg, sats=args.sats, seq=args.seq,
               seqs_per_sat=args.seqs_per_sat, local_iters=args.local_iters,
               epochs=args.epochs, size_mode=args.size_mode, device=dev)


if __name__ == "__main__":
    main()
