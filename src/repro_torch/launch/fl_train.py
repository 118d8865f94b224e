"""FL training launcher — the entry point for the paper's system (the port
of the JAX package's ``launch/fl_train.py``).

    PYTHONPATH=src python -m repro_torch.launch.fl_train \\
        --strategy asyncfleo-hap --epochs 8 --target 0.8 \\
        [--iid] [--dataset mnist|cifar] [--model cnn|mlp] \\
        [--checkpoint out/server.npz] [--resume out/server.npz] \\
        [--device cuda]

Runs the constellation simulation with real training on ``--device`` and,
with ``--checkpoint``, saves the PS state (global model + epoch +
grouping) in the JAX package's file format when the run ends.
``--resume`` starts from a saved global model (either package's file) and
prints the epoch it was saved at; the run counts its epochs from 0, as in
the reference.

One deviation from the reference: its launcher saves the *initial*
model (``w_final = w0``), so its checkpoint never holds what the run
trained.  This launcher saves the global model the run ended with.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
from typing import List, Optional

from repro_torch import resolve_device
from repro_torch.checkpoint import load_server_state, save_server_state
from repro_torch.configs import CIFAR_CNN, CIFAR_MLP, MNIST_CNN, MNIST_MLP
from repro_torch.core.constellation import paper_constellation
from repro_torch.core.simulator import (FLSimulation, SimConfig,
                                        convergence_time)
from repro_torch.data.partition import iid_partition, paper_noniid_partition
from repro_torch.data.synthetic import class_conditional_images
from repro_torch.fl.client import Evaluator, ImageClassifierPool
from repro_torch.fl.strategies import STRATEGIES, get_strategy
from repro_torch.models import cnn


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--strategy", default="asyncfleo-hap",
                    choices=sorted(STRATEGIES))
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--target", type=float, default=None)
    ap.add_argument("--iid", action="store_true")
    ap.add_argument("--dataset", default="mnist", choices=["mnist", "cifar"])
    ap.add_argument("--model", default="cnn", choices=["cnn", "mlp"])
    ap.add_argument("--local-iters", type=int, default=30)
    ap.add_argument("--days", type=float, default=3.0)
    ap.add_argument("--separation", type=float, default=0.8)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--resume", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    base = {("mnist", "cnn"): MNIST_CNN, ("mnist", "mlp"): MNIST_MLP,
            ("cifar", "cnn"): CIFAR_CNN, ("cifar", "mlp"): CIFAR_MLP}[
        (args.dataset, args.model)]
    cfg = dataclasses.replace(base, conv_channels=(8, 16)) \
        if args.model == "cnn" else base

    const = paper_constellation()
    imgs, labs = class_conditional_images(args.seed, 4000,
                                          size=cfg.image_size,
                                          channels=cfg.channels,
                                          separation=args.separation)
    ti, tl = class_conditional_images(args.seed + 99, 1000,
                                      size=cfg.image_size,
                                      channels=cfg.channels,
                                      separation=args.separation)
    shards = (iid_partition(labs, const.num_sats, args.seed) if args.iid
              else paper_noniid_partition(labs, const.orbit_ids(),
                                          args.seed))
    pool = ImageClassifierPool(cfg, imgs, labs, shards,
                               local_iters=args.local_iters, device=dev)
    ev = Evaluator(cfg, ti, tl, device=dev)

    if args.resume:
        w0, side = load_server_state(args.resume, device=dev)
        print(f"resumed from {args.resume} at epoch {side['epoch']}")
    else:
        w0 = cnn.init_params(args.seed, cfg, device=dev)

    sim = FLSimulation(get_strategy(args.strategy), pool, ev,
                       SimConfig(duration_s=args.days * 86400.0,
                                 seed=args.seed))
    print(f"strategy={args.strategy} sats={const.num_sats} "
          f"iid={args.iid} dataset={args.dataset}/{args.model}")
    hist = sim.run(w0, max_epochs=args.epochs, target_accuracy=args.target)
    # the global model the run ended with: a copy of the flat model of the
    # fused path, which this launcher runs (w0 when nothing was aggregated)
    w_final = (w0 if sim._w_flat is None
               else sim._spec.unflatten(sim._w_flat.clone()))
    for r in hist:
        print(f"epoch {r.epoch:3d}  sim {r.time_s/3600:6.2f} h  "
              f"acc {r.accuracy:.4f}  models {r.num_models:2d}  "
              f"gamma {r.gamma:.2f}")
    if args.checkpoint and hist:
        os.makedirs(os.path.dirname(os.path.abspath(args.checkpoint)),
                    exist_ok=True)
        save_server_state(args.checkpoint, global_model=w_final,
                          epoch=hist[-1].epoch,
                          grouping=sim.grouping.groups)
        print(f"server state -> {args.checkpoint}")
    if args.target:
        conv = convergence_time(hist, args.target)
        print(f"convergence to {args.target}: "
              f"{conv/3600:.2f} h" if conv else "not reached")
    return dict(sim=sim, history=hist, w0=w0, w_final=w_final)


if __name__ == "__main__":
    main()
