"""Strategy comparison on the PyTorch port (paper Table II / Fig. 6).

    PYTHONPATH=src python -m repro_torch.fl_constellation_sim \\
        --schemes asyncfleo-hap fedhap --epochs 8 --iid --device cuda

Runs the simulation for each scheme on the same synthetic data and prints
accuracy-vs-simulated-time CSV curves, as ``examples/fl_constellation_sim.py``
does for the JAX package.  The model is ``MNIST_CNN`` at its full width
(16/32 conv channels, hidden 128: 206,922 parameters).

``--event-driven`` swaps the epoch loop for the event-driven async
scheduler (`repro_torch.sched`): each scheme runs under its trigger policy
(AsyncFLEO idle window / sync barrier / FedAsync per-arrival, DESIGN.md
§7), and the compiled contact plan's window statistics are printed with
the curves.  ``--max-in-flight N`` (N > 1, implies ``--event-driven``)
pipelines every scheme's rounds; ``asyncfleo-pipelined`` ships with depth
3 and the contact-plan handoff:

    PYTHONPATH=src python -m repro_torch.fl_constellation_sim \\
        --schemes asyncfleo-pipelined --epochs 2 --iid --event-driven

``--staleness-fn`` swaps eq. 13's staleness discount for a FedAsync-family
alternative.  The fault flags build one ``FaultModel`` (DESIGN.md §10)
that every scheme runs under: ``--dropout`` (per-transfer loss, retried
with exponential backoff; implies ``--event-driven``),
``--compute-spread`` (seeded per-satellite training-time multipliers)
and ``--eclipse-fraction`` (seeded per-satellite dark windows).  The
README's robustness smoke:

    PYTHONPATH=src python -m repro_torch.fl_constellation_sim \
        --schemes asyncfleo-gs --epochs 2 --iid --event-driven \
        --dropout 0.2 --compute-spread 1.0 --staleness-fn poly
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Dict, List, Optional, Sequence

from repro_torch import resolve_device
from repro_torch.configs.paper_models import MNIST_CNN, SmallNetConfig
from repro_torch.core.constellation import paper_constellation
from repro_torch.core.simulator import (FLSimulation, SimConfig,
                                        convergence_time)
from repro_torch.data.partition import iid_partition, paper_noniid_partition
from repro_torch.data.synthetic import class_conditional_images
from repro_torch.fl.client import Evaluator, ImageClassifierPool
from repro_torch.fl.strategies import STRATEGIES, get_strategy
from repro_torch.models import cnn
from repro_torch.sched.faults import FaultModel


@dataclasses.dataclass
class Workload:
    """The example's data, pool and evaluator, and the initial model."""
    pool: ImageClassifierPool
    evaluator: Evaluator
    w0: Dict


def build_workload(*, iid: bool, device="cuda",
                   cfg: SmallNetConfig = MNIST_CNN, num_train: int = 4000,
                   num_test: int = 1000, local_iters: int = 30,
                   batch_size: int = 32, w0: Optional[Dict] = None,
                   batch_indices=None) -> Workload:
    """The example's synthetic task (``separation=0.8``), sharded over the
    paper constellation (IID or the paper's 4/6-class non-IID split).
    ``w0`` defaults to ``cnn.init_params(0, cfg)``."""
    dev = resolve_device(device)
    const = paper_constellation()
    imgs, labs = class_conditional_images(0, num_train, separation=0.8)
    ti, tl = class_conditional_images(99, num_test, separation=0.8)
    shards = (iid_partition(labs, const.num_sats, 0) if iid
              else paper_noniid_partition(labs, const.orbit_ids(), 0))
    pool = ImageClassifierPool(cfg, imgs, labs, shards,
                               local_iters=local_iters,
                               batch_size=batch_size, device=dev,
                               batch_indices=batch_indices)
    ev = Evaluator(cfg, ti, tl, device=dev)
    if w0 is None:
        w0 = cnn.init_params(0, cfg, device=dev)
    return Workload(pool, ev, w0)


def run_schemes(schemes: Sequence[str], work: Workload, *, epochs: int,
                days: float = 3.0, event_driven: bool = False,
                max_in_flight: int = 0, staleness_fn: str = "eq13",
                fault_model: Optional[FaultModel] = None
                ) -> Dict[str, tuple]:
    """Run each scheme from ``work.w0``: the epoch loop, or the
    event-driven runtime.  ``max_in_flight`` > 0 overrides every scheme's
    pipeline depth; ``staleness_fn`` every scheme's eq. 13 discount;
    ``fault_model`` is every scheme's ``SimConfig.fault_model``.
    Returns {scheme: (FLSimulation, history)}."""
    out = {}
    for name in schemes:
        spec = get_strategy(name)
        if max_in_flight:
            spec = dataclasses.replace(spec, max_in_flight=max_in_flight)
        if staleness_fn != "eq13":
            spec = dataclasses.replace(spec, staleness_fn=staleness_fn)
        sim = FLSimulation(spec, work.pool, work.evaluator,
                           SimConfig(duration_s=days * 86400.0,
                                     event_driven=event_driven,
                                     fault_model=fault_model))
        out[name] = (sim, sim.run(work.w0, max_epochs=epochs))
    return out


def _print_curves(results: Dict[str, tuple], target: float) -> None:
    print("scheme,epoch,sim_time_h,accuracy,num_models,gamma")
    summary = []
    for name, (sim, hist) in results.items():
        if sim.sim.event_driven:
            s = sim.plan.summary()
            print(f"# {name}: contact plan — {s['num_windows']} windows, "
                  f"coverage {s['coverage_fraction']:.3f}, "
                  f"mean window {s['mean_window_s']:.0f}s")
            if sim.fault is not None:
                st = sim.runtime.stats
                dropped = (st["dropped_after_max_retries"]
                           + st["dropped_unreachable"])
                print(f"# {name}: faults — transfers failed "
                      f"{st['transfers_failed']}, retried "
                      f"{st['transfer_retries']}, dropped {dropped}")
        for r in hist:
            print(f"{name},{r.epoch},{r.time_s/3600:.3f},{r.accuracy:.4f},"
                  f"{r.num_models},{r.gamma:.3f}")
        conv = convergence_time(hist, target)
        summary.append((name, max(r.accuracy for r in hist),
                        conv / 3600 if conv else None))
    print("\n# scheme,best_acc,conv_time_h(target=%.2f)" % target)
    for name, acc, conv in summary:
        print(f"# {name},{acc:.4f},{conv if conv else 'n/a'}")


def main(argv: Optional[List[str]] = None) -> Dict[str, tuple]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--schemes", nargs="+",
                    default=["asyncfleo-hap", "fedhap"],
                    choices=sorted(STRATEGIES))
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--iid", action="store_true")
    ap.add_argument("--target", type=float, default=0.75)
    ap.add_argument("--days", type=float, default=3.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--event-driven", action="store_true",
                    help="drive each scheme with the async event scheduler "
                         "(contact plan + trigger policies) instead of the "
                         "epoch loop")
    ap.add_argument("--max-in-flight", type=int, default=0,
                    help="override every scheme's pipeline depth (rounds "
                         "in flight, DESIGN.md §8); 0 keeps each "
                         "strategy's own setting, >1 implies "
                         "--event-driven")
    ap.add_argument("--staleness-fn", default="eq13",
                    choices=["eq13", "constant", "hinge", "poly"],
                    help="staleness discount: the paper's eq. 13 or a "
                         "FedAsync-family alternative")
    ap.add_argument("--dropout", type=float, default=0.0,
                    help="per-transfer loss probability (retried with "
                         "exponential backoff, DESIGN.md §10); >0 implies "
                         "--event-driven")
    ap.add_argument("--compute-spread", type=float, default=0.0,
                    help="per-sat compute heterogeneity: training time "
                         "stretched by a seeded multiplier in "
                         "[1, 1+spread]")
    ap.add_argument("--eclipse-fraction", type=float, default=0.0,
                    help="fraction of each (phase-shifted) orbital period "
                         "a satellite is unavailable")
    args = ap.parse_args(argv)
    if args.max_in_flight > 1 or args.dropout > 0.0:
        args.event_driven = True
    fault = None
    if args.dropout or args.compute_spread or args.eclipse_fraction:
        fault = FaultModel(loss_prob=args.dropout,
                           compute_rate_spread=args.compute_spread,
                           eclipse_fraction=args.eclipse_fraction)
    work = build_workload(iid=args.iid, device=args.device)
    results = run_schemes(args.schemes, work, epochs=args.epochs,
                          days=args.days, event_driven=args.event_driven,
                          max_in_flight=args.max_in_flight,
                          staleness_fn=args.staleness_fn,
                          fault_model=fault)
    _print_curves(results, args.target)
    return results


if __name__ == "__main__":
    main()
