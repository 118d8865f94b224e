#!/usr/bin/env python3
"""How far the legacy simulator path drifts from the fused one, and how far
a faulty run drifts, on the port at full width.

    python3 scripts/path_divergence.py [--epochs 6] [--cpu-epochs 3]
                                       [--out PATH]

Runs ``chip_smoke.py`` phase 20's configurations (``MNIST_CNN`` at full
width, N = 206,922, S = 40, J = 30, b = 32, IID) on the fused and the
legacy path of ``FLSimulation``, and prints, record by record, the max
|w_legacy - w_fused| of the global models, the accuracy difference and the
number of test predictions that differ.  Sound readings: legacy against
fused on the card (``--epochs`` records) and on the CPU (``--cpu-epochs``
records, the plain ``fed_agg``, another summation order), and the card's
fused run against the CPU's.  Known-bad controls, on the card's legacy
path, with one fault in the aggregation of the last record that
``chip_smoke.py`` holds (record 3): one selected model replaced by the
global it was trained from (a lost update), or scaled by 1.001.  Phase
20's limits are set from these readings.  Needs a CUDA card; the CPU runs
take a few minutes."""
from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.core import aggregation as agg  # noqa: E402
from repro_torch.core.modelbank import flatten_tree  # noqa: E402
from repro_torch.core.simulator import FLSimulation, SimConfig  # noqa: E402
from repro_torch.fl.strategies import get_strategy  # noqa: E402
from repro_torch.fl_constellation_sim import build_workload  # noqa: E402
from repro_torch.models import cnn  # noqa: E402

CONFIGS = (("asyncfleo-hap", {}),
           ("asyncfleo-twohap", dict(agg_timeout_s=120.0)),
           ("fedsat", {}))
FAULT_RECORD = 2          # the third record, the last one phase 20 holds


class Seen:
    """An evaluator that keeps a flat copy of every model it evaluates."""

    def __init__(self, evaluator):
        self.evaluator, self.seen = evaluator, []

    def eval_async(self, params):
        self.seen.append(flatten_tree(params))
        return self.evaluator.eval_async(params)


def run(work, scheme, mode, epochs, sim_kw):
    ev = Seen(work.evaluator)
    sim = FLSimulation(get_strategy(scheme), work.pool, ev,
                       SimConfig(duration_s=3 * 86400.0,
                                 use_model_bank=mode != "legacy",
                                 use_fused_step=mode == "fused", **sim_kw))
    hist = sim.run(work.w0, max_epochs=epochs)
    return dict(hist=hist, seen=ev.seen, spec=sim._spec)


def faulty_aggregate(kind):
    """``asyncfleo_aggregate`` with one fault at ``FAULT_RECORD``: the first
    model of the first group replaced by the global it was trained from
    (``lost``) or scaled by 1.001 (``scaled``)."""
    clean = agg.asyncfleo_aggregate

    def aggregate(w_prev, groups, models, metas, beta, **kw):
        if beta == FAULT_RECORD:
            models = list(models)
            i = next(iter(groups.values()))[0]
            models[i] = (dict(w_prev) if kind == "lost" else
                         {k: v * 1.001 for k, v in models[i].items()})
        return clean(w_prev, groups, models, metas, beta, **kw)
    return clean, aggregate


def logits(work, spec, w_flat):
    ev = work.evaluator
    imgs = torch.from_numpy(ev.images).to(w_flat.device)[None]
    params = {k: v[None] for k, v in spec.unflatten(w_flat).items()}
    return cnn.apply(params, work.pool.cfg, imgs)[0]


def compare(work, a, b):
    """Record by record: max |w_a - w_b| (on the CPU, in float64), the
    accuracy difference and the number of differing test predictions."""
    out = []
    for k, (wa, wb) in enumerate(zip(a["seen"], b["seen"])):
        wa, wb = wa.double().cpu(), wb.double().cpu()
        pa = logits(work, b["spec"], a["seen"][k]).argmax(-1).cpu()
        pb = logits(work, b["spec"], b["seen"][k].to(
            a["seen"][k].device)).argmax(-1).cpu()
        out.append(dict(
            w_max_abs_diff=float((wa - wb).abs().max()),
            acc_diff=a["hist"][k].accuracy - b["hist"][k].accuracy,
            flips=int((pa != pb).sum()),
            rows_equal=_row(a["hist"][k]) == _row(b["hist"][k])))
    return out


def _row(r):
    return (r.epoch, r.time_s, r.num_models, r.gamma, r.stale_groups)


def show(label, recs):
    print(f"{label}:")
    for k, r in enumerate(recs):
        print(f"  record {k + 1}: max |dw| {r['w_max_abs_diff']:.3e}, "
              f"accuracy {r['acc_diff']:+.4f}, {r['flips']} predictions "
              f"differ, host rows {'equal' if r['rows_equal'] else 'DIFFER'}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--cpu-epochs", type=int, default=3)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    report = {"card": torch.cuda.get_device_name(0), "epochs": args.epochs,
              "cpu_epochs": args.cpu_epochs, "configs": {}}
    gpu = build_workload(iid=True, device="cuda")
    cpu = build_workload(iid=True, device="cpu")
    for scheme, sim_kw in CONFIGS:
        label = scheme + "".join(f" {k}={v:g}" for k, v in sim_kw.items())
        res = {}
        card = {m: run(gpu, scheme, m, args.epochs, sim_kw)
                for m in ("fused", "legacy")}
        res["card legacy - card fused"] = compare(gpu, card["legacy"],
                                                  card["fused"])
        if scheme.startswith("asyncfleo"):
            for kind in ("lost", "scaled"):
                clean, faulty = faulty_aggregate(kind)
                agg.asyncfleo_aggregate = faulty
                try:
                    bad = run(gpu, scheme, "legacy", FAULT_RECORD + 1, sim_kw)
                finally:
                    agg.asyncfleo_aggregate = clean
                res[f"control {kind}: card legacy - card fused"] = compare(
                    gpu, bad, card["fused"])
        if args.cpu_epochs:
            host = {m: run(cpu, scheme, m, args.cpu_epochs, sim_kw)
                    for m in ("fused", "legacy")}
            res["cpu legacy - cpu fused"] = compare(cpu, host["legacy"],
                                                    host["fused"])
            res["card fused - cpu fused"] = compare(cpu, dict(
                card["fused"], seen=[w.cpu() for w in card["fused"]["seen"]]),
                host["fused"])
        for name, recs in res.items():
            show(f"{label}, {name}", recs)
            if not all(math.isfinite(r["w_max_abs_diff"]) for r in recs):
                print(f"{label}, {name}: a model is not finite",
                      file=sys.stderr)
                return 1
        report["configs"][label] = res
    report["wall_s"] = time.perf_counter() - t0
    print(f"wall {report['wall_s']:.1f} s")
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
