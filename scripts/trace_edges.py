#!/usr/bin/env python3
"""Does a profiler trace hold every launch when its window closes straight
after the card goes idle?

    python3 scripts/trace_edges.py [--n N] [--reps R] [--traces T]

Takes ``T`` traces of ``R`` calls of ``fed_agg`` over a (4, N) bank and a
(4, N) carry (by default phase 29's shape of ``chip_smoke.py``), each the
recorded step of a warm-up-then-record profiler schedule as
``chip_smoke.time_device`` takes it, once with no idle time at the
window's edges and once with ``chip_smoke.TRACE_EDGE_S`` on each side.
Prints one JSON line a trace (kernels recorded; the first recorded
kernel's start after the recorded step's start and the step's end after
the last recorded kernel's end, in microseconds), then how many traces
at each margin held fewer than ``R`` kernels.  Needs a CUDA card."""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=878845696)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--traces", type=int, default=12)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    import chip_smoke as cs
    from repro_torch.kernels.fed_agg import fed_agg
    if not torch.cuda.is_available():
        sys.exit("trace_edges: needs a CUDA card")
    print(cs.card_line())
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    C, N = 4, args.n
    s, s2 = (torch.randn(C, N, generator=gen, device=dev) for _ in range(2))
    b = torch.randn(N, generator=gen, device=dev)
    g, g2 = (torch.rand(C, generator=gen, device=dev) / C for _ in range(2))

    def call():
        fed_agg(s, g, b, 0.35, out=b, stack2=s2, gamma2=g2)
    call()
    torch.cuda.synchronize()
    short = {}
    for edge in (0.0, cs.TRACE_EDGE_S):
        short[edge] = 0
        for trace in range(args.traces):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA],
                         schedule=schedule(wait=0, warmup=1, active=1,
                                           repeat=1)) as prof:
                for _step in range(2):      # warm-up, then recorded
                    for _ in range(args.reps):
                        call()
                    torch.cuda.synchronize()
                    time.sleep(edge)
                    prof.step()
                    time.sleep(edge)
            events = prof.events()
            step = next(e.time_range for e in events
                        if e.name.startswith("ProfilerStep"))
            kern = sorted((e.time_range for e in events
                           if str(e.device_type).endswith("CUDA")
                           and "fed_agg" in e.name), key=lambda r: r.start)
            short[edge] += len(kern) != args.reps
            print(json.dumps(dict(
                edge_s=edge, trace=trace, kernels=len(kern),
                first_start_after_step_us=(kern[0].start - step.start
                                           if kern else None),
                step_end_after_last_end_us=(step.end - kern[-1].end
                                            if kern else None))),
                flush=True)
    print(json.dumps({"shape": [C, C, N], "reps": args.reps,
                      "traces": args.traces,
                      "short_traces_by_edge_s": short}))


if __name__ == "__main__":
    main()
