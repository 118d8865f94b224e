#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py [--report PATH]

Phases, each of which fails the run (non-zero exit) when it fails:

  0. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
  1. the CUDA kernels built from ``src/repro_torch/csrc`` (one nvcc per
     source, all at once), timed;
  2. ``fed_agg`` against its plain version on the card, max abs error;
  3. ``pairwise_dist_sq`` against its plain version, error over max(D, 1);
  4. the main path: ``repro_torch.fl_constellation_sim.main`` runs
     asyncfleo-hap with MNIST_CNN at full width (N = 206,922), S = 40,
     J = 30, b = 32, 3 epochs, IID shards of the example's synthetic data.
     ``fed_agg`` must launch twice per epoch step; the host-side history
     must equal a CPU run of the port on the same inputs; the last accuracy
     must be above 0.10;
  5. the grouping path: ``GroupingState.observe_orbit`` through
     ``pairwise_dist_sq`` on each orbit's rows of a bank trained from the
     main path's final model, against the plain route: the same groups;
  6. timings at the main path's shapes (kernel time from the profiler's
     device trace over 200 calls, inputs cycled through more than the
     50 MB L2; CUDA events and the host clock beside it), the warm 3-epoch
     wall time and a ``torch.profiler`` table of the top device ops;
  7. one JSON line of per-kernel numbers.

The last three lines are that JSON line, the card's name and power limit,
and ``{"ok": true, "device": {...}}``.  Without a card, or without the
repository beside it, it exits non-zero and prints no result.
``--report PATH`` also writes every number of the run there as JSON.
"""
import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

H100_BYTES_PER_S = 3.35e12          # HBM3, H100 SXM data sheet
H100_F32_FLOP_PER_S = 67e12         # f32 outside the tensor cores
F32_EPS = 2.0 ** -24
L2_BYTES = 50 * 2 ** 20
FED_AGG_TOL = 1e-5                  # max abs error, outputs of order 1
PDIST_TOL = 1e-5                    # error / max(D, 1)


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def phase(msg: str) -> None:
    print(f"# {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cycled_inputs(make, nbytes: int):
    """Enough copies of one input set (from ``make()``) that cycling
    through them streams more than twice the L2 cache: each launch finds
    its inputs cold, as the main path does."""
    return [make() for _ in range(max(2, math.ceil(2 * L2_BYTES / nbytes)))]


def time_device(torch, fn, sets, reps: int = 200):
    """Per call of ``fn`` over ``reps`` calls cycling through ``sets``:
    (device ms: the summed durations of the kernels it launched, from the
    profiler's CUPTI trace; queue ms: CUDA events around the queued calls,
    which include the gaps when the host enqueues slower than the card
    runs; host ms: the wall time of one enqueue)."""
    from torch.profiler import ProfilerActivity, profile
    for s in sets[:2]:
        fn(*s)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for i in range(reps):
        fn(*sets[i % len(sets)])
    end.record()
    host = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    queue = start.elapsed_time(end) / reps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(reps):
            fn(*sets[i % len(sets)])
        torch.cuda.synchronize()
    dev_us = sum(e.self_device_time_total for e in prof.key_averages()
                 if str(e.device_type).endswith("CUDA"))
    if dev_us <= 0:
        fail("the profiler recorded no device time for a timed kernel")
    return dev_us / reps / 1e3, queue, host


def bound_ms(nbytes: float, flops: float):
    t_b = nbytes / H100_BYTES_PER_S * 1e3
    t_f = flops / H100_F32_FLOP_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--report", type=Path, default=None,
                    help="write every number of the run to this JSON file")
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this needs a CUDA card")
    if not (SRC / "repro_torch" / "csrc").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout of the "
             "repository")
    sys.path.insert(0, str(SRC))

    from repro_torch import kernels
    from repro_torch.core.grouping import GroupingState
    from repro_torch.core.links import model_bits
    from repro_torch.core.modelbank import FlatSpec, ModelBank, pad_bucket_ids
    from repro_torch.fl_constellation_sim import (build_workload, main as
                                                  sim_main, run_schemes)
    from repro_torch.kernels.fed_agg import fed_agg
    from repro_torch.kernels.fed_agg.ref import fed_agg_ref
    from repro_torch.kernels.pairwise_dist import pairwise_dist_sq
    from repro_torch.kernels.pairwise_dist.ref import pairwise_dist_sq_ref

    dev = torch.device("cuda")
    report = {}
    # ---- 0. the card ------------------------------------------------------
    card = card_line()
    phase(f"phase 0: {torch.cuda.get_device_name(0)} ({card}), torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)")
    report["card"] = card

    # ---- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    logs = kernels.build_all(verbose=True)
    build_s = time.perf_counter() - t0
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"  {name}: {line.strip()}")
    phase(f"phase 1: kernels {list(kernels.SOURCES)} built in "
          f"{build_s:.1f} s into {kernels.BUILD_DIR}")
    report["build_s"] = build_s

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    # ---- 2. fed_agg vs plain ----------------------------------------------
    phase("phase 2: fed_agg kernel vs plain (max abs error)")
    fed_err = 0.0
    for C in (64, 4, 1, 3):
        for N in (206922, 10003, 1001):
            stack = randn(C, N)
            gamma = torch.rand(C, generator=gen, device=dev) / C
            buf = randn(N + 1)
            for bw in (0.0, 0.35):
                for base in (buf[:N], buf[1:]):   # 16-byte aligned or not
                    got = fed_agg(stack, gamma, base, bw)
                    want = fed_agg_ref(stack, gamma, base, bw)
                    err = float((got - want).abs().max())
                    fed_err = max(fed_err, err)
                    if not err <= FED_AGG_TOL:
                        fail(f"fed_agg C={C} N={N} bw={bw}: error {err}")
                # out is base: the carry pass's in-place contract
                out = buf[:N].clone()
                want = fed_agg_ref(stack, gamma, out, bw)
                fed_agg(stack, gamma, out, bw, out=out)
                err = float((out - want).abs().max())
                fed_err = max(fed_err, err)
                if not err <= FED_AGG_TOL:
                    fail(f"fed_agg aliased C={C} N={N} bw={bw}: error {err}")
            print(f"  C={C:2d} N={N:6d}: ok")
    empty = fed_agg(torch.zeros((0, 1001), device=dev),
                    torch.zeros(0, device=dev), buf[:1001], 0.35)
    if not torch.allclose(empty, 0.35 * buf[:1001], atol=0, rtol=1e-6):
        fail("fed_agg C=0 is not bw * base")
    torch.cuda.synchronize()
    print(f"fed_agg: max abs error {fed_err:.3e} over 24 shapes, both base "
          f"alignments, aliased out, C=0 (tolerance {FED_AGG_TOL})")

    # ---- 3. pairwise_dist_sq vs plain -------------------------------------
    phase("phase 3: pairwise_dist_sq kernel vs plain (error / max(D, 1))")
    pd_err = pd_abs = 0.0
    for M in (2, 9, 65):
        for N in (206922, 4097):
            x = randn(M, N)
            got, want = pairwise_dist_sq(x), pairwise_dist_sq_ref(x)
            scale = max(float(want.max()), 1.0)
            abs_err = float((got - want).abs().max())
            err = abs_err / scale
            pd_err, pd_abs = max(pd_err, err), max(pd_abs, abs_err)
            if not err <= PDIST_TOL or not torch.equal(got, got.T):
                fail(f"pairwise_dist_sq M={M} N={N}: scaled error {err}")
            print(f"  M={M:2d} N={N:6d}: abs {abs_err:.3e}, scaled "
                  f"{err:.3e} (max D {scale:.3e})")
    torch.cuda.synchronize()
    print(f"pairwise_dist_sq: max scaled error {pd_err:.3e} (tolerance "
          f"{PDIST_TOL}), max abs {pd_abs:.3e}")

    # ---- 4. the main path -------------------------------------------------
    phase("phase 4: main path — repro_torch.fl_constellation_sim.main, "
          "asyncfleo-hap, MNIST_CNN, S=40, J=30, b=32, 3 epochs, IID")
    argv = ["--schemes", "asyncfleo-hap", "--epochs", "3", "--iid",
            "--device", "cuda"]
    fed_agg.launches = 0
    pairwise_dist_sq.launches = 0
    t0 = time.perf_counter()
    results = sim_main(argv)
    torch.cuda.synchronize()
    wall_first = time.perf_counter() - t0
    main_launches = fed_agg.launches
    sim, hist = results["asyncfleo-hap"]
    prog = sim.trainer._epoch_programs[sim._spec]
    steps = prog.dispatches + prog.fallback_dispatches
    print(f"main path: {len(hist)} epochs in {wall_first:.2f} s (first run), "
          f"{steps} epoch steps ({prog.fallback_dispatches} fallback), "
          f"fed_agg launches {main_launches}, segments "
          f"{ {k: round(v, 3) for k, v in sim.segment_seconds.items()} }")
    if len(hist) != 3:
        fail(f"main path ran {len(hist)} epochs, not 3")
    if main_launches < 2 * steps or (prog.fallback_dispatches == 0
                                     and main_launches != 2 * steps):
        fail(f"fed_agg launched {main_launches} times for {steps} steps")
    if not all(math.isfinite(r.accuracy) for r in hist):
        fail("non-finite accuracy")
    if not hist[-1].accuracy > 0.10:
        fail(f"last accuracy {hist[-1].accuracy} is not above 0.10")
    w_flat = sim._w_flat
    if w_flat.shape != (206922,) or not bool(torch.isfinite(w_flat).all()):
        fail("the global model is not a finite (206922,) vector")
    # the shapes the main path gave the kernels
    bits = model_bits(sim._spec.unflatten(w_flat))
    recv = sim.plan.downlink_times(0.0, bits, 0)
    n_part = int(sum(1 for r in recv if math.isfinite(r)))
    C_bank = len(pad_bucket_ids(range(n_part))[0])
    print(f"  epoch 0: {n_part} participants, bank ({C_bank}, 206922), "
          f"carry (4, 206922)")

    t0 = time.perf_counter()
    cpu = build_workload(iid=True, device="cpu")
    cpu_hist = run_schemes(["asyncfleo-hap"], cpu, epochs=3)[
        "asyncfleo-hap"][1]
    cpu_s = time.perf_counter() - t0
    for a, b in zip(hist, cpu_hist):
        ka = (a.epoch, a.time_s, a.num_models, a.gamma, a.stale_groups)
        kb = (b.epoch, b.time_s, b.num_models, b.gamma, b.stale_groups)
        if ka != kb:
            fail(f"card and CPU histories differ: {ka} vs {kb}")
    for a, b in zip(hist, cpu_hist):
        print(f"  epoch {a.epoch}: t={a.time_s / 3600:.3f} h "
              f"acc={a.accuracy:.4f} (CPU {b.accuracy:.4f}) "
              f"models={a.num_models} gamma={a.gamma:.3f} "
              f"stale_groups={a.stale_groups}")
    print(f"host history equals the CPU run of the port (3 epochs, "
          f"{cpu_s:.1f} s on the CPU)")
    report["main_path"] = {
        "wall_s_first": wall_first, "fed_agg_launches": main_launches,
        "epoch_steps": steps, "participants_epoch0": n_part,
        "segments_s": sim.segment_seconds,
        "history": [vars(r) for r in hist],
        "history_cpu": [vars(r) for r in cpu_hist], "cpu_s": cpu_s}

    # ---- 5. grouping through pairwise_dist --------------------------------
    phase("phase 5: grouping path — GroupingState.observe_orbit through "
          "pairwise_dist_sq vs the plain route")
    pool, w0 = sim.trainer, results_w0(sim)
    ids, _n = pad_bucket_ids(range(pool.num_clients))
    params = sim._spec.unflatten(w_flat)
    trained, _ = pool.train_stacked(params, pool.epoch_inputs(ids), ids,
                                    seed=12345)
    stack = FlatSpec.of(params).flatten_stacked(trained)
    states = {True: GroupingState(use_dist_kernel=True),
              False: GroupingState(use_dist_kernel=False)}
    for st in states.values():
        st.set_reference(w0)
    const = sim.constellation
    orbit_ids = const.orbit_ids()
    pairwise_dist_sq.launches = 0
    for o in range(const.num_orbits):
        rows = [s for s in range(const.num_sats) if orbit_ids[s] == o]
        bank = ModelBank(sim._spec, stack[rows].contiguous())
        sizes = [pool.data_size(s) for s in rows]
        for st in states.values():
            st.observe_orbit(o, bank, sizes)
    torch.cuda.synchronize()
    group_launches = pairwise_dist_sq.launches
    ref = states[True].ref_device()
    n_max = max(float(ref @ ref), float((stack[:const.num_sats] ** 2)
                                        .sum(1).max()))
    tol_d2 = F32_EPS * n_max * math.sqrt(ref.numel())
    worst = 0.0
    for o in range(const.num_orbits):
        dk, dp = states[True].distances[o], states[False].distances[o]
        worst = max(worst, abs(dk * dk - dp * dp))
        print(f"  orbit {o}: d kernel {dk:.7f} plain {dp:.7f}, "
              f"|d_k^2 - d_p^2| = {abs(dk * dk - dp * dp):.3e}")
    print(f"groups: kernel {states[True].groups}, plain "
          f"{states[False].groups}; pairwise_dist_sq launches "
          f"{group_launches}; worst |d^2 error| {worst:.3e} (tolerance "
          f"eps*max(n)*sqrt(N) = {tol_d2:.3e})")
    if group_launches < const.num_orbits:
        fail(f"pairwise_dist_sq launched {group_launches} times for "
             f"{const.num_orbits} orbits")
    if states[True].groups != states[False].groups:
        fail("kernel and plain routes grouped the orbits differently")
    if not worst <= tol_d2:
        fail(f"grouping distances differ by {worst} > {tol_d2}")
    report["grouping"] = {"launches": group_launches, "worst_d2_err": worst,
                          "tol_d2": tol_d2,
                          "groups": states[True].groups}

    # ---- 6. timings -------------------------------------------------------
    phase("phase 6: timings (kernel time from the profiler's device trace "
          "over 200 calls; inputs cycled through > 2x L2)")
    N = 206922
    timings = {}

    def fed_case(C):
        nbytes = (C * N + 2 * N + C) * 4
        sets = cycled_inputs(lambda: (randn(C, N), torch.rand(
            C, generator=gen, device=dev) / C, randn(N)), nbytes)
        k_ms, q_ms, host_ms = time_device(
            torch, lambda s, g, b: fed_agg(s, g, b, 0.35, out=b), sets)
        p_ms, _, _ = time_device(
            torch, lambda s, g, b: fed_agg_ref(s, g, b, 0.35), sets)
        l_ms, _, _ = time_device(
            torch, lambda s, g, b: torch.addmv(b, s.t(), g, beta=0.35), sets)
        b_ms, by = bound_ms(nbytes, 2.0 * C * N)
        return dict(shape=[C, N], ms=k_ms, queue_ms=q_ms, host_ms=host_ms,
                    plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms,
                    bound_by=by)

    def pd_case(M):
        nbytes = (M * N + M * M) * 4
        sets = cycled_inputs(lambda: (randn(M, N),), nbytes)
        k_ms, q_ms, host_ms = time_device(torch, pairwise_dist_sq, sets)
        p_ms, _, _ = time_device(torch, pairwise_dist_sq_ref, sets)
        l_ms, _, _ = time_device(torch, lambda x: torch.cdist(
            x, x, compute_mode="use_mm_for_euclid_dist"), sets)
        b_ms, by = bound_ms(nbytes, float(M * (M + 1)) * N)
        return dict(shape=[M, N], ms=k_ms, queue_ms=q_ms, host_ms=host_ms,
                    plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms,
                    bound_by=by)

    timings["fed_agg_bank"] = fed_case(C_bank)
    timings["fed_agg_carry"] = fed_case(4)
    timings["pairwise_dist_grouping"] = pd_case(2)
    timings["pairwise_dist_m65"] = pd_case(65)
    for name, t in timings.items():
        print(f"{name} {t['shape']}: kernel {t['ms'] * 1e3:.1f} us (queued "
              f"{t['queue_ms'] * 1e3:.1f} us/call, host enqueue "
              f"{t['host_ms'] * 1e3:.1f} us/call), bound "
              f"{t['bound_ms'] * 1e3:.1f} us ({t['bound_by']}), plain "
              f"{t['plain_ms'] * 1e3:.1f} us, library "
              f"{t['library_ms'] * 1e3:.1f} us")
    report["timings"] = timings

    warm = []
    for _ in range(2):
        t0 = time.perf_counter()
        run_schemes(["asyncfleo-hap"], sim_workload(sim), epochs=3)
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
    print(f"warm 3-epoch wall (s): {warm}")
    report["warm_wall_s"] = warm

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_schemes(["asyncfleo-hap"], sim_workload(sim), epochs=3)
        torch.cuda.synchronize()
        wall_prof = time.perf_counter() - t0
    dev_ops = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")
               and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in dev_ops) / 1e3
    dev_ops.sort(key=lambda e: -e.self_device_time_total)
    wall_ms = min(warm) * 1e3
    share = busy_ms / wall_ms if busy_ms else float("nan")
    print(f"profile: device busy {busy_ms:.1f} ms over {len(dev_ops)} kernel "
          f"names; warm wall {wall_ms:.1f} ms unprofiled ({wall_prof * 1e3:.1f}"
          f" ms profiled); busy share of the unprofiled wall {share:.3f}"
          + ("" if busy_ms else " — the profiler showed no device time: "
             "not measured"))
    top = [dict(name=e.key[:90], ms=e.self_device_time_total / 1e3,
                count=e.count) for e in dev_ops[:12]]
    for t in top:
        print(f"  {t['ms']:9.3f} ms x{t['count']:<6d} {t['name']}")
    report["profile"] = dict(busy_ms=busy_ms, wall_ms=wall_ms,
                             wall_ms_profiled=wall_prof * 1e3,
                             busy_share=share, top=top)

    # ---- 7. the kernel line -----------------------------------------------
    fb, pg = timings["fed_agg_bank"], timings["pairwise_dist_grouping"]
    kernel_line = {"kernels": [
        dict(name="fed_agg", route="cuda",
             source="src/repro_torch/csrc/fed_agg.cu",
             replaces="src/repro/kernels/fed_agg/kernel.py:22",
             launches=main_launches, max_abs_err=fed_err, ms=fb["ms"],
             plain_ms=fb["plain_ms"], bound_ms=fb["bound_ms"],
             bound_by=fb["bound_by"], library_ms=fb["library_ms"]),
        dict(name="pairwise_dist_sq", route="cuda",
             source="src/repro_torch/csrc/pairwise_dist.cu",
             replaces="src/repro/kernels/pairwise_dist/kernel.py:23",
             launches=group_launches, max_abs_err=pd_abs, ms=pg["ms"],
             plain_ms=pg["plain_ms"], bound_ms=pg["bound_ms"],
             bound_by=pg["bound_by"], library_ms=pg["library_ms"]),
    ]}
    report["kernels"] = kernel_line["kernels"]
    if args.report is not None:
        args.report.parent.mkdir(parents=True, exist_ok=True)
        args.report.write_text(json.dumps(report, indent=1, default=str))
    print(json.dumps(kernel_line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def results_w0(sim):
    """The main path's initial model (kept by the grouping state as w0)."""
    return sim._spec.unflatten(sim.grouping.ref_device())


def sim_workload(sim):
    """The main path's workload again, from its initial model."""
    from repro_torch.fl_constellation_sim import Workload
    return Workload(sim.trainer, sim.evaluator, results_w0(sim))


if __name__ == "__main__":
    main()
