#!/usr/bin/env python3
"""The production-mesh dry-runs of both packages, row by row, and the
port's per-device memory against the reference's.

    python3 scripts/dryrun_parity.py --side port [--rows all] \\
        [--meshes single,multi] [--jobs 8] \\
        [--against scripts/dryrun_reference.json] [--out PATH]
    python3 scripts/dryrun_parity.py --side reference \\
        --meshes single,multi --out scripts/dryrun_reference.json

``--side port`` runs ``python -m repro_torch.launch.dryrun`` (no JAX),
``--side reference`` the JAX package's ``python -m repro.launch.dryrun``
(with ``JAX_PLATFORMS=cpu``), one process a row (arch, shape, mesh),
``--jobs`` at once, each cut at ``--timeout`` seconds.  ``--rows`` is
``all`` (every arch at every shape) or a comma-separated list of
``arch:shape``; ``--meshes`` names the production meshes, ``single`` (16
x 16) and ``multi`` (2 x 16 x 16, ``--multi-pod``).  Each
row's result, its wall seconds and its exit code go to ``--out`` as JSON
(the memory keys of the row, ``replicated`` and ``peak_holders`` where
the port has them, ``lower_s``).  With ``--against`` (such a file from the
other side, here ``scripts/dryrun_reference.json``: the reference's rows
on 16 x 16 and 2 x 16 x 16, taken on a CPU with jax 0.9.0), a table of
temp bytes, their ratio and the argument bytes' difference is printed, a
row at a time as each ends.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("qwen3-4b", "llama3-8b", "granite-8b", "internvl2-1b",
         "hubert-xlarge", "starcoder2-3b", "zamba2-2.7b", "rwkv6-7b",
         "deepseek-v2-236b", "kimi-k2-1t-a32b")
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
MODULES = {"port": "repro_torch.launch.dryrun",
           "reference": "repro.launch.dryrun"}
KEEP = ("arch", "shape", "multi_pod", "mesh_shape", "skipped", "memory",
        "replicated", "peak_holders", "lower_s", "flops_per_device",
        "error")


def key(arch: str, shape: str, multi_pod: bool) -> str:
    return f"{arch}:{shape}" + (":multi-pod" if multi_pod else "")


def run_row(side: str, arch: str, shape: str, multi_pod: bool,
            timeout: float, tmp: Path) -> dict:
    """One row in a process of its own: the row's kept keys, ``wall_s``
    and ``rc``."""
    out = tmp / f"{key(arch, shape, multi_pod).replace(':', '_')}.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    if side == "reference":
        env["JAX_PLATFORMS"] = "cpu"
    cmd = [sys.executable, "-m", MODULES[side], "--arch", arch, "--shape",
           shape, "--out", str(out)] + (["--multi-pod"] if multi_pod else [])
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, env=env, cwd=str(ROOT), timeout=timeout,
                              capture_output=True, text=True)
        rc, err = proc.returncode, proc.stderr[-2000:]
    except subprocess.TimeoutExpired:
        rc, err = 124, f"cut at {timeout} s"
    wall = time.perf_counter() - t0
    row = {"arch": arch, "shape": shape, "multi_pod": multi_pod}
    if out.exists():
        [got] = json.loads(out.read_text())
        row.update({k: v for k, v in got.items() if k in KEEP})
    elif rc:
        row["error"] = err
    row.update(wall_s=round(wall, 1), rc=rc)
    return row


def line(row: dict, ref: dict) -> str:
    name = key(row["arch"], row["shape"], row["multi_pod"])
    if row.get("skipped"):
        return f"{name}: skipped"
    if "memory" not in row:
        return f"{name}: rc {row['rc']} {row.get('error', '')[-300:]}"
    temp = row["memory"]["temp_size_bytes"]
    text = f"{name}: temp {temp / 1e9:.2f} GB"
    other = ref.get(name)
    if other and "memory" in other:
        want = other["memory"]["temp_size_bytes"]
        darg = (row["memory"]["argument_size_bytes"]
                - other["memory"]["argument_size_bytes"])
        text += (f", reference {want / 1e9:.2f} GB, ratio "
                 f"{temp / want:.3f}; arguments {darg:+d} B")
    text += (f"; replicated {row.get('replicated', [])}; "
             f"{row.get('lower_s')} s traced, {row['wall_s']} s wall")
    return text


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--side", required=True, choices=sorted(MODULES))
    ap.add_argument("--rows", default="all")
    ap.add_argument("--meshes", default="single")
    ap.add_argument("--jobs", type=int, default=8)
    ap.add_argument("--timeout", type=float, default=1800)
    ap.add_argument("--against", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    rows = ([(a, s) for a in ARCHS for s in SHAPES] if args.rows == "all"
            else [tuple(r.split(":")) for r in args.rows.split(",")])
    pods = [{"single": False, "multi": True}[m]
            for m in args.meshes.split(",")]
    ref = {}
    if args.against:
        ref = {key(r["arch"], r["shape"], r["multi_pod"]): r
               for r in json.loads(Path(args.against).read_text())}
    results = []
    with tempfile.TemporaryDirectory() as tmp, \
            ThreadPoolExecutor(args.jobs) as pool:
        futures = [pool.submit(run_row, args.side, a, s, multi,
                               args.timeout, Path(tmp))
                   for multi in pods for a, s in rows]
        for f in futures:
            row = f.result()
            results.append(row)
            print(line(row, ref), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(results, indent=1))
    return 1 if any(r["rc"] for r in results) else 0


if __name__ == "__main__":
    sys.exit(main())
