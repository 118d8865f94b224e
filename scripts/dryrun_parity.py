#!/usr/bin/env python3
"""The production-mesh dry-runs of both packages, row by row, and the
port's per-device memory against the reference's.

    python3 scripts/dryrun_parity.py --side port [--rows all] \\
        [--meshes single,multi] [--jobs 8] [--layers N] \\
        [--against scripts/dryrun_reference.json] [--out PATH]
    python3 scripts/dryrun_parity.py --side reference \\
        --meshes single,multi --out scripts/dryrun_reference.json

``--side port`` runs ``python -m repro_torch.launch.dryrun`` (no JAX),
``--side reference`` the JAX package's dry-run through
``scripts/dryrun_reference_row.py`` (with ``JAX_PLATFORMS=cpu``; its row
is ``python -m repro.launch.dryrun``'s with each collective listed at the
dtype its program gives it, ``collectives``, and their totals,
``collective_bytes_program``), one process a row (arch, shape, mesh),
``--jobs`` at once, each cut at ``--timeout`` seconds.  ``--rows`` is
``all`` (every arch at every shape) or a comma-separated list of
``arch:shape``; ``--meshes`` names the production meshes, ``single`` (16
x 16) and ``multi`` (2 x 16 x 16, ``--multi-pod``).  Each
row's result, its wall seconds and its exit code go to ``--out`` as JSON
(the memory keys of the row, its FLOPs, bytes accessed and collective
bytes by kind, each collective, ``replicated`` and ``peak_holders`` where
the port has them, ``lower_s``).  With ``--against`` (such a file from the other side,
here ``scripts/dryrun_reference.json``: the reference's rows on 16 x 16
and 2 x 16 x 16, taken on a CPU with jax 0.9.0), a table of temp bytes,
their ratio, the argument bytes' difference, and the ratios of FLOPs a
device and of each collective kind's bytes is printed (against the
reference's program dtypes where its row has them: XLA's CPU compile
widens bf16 all-reduces to f32), a row at a time as each ends.  The two sides count differently: XLA's ``cost_analysis``
counts every operation of the partitioned program (elementwise work too)
on one device; the port counts the matrix products' 2 m n k
(``FlopCounterMode``) of one rank's share.  Collective bytes are each
kind's output bytes on one device on both sides.  The reference scans its
layer stacks (``lax.scan``), and both its counts hold a loop's body once,
so a full row's ratios grow with the layer count;
``tests/test_torch_dryrun_parity.py`` (b) holds the port's row cut to one
layer (one lead and one MoE layer for the MoE family) to them.  ``--layers
N`` cuts the port's configs to N layers (``CUT``): the table then pairs each of the port's collectives of the residual stream's bytes
or more (B/16 x S x d in bf16) with one of the reference program's
(``launch.collectives.pair_with_reference``) and prints how many of
them found none.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import textwrap
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("qwen3-4b", "llama3-8b", "granite-8b", "internvl2-1b",
         "hubert-xlarge", "starcoder2-3b", "zamba2-2.7b", "rwkv6-7b",
         "deepseek-v2-236b", "kimi-k2-1t-a32b")
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
COMMANDS = {"port": ["-m", "repro_torch.launch.dryrun"],
            "reference": [str(ROOT / "scripts" / "dryrun_reference_row.py")]}
# the port's row with its config cut to N layers, as the tests' and the
# smoke's dry-runs cut it: argv arch, shape, out, multi-pod (0/1), N
CUT = textwrap.dedent("""
    import json, sys
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import dryrun_one, quiet_dtensor
    quiet_dtensor()
    arch, shape, out, multi, layers = sys.argv[1:]
    row = dryrun_one(arch, shape, multi_pod=multi == "1", verbose=False,
                     cfg=get_config(arch).replace(num_layers=int(layers)))
    with open(out, "w") as f:
        json.dump([row], f)
""")
KEEP = ("arch", "shape", "multi_pod", "mesh_shape", "skipped", "memory",
        "replicated", "peak_holders", "lower_s", "flops", "flops_per_device",
        "bytes_accessed", "collective_bytes", "collective_bytes_program",
        "collectives", "error")


def key(arch: str, shape: str, multi_pod: bool) -> str:
    return f"{arch}:{shape}" + (":multi-pod" if multi_pod else "")


def run_row(side: str, arch: str, shape: str, multi_pod: bool,
            timeout: float, tmp: Path, layers: int = 0) -> dict:
    """One row in a process of its own (the port's cut to ``layers``
    layers if set): the row's kept keys, ``wall_s`` and ``rc``."""
    out = tmp / f"{key(arch, shape, multi_pod).replace(':', '_')}.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    if side == "reference":
        env["JAX_PLATFORMS"] = "cpu"
    if layers:
        cmd = [sys.executable, "-c", CUT, arch, shape, str(out),
               str(int(multi_pod)), str(layers)]
    else:
        cmd = [sys.executable, *COMMANDS[side], "--arch", arch, "--shape",
               shape, "--out", str(out)] \
            + (["--multi-pod"] if multi_pod else [])
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


def ratios(row: dict, other: dict) -> dict:
    """The port's (``row``) FLOPs a device and each collective kind's
    bytes over the reference's (``other``; XLA counts the partitioned
    program, one device's, its collectives at the program's dtypes where
    the row has them), None where the reference has none."""
    want = other["flops"]
    out = {"flops": row["flops_per_device"] / want if want > 0 else None}
    mine = row.get("collective_bytes") or {}
    theirs = (other.get("collective_bytes_program")
              or other.get("collective_bytes") or {})
    for kind in sorted(set(mine) | set(theirs)):
        if not kind.startswith("_"):
            want = theirs.get(kind, 0)
            out[f"coll {kind}"] = mine.get(kind, 0) / want if want else None
    return out


def unpaired(row: dict, other: dict) -> str:
    """The table's note on the port's collectives (a row cut to
    ``--layers``) paired with the reference program's (``other``)."""
    from repro_torch.configs import get_config, get_shape
    from repro_torch.launch.collectives import (pair_with_reference,
                                                residual_bytes)
    least = residual_bytes(get_config(row["arch"]), get_shape(row["shape"]))
    gated = [p for p in pair_with_reference(
        row["collectives"], other["collectives"], least) if p["gated"]]
    return (f"; {len(gated)} collectives of {least:,} B or more, "
            f"{sum(p['ref'] is None for p in gated)} unpaired")


def line(row: dict, ref: dict, pair: bool = False) -> str:
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
        if "flops" in other:
            text += "; " + ", ".join(
                f"{k} {'-' if v is None else f'{v:.3f}'}"
                for k, v in ratios(row, other).items())
            coll = (other.get("collective_bytes_program")
                    or other.get("collective_bytes") or {}).get("total", 0)
            text += (f" (reference {other['flops']:.4g} FLOPs, "
                     f"{coll / 1e9:.3f} GB collectives a device at its "
                     "program's dtypes)")
    if pair and other and row.get("collectives") and other.get(
            "collectives"):
        text += unpaired(row, other)
    text += (f"; replicated {row.get('replicated', [])}; "
             f"{row.get('lower_s')} s traced, {row['wall_s']} s wall")
    return text


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--side", required=True, choices=sorted(COMMANDS))
    ap.add_argument("--rows", default="all")
    ap.add_argument("--meshes", default="single")
    ap.add_argument("--jobs", type=int, default=8)
    ap.add_argument("--timeout", type=float, default=1800)
    ap.add_argument("--against", default=None)
    ap.add_argument("--layers", type=int, default=0,
                    help="the port's configs cut to this many layers; the "
                         "table pairs the collectives")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.layers:
        if args.side != "port":
            ap.error("--layers cuts the port's configs only")
        sys.path.insert(0, str(ROOT / "src"))       # for ``unpaired``
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
                               args.timeout, Path(tmp), args.layers)
                   for multi in pods for a, s in rows]
        for f in futures:
            row = f.result()
            results.append(row)
            print(line(row, ref, bool(args.layers)), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(results, indent=1))
    return 1 if any(r["rc"] for r in results) else 0


if __name__ == "__main__":
    sys.exit(main())
