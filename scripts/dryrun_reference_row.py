#!/usr/bin/env python3
"""One row of the JAX package's production-mesh dry-run, with its
collectives listed one by one at the dtype its program gives them.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 scripts/dryrun_reference_row.py \\
        --arch qwen3-4b --shape train_4k [--multi-pod] --out row.json

It calls ``repro.launch.dryrun.dryrun_one`` (the reference's row, whose
keys it keeps unchanged) and reads two texts of the compiled step: the
optimised HLO that ``dryrun_one`` parses for ``collective_bytes``, and the
module just before XLA's ``all-reduce-promotion`` pass, which XLA dumps
(``--xla_dump_to``, set in ``XLA_FLAGS`` before JAX starts) into a
temporary directory.  On the CPU that pass widens every bf16 all-reduce
to f32 (its reduction becomes ``%add...clone_promoted`` and a convert
back to bf16 follows it), and the ``float-normalization-bf16`` pass after
it widens bf16 all-gathers, all-to-alls and collective-permutes, so the
optimised HLO holds XLA's CPU bytes, not the bytes the partitioned
program asks for.  The row gains:

  * ``collectives``: each collective of the optimised HLO, in its order:
    ``kind``, ``shapes`` (each result's type, ``f32[16,4096,2560]``),
    ``bytes``, ``ranks`` (its replica groups' size), ``op_name`` (from its
    metadata), ``promoted`` (its reduction is a ``clone_promoted`` one, or
    a result's dtype is not the program's: widened by either pass),
    and ``program_shapes`` and ``program_bytes``: each result at the dtype
    of the collective before promotion that it was made from (the same
    kind, dimensions and replica groups; the same ``op_name`` first);
  * ``collective_bytes_program``: the totals of ``collective_bytes``'s
    form at the program's dtypes;
  * ``peak_values``: the ``PEAK_VALUES`` largest values live at the peak
    of XLA's buffer assignment for the step (its dump's "Live ranges at
    ... (peak)"), each ``[bytes, value, type]``: what the reference's
    ``temp_size_bytes`` is made of, op by op (``PERF.md`` §6 reads them
    against the program's dtypes).

It writes ``[row]`` to ``--out``, as ``python -m repro.launch.dryrun``
does.  ``scripts/dryrun_parity.py --side reference`` runs it a row at a
time.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
import tempfile
from collections import defaultdict

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
}
PROMOTION_PASS = "all-reduce-promotion"
PEAK_VALUES = 8
_OP = re.compile(r"%?[\w.\-]+\s*=\s*(\([^)]*\)|[^ ]+)\s+([\w\-]+)\(")
_TYPE = re.compile(r"(pred|[suf]\d+|bf16|c64)\[([\d,]*)\]")
_IOTA = re.compile(r"replica_groups=\[([\d,]+)\]<=\[([\d,]+)\](?:T\(([\d,]+)\))?")
_LIST = re.compile(r"replica_groups=\{(\{[\d,]*\}(?:,\{[\d,]*\})*)?\}")
_OP_NAME = re.compile(r'op_name="([^"]*)"')
_APPLY = re.compile(r"to_apply=%?([\w.\-]+)")


def type_bytes(dtype: str, dims: str) -> int:
    n = 1
    for d in filter(None, dims.split(",")):
        n *= int(d)
    return n * DTYPE_BYTES.get(dtype, 4)


def replica_groups(line: str) -> tuple:
    """The op's replica groups as a tuple of tuples of device ids (its
    iota form ``[G,S]<=[dims]T(perm)`` expanded), () where it has none."""
    m = _IOTA.search(line)
    if m:
        import numpy as np
        shape = [int(x) for x in m.group(1).split(",")]
        dims = [int(x) for x in m.group(2).split(",")]
        ids = np.arange(int(np.prod(dims))).reshape(dims)
        if m.group(3):
            ids = ids.transpose([int(x) for x in m.group(3).split(",")])
        return tuple(map(tuple, ids.reshape(shape).tolist()))
    m = _LIST.search(line)
    if m and m.group(1):
        return tuple(tuple(int(x) for x in g.split(",") if x)
                     for g in re.findall(r"\{([\d,]*)\}", m.group(1)))
    return ()


def parse(hlo: str) -> list:
    """Each collective of ``hlo``'s text: kind, results [(dtype, dims)],
    replica groups, op_name and reduction computation."""
    out = []
    for line in hlo.splitlines():
        m = _OP.match(line.strip())
        if not m:
            continue
        type_str, opname = m.group(1), m.group(2)
        kind = next((c for c in COLLECTIVES
                     if opname == c or opname.startswith(c + "-start")), None)
        if kind is None:
            continue
        name = _OP_NAME.search(line)
        apply = _APPLY.search(line)
        out.append(dict(kind=kind, results=_TYPE.findall(type_str),
                        groups=replica_groups(line),
                        op_name=name.group(1) if name else "",
                        to_apply=apply.group(1) if apply else ""))
    return out


def program_dtypes(final: list, before: list) -> list:
    """Each result of each collective of ``final`` at its program dtype:
    paired with an unused result of a collective of ``before`` (the
    module before promotion) of the same kind, dimensions and replica
    groups, one of the same op_name first; its own where none is left.
    Every result is paired: XLA's combiner later joins promoted and
    unpromoted all-reduces into one tuple under either's reduction."""
    pool = defaultdict(list)        # (kind, dims, groups) -> [(dtype, op)]
    for op in before:
        for dtype, dims in op["results"]:
            pool[(op["kind"], dims, op["groups"])].append(
                [dtype, op["op_name"]])
    out = []
    for op in final:
        got = []
        for dtype, dims in op["results"]:
            cands = pool.get((op["kind"], dims, op["groups"]), [])
            pick = next((c for c in cands if c[1] == op["op_name"]),
                        cands[0] if cands else None)
            if pick is not None:
                cands.remove(pick)
            got.append(pick[0] if pick else dtype)
        out.append(got)
    return out


def collectives(hlo: str, before: str) -> list:
    """The row's ``collectives`` (see the module docstring)."""
    final = parse(hlo)
    rows = []
    for op, prog in zip(final, program_dtypes(final, parse(before))):
        shapes = [f"{dt}[{dims}]" for dt, dims in op["results"]]
        program = [f"{dt}[{dims}]"
                   for dt, (_, dims) in zip(prog, op["results"])]
        rows.append(dict(
            kind=op["kind"], shapes=shapes,
            bytes=sum(type_bytes(dt, d) for dt, d in op["results"]),
            ranks=len(op["groups"][0]) if op["groups"] else 0,
            op_name=op["op_name"],
            promoted=("clone_promoted" in op["to_apply"]
                      or program != shapes),
            program_shapes=program,
            program_bytes=sum(type_bytes(dt, d) for dt, (_, d)
                              in zip(prog, op["results"]))))
    return rows


def program_totals(rows: list) -> dict:
    """``collective_bytes``'s form (bytes by kind, ``_counts``,
    ``total``) at the program's dtypes."""
    out, counts = defaultdict(int), defaultdict(int)
    for r in rows:
        out[r["kind"]] += r["program_bytes"]
        counts[r["kind"]] += 1
    result = dict(out)
    result["_counts"] = dict(counts)
    result["total"] = int(sum(out.values()))
    return result


def before_promotion(dump: str, hlo: str) -> str:
    """The text of the compiled module just before the promotion pass,
    from XLA's dump; the optimised HLO itself where XLA dumped none (no
    pass ran, or it changed nothing)."""
    module = re.match(r"HloModule\s+([\w.\-]+)", hlo)
    name = module.group(1) if module else ""
    files = sorted(glob.glob(os.path.join(
        dump, f"*.{name}.*before_{PROMOTION_PASS}.txt")))
    if not files:
        return hlo
    with open(files[-1]) as f:
        return f.read()


_LIVE = re.compile(r"^\s+([\w.\-]+)\{[\d,]*\}: (\d+) bytes")
_VALUE = re.compile(r"value: <\d+ ([\w.\-]+) @\d+> \(size=\d+,"
                    r"offset=\d+\): ([^ ]+)")


def peak_values(dump: str, hlo: str) -> list:
    """The ``PEAK_VALUES`` largest values live at the peak of the step's
    buffer assignment in XLA's dump: ``[bytes, value, type]`` each; none
    where XLA dumped no assignment."""
    module = re.match(r"HloModule\s+([\w.\-]+)", hlo)
    files = sorted(glob.glob(os.path.join(
        dump, f"*.{module.group(1) if module else ''}"
        ".*buffer-assignment.txt")))
    if not files:
        return []
    with open(files[-1]) as f:
        lines = f.read().splitlines()
    types = {}
    for line in lines:
        m = _VALUE.search(line)
        if m:
            types.setdefault(m.group(1), m.group(2))
    at = next((i for i, line in enumerate(lines)
               if "Live ranges at" in line and "(peak)" in line), None)
    if at is None:
        return []
    live = []
    for line in lines[at + 1:]:
        m = _LIVE.match(line)
        if not m:
            break
        live.append([int(m.group(2)), m.group(1), types.get(m.group(1), "")])
    return sorted(live, reverse=True)[:PEAK_VALUES]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as dump:
        # before JAX starts: it reads XLA_FLAGS once
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "") + f" --xla_dump_to={dump}"
            f" --xla_dump_hlo_pass_re={PROMOTION_PASS}").strip()
        import repro.launch.dryrun as ref
        seen = {}
        parse_hlo = ref.collective_bytes

        def keep(hlo):
            seen["hlo"] = hlo
            return parse_hlo(hlo)
        ref.collective_bytes = keep
        try:
            row = ref.dryrun_one(args.arch, args.shape,
                                 multi_pod=args.multi_pod, verbose=False)
        except Exception as e:          # a dry-run failure is a bug
            row = {"arch": args.arch, "shape": args.shape,
                   "error": repr(e)[:500], "skipped": False}
        if "hlo" in seen:
            rows = collectives(seen["hlo"],
                               before_promotion(dump, seen["hlo"]))
            row["collectives"] = rows
            row["collective_bytes_program"] = program_totals(rows)
            row["peak_values"] = peak_values(dump, seen["hlo"])
    with open(args.out, "w") as f:
        json.dump([row], f, indent=1)
    return 1 if "error" in row else 0


if __name__ == "__main__":
    sys.exit(main())
