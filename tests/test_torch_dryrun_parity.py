"""The dry-run's per-device placements against the reference's GSPMD.

(a) GQA on a small fake world: qwen3-4b reduced with 8 query heads and 2
    kv heads on fake 2 x 4 and 1 x 4 (data, model) meshes, where "model"
    (4) exceeds the kv heads (2) and the rules replicate k and v over it.
    For the train, prefill and decode steps: ``replicated`` is empty, and
    rank 0's FLOPs are the per-rank share written out from the rules
    within 1 %: q, o, attention, the MLP and the unembedding split over
    data x model, the k and v projections over data alone.  The scans'
    local regions (rwkv6-7b and zamba2-2.7b reduced, train on 2 x 2)
    count the program's FLOPs and matrix products once: the same as the
    trace at one rank, where no local region runs.
(b) Full width on 16 x 16: qwen3-4b train_4k and prefill_32k against the
    reference's own dry-run (``scripts/dryrun_reference_row.py``:
    ``repro.launch.dryrun``'s row, with its collectives one by one at the
    dtype its program gives them), each package in a process of its own:
    argument bytes equal but for the port's 512-byte rounding of each
    leaf, and the port's temp memory within [0.5, 2] x the reference's (a
    trace that loses storages would size a run too small).  The port's
    step cut to one layer (the reference's counts hold its scanned layer
    loop's body once): FLOPs a device within ``FLOPS_BOUNDS`` of the
    reference's; each collective of at least the residual stream's bytes
    a rank paired with one of the reference's program of the same kind,
    type and dtype, and the all-reduce bytes within ``REF_REL`` of the
    reference program's, or within ``READING_REL`` of the reading where
    the two programs differ op by op as ``PERF.md`` §6 writes down
    (``PORT_READINGS``).  Refused: one rank's count doubled, the
    collective left out, the lookup's rows summed in f32.  The same for
    llama3-8b train_4k (8 kv heads over 16 ranks) at one layer.  The MoE
    family: deepseek-v2-236b prefill_32k at full width (nothing
    replicated, argument bytes, temp within [0.5, 2] x), its train_4k
    (the temp at its reading and within [0.5, 2] x the reference's taken
    at its program's dtypes), and deepseek-v2
    and kimi-k2 train_4k and prefill_32k cut to one lead and one MoE
    layer (FLOPs within ``MOE_FLOPS_BOUNDS``, collectives paired, the
    all-reduce and all-gather totals), the reference's rows read from
    ``scripts/dryrun_reference.json``; refused: the dispatch and MLA
    before the dry-runs placed them (``tests/torch_moe_before.py``).
(c) On plain tensors, attention, the loss and the embedding lookup give
    the same bits as the versions before the dry-run placed them (frozen
    below), forward and backward, at three GQA shapes in f32 and bf16;
    serving's unembedding, its table cast a vocab block at a time, the
    bits of one cast and product; ``moe_ffn`` (with and without drops,
    a shared expert) and MLA's prefill (both query branches, a window,
    query chunks) the bits of ``tests/torch_moe_before.py``.
(d) On a real 4-rank gloo world of the CPU, the dry-run's local regions
    (``models/spmd.py``: the vocab-parallel loss and lookup, its rows in
    f32 and bf16, attention on each rank's heads with 2 ranks over 1 kv
    head, and the whole attention block from its weights, the kv
    gradient carried partial, the MoE FFN with and without dropped
    assignments, MLA's prefill, the chunked and sequential scans and a
    decode step on each rank's heads, serving's blocked unembedding on
    each rank's rows and vocab shard) give the plain route's outputs and
    gradients, so the trace holds the same program; the lookup's rows
    cast before their reduction and the kv slice's gradient left
    partial give the bits of the routes before them, in f32 and bf16.

The subprocesses of (a) and (b) start together in a module fixture.
"""
import json
import math
import os
import pathlib
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest
import torch
from torch_mesh_cases import run_world, spmd_case

from repro_torch.models import layers as L
from repro_torch.models import registry as R

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
KINDS = ("train_4k", "prefill_32k", "decode_32k")
GQA_MESHES = ((2, 4), (1, 4))
FULL_SHAPES = ("train_4k", "prefill_32k")
TEMP_RATIO = 2.0
TEMP_RATIO_FLOOR = 0.5
SCAN_ARCHS = ("rwkv6-7b", "zamba2-2.7b")
SCAN_MESHES = ((1, 1), (2, 2))
ALLOC_UNIT = 512
FLOPS_REL = 0.01
# (b): the port's FLOPs a device over the reference's.  The reference
# scans its layers (``lax.scan``), and XLA's ``cost_analysis`` and its HLO
# text count a loop's body once, so its figures are those of the step
# with one layer: the port's one-layer row is held against them.  The
# bounds lie about 20 % around a CPU's readings (torch 2.13, jax
# 0.9.0): 1.164 (train) and 1.083 (prefill; XLA counts elementwise work,
# the port only the products, which remat and the loss's f32 logits add
# to)
FLOPS_BOUNDS = {"train_4k": (0.95, 1.4), "prefill_32k": (0.9, 1.3)}
# (b): the one-layer step's collectives against the reference program's
# (XLA's CPU compile widens its bf16 all-reduces to f32; the reference's
# row holds each at its program's dtype too).  Each of the port's that
# moves at least the residual stream's bytes a rank (B/16 x S x d in
# bf16) pairs with one of the reference's of the same kind and type
# (``collectives.pair_with_reference``), and the all-reduce bytes lie
# within REF_REL of the reference program's, or, for a row whose
# program differs from GSPMD's op by op as PERF.md §6 writes down (the
# port adds a layer's partial input gradients before one reduction where
# GSPMD reduces each product's, and leaves the kv slice's gradient
# partial where GSPMD reduces it over the 2 ranks that read a kv head;
# its parameter gradients are f32 and scattered over "data"), within
# READING_REL of a CPU's reading (torch 2.13; PORT_READINGS)
REF_REL = 0.10
READING_REL = 0.02
PORT_READINGS = {("qwen3-4b", "train_4k"): 2349598468,
                 ("llama3-8b", "train_4k"): 3758885700,
                 # the MoE rows at one lead and one MoE layer: the program's
                 # all-reduces but the one of JAX's scatter JVP (u32[T k,
                 # d], its ids of the set-scatter's winning rows; PERF.md
                 # §6), which the port's dispatch does not make
                 ("deepseek-v2-236b", "train_4k"): 394483468612,
                 ("kimi-k2-1t-a32b", "train_4k"): 733769112388}
PAIR_ARCH = "llama3-8b"         # (b) at one layer only
# (b): qwen3-4b decode_32k's temp, 0.05x the reference's: XLA's CPU
# compile holds two f32 copies of the step's whole K and V caches in its
# temp (9.66 of its 10.28 GB; PERF.md §6), the port writes the cache in
# place in bf16.  Held within READING_REL of a CPU's reading so that a
# change is seen (no ratio gate reaches it)
DECODE_TEMP_READING = 546732544

# (a): every kind on each mesh, in one process (a fake world is replaced
# when the next mesh asks for another size)
GQA_SCRIPT = textwrap.dedent("""
    import json, sys
    from repro_torch.configs import get_config, get_shape
    from repro_torch.launch.dryrun import dryrun_one, quiet_dtensor
    quiet_dtensor()
    cfg = get_config("qwen3-4b").reduced().replace(num_heads=8,
                                                   num_kv_heads=2)
    rows = {}
    for mesh in json.loads(sys.argv[1]):
        for kind in json.loads(sys.argv[2]):
            row = dryrun_one("qwen3-4b", kind, cfg=cfg,
                             shape=get_shape(kind).reduced(),
                             mesh_shape=tuple(mesh), verbose=False)
            rows[f"{mesh[0]}x{mesh[1]} {kind}"] = row
    print(json.dumps(rows))
""")

# (a): a scanning arch's reduced train step at one rank and split
SCAN_SCRIPT = textwrap.dedent("""
    import json, sys
    from repro_torch.configs import get_config, get_shape
    from repro_torch.launch.dryrun import dryrun_one, quiet_dtensor
    quiet_dtensor()
    arch = sys.argv[1]
    rows = {}
    for mesh in json.loads(sys.argv[2]):
        rows[f"{mesh[0]}x{mesh[1]}"] = dryrun_one(
            arch, "train_4k", cfg=get_config(arch).reduced(),
            shape=get_shape("train_4k").reduced(), mesh_shape=tuple(mesh),
            verbose=False)
    print(json.dumps(rows))
""")

# (b): the port's row (sys.argv[3] "full"; else only what follows) and
# the number of tensors among its arguments; the same step with one
# layer, what the reference's counts hold; and that step with the lookup
# before its repair, its f32 rows summed over the vocab's ranks and then
# cast (the control the gate must refuse)
PORT_SCRIPT = textwrap.dedent("""
    import json, sys
    from repro_torch.configs import get_config, get_shape
    from repro_torch.launch.dryrun import dryrun_one, quiet_dtensor
    from repro_torch.launch.specs import (input_specs, opt_state_specs,
                                          param_specs)
    from repro_torch.models import layers as L, spmd
    from repro_torch.tree import tree_leaves
    quiet_dtensor()
    arch, shape = sys.argv[1], sys.argv[2]
    cfg, shp = get_config(arch), get_shape(shape)
    row = {}
    if sys.argv[3] == "full":
        row = dryrun_one(arch, shape, verbose=False)
        trees = [param_specs(cfg), input_specs(cfg, shp)]
        if shp.kind == "train":
            trees.append(opt_state_specs(cfg, trees[0]))
        row["n_leaves"] = sum(len(tree_leaves(t)) for t in trees)
    keep = ("flops_per_device", "collective_bytes", "collectives")
    one = dryrun_one(arch, shape, cfg=cfg.replace(num_layers=1),
                     verbose=False)
    row["one_layer"] = {k: one[k] for k in keep}

    def embed_f32(p, cfg, tokens, dtype):
        return spmd.take_rows(p["embedding"], tokens).to(dtype)
    L.embed = embed_f32
    one = dryrun_one(arch, shape, cfg=cfg.replace(num_layers=1),
                     verbose=False)
    row["f32_lookup"] = {k: one[k] for k in keep}
    print(json.dumps(row))
""")
REF_ROW = str(ROOT / "scripts" / "dryrun_reference_row.py")

# (b), the MoE family: the port's row at full depth (sys.argv[2], or
# "none"), and for each shape of sys.argv[3:] the step cut to one lead and
# one MoE layer (what the reference's counts hold: it scans each stack and
# counts the body once), with the MoE dispatch and MLA as they were before
# the dry-runs placed them (``tests/torch_moe_before.py``): the control
# the gates must refuse
MOE_SCRIPT = textwrap.dedent("""
    import json, sys
    from repro_torch.configs import get_config, get_shape
    from repro_torch.launch.dryrun import dryrun_one, quiet_dtensor
    from repro_torch.launch.specs import (input_specs, opt_state_specs,
                                          param_specs)
    from repro_torch.models import moe as MOE
    from repro_torch.tree import tree_leaves
    import torch_moe_before as before
    quiet_dtensor()
    arch, full, shapes = sys.argv[1], sys.argv[2], sys.argv[3:]
    cfg = get_config(arch)
    out = {}
    if full != "none":
        out["full"] = dryrun_one(arch, full, verbose=False)
        shp = get_shape(full)
        trees = [param_specs(cfg), input_specs(cfg, shp)]
        if shp.kind == "train":
            trees.append(opt_state_specs(cfg, trees[0]))
        out["full"]["n_leaves"] = sum(len(tree_leaves(t)) for t in trees)
    keep = ("flops_per_device", "collective_bytes", "collectives",
            "memory", "replicated")
    two = cfg.replace(num_layers=2)
    for name, fns in (("now", (MOE.moe_ffn, MOE.mla_attention)),
                      ("before", (before.moe_ffn, before.mla_attention))):
        MOE.moe_ffn, MOE.mla_attention = fns
        for shape in shapes:
            row = dryrun_one(arch, shape, cfg=two, verbose=False)
            out[f"{name} {shape}"] = {k: row[k] for k in keep}
    print(json.dumps(out))
""")
MOE_ARCHS = ("deepseek-v2-236b", "kimi-k2-1t-a32b")
MOE_FULL = ("deepseek-v2-236b", "prefill_32k")
# (b): deepseek-v2-236b train_4k at full width, 0.43 x the reference's
# temp: the peak of XLA's CPU compile holds values its program has in
# bf16 in f32 (``scripts/dryrun_reference_row.py``'s ``peak_values``;
# PERF.md §6): three (T k, d) rows, f32[6291456, 5120] each, which the
# row's ``collectives`` list as promoted from bf16, and an f32 copy of the
# 59 MoE layers' inputs, f32[59, 16, 4096, 5120], that the module before
# the CPU's float normalization holds in bf16 only.  Those at bf16, the
# reference's temp 917,835,315,944 B reads 917,835,315,944 - 3 x
# 64,424,509,440 - 39,594,229,760 B, the port's temp against it within
# [0.5, 2] x; and the port's temp at its reading (torch 2.11 and 2.13)
# within READING_REL
MOE_TRAIN_FULL = ("deepseek-v2-236b", "train_4k")
MOE_TRAIN_REF_PROGRAM_TEMP = 684967557864
MOE_TRAIN_TEMP_READING = 394421805056
# its temp on torch 2.11 before its MLA and dispatch were placed (0.91 x
# XLA's CPU temp, 7 operations replicated): the control the reading refuses
MOE_TRAIN_TEMP_BEFORE = 836036977152
# (b): the MoE rows' FLOPs a device at one lead and one MoE layer over the
# reference's, about 15 % around a CPU's readings (torch 2.13, jax 0.9.0):
# deepseek-v2 0.974 (train) and 0.976 (prefill), kimi-k2 1.022 and 1.023
MOE_FLOPS_BOUNDS = (0.85, 1.15)
# deepseek-v2-236b prefill_32k's temp on torch 2.11 before its MLA and
# dispatch were placed (PERF.md §6): the known-bad value the gate refuses
MOE_TEMP_BEFORE = 2372776756224


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=SRC)
    env.update(extra)
    env.pop("XLA_FLAGS", None)
    return env


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parity")
    cmds = {"gqa": ([sys.executable, "-c", GQA_SCRIPT,
                     json.dumps(GQA_MESHES), json.dumps(KINDS)], _env())}
    for arch in SCAN_ARCHS:
        cmds[f"scan {arch}"] = ([sys.executable, "-c", SCAN_SCRIPT, arch,
                                 json.dumps(SCAN_MESHES)], _env())
    for arch, shape, full in [("qwen3-4b", s, "full") for s in FULL_SHAPES] \
            + [(PAIR_ARCH, "train_4k", "one")]:
        cmds[f"port {arch} {shape}"] = ([sys.executable, "-c", PORT_SCRIPT,
                                         arch, shape, full], _env())
        cmds[f"ref {arch} {shape}"] = (
            [sys.executable, REF_ROW, "--arch", arch, "--shape", shape,
             "--out", str(tmp / f"ref_{arch}_{shape}.json")],
            _env(JAX_PLATFORMS="cpu"))
    moe_env = _env(PYTHONPATH=os.pathsep.join([SRC, str(ROOT / "tests")]))
    for arch in MOE_ARCHS:
        full = MOE_FULL[1] if arch == MOE_FULL[0] else "none"
        cmds[f"moe {arch}"] = ([sys.executable, "-c", MOE_SCRIPT, arch, full,
                                *FULL_SHAPES], moe_env)
    cmds["moe train"] = ([sys.executable, "-c", MOE_SCRIPT, *MOE_TRAIN_FULL],
                         moe_env)
    procs = {}
    cmds["port decode"] = ([sys.executable, "-m",
                            "repro_torch.launch.dryrun", "--arch", "qwen3-4b",
                            "--shape", "decode_32k", "--out",
                            str(tmp / "port_decode.json")], _env())
    for name, (cmd, env) in cmds.items():
        with open(tmp / f"{name}.out", "w") as out, \
                open(tmp / f"{name}.err", "w") as err:
            procs[name] = subprocess.Popen(cmd, env=env, stdout=out,
                                           stderr=err, cwd=str(ROOT))
    done = {}
    for name, p in procs.items():
        p.wait(timeout=600)
        err = (tmp / f"{name}.err").read_text()
        assert p.returncode == 0, f"{name}: {err[-3000:]}"
        if name.startswith("ref") or name == "port decode":
            path = tmp / f"{name.replace(' ', '_')}.json"
            [row] = json.loads(path.read_text())
            done[name] = row
        else:
            out = (tmp / f"{name}.out").read_text().strip().splitlines()
            done[name] = json.loads(out[-1])
    return done


# ---- (a) --------------------------------------------------------------------

# qwen3-4b reduced with 8 query heads of 64 over 2 kv heads: d 256, d_ff
# 512, vocab 512, 2 layers; every reduced shape is B 4, and S 128 (train,
# prefill) or one token over a 128-slot cache (decode)
D, H, KV, HD, FF, V, NL, B, S = 256, 8, 2, 64, 512, 512, 2, 4, 128


def _share(kind, data, model):
    """Rank 0's FLOPs written out from the rules: the products that
    FlopCounterMode counts (2 m n k each), q, o, attention, the MLP and the
    unembedding split over data x model, k and v over data alone (2 kv
    heads do not divide a model axis of 4)."""
    both, kv_split = data * model, data
    if kind == "decode_32k":
        T, Sq, Sk = B, 1, S
    else:
        T, Sq, Sk = B * S, S, S
    q = 2 * T * D * H * HD / both
    kv = 2 * 2 * T * D * KV * HD / kv_split
    attn = 2 * 2 * B * H * Sq * Sk * HD / both
    o = 2 * T * H * HD * D / both
    mlp = 3 * 2 * T * D * FF / both
    last = 2 * T * FF * D / both         # the product remat does not redo
    layer = q + kv + attn + o + mlp
    fwd = NL * layer + 2 * T * D * V / both
    if kind == "train_4k":
        return 3 * fwd + NL * (layer - last)
    return fwd


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mesh", GQA_MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_gqa_heads_stay_split(runs, mesh, kind):
    row = runs["gqa"][f"{mesh[0]}x{mesh[1]} {kind}"]
    assert row["replicated"] == []
    want = _share(kind, *mesh)
    assert abs(row["flops_per_device"] - want) <= FLOPS_REL * want, \
        (row["flops_per_device"], want)
    # the global count is the same program's at any placement
    assert abs(row["flops"] - _share(kind, 1, 1)) <= FLOPS_REL * row["flops"]


@pytest.mark.parametrize("arch", SCAN_ARCHS)
def test_scan_regions_count_their_work_once(runs, arch):
    one, split = (runs[f"scan {arch}"][f"{m}x{n}"] for m, n in SCAN_MESHES)
    assert split["replicated"] == []
    assert abs(split["flops"] - one["flops"]) <= FLOPS_REL * one["flops"], \
        (split["flops"], one["flops"])
    assert split["matmuls"] == one["matmuls"]
    assert split["flops_per_device"] < one["flops_per_device"] / 2


# ---- (b) --------------------------------------------------------------------

@pytest.mark.parametrize("shape", FULL_SHAPES)
def test_full_width_matches_reference(runs, shape):
    port, ref = runs[f"port qwen3-4b {shape}"], runs[f"ref qwen3-4b {shape}"]
    assert port["replicated"] == []
    got = port["memory"]["argument_size_bytes"]
    want = ref["memory"]["argument_size_bytes"]
    # each of the port's storages is rounded up to the allocator's unit
    assert want <= got < want + ALLOC_UNIT * port["n_leaves"], (got, want)
    ratio = (port["memory"]["temp_size_bytes"]
             / ref["memory"]["temp_size_bytes"])
    assert TEMP_RATIO_FLOOR <= ratio <= TEMP_RATIO, (port["memory"],
                                                     ref["memory"])


@pytest.mark.parametrize("shape", FULL_SHAPES)
def test_reference_lists_its_peak(runs, shape):
    """The reference's row lists the largest values live at the peak of
    XLA's buffer assignment (``peak_values``, what ``PERF.md`` §6 reads
    its temp from), largest first, each a typed value of at most the
    row's temp and argument bytes."""
    row = runs[f"ref qwen3-4b {shape}"]
    got = row["peak_values"]
    assert got and [v[0] for v in got] == sorted((v[0] for v in got),
                                                 reverse=True)
    mem = row["memory"]
    assert all(0 < n <= mem["temp_size_bytes"] + mem["argument_size_bytes"]
               and name for n, name, _ in got), got


def test_decode_temp_holds_its_reading(runs):
    """qwen3-4b decode_32k on 16 x 16: the port's temp at its reading, far
    under the reference's (``scripts/dryrun_reference.json``), whose XLA
    copies of the cache it does not make; the argument bytes the
    reference's but for the port's 512-byte rounding."""
    row = runs["port decode"]
    ref = {(r["arch"], r["shape"], r["multi_pod"]): r for r in json.loads(
        (ROOT / "scripts" / "dryrun_reference.json").read_text())}[
        ("qwen3-4b", "decode_32k", False)]
    temp = row["memory"]["temp_size_bytes"]
    assert abs(temp - DECODE_TEMP_READING) <= READING_REL * \
        DECODE_TEMP_READING, temp
    assert temp < 0.1 * ref["memory"]["temp_size_bytes"]
    got = row["memory"]["argument_size_bytes"]
    want = ref["memory"]["argument_size_bytes"]
    assert want <= got < want + ALLOC_UNIT * 64, (got, want)


def _within(bounds, got, want) -> bool:
    lo, hi = bounds
    return want > 0 and lo <= got / want <= hi


def _total_ok(got, want, reading) -> bool:
    if reading is None:
        return want > 0 and abs(got - want) <= REF_REL * want
    return abs(got - reading) <= READING_REL * reading


def _gate(one, ref, arch, shape):
    """(the pairs, the unpaired ones of the residual stream's bytes or
    more, the port's all-reduce bytes, the reference program's, whether
    the total lies in its window)."""
    from repro_torch.configs import get_config, get_shape
    from repro_torch.launch.collectives import (pair_with_reference,
                                                residual_bytes)
    rows = pair_with_reference(
        one["collectives"], ref["collectives"],
        residual_bytes(get_config(arch), get_shape(shape)))
    unpaired = [r for r in rows if r["gated"] and r["ref"] is None]
    got = one["collective_bytes"].get("all-reduce", 0)
    want = ref["collective_bytes_program"].get("all-reduce", 0)
    reading = PORT_READINGS.get((arch, shape))
    return rows, unpaired, got, want, _total_ok(got, want, reading)


def _check_pairs(port, ref, arch, shape):
    rows, unpaired, got, want, ok = _gate(port["one_layer"], ref, arch,
                                          shape)
    assert any(r["gated"] for r in rows)
    assert not unpaired and ok, (unpaired, got, want, rows)
    # known-bad controls: one rank's count doubled, the collective left
    # out; the lookup's rows summed in f32 before the cast
    reading = PORT_READINGS.get((arch, shape))
    assert not _total_ok(2 * got, want, reading)
    assert not _total_ok(0, want, reading)
    _, unpaired, _, _, ok = _gate(port["f32_lookup"], ref, arch, shape)
    assert unpaired and not ok, unpaired


@pytest.mark.parametrize("shape", FULL_SHAPES)
def test_flops_and_collectives_match_reference(runs, shape):
    port = runs[f"port qwen3-4b {shape}"]
    ref = runs[f"ref qwen3-4b {shape}"]
    got, want = port["one_layer"]["flops_per_device"], ref["flops"]
    bounds = FLOPS_BOUNDS[shape]
    assert _within(bounds, got, want), (got, want)
    # known-bad controls: one rank's count doubled, the work left out
    assert not _within(bounds, 2 * got, want)
    assert not _within(bounds, 0, want)
    # the full row counts every layer where the reference counts one
    assert port["flops_per_device"] > 10 * got
    _check_pairs(port, ref, "qwen3-4b", shape)


def test_llama_collectives_pair_with_reference(runs):
    """llama3-8b train_4k at one layer: 8 kv heads over 16 ranks."""
    _check_pairs(runs[f"port {PAIR_ARCH} train_4k"],
                 runs[f"ref {PAIR_ARCH} train_4k"], PAIR_ARCH, "train_4k")


def _reference(arch, shape):
    """The reference's row on 16 x 16 (``scripts/dryrun_reference.json``)."""
    return {(r["arch"], r["shape"], r["multi_pod"]): r for r in json.loads(
        (ROOT / "scripts" / "dryrun_reference.json").read_text())}[
        (arch, shape, False)]


def _temp_ok(temp, ref) -> bool:
    return TEMP_RATIO_FLOOR <= temp / ref["memory"]["temp_size_bytes"] \
        <= TEMP_RATIO


def test_moe_prefill_full_width_matches_reference(runs):
    """deepseek-v2-236b prefill_32k, all 60 layers on 16 x 16: nothing
    replicated (MLA on each rank's heads, the dispatch placed as GSPMD
    places it), the reference's argument bytes but for the port's 512-byte
    rounding, temp within [0.5, 2] x the reference's.  Refused: a trace
    that lost its storages (no temp), the temp of torch 2.11's trace
    before (MLA's scores of every head on every rank: 8.43 x)."""
    arch, shape = MOE_FULL
    row, ref = runs[f"moe {arch}"]["full"], _reference(arch, shape)
    assert row["replicated"] == []
    got = row["memory"]["argument_size_bytes"]
    want = ref["memory"]["argument_size_bytes"]
    assert want <= got < want + ALLOC_UNIT * row["n_leaves"], (got, want)
    temp = row["memory"]["temp_size_bytes"]
    assert _temp_ok(temp, ref), (row["memory"], ref["memory"])
    assert not _temp_ok(0, ref) and not _temp_ok(MOE_TEMP_BEFORE, ref)


def test_moe_train_temp_holds_its_reading(runs):
    """deepseek-v2-236b train_4k, all 60 layers on 16 x 16: nothing
    replicated, the reference's argument bytes but for the port's 512-byte
    rounding, the temp within ``READING_REL`` of its reading and within
    [0.5, 2] x the reference's taken at its program's dtypes
    (``MOE_TRAIN_REF_PROGRAM_TEMP``).  Refused: a trace that lost its
    storages (no temp) and the temp of torch 2.11's trace before the MoE
    family's placements."""
    arch, shape = MOE_TRAIN_FULL
    row, ref = runs["moe train"]["full"], _reference(arch, shape)
    assert row["replicated"] == []
    got = row["memory"]["argument_size_bytes"]
    want = ref["memory"]["argument_size_bytes"]
    assert want <= got < want + ALLOC_UNIT * row["n_leaves"], (got, want)

    def ok(temp):
        return (abs(temp - MOE_TRAIN_TEMP_READING)
                <= READING_REL * MOE_TRAIN_TEMP_READING
                and TEMP_RATIO_FLOOR
                <= temp / MOE_TRAIN_REF_PROGRAM_TEMP <= TEMP_RATIO)
    assert ok(row["memory"]["temp_size_bytes"]), row["memory"]
    assert not ok(0) and not ok(MOE_TRAIN_TEMP_BEFORE)
    assert MOE_TRAIN_REF_PROGRAM_TEMP < ref["memory"]["temp_size_bytes"]


def _moe_gate(row, arch, shape):
    """(the unpaired gated collectives, whether the all-reduce and the
    all-gather totals lie in their windows) of a one-lead-one-MoE row."""
    ref = _reference(arch, shape)
    _, unpaired, _, _, ok = _gate(row, ref, arch, shape)
    got = row["collective_bytes"].get("all-gather", 0)
    want = ref["collective_bytes_program"].get("all-gather", 0)
    return unpaired, ok and _total_ok(got, want, None)


@pytest.mark.parametrize("shape", FULL_SHAPES)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_flops_and_collectives_match_reference(runs, arch, shape):
    """One lead and one MoE layer on 16 x 16: nothing replicated; FLOPs a
    device within ``MOE_FLOPS_BOUNDS`` of the reference's; each collective
    of the residual stream's bytes or more paired with one of the
    reference program's (the router's probabilities all-gathered, the
    dispatched rows and the experts' results all-reduced, (T k, d) in
    bf16), the all-reduce bytes within ``REF_REL`` of the program's or at
    the reading, the all-gather bytes within ``REF_REL``.  Refused: the
    count doubled or left out, and the dispatch and MLA before their
    placements (their whole-tensor gathers pair with nothing)."""
    got = runs[f"moe {arch}"]
    now, bad = got[f"now {shape}"], got[f"before {shape}"]
    ref = _reference(arch, shape)
    assert now["replicated"] == [] and bad["replicated"]
    want = ref["flops"]
    assert _within(MOE_FLOPS_BOUNDS, now["flops_per_device"], want), \
        (now["flops_per_device"], want)
    assert not _within(MOE_FLOPS_BOUNDS, 2 * now["flops_per_device"], want)
    assert not _within(MOE_FLOPS_BOUNDS, 0, want)
    unpaired, ok = _moe_gate(now, arch, shape)
    assert not unpaired and ok, (unpaired, now["collective_bytes"],
                                 ref["collective_bytes_program"])
    reading = PORT_READINGS.get((arch, shape))
    ar = now["collective_bytes"]["all-reduce"]
    want = ref["collective_bytes_program"]["all-reduce"]
    assert not _total_ok(2 * ar, want, reading)
    assert not _total_ok(0, want, reading)
    unpaired, ok = _moe_gate(bad, arch, shape)
    assert unpaired and not ok, unpaired


# ---- (c) --------------------------------------------------------------------

def _mask_bias_before(q_pos, k_pos, causal, window, dtype):
    diff = q_pos[..., :, None] - k_pos[..., None, :]
    ok = torch.ones(diff.shape, dtype=torch.bool, device=diff.device)
    if causal:
        ok &= diff >= 0
    if window:
        ok &= diff < window
    return torch.where(ok, 0.0, -1e30).to(dtype)


def attention_scores_before(q, k, v, q_pos, k_pos, *, causal, window,
                            kv_groups):
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    q = q.reshape(B, Sq, KV, kv_groups, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", q, k).float()
    scores = scores / math.sqrt(hd)
    bias = _mask_bias_before(q_pos, k_pos, causal, window, torch.float32)
    bias = bias.reshape(bias.shape[:-2] + (1,) * (scores.dim() - bias.dim())
                        + bias.shape[-2:])
    probs = torch.softmax(scores + bias, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v)
    return out.reshape(B, Sq, H, hd)


def ce_before(logits, labels, mask=None):
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1, keepdim=True)
    gold = torch.gather(logits, -1, labels[..., None].long())
    nll = (logz - gold)[..., 0]
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / mask.sum().clamp(min=1.0)


# (B, Sq, Sk, H, KV, hd, causal, window): prefill, a windowed prefill with
# a query chunk behind its keys, and a decode step over a longer cache
ATTN_SHAPES = ((2, 16, 16, 8, 2, 32, True, 0),
               (1, 8, 24, 6, 3, 16, True, 5),
               (3, 1, 40, 4, 1, 64, True, 0))
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _leaves(shape, dtype, rng):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) \
        .to(dtype).requires_grad_(True)


def _grads(fn, *inputs):
    out = fn(*inputs)
    g = torch.from_numpy(np.random.default_rng(7).standard_normal(
        tuple(out.shape)).astype(np.float32)).to(out.dtype)
    grads = torch.autograd.grad(out, inputs, g)
    return out.detach(), grads


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", range(len(ATTN_SHAPES)))
def test_attention_bits_unchanged(case, dtype):
    B, Sq, Sk, H, KV, hd, causal, window = ATTN_SHAPES[case]
    dt = DTYPES[dtype]
    rng = np.random.default_rng(case)
    q = _leaves((B, Sq, H, hd), dt, rng)
    k = _leaves((B, Sk, KV, hd), dt, rng)
    v = _leaves((B, Sk, KV, hd), dt, rng)
    q_pos = torch.arange(Sk - Sq, Sk)[None].expand(B, Sq)
    k_pos = torch.arange(Sk)[None].expand(B, Sk)
    kw = dict(causal=causal, window=window, kv_groups=H // KV)
    outs = [_grads(lambda *a: fn(*a, q_pos, k_pos, **kw), q, k, v)
            for fn in (L.attention_scores, attention_scores_before)]
    (out, grads), (out0, grads0) = outs
    assert out.dtype == dt and torch.equal(out, out0)
    for g, g0 in zip(grads, grads0):
        assert torch.equal(g, g0)


# (B, S, V, masked)
CE_SHAPES = ((2, 16, 64, False), (3, 7, 50, True), (1, 33, 128, False))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", range(len(CE_SHAPES)))
def test_loss_bits_unchanged(case, dtype):
    Bc, Sc, Vc, masked = CE_SHAPES[case]
    rng = np.random.default_rng(10 + case)
    logits = _leaves((Bc, Sc, Vc), DTYPES[dtype], rng)
    labels = torch.from_numpy(rng.integers(0, Vc, (Bc, Sc))).to(torch.int32)
    mask = (torch.from_numpy(rng.integers(0, 2, (Bc, Sc))).bool()
            if masked else None)
    outs = [_grads(lambda x: fn(x, labels, mask), logits)
            for fn in (R._ce, ce_before)]
    (loss, (g,)), (loss0, (g0,)) = outs
    assert torch.equal(loss, loss0) and torch.equal(g, g0)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_embed_bits_unchanged(dtype):
    """The lookup casts the rows it gathered (each rank's, before the sum
    over the vocab's ranks, on DTensors): on plain tensors the output and
    the table's f32 gradient keep the bits of the gather, then cast."""
    rng = np.random.default_rng(30)
    table = _leaves((50, 16), torch.float32, rng)
    tokens = torch.from_numpy(rng.integers(0, 50, (3, 11))).to(torch.int32)
    cfg = types.SimpleNamespace()
    outs = [_grads(lambda w: fn(w), table) for fn in (
        lambda w: L.embed({"embedding": w}, cfg, tokens, DTYPES[dtype]),
        lambda w: w[tokens].to(DTYPES[dtype]))]
    (out, (g,)), (out0, (g0,)) = outs
    assert out.dtype == DTYPES[dtype] and torch.equal(out, out0)
    assert g.dtype == torch.float32 and torch.equal(g, g0)


# serving's unembedding: bf16 activations against an f32 table over two
# vocab blocks and a ragged third, tied and not
UNEMBED_V = 2 * L.VOCAB_BLOCK + 7


@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
def test_unembed_bits_unchanged(tied):
    """Without a gradient the table is cast a vocab block at a time; the
    logits keep the bits of the one cast and product before."""
    rng = np.random.default_rng(20)
    x = torch.from_numpy(rng.standard_normal((2, 9, 64)).astype(
        np.float32)).to(torch.bfloat16)
    shape = (UNEMBED_V, 64) if tied else (64, UNEMBED_V)
    w = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    p = {"embedding" if tied else "unembed": w}
    cfg = types.SimpleNamespace(tie_embeddings=tied)
    with torch.no_grad():
        got = L.unembed(p, cfg, x)
    cast = w.to(torch.bfloat16)
    want = x @ (cast.T if tied else cast)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


# the MoE dispatch and MLA's prefill (a small deepseek-v2): moe_ffn with a
# shared expert at capacity factors that drop assignments (0.25) and drop
# none (64); MLA on both query branches (q_lora_rank 0 and 12), causal and
# windowed, with q_chunks
MOE_CFG = dict(d_model=32, num_heads=4, nope_head_dim=8, rope_head_dim=4,
               kv_lora_rank=16, q_lora_rank=0, num_experts=8, top_k=2,
               moe_d_ff=24, num_shared_experts=1)
MOE_FACTORS = (0.25, 64.0)
MOE_S = 48
MLA_CASES = ((0, 0, 1), (12, 0, 3), (12, 5, 4))     # (q_lora, window, chunks)


def _moe_cfg(**kw):
    from repro_torch.configs import get_config
    return get_config("deepseek-v2-236b").reduced().replace(**dict(MOE_CFG,
                                                                   **kw))


def _tree_leaves(p, dtype, rng):
    """``p``'s leaves redrawn from ``rng`` (the norms near one) as leaves
    that want a gradient, in order, and a function that rebuilds ``p``."""
    keys, leaves = [], []
    for k, v in sorted(p.items()):
        for kk, vv in (sorted(v.items()) if isinstance(v, dict)
                       else [(None, v)]):
            keys.append((k, kk))
            t = rng.standard_normal(tuple(vv.shape)).astype(np.float32)
            if "norm" in k:
                t = 1 + t / 4
            else:
                t = t / np.sqrt(vv.shape[-2] if vv.dim() > 1 else 1)
            leaves.append(torch.from_numpy(t).to(dtype).requires_grad_(True))

    def build(*ts):
        out = {}
        for (k, kk), t in zip(keys, ts):
            if kk is None:
                out[k] = t
            else:
                out.setdefault(k, {})[kk] = t
        return out
    return leaves, build


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("factor", MOE_FACTORS)
def test_moe_bits_unchanged(factor, dtype):
    """The dispatch (its sort and aux loss now shared with the dry-run's
    local form) keeps the bits of the code before, forward and backward,
    its weights f32 and the activations in ``dtype``."""
    import torch_moe_before as before
    from repro_torch.models import moe as MOE
    cfg = _moe_cfg()
    rng = np.random.default_rng(40)
    p = MOE.init_moe_ffn(torch.Generator().manual_seed(0), cfg,
                         device="cpu")
    leaves, build = _tree_leaves(p, torch.float32, rng)
    x = _leaves((2, MOE_S, cfg.d_model), DTYPES[dtype], rng)
    _, _, ids = MOE.route(build(*leaves), cfg, x.reshape(-1, cfg.d_model))
    C = MOE.moe_capacity(ids.shape[0], cfg.num_experts, cfg.top_k, factor)
    _, _, valid, _ = MOE._assignments(ids, cfg.num_experts, C)
    assert (not valid.all()) == (factor < 1)       # drops at 0.25 only
    outs = []
    for fn in (MOE.moe_ffn, before.moe_ffn):
        got, aux = fn(build(*leaves), cfg, x, capacity_factor=factor)
        g = torch.from_numpy(np.random.default_rng(7).standard_normal(
            tuple(got.shape)).astype(np.float32)).to(got.dtype)
        grads = torch.autograd.grad((got.float() * g.float()).sum()
                                    + 3 * aux, [x] + leaves)
        outs.append((got.detach(), aux.detach(), grads))
    (out, aux, grads), (out0, aux0, grads0) = outs
    assert out.dtype == DTYPES[dtype]
    assert torch.equal(out, out0) and torch.equal(aux, aux0)
    for g, g0 in zip(grads, grads0):
        assert torch.equal(g, g0)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", range(len(MLA_CASES)))
def test_mla_bits_unchanged(case, dtype):
    """MLA's prefill (its expanded core now a function the dry-run's
    local region calls) keeps the bits of the code before, forward and
    backward."""
    import torch_moe_before as before
    from repro_torch.models import moe as MOE
    q_lora, window, chunks = MLA_CASES[case]
    cfg = _moe_cfg(q_lora_rank=q_lora)
    rng = np.random.default_rng(50 + case)
    p = MOE.init_mla(torch.Generator().manual_seed(0), cfg, device="cpu")
    leaves, build = _tree_leaves(p, torch.float32, rng)
    x = _leaves((2, 12, cfg.d_model), DTYPES[dtype], rng)
    pos = torch.arange(12)[None].expand(2, 12)
    outs = [_grads(lambda *a: fn(build(*a[1:]), cfg, a[0], pos,
                                 window=window, q_chunks=chunks)[0],
                   x, *leaves)
            for fn in (MOE.mla_attention, before.mla_attention)]
    (out, grads), (out0, grads0) = outs
    assert out.dtype == DTYPES[dtype] and torch.equal(out, out0)
    for g, g0 in zip(grads, grads0):
        assert torch.equal(g, g0)


# ---- (d) ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def world():
    [res, *_] = run_world(4, spmd_case)
    return res


@pytest.mark.parametrize("name", ["token_nll", "take_rows",
                                  "take_rows_bf16", "attention",
                                  "attention_remat", "attention_block",
                                  "moe", "moe_drop", "mla",
                                  "scan", "recurrent", "step", "unembed"])
def test_local_regions_compute_the_plain_route(world, name):
    got = world[name]
    assert len(got["split"]) == len(got["plain"])
    for a, b in zip(got["split"], got["plain"]):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["take_rows f32", "take_rows bf16",
                                  "attention f32", "attention bf16"])
def test_repairs_keep_the_bits(world, name):
    """The lookup's rows cast before the vocab's reduction, and the kv
    slice's gradient left partial, against the routes before them on the
    same DTensors: outputs and gradients bit for bit."""
    now, before = world["bits"][name]
    assert len(now) == len(before)
    for a, b in zip(now, before):
        assert a.shape == b.shape and np.array_equal(a, b)
