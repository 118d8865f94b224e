"""The dry-run (``repro_torch.launch.dryrun``, ``ep_dryrun``,
``fl_dryrun``) on fake worlds of 2 x 2 and 2 x 2 x 2 ranks.

* Every arch at its reduced config on a reduced shape of each kind
  (train, prefill, decode) on 2 x 2, and on 2 x 2 x 2 every arch's
  decode step and a dense and an MoE arch's train and prefill steps
  (qwen3-4b, kimi-k2: DTensor's sharding propagation takes some 130 s
  for the other train and prefill steps there on the CPU, and the card's
  host runs them at full width): each row has the reference's
  keys where they have a counterpart (``dryrun.py:76-104``), the skip row
  for encoder-only decode, and ``params`` and ``active_params`` equal the
  reference's ``param_count()`` and ``active_param_count()``.
* ``argument_size_bytes`` of qwen3-4b's reduced train step on 2 x 2:
  the sum over its shards, written out leaf by leaf below.
* Its ``flops`` against the matrix products written out from the
  config's shapes: the forward F, the backward 2F, and with remat each
  layer's forward again but its last product (``torch.utils.checkpoint``
  stops recomputing once the saved tensors are back); rank 0 computes a
  quarter of it.
* At one rank, the dry-run's arguments, FLOPs and peak against a real
  step of the same config on the CPU, traced by ``StepTrace`` over its
  CPU storages (the chip check holds it against the card's allocator).
* An injected failure gives an ``error`` row and exit code 1;
  ``--donate`` is refused; the EP and FL dry-runs print their rows.
* No new module imports JAX or the JAX package.

Each world runs in a subprocess: a fake world takes its process's default
process group.
"""
import ast
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

from repro.configs import ARCHS as JARCHS

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
KINDS = ("train_4k", "prefill_32k", "decode_32k")
MESHES = ("2x2", "2x2x2")
# the archs whose train and prefill steps are traced on 2 x 2 x 2
FOLDED_ARCHS = ("qwen3-4b", "kimi-k2-1t-a32b")
REF_KEYS = ("arch", "shape", "multi_pod", "rules", "mesh_shape",
            "num_devices", "window", "q_chunks", "capacity_factor", "remat",
            "cache_len", "lower_s", "flops", "bytes_accessed",
            "collective_bytes", "memory", "params", "active_params",
            "skipped")
NEW_MODULES = ["src/repro_torch/launch/specs.py",
               "src/repro_torch/launch/collectives.py",
               "src/repro_torch/launch/dryrun.py",
               "src/repro_torch/launch/ep_dryrun.py",
               "src/repro_torch/launch/fl_dryrun.py",
               "src/repro_torch/launch/mesh.py"]

# each run: (name, mesh flags, [(arch or "all", shape), ...])
RUNS = (("2x2", ["--mesh", "2x2"], [("all", "train_4k")]),
        ("2x2_serve", ["--mesh", "2x2"], [("all", k) for k in KINDS[1:]]),
        ("2x2x2", ["--mesh", "2x2x2", "--multi-pod"],
         [("all", "decode_32k")] + [(a, k) for a in FOLDED_ARCHS
                                    for k in KINDS[:2]]))

ROWS_SCRIPT = textwrap.dedent("""
    import json, sys
    from repro_torch.launch import dryrun
    out, plan, extra = sys.argv[1], json.loads(sys.argv[2]), sys.argv[3:]
    rows, rc = [], 0
    for i, (arch, shape) in enumerate(plan):
        path = f"{out}.{i}"
        rc |= dryrun.main(["--arch", arch, "--shape", shape, "--reduced",
                           "--out", path] + extra)
        rows += json.load(open(path))
    json.dump({"rc": rc, "rows": rows}, open(out, "w"))
""")

# the dry-run at one rank against a real step on the CPU
ONE_RANK_SCRIPT = textwrap.dedent("""
    import json
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.collectives import StepTrace
    from repro_torch.launch.dryrun import dryrun_one
    from repro_torch.launch.steps import make_optimizer, make_train_step
    from repro_torch.launch.train import make_batch
    from repro_torch.models import registry as R

    cfg = get_config("qwen3-4b").reduced().replace(dtype="float32")
    shape = ShapeConfig("t", 64, 2, "train")
    out = {}
    for remat in (False, True):
        c = cfg.replace(remat=remat)
        row = dryrun_one("qwen3-4b", "t", cfg=c, shape=shape,
                         mesh_shape=(1, 1), remat=remat, verbose=False)
        opt = make_optimizer()
        params = R.init_params(0, c, device="cpu")
        state = opt.init(params)
        batch = make_batch(c, 2, 64, device="cpu")
        batch["tokens"] = batch["tokens"].to(torch.int32)
        trace = StepTrace(device="cpu")
        held = trace.hold([params, state, batch])
        with trace, FlopCounterMode(display=False) as fc:
            make_train_step(c, opt)(params, state, batch)
        out[str(remat)] = dict(row=row, held=held, peak=trace.peak_bytes,
                               flops=fc.get_total_flops())
    print(json.dumps(out))
""")

INJECTED_SCRIPT = textwrap.dedent("""
    import sys
    from repro_torch.launch import dryrun

    def broken(*a, **k):
        raise RuntimeError("injected")
    dryrun.make_train_step = broken
    sys.exit(dryrun.main(sys.argv[1:]))
""")


def _env():
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("XLA_FLAGS", None)
    return env


def _start(args, tmp, name):
    """A subprocess whose output goes to files (pipes would fill while
    another run is waited for)."""
    out = open(tmp / f"{name}.out", "w")
    err = open(tmp / f"{name}.err", "w")
    with out, err:
        return subprocess.Popen([sys.executable] + args, env=_env(),
                                stdout=out, stderr=err, text=True)


def _finish(proc, tmp, name, timeout=600):
    proc.wait(timeout=timeout)
    return (proc.returncode, (tmp / f"{name}.out").read_text(),
            (tmp / f"{name}.err").read_text())


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every run of this file, started at once: the rows of each mesh,
    the one-rank comparison, the injected failure, ``--donate``, a
    no-remat train row, and the EP and FL dry-runs."""
    tmp = tmp_path_factory.mktemp("dryrun")
    runs = {name: ["-c", ROWS_SCRIPT, str(tmp / f"{name}.json"),
                   json.dumps(plan)] + flags for name, flags, plan in RUNS}
    runs["one_rank"] = ["-c", ONE_RANK_SCRIPT]
    runs["injected"] = [
        "-c", INJECTED_SCRIPT, "--arch", "qwen3-4b", "--shape", "all",
        "--reduced", "--mesh", "2x2", "--out", str(tmp / "injected.json")]
    runs["donate"] = ["-m", "repro_torch.launch.dryrun", "--arch",
                      "qwen3-4b", "--shape", "train_4k", "--donate"]
    runs["no_remat"] = [
        "-m", "repro_torch.launch.dryrun", "--arch", "qwen3-4b", "--shape",
        "train_4k", "--reduced", "--mesh", "2x2", "--no-remat", "--out",
        str(tmp / "no_remat.json")]
    runs["ep"] = ["-m", "repro_torch.launch.ep_dryrun", "--reduced",
                  "--mesh", "2x2", "--out", str(tmp / "ep.json")]
    runs["fl"] = ["-m", "repro_torch.launch.fl_dryrun", "--mesh", "2x2x1",
                  "--multi-pod", "--layers", "2", "--d-model", "64",
                  "--seq", "32", "--batch", "2", "--local-iters", "2",
                  "--out", str(tmp / "fl.json")]
    procs = {k: _start(a, tmp, k) for k, a in runs.items()}
    done = {k: _finish(p, tmp, k) for k, p in procs.items()}
    for name, _, _ in RUNS:
        rc, _, err = done[name]
        assert rc == 0, err[-3000:]
        done[name] = json.loads((tmp / f"{name}.json").read_text())
    done["2x2"]["rows"] += done.pop("2x2_serve")["rows"]
    done["tmp"] = tmp
    return done


def _row(rows, arch, shape):
    [row] = [r for r in rows if r["arch"] == arch and r["shape"] == shape]
    return row


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(JARCHS))
def test_every_arch_traces(worlds, mesh, arch):
    res = worlds[mesh]
    assert res["rc"] == 0
    want = JARCHS[arch].reduced()
    shape = [int(n) for n in mesh.split("x")]
    for kind in KINDS:
        if mesh == "2x2x2" and kind != "decode_32k" and \
                arch not in FOLDED_ARCHS:
            continue
        row = _row(res["rows"], arch, kind)
        assert "error" not in row, row
        if row["skipped"]:
            assert kind == "decode_32k" and not want.causal
            assert row["reason"] == ("encoder-only has no decode step "
                                     "(DESIGN.md)")
            continue
        assert set(REF_KEYS) <= set(row)
        assert row["mesh_shape"] == shape
        assert row["num_devices"] == 2 ** len(shape)
        assert row["multi_pod"] == (len(shape) == 3)
        assert row["params"] == want.param_count()
        assert row["active_params"] == want.active_param_count()
        mem = row["memory"]
        assert mem["argument_size_bytes"] > 0
        assert mem["peak_size_bytes"] == (mem["argument_size_bytes"]
                                          + mem["temp_size_bytes"])
        assert row["flops"] > 0 and row["flops_per_device"] > 0
        coll = row["collective_bytes"]
        assert coll["total"] == sum(v for k, v in coll.items()
                                    if k not in ("total", "_counts"))
        assert "compile_s" not in row


# qwen3-4b reduced: d 256, 4 heads of 64 (and 4 kv heads), d_ff 512,
# vocab 512, 2 layers, f32 params; train_4k reduced: B 4 x S 128 tokens
D, H, HD, FF, V, L, B, S = 256, 4, 64, 512, 512, 2, 4, 128
# each leaf's shard on the 2 x 2 (data, model) mesh, in elements: vocab,
# heads, kv heads and the MLP width split over "model" (2), the norms
# replicated
PARAM_SHARDS = {
    "embed/embedding": 512 // 2 * D, "embed/unembed": D * 512 // 2,
    "final_norm": D, "layers/attn/k_norm": L * HD, "layers/attn/q_norm":
    L * HD, "layers/attn/wk": L * D * H // 2 * HD, "layers/attn/wo":
    L * H // 2 * HD * D, "layers/attn/wq": L * D * H // 2 * HD,
    "layers/attn/wv": L * D * H // 2 * HD, "layers/ffn/w1": L * D * FF // 2,
    "layers/ffn/w2": L * FF // 2 * D, "layers/ffn/w3": L * D * FF // 2,
    "layers/ln1": L * D, "layers/ln2": L * D}


def _alloc(nbytes):
    return -(-nbytes // 512) * 512


def test_argument_bytes_are_the_shards(worlds):
    row = _row(worlds["2x2"]["rows"], "qwen3-4b", "train_4k")
    params = sum(_alloc(4 * n) for n in PARAM_SHARDS.values())
    # AdamW's m and v have the params' shards in f32; its step is an int32
    # scalar; the tokens (B, S) int32 split over "data"
    tokens = _alloc(4 * B // 2 * S)
    want = 3 * params + _alloc(4) + tokens
    assert row["memory"]["argument_size_bytes"] == want


def _matmul_flops():
    """(forward FLOPs, one layer's forward, its last product) of qwen3-4b
    reduced over B x S tokens, as FlopCounterMode counts them (2 m n k)."""
    T = B * S
    qkv = 3 * 2 * T * D * H * HD
    attn = 2 * (2 * B * H * S * S * HD)          # scores and probs @ v
    out = 2 * T * H * HD * D
    mlp = 3 * 2 * T * D * FF
    layer = qkv + attn + out + mlp
    return L * layer + 2 * T * D * V, layer, 2 * T * FF * D


def test_dense_train_flops_written_out(worlds):
    fwd, layer, last = _matmul_flops()
    rc, _, err = worlds["no_remat"]
    assert rc == 0, err[-2000:]
    [row] = json.loads((worlds["tmp"] / "no_remat.json").read_text())
    assert row["flops"] == 3 * fwd
    assert row["flops_per_device"] == 3 * fwd / 4
    remat = _row(worlds["2x2"]["rows"], "qwen3-4b", "train_4k")
    assert remat["remat"] and not row["remat"]
    assert remat["flops"] == 3 * fwd + L * (layer - last)
    assert remat["flops_per_device"] == remat["flops"] / 4
    prefill = _row(worlds["2x2"]["rows"], "qwen3-4b", "prefill_32k")
    assert prefill["flops"] == fwd


def test_one_rank_matches_a_real_step(worlds):
    rc, out, err = worlds["one_rank"]
    assert rc == 0, err[-3000:]
    for remat, r in json.loads(out.strip().splitlines()[-1]).items():
        row, mem = r["row"], r["row"]["memory"]
        assert mem["argument_size_bytes"] == r["held"]
        assert row["flops"] == row["flops_per_device"] == r["flops"]
        assert row["collective_bytes"]["total"] == 0
        # the same program: the live bytes differ by a few host-side
        # allocations' rounding at most
        assert abs(mem["peak_size_bytes"] - r["peak"]) <= 1e-3 * r["peak"]


def test_injected_failure_gives_error_row(worlds):
    rc, _, err = worlds["injected"]
    assert rc == 1
    assert "FAIL qwen3-4b train_4k: injected" in err
    rows = json.loads((worlds["tmp"] / "injected.json").read_text())
    by_shape = {r["shape"]: r for r in rows}
    assert by_shape["train_4k"] == {"arch": "qwen3-4b", "shape": "train_4k",
                                    "error": "RuntimeError('injected')",
                                    "skipped": False}
    assert all("error" not in r for s, r in by_shape.items()
               if s != "train_4k")


def test_donate_is_refused(worlds):
    rc, _, err = worlds["donate"]
    assert rc == 2
    assert "PyTorch has no buffer donation" in err


def test_ep_and_fl_rows(worlds):
    for name in ("ep", "fl"):
        rc, _, err = worlds[name]
        assert rc == 0, err[-3000:]
    ep = json.loads((worlds["tmp"] / "ep.json").read_text())
    assert ep["arch"] == "kimi-k2-1t-a32b" and ep["shape"] == "train_4k"
    for name in ("gspmd_dispatch", "explicit_ep"):
        assert {"lower_s", "collective_bytes", "temp_gb_per_dev"} \
            <= set(ep[name])
    assert ep["explicit_ep"]["collective_bytes"]["_counts"]["all-to-all"] \
        == 2
    fl = json.loads((worlds["tmp"] / "fl.json").read_text())
    assert fl["kind"] == "fl_round" and fl["mesh_shape"] == [2, 2, 1]
    assert fl["num_sats"] == 4
    # eq. 14's buffer, [every leaf | gamma | loss], over "pod" then "data"
    n = fl["per_sat_params"]
    assert fl["collective_bytes"] == {"all-reduce": 2 * (n + 2) * 4,
                                      "_counts": {"all-reduce": 2},
                                      "total": 2 * (n + 2) * 4}


@pytest.mark.parametrize("path", NEW_MODULES)
def test_no_jax_imports(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib", "repro"), \
                f"{path} imports {name}"
