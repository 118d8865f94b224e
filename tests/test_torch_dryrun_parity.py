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
    reference's own dry-run (``python -m repro.launch.dryrun``), each
    package in a process of its own: argument bytes equal but for the
    port's 512-byte rounding of each leaf, and the port's temp memory
    within [0.5, 2] x the reference's (a trace that loses storages would
    size a run too small).
(c) On plain tensors, attention and the loss give the same bits as the
    versions before the dry-run placed them (frozen below), forward and
    backward, at three GQA shapes in f32 and bf16.
(d) On a real 4-rank gloo world of the CPU, the dry-run's local regions
    (``models/spmd.py``: the vocab-parallel loss and lookup, attention
    on each rank's heads with 2 ranks over 1 kv head, the chunked and
    sequential scans and a decode step on each rank's heads) give the
    plain route's outputs and gradients, so the trace holds the same
    program.

The subprocesses of (a) and (b) start together in a module fixture.
"""
import json
import math
import os
import pathlib
import subprocess
import sys
import textwrap

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

# (b): the port's row and the number of tensors among its arguments
PORT_SCRIPT = textwrap.dedent("""
    import json, sys
    from repro_torch.configs import get_config, get_shape
    from repro_torch.launch.dryrun import dryrun_one, quiet_dtensor
    from repro_torch.launch.specs import (input_specs, opt_state_specs,
                                          param_specs)
    from repro_torch.tree import tree_leaves
    quiet_dtensor()
    arch, shape = sys.argv[1], sys.argv[2]
    row = dryrun_one(arch, shape, verbose=False)
    cfg, shp = get_config(arch), get_shape(shape)
    trees = [param_specs(cfg), input_specs(cfg, shp)]
    if shp.kind == "train":
        trees.append(opt_state_specs(cfg, trees[0]))
    row["n_leaves"] = sum(len(tree_leaves(t)) for t in trees)
    print(json.dumps(row))
""")


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=SRC, **extra)
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
    for shape in FULL_SHAPES:
        cmds[f"port {shape}"] = ([sys.executable, "-c", PORT_SCRIPT,
                                  "qwen3-4b", shape], _env())
        cmds[f"ref {shape}"] = (
            [sys.executable, "-m", "repro.launch.dryrun", "--arch",
             "qwen3-4b", "--shape", shape, "--out",
             str(tmp / f"ref_{shape}.json")], _env(JAX_PLATFORMS="cpu"))
    procs = {}
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
        if name.startswith("ref"):
            [row] = json.loads((tmp / f"ref_{name[4:]}.json").read_text())
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
    port, ref = runs[f"port {shape}"], runs[f"ref {shape}"]
    assert port["replicated"] == []
    got = port["memory"]["argument_size_bytes"]
    want = ref["memory"]["argument_size_bytes"]
    # each of the port's storages is rounded up to the allocator's unit
    assert want <= got < want + ALLOC_UNIT * port["n_leaves"], (got, want)
    ratio = (port["memory"]["temp_size_bytes"]
             / ref["memory"]["temp_size_bytes"])
    assert TEMP_RATIO_FLOOR <= ratio <= TEMP_RATIO, (port["memory"],
                                                     ref["memory"])


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


# ---- (d) ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def world():
    [res, *_] = run_world(4, spmd_case)
    return res


@pytest.mark.parametrize("name", ["token_nll", "take_rows", "attention",
                                  "attention_remat", "scan", "recurrent",
                                  "step"])
def test_local_regions_compute_the_plain_route(world, name):
    got = world[name]
    assert len(got["split"]) == len(got["plain"])
    for a, b in zip(got["split"], got["plain"]):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
