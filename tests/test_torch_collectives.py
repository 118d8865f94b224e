"""Collective accounting of traced programs
(``repro_torch.launch.collectives``) against the JAX package's HLO
accounting (``repro.launch.hlo_analysis``).

* The counterparts of ``test_collective_parser`` and
  ``test_shape_bytes_tuple`` (``tests/test_launch.py``): collectives
  recorded by ``StepTrace`` on a fake world of 4 ranks, each counted by
  its output bytes on this rank (the parser's convention), results that
  are lists or tuples contributing every element; ``remat_duplication``
  counts the matrix products.
* ``make_fl_round`` and ``make_ep_moe_layer`` traced on 4 fake ranks,
  against the reference's ``collective_bytes`` of the same program
  compiled on 4 forced CPU devices.  The FL round's all-reduce is equal in
  bytes and count.  The port's differences are named where they are
  asserted: the two-axis FL round reduces over each axis in turn (two
  all-reduces of one buffer; XLA reduces over both at once); the EP
  layer's dispatch is one all-to-all of rows that carry their expert id
  (the reference's is two, ids and tokens, of the same bytes), and the
  port's layer hands every rank the whole output (an all-gather over
  "model", then "data", and a broadcast of data row 0's aux), where the
  reference's returns it sharded.  The EP layer runs in f32: XLA's CPU
  backend moves a bf16 all-to-all as f32, which would double the
  reference's bytes.

Both sides run in subprocesses: the fake world takes its process's default
group, and the reference needs its 4 forced devices before JAX starts.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

EP_MESHES = ((2, 2), (1, 4))
EP_B, EP_S = 4, 128
FL = dict(layers=2, d_model=64, seq=32, batch=2, iters=2)

PORT_SCRIPT = textwrap.dedent("""
    import json
    import torch
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    from repro_torch.configs import get_config
    from repro_torch.fl.sharded import make_fl_round
    from repro_torch.launch.collectives import (StepTrace, collective_bytes,
                                                remat_duplication)
    from repro_torch.launch.mesh import Mesh, make_fake_mesh
    from repro_torch.models import registry as R
    from repro_torch.models.moe_ep import make_ep_moe_layer

    EP_MESHES, EP_B, EP_S, FL = %r, %r, %r, %r
    out = {}

    def meta(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")

    # ---- the parser's cases, recorded ------------------------------------
    dm = make_fake_mesh((4, 1), ("data", "model"))
    g = dm.get_group("data")
    with StepTrace() as tr:
        funcol.all_gather_tensor(meta(2, 128, dtype=torch.bfloat16), 0, g)
        dist.all_reduce(meta(256), group=g)
        dist.reduce_scatter_tensor(meta(16, 16), meta(64, 16), group=g)
        funcol.all_reduce_coalesced([meta(16, 16), meta(4)], "sum", g)
        parts = [meta(3) for _ in range(4)]
        dist.all_gather(parts, meta(3), group=g)
        dist.send(meta(2, 2, dtype=torch.int32), dst=1)
        dist.recv(meta(100, dtype=torch.bool), src=1)
        torch.mm(meta(8, 8), meta(8, 8))
        torch.bmm(meta(2, 8, 8), meta(2, 8, 8))
    out["parser"] = collective_bytes(tr.collectives)
    out["ops"] = [[c.kind, c.op, c.nbytes] for c in tr.collectives]
    out["matmuls"] = remat_duplication(tr)

    # ---- the FL round ----------------------------------------------------
    cfg = get_config("qwen3-4b").reduced().replace(
        remat=False, num_layers=FL["layers"], d_model=FL["d_model"],
        d_ff=FL["d_model"] * 4, vocab_size=8192)

    def loss_fn(params, batch):
        return R.train_loss(params, cfg, {"tokens": batch},
                            impl="plain")[0]

    for name, shape, axes, pod in (
            ("fl", (4, 1), ("data", "model"), None),
            ("fl_pod", (2, 2, 1), ("pod", "data", "model"), "pod")):
        mesh = Mesh.from_device_mesh(make_fake_mesh(shape, axes))
        fl_round = make_fl_round(loss_fn, mesh, local_iters=FL["iters"],
                                 lr=0.01, pod_axis=pod)
        p = R.init_params(0, cfg, device="meta")
        with StepTrace() as tr:
            fl_round(p, meta(4, FL["iters"], FL["batch"], FL["seq"],
                             dtype=torch.int32), meta(4))
        out[name] = collective_bytes(tr.collectives)
    out["fl_params"] = sum(t.numel() for t in
                           torch.utils._pytree.tree_leaves(p))

    # ---- expert-parallel MoE ----------------------------------------------
    cfg = get_config("kimi-k2-1t-a32b").reduced().replace(dtype="float32")
    E, f, d = cfg.num_experts, cfg.moe_d_ff or cfg.d_ff, cfg.d_model
    for shape in EP_MESHES:
        mesh = Mesh.from_device_mesh(make_fake_mesh(shape,
                                                    ("data", "model")))
        p = {"router": meta(d, E), "we1": meta(E, d, f),
             "we3": meta(E, d, f), "we2": meta(E, f, d)}
        with StepTrace() as tr:
            make_ep_moe_layer(cfg, mesh)(p, meta(EP_B, EP_S, d))
        out["ep%%dx%%d" %% shape] = collective_bytes(tr.collectives)
    print(json.dumps(out))
""" % (EP_MESHES, EP_B, EP_S, FL))

REF_SCRIPT = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import json
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.fl.sharded import make_fl_round
    from repro.launch.hlo_analysis import collective_bytes
    from repro.models import registry as R
    from repro.models.moe_ep import make_ep_moe_layer

    EP_MESHES, EP_B, EP_S, FL = %r, %r, %r, %r
    SDS = jax.ShapeDtypeStruct
    out = {}
    cfg = get_config("qwen3-4b").reduced().replace(
        remat=False, num_layers=FL["layers"], d_model=FL["d_model"],
        d_ff=FL["d_model"] * 4, vocab_size=8192)

    def loss_fn(params, batch):
        return R.train_loss(params, cfg, {"tokens": batch})[0]

    p = jax.eval_shape(lambda k: R.init_params(k, cfg), SDS((2,), jnp.uint32))
    for name, shape, axes, pod in (
            ("fl", (4, 1), ("data", "model"), None),
            ("fl_pod", (2, 2, 1), ("pod", "data", "model"), "pod")):
        mesh = jax.make_mesh(shape, axes)
        fl_round = make_fl_round(loss_fn, mesh, local_iters=FL["iters"],
                                 lr=0.01, pod_axis=pod)
        hlo = jax.jit(fl_round).lower(
            p, SDS((4, FL["iters"], FL["batch"], FL["seq"]), jnp.int32),
            SDS((4,), jnp.float32)).compile().as_text()
        out[name] = collective_bytes(hlo)

    cfg = get_config("kimi-k2-1t-a32b").reduced().replace(dtype="float32")
    E, f, d = cfg.num_experts, cfg.moe_d_ff or cfg.d_ff, cfg.d_model
    p = {"router": SDS((d, E), jnp.float32), "we1": SDS((E, d, f), jnp.float32),
         "we3": SDS((E, d, f), jnp.float32), "we2": SDS((E, f, d), jnp.float32)}
    for shape in EP_MESHES:
        mesh = jax.make_mesh(shape, ("data", "model"))
        with mesh:
            hlo = jax.jit(lambda p, x: make_ep_moe_layer(cfg, mesh)(p, x)) \\
                .lower(p, SDS((EP_B, EP_S, d), jnp.float32)).compile().as_text()
        out["ep%%dx%%d" %% shape] = collective_bytes(hlo)
    print(json.dumps(out))
""" % (EP_MESHES, EP_B, EP_S, FL))


def _run(script):
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", script], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def port():
    return _run(PORT_SCRIPT)


@pytest.fixture(scope="module")
def ref():
    return _run(REF_SCRIPT)


def test_collective_parser(port):
    out = port["parser"]
    assert out["all-gather"] == 8 * 128 * 2 + 4 * 3 * 4
    assert out["all-reduce"] == 256 * 4 + 16 * 16 * 4 + 4 * 4
    assert out["reduce-scatter"] == 16 * 16 * 4
    assert out["collective-permute"] == 2 * 2 * 4 + 100
    assert out["_counts"] == {"all-gather": 2, "all-reduce": 2,
                              "reduce-scatter": 1, "collective-permute": 2}
    assert out["total"] == sum(v for k, v in out.items()
                               if k not in ("total", "_counts"))
    assert port["matmuls"] == 2.0


def test_shape_bytes_tuple(port):
    # a coalesced all-reduce (a tuple result) counts every element; the
    # all_gather into a list counts every part; pred[100] is 100 bytes
    ops = {op: n for _, op, n in port["ops"]}
    assert ops["_c10d_functional.all_reduce_coalesced"] == 16 * 16 * 4 + 4 * 4
    assert ops["c10d.allgather_"] == 4 * 3 * 4
    assert ops["c10d.recv_"] == 100


def test_fl_round_matches_reference(port, ref):
    n = port["fl_params"]
    assert port["fl"] == ref["fl"] == {
        "all-reduce": (n + 2) * 4, "_counts": {"all-reduce": 1},
        "total": (n + 2) * 4}


def test_fl_round_two_axes(port, ref):
    # the port reduces over "pod", then "data"; XLA over both at once
    want = ref["fl_pod"]
    assert want["_counts"] == {"all-reduce": 1}
    assert port["fl_pod"] == {
        "all-reduce": 2 * want["all-reduce"], "_counts": {"all-reduce": 2},
        "total": 2 * want["total"]}


@pytest.mark.parametrize("shape", EP_MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_ep_layer_matches_reference(port, ref, shape):
    nd, n = shape
    got, want = port["ep%dx%d" % shape], ref["ep%dx%d" % shape]
    # aux's mean over "model": one 4-byte all-reduce on both sides
    assert got["all-reduce"] == want["all-reduce"] == 4
    assert got["_counts"]["all-reduce"] == want["_counts"]["all-reduce"] == 1
    # dispatch and return: the same bytes; one all-to-all fewer in the port
    assert got["all-to-all"] == want["all-to-all"]
    assert got["_counts"]["all-to-all"] == want["_counts"]["all-to-all"] - 1
    # the port's whole output on every rank: the (B/nd, S, d) block
    # gathered over "model", then (B, S, d) over "data"; aux broadcast
    d = 256
    gathered = EP_B // nd * EP_S * d * 4 + (EP_B * EP_S * d * 4
                                            if nd > 1 else 0)
    assert got.get("all-gather", 0) == gathered
    assert got.get("broadcast", 0) == (4 if nd > 1 else 0)
    assert "all-gather" not in want and "broadcast" not in want
    assert got["total"] == want["total"] + gathered + got.get("broadcast", 0)
