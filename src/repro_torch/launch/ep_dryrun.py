"""Dry-run comparison, as the JAX package's ``launch/ep_dryrun.py``: the
sort-dispatch MoE layer (``models/moe.moe_ffn``) sharded by DTensor
against explicit expert parallelism (``models/moe_ep.py``: all-to-all
over the model axis) at production scale: one MoE layer of the given
arch at ``train_4k`` token counts on the 16 x 16 mesh.

    PYTHONPATH=src python -m repro_torch.launch.ep_dryrun \\
        --arch kimi-k2-1t-a32b [--out out.json]

Like ``launch.dryrun`` this runs on no device: the process starts a fake
world of 256 ranks, plays rank 0 and traces on meta tensors.

  * ``gspmd_dispatch``: ``moe_ffn`` on DTensors, the router replicated,
    the expert weights sharded over "model", the tokens over "data"; the
    dispatch runs as the reference's GSPMD program runs it
    (``spmd.experts_call``: the router's logits gathered whole, the (T k,
    d) rows and expert results all-reduced), the rest as DTensor's
    sharding propagation issues it (and any redistribution to
    ``Replicate`` where it has no sharding, as ``replicated`` names
    them).
  * ``explicit_ep``: ``make_ep_moe_layer`` over the fake world's groups;
    every rank takes the full params and tokens and its own block of each.
    Its expert buffers are sized for the busiest expert, which a meta
    tensor cannot tell: the trace sizes them for every received row on one
    expert, the most any data could need (``moe_ep._expert_ffn``).

Each row has the reference's keys but ``compile_s`` (nothing is
compiled): ``lower_s`` (the trace's wall), ``collective_bytes`` (rank 0's,
``launch.collectives``) and ``temp_gb_per_dev``: rank 0's traced peak
above the arguments (params and tokens), in GiB.  The reference divides
its per-device ``temp_size_in_bytes`` by the device count once more; this
is the per-device figure.  Added: ``flops_per_device`` (rank 0's local
operations, ``FlopCounterMode``'s formulas) and ``replicated``.

``--mesh DxM`` replaces the production mesh by a smaller fake one, and
``--reduced`` takes the arch's reduced config at the shape's reduced size
(the CPU tests use both).
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from repro_torch.configs import get_config, get_shape
from repro_torch.launch import sharding as sh
from repro_torch.launch.collectives import StepTrace, collective_bytes
from repro_torch.launch.dryrun import (distribute, mesh_for, parse_mesh,
                                      quiet_dtensor)
from repro_torch.launch.mesh import Mesh
from repro_torch.models import moe as MOE
from repro_torch.models.moe_ep import make_ep_moe_layer


def _trace(fn, args) -> dict:
    from torch.distributed.tensor.experimental import implicit_replication
    trace = StepTrace()
    arg_bytes = trace.hold(args)
    t0 = time.perf_counter()
    with trace, implicit_replication():
        out = fn(*args)
    wall = time.perf_counter() - t0
    del out
    return {"lower_s": round(wall, 2),
            "collective_bytes": collective_bytes(trace.collectives),
            "temp_gb_per_dev": round((trace.peak_bytes - arg_bytes) / 2**30,
                                     3),
            "flops_per_device": float(trace.flops),
            "replicated": sorted(set(trace.replicated))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="kimi-k2-1t-a32b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--mesh", type=parse_mesh, default=None,
                    help="a fake DxM mesh in place of the production one")
    ap.add_argument("--reduced", action="store_true",
                    help="the arch's reduced config at the shape's reduced "
                         "size")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    quiet_dtensor()

    cfg = get_config(args.arch)
    shape = get_shape(args.shape)
    if args.reduced:
        cfg, shape = cfg.reduced(), shape.reduced()
    dm = mesh_for(args.mesh)
    B, S, d = shape.global_batch, shape.seq_len, cfg.d_model
    E, f = cfg.num_experts, cfg.moe_d_ff or cfg.d_ff

    def meta(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")

    p_spec = {"router": meta(d, E), "we1": meta(E, d, f),
              "we3": meta(E, d, f), "we2": meta(E, f, d)}
    x_spec = meta(B, S, d, dtype=getattr(torch, cfg.dtype))

    # ---- sort dispatch, sharded by DTensor ----------------------------------
    specs = {"router": sh.PartitionSpec(),
             "we1": sh.PartitionSpec("model"),
             "we3": sh.PartitionSpec("model"),
             "we2": sh.PartitionSpec("model")}
    results = {}
    results["gspmd_dispatch"] = _trace(
        lambda p, x: MOE.moe_ffn(p, cfg, x),
        [distribute(p_spec, specs, dm),
         distribute(x_spec, sh.PartitionSpec("data", None, None), dm)])
    print("gspmd_dispatch", json.dumps(results["gspmd_dispatch"]),
          flush=True)

    # ---- explicit expert parallelism over the fake world's groups ----------
    layer = make_ep_moe_layer(cfg, Mesh.from_device_mesh(dm))
    results["explicit_ep"] = _trace(layer, [p_spec, x_spec])
    print("explicit_ep", json.dumps(results["explicit_ep"]), flush=True)

    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"arch": args.arch, "shape": args.shape, **results}, fh,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
