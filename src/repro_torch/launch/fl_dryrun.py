"""Dry-run of the constellation-parallel FL round (DESIGN.md §3), as the
JAX package's ``launch/fl_dryrun.py``: satellites on the data axis, J
local SGD steps each, the staleness-weighted all-reduce aggregation
(``fl/sharded.py``), on the production mesh.

    PYTHONPATH=src python -m repro_torch.launch.fl_dryrun [--multi-pod] \\
        [--sats-per-device 1] [--out out.json]

The per-satellite model is the qwen3-4b reduced config at ``--layers``
and ``--d-model``, as in the reference.  Like ``launch.dryrun`` this runs
on no device: the process starts a fake world of 256 (512) ranks, plays
rank 0, and traces its part of the round on meta tensors (global params,
batches and weights as every rank takes them; ``fl_round`` slices its
satellite block).  The loss is the plain route's (``impl="plain"``, the
reference's ``impl="xla"``).  The row holds the reference's keys but
``compile_s`` (nothing is compiled); ``lower_s`` is the trace's wall,
``collective_bytes`` rank 0's collectives (``launch.collectives``), the
memory figures rank 0's storages in the allocator's 512-byte units, and
``flops`` its local operations by ``FlopCounterMode``'s formulas.  The
reference's ring ``ppermute`` is not in the port's round (XLA drops it;
``fl/sharded.py``), so no ``collective-permute`` shows.

``--mesh DxM`` (or ``PxDxM`` with ``--multi-pod``) replaces the
production mesh by a smaller fake one (the CPU tests use it).
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time

import torch

from repro_torch.configs import get_config
from repro_torch.fl.sharded import make_fl_round
from repro_torch.launch.collectives import StepTrace, collective_bytes
from repro_torch.launch.dryrun import mesh_for, parse_mesh, quiet_dtensor
from repro_torch.launch.mesh import Mesh
from repro_torch.models import registry as R
from repro_torch.tree import tree_leaves


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--sats-per-device", type=int, default=1)
    ap.add_argument("--local-iters", type=int, default=4)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--mesh", type=parse_mesh, default=None,
                    help="a fake DxM (or, with --multi-pod, PxDxM) mesh "
                         "in place of the production one")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    quiet_dtensor()

    dm = mesh_for(args.mesh, multi_pod=args.multi_pod)
    mesh = Mesh.from_device_mesh(dm)
    n_sat_devices = mesh.size("data") * (mesh.size("pod") if args.multi_pod
                                         else 1)
    num_sats = n_sat_devices * args.sats_per_device

    cfg = get_config(args.arch).reduced().replace(
        remat=False, num_layers=args.layers, d_model=args.d_model,
        d_ff=args.d_model * 4, vocab_size=8192)

    def loss_fn(params, batch):
        loss, _ = R.train_loss(params, cfg, {"tokens": batch}, impl="plain")
        return loss

    fl_round = make_fl_round(
        loss_fn, mesh, local_iters=args.local_iters, lr=0.01,
        pod_axis="pod" if args.multi_pod else None)

    p_spec = R.init_params(0, cfg, device="meta")
    batches = torch.empty((num_sats, args.local_iters, args.batch, args.seq),
                          dtype=torch.int32, device="meta")
    weights = torch.empty((num_sats,), dtype=torch.float32, device="meta")

    trace = StepTrace()
    arg_bytes = trace.hold([p_spec, batches, weights])
    t0 = time.perf_counter()
    with trace:
        out = fl_round(p_spec, batches, weights)
    t_lower = time.perf_counter() - t0
    del out

    n_params = sum(math.prod(l.shape) for l in tree_leaves(p_spec))
    result = {
        "kind": "fl_round", "mesh_shape": list(mesh.shape),
        "num_sats": num_sats, "local_iters": args.local_iters,
        "per_sat_params": n_params,
        "lower_s": round(t_lower, 2),
        "flops": float(trace.flops),
        "collective_bytes": collective_bytes(trace.collectives),
        "temp_size_bytes": trace.peak_bytes - arg_bytes,
        "argument_size_bytes": arg_bytes,
    }
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
