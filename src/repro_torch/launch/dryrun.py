"""Multi-pod dry-run, as the JAX package's ``launch/dryrun.py``: trace
every (arch x shape) step on the production mesh and extract roofline
inputs, with nothing allocated.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b \\
        --shape train_4k [--multi-pod] [--rules base|fsdp] [--out out.json]

Exit code 0 = every step traced; a failed (arch, shape) gives an
``error`` row and exit code 1.

What runs, and on what.  ``make_production_mesh`` starts a fake world of
256 (or 512) ranks in this process, which plays rank 0.  Parameters,
optimizer state, the batch and the decode cache are DTensors placed by
``launch.sharding`` (``placements(tree_shardings(...))``) whose local
shards are meta tensors: shapes and dtypes, no data.  This is the one
entry point of the port that runs on no device, not even the CPU, as the
reference's lowers ``ShapeDtypeStruct``s; it never initialises CUDA.
The step is ``launch.steps``' on the plain route (``impl="plain"``, the
reference's default ``impl="xla"``): the CUDA kernels read data pointers
and cannot take meta tensors.  So attention's FLOPs are the full,
unmasked products, as the reference's analytic count assumes ("as XLA
computes them").  DTensor propagates the sharding op by op, as GSPMD
does in the reference; where it has no sharding for an operation, the
operation's arguments are redistributed to ``Replicate`` and the
collectives show in the row (``replicated`` names those operations; see
``launch.collectives``).

On the multi-pod mesh DTensor traces over (pod x data, model), the same
512 ranks with "pod" folded into "data": on a 3-D mesh whose batch
dimension is split over two axes, DTensor's redistribution planner (torch
2.13) searches a graph for every candidate sharding of every operation,
and a reduced config's step did not finish in 40 s.  Where the rules
split a dimension over "pod" and "data" together (the batch, under
either rule set) the fold is exact; where they split one over "data"
alone (the KV cache's sequence at long_500k, FSDP's embed dimension) it
is split over the pods too, 32-way where the reference's is 16-way.

The row.  The reference's keys where they have a counterpart:

  * ``flops``: ``FlopCounterMode``'s formulas over the step's DTensor
    operations at their global shapes, and over the model's local regions
    (``models/spmd.py``) times the ranks that share them
    (``StepTrace.global_flops``), i.e. every traced layer whole (the
    reference's ``cost_analysis()`` counts a scanned layer once; a trace
    runs every layer); ``flops_per_device``: the same formulas over rank
    0's local operations;
  * ``bytes_accessed``: the bytes rank 0's local operations read and
    write (each operation's tensor arguments and outputs, views
    excluded): an eager program's traffic, with no fusion;
  * ``collective_bytes``: rank 0's collectives (``collective_bytes``);
    ``collectives``: each of them, in the order issued (kind, each
    output's type in HLO's notation, bytes, the group's ranks and the
    model line it follows: ``Collective.row``), which
    ``collectives.pair_with_reference`` pairs with the reference's;
  * ``memory``: per device, rank 0's storages in the caching allocator's
    512-byte units: ``argument_size_bytes`` (the shards of params,
    optimizer state, batch and cache), ``output_size_bytes`` (the
    outputs the step allocated), ``temp_size_bytes`` (the traced peak
    above the arguments) and ``peak_size_bytes`` (arguments + temp);
  * ``params``, ``active_params``: ``registry.analytic_param_count``;
  * ``lower_s``: the trace's wall seconds.

There is no ``compile_s``, ``generated_code_size_bytes`` or
``hlo_bytes``: nothing is compiled (the port runs eagerly), so there is
no program to time or measure.  Added: ``flops_per_device``,
``matmuls`` (``remat_duplication``), ``ops`` (local operations traced),
``peak_size_bytes``, ``replicated`` (each entry ending with the model's
line that issued the operation) and ``peak_holders`` (the sites that
hold the most bytes live at the peak: bytes, the operation and model
line that made the storages, and their count; ``StepTrace.holders``).

Flags that have no counterpart: ``--mesh DxM`` or ``PxDxM`` replaces the
production mesh by a smaller fake one, ``--reduced`` runs each arch's
reduced config on each shape's reduced size (the CPU tests use both).
``--donate`` is refused: PyTorch has no buffer donation.  The port's
steps return new tensors, and a caller's arguments live until it drops
them; the step would have to update in place to free them, which
``launch.steps`` does not do.
"""
from __future__ import annotations

import argparse
import json
import logging
import math
import sys
import time

import torch

from repro_torch.configs import (ARCHS, SHAPES, applicable, get_config,
                                 get_shape)
from repro_torch.launch import sharding as sh
from repro_torch.launch.collectives import (StepTrace, alloc_bytes,
                                            collective_bytes,
                                            remat_duplication)
from repro_torch.launch.mesh import make_fake_mesh, make_production_mesh
from repro_torch.launch.specs import (cache_specs, input_specs,
                                      opt_state_specs, param_specs)
from repro_torch.launch.steps import (cache_len_for, make_decode_step,
                                      make_optimizer, make_prefill_step,
                                      make_train_step, window_for)
from repro_torch.models import registry as R
from repro_torch.tree import tree_paths, tree_unflatten

DONATE_REFUSED = (
    "--donate: PyTorch has no buffer donation.  The port's steps return "
    "new tensors and the caller's arguments live until it drops them, so "
    "donating would change nothing in the trace")

MESH_AXES = ("pod", "data", "model")


def quiet_dtensor() -> None:
    """Silence DTensor's advice on each redistribution it makes in more
    than one collective: the trace records those collectives anyway."""
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)


def mesh_for(mesh_shape=None, *, multi_pod: bool = False):
    """The production mesh, or a fake mesh of ``mesh_shape`` ((data,
    model) or (pod, data, model))."""
    if mesh_shape is None:
        return make_production_mesh(multi_pod=multi_pod)
    mesh_shape = tuple(int(n) for n in mesh_shape)
    if len(mesh_shape) not in (2, 3) or (len(mesh_shape) == 3) != multi_pod:
        raise ValueError(f"mesh {mesh_shape} with multi_pod={multi_pod}: "
                         "a (data, model) or, multi-pod, a (pod, data, "
                         "model) grid")
    return make_fake_mesh(mesh_shape, MESH_AXES[-len(mesh_shape):])


def fold_pod(mesh):
    """The mesh DTensor traces over: ``mesh`` itself, or for a (pod, data,
    model) mesh the (pod x data, model) mesh of the same ranks, its first
    axis named "data".  See the module docstring."""
    from torch.distributed.device_mesh import DeviceMesh
    names = tuple(mesh.mesh_dim_names)
    if names[0] != "pod":
        return mesh
    pod, data, model = mesh.shape
    return DeviceMesh(mesh.device_type,
                      torch.arange(pod * data * model).view(pod * data, model),
                      mesh_dim_names=("data", "model"))


def distribute(tree, specs, mesh):
    """DTensors over ``mesh`` of the same global shapes and dtypes as the
    leaves of ``tree``, placed by ``specs`` (``PartitionSpec``s, the same
    structure), each with a fresh meta tensor as its local shard.
    Leaves that are not tensors (a cache's host index) stay as they are."""
    from torch.distributed.tensor import DTensor
    sizes = sh.mesh_sizes(mesh)
    pairs = tree_paths(tree)
    spec_leaves = ([specs] if isinstance(specs, sh.PartitionSpec)
                   else [s for _, s in tree_paths(specs)])
    out = []
    for (path, t), spec in zip(pairs, spec_leaves):
        if not isinstance(t, torch.Tensor):
            out.append(t)
            continue
        pl = sh.placements(spec, sizes)
        local = list(t.shape)
        for axis, p in zip(sizes, pl):
            if p.is_shard():
                local[p.dim] //= sizes[axis]
        shard = torch.empty(local, dtype=t.dtype, device="meta")
        out.append(DTensor.from_local(shard, mesh, pl, run_check=False,
                                      shape=t.shape, stride=t.stride()))
    if not isinstance(tree, dict):
        return out[0]
    return tree_unflatten([path for path, _ in pairs], out)


def _tensor_part(tree):
    """``tree`` without its leaves that are not tensors."""
    return {k: (_tensor_part(v) if isinstance(v, dict) else v)
            for k, v in tree.items()
            if isinstance(v, (dict, torch.Tensor))}


def _storages(tree) -> dict:
    """{storage key: allocator bytes} of the local storages of the tensors
    (or DTensors) in ``tree``, nested dicts, lists and tuples."""
    from torch.distributed.tensor import DTensor
    out, stack = {}, [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif isinstance(x, torch.Tensor):
            st = (x._local_tensor if isinstance(x, DTensor)
                  else x).untyped_storage()
            out[st._cdata] = alloc_bytes(st.nbytes())
    return out


def dryrun_one(arch: str, shape_name: str, *, multi_pod: bool = False,
               rules_name: str = "base", donate: bool = False,
               remat: bool = True, verbose: bool = True,
               q_chunks: int = 1, capacity_factor: float = None,
               cfg=None, shape=None, mesh_shape=None) -> dict:
    """One row.  The port's own keywords: ``cfg`` and ``shape`` replace
    the registry's config and shape (``arch`` and ``shape_name`` then
    only name the row); ``mesh_shape`` replaces the production mesh."""
    from torch.distributed.tensor.experimental import implicit_replication
    if donate:
        raise ValueError(DONATE_REFUSED)
    cfg = (cfg or get_config(arch)).replace(remat=remat)
    if capacity_factor is not None:
        cfg = cfg.replace(moe_capacity_factor=capacity_factor)
    shape = shape or get_shape(shape_name)
    if not applicable(cfg, shape):
        return {"arch": arch, "shape": shape_name, "skipped": True,
                "reason": "encoder-only has no decode step (DESIGN.md)"}

    grid = mesh_for(mesh_shape, multi_pod=multi_pod)
    mesh = fold_pod(grid)
    rules = sh.RULE_SETS[rules_name]
    window = window_for(cfg, shape)

    p_spec = param_specs(cfg)
    params = distribute(p_spec, sh.tree_shardings(p_spec, mesh, rules), mesh)
    b_spec = input_specs(cfg, shape)
    batch = distribute(b_spec, sh.batch_shardings(b_spec, mesh, rules), mesh)
    if shape.kind == "train":
        o_spec = opt_state_specs(cfg, p_spec)
        extra = [distribute(o_spec, sh.tree_shardings(o_spec, mesh, rules),
                            mesh)]
        step = make_train_step(cfg, make_optimizer(), window=window,
                               impl="plain", q_chunks=q_chunks)
    elif shape.kind == "prefill":
        extra = []
        step = make_prefill_step(cfg, window=window, impl="plain",
                                 q_chunks=q_chunks)
    else:                                           # decode / serve_step
        c_spec = cache_specs(cfg, shape)
        tensors = _tensor_part(c_spec)
        cache = distribute(tensors, sh.tree_shardings(tensors, mesh, rules),
                           mesh)
        extra = [dict(c_spec, **cache)]
        step = make_decode_step(cfg, window=window)
    args = [params] + extra + [batch]
    del p_spec, b_spec

    trace = StepTrace()
    arg_bytes = trace.hold(args)
    held = _storages(args)
    t0 = time.perf_counter()
    with trace, implicit_replication():
        out = step(*args)
    t_lower = time.perf_counter() - t0
    out_bytes = sum(n for key, n in _storages(out).items()
                    if key not in held)
    del out

    n_dev = math.prod(grid.shape)
    result = {
        "arch": arch, "shape": shape_name, "multi_pod": multi_pod,
        "rules": rules_name, "mesh_shape": list(grid.shape),
        "num_devices": int(n_dev),
        "window": window,
        "q_chunks": q_chunks,
        "capacity_factor": cfg.moe_capacity_factor,
        "remat": remat,
        "cache_len": (cache_len_for(cfg, shape) if shape.kind == "decode"
                      else 0),
        "lower_s": round(t_lower, 2),
        "flops": float(trace.global_flops),
        "flops_per_device": float(trace.flops),
        "bytes_accessed": float(trace.bytes_accessed),
        "collective_bytes": collective_bytes(trace.collectives),
        "collectives": [c.row() for c in trace.collectives],
        "memory": {
            "argument_size_bytes": arg_bytes,
            "output_size_bytes": out_bytes,
            "temp_size_bytes": trace.peak_bytes - arg_bytes,
            "peak_size_bytes": trace.peak_bytes,
        },
        "params": int(R.analytic_param_count(cfg)),
        "active_params": int(R.analytic_param_count(cfg, active_only=True)),
        "matmuls": remat_duplication(trace),
        "ops": trace.ops,
        "replicated": sorted(set(trace.replicated)),
        "peak_holders": [[n, what] for n, what in trace.holders],
        "skipped": False,
    }
    if verbose:
        print(json.dumps({k: v for k, v in result.items() if k != "memory"},
                         indent=None), flush=True)
        print("memory_analysis:", result["memory"], flush=True)
    return result


def parse_mesh(text: str):
    return tuple(int(n) for n in text.lower().split("x"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS) + ["all"])
    ap.add_argument("--shape", required=True, choices=sorted(SHAPES) + ["all"])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--rules", default="base", choices=sorted(sh.RULE_SETS))
    ap.add_argument("--donate", action="store_true",
                    help="refused: " + DONATE_REFUSED)
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--q-chunks", type=int, default=1)
    ap.add_argument("--capacity-factor", type=float, default=None)
    ap.add_argument("--mesh", type=parse_mesh, default=None,
                    help="a fake DxM (or, with --multi-pod, PxDxM) mesh "
                         "in place of the production one")
    ap.add_argument("--reduced", action="store_true",
                    help="each arch's reduced config at each shape's "
                         "reduced size")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.donate:
        ap.error(DONATE_REFUSED)
    quiet_dtensor()

    archs = sorted(ARCHS) if args.arch == "all" else [args.arch]
    shapes = sorted(SHAPES) if args.shape == "all" else [args.shape]
    results = []
    failures = 0
    for a in archs:
        for s in shapes:
            try:
                results.append(dryrun_one(
                    a, s, multi_pod=args.multi_pod, rules_name=args.rules,
                    remat=not args.no_remat, q_chunks=args.q_chunks,
                    capacity_factor=args.capacity_factor,
                    cfg=get_config(a).reduced() if args.reduced else None,
                    shape=get_shape(s).reduced() if args.reduced else None,
                    mesh_shape=args.mesh))
            except Exception as e:          # a dry-run failure is a bug
                failures += 1
                results.append({"arch": a, "shape": s, "error": repr(e)[:500],
                                "skipped": False})
                print(f"FAIL {a} {s}: {e}", file=sys.stderr, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
