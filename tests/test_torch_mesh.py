"""Host meshes (``repro_torch.launch.mesh``) in gloo worlds of 1, 2 and 4
CPU ranks, and the sharding rules (``repro_torch.launch.sharding``)
against the JAX package's.

* Rules: every leaf of the parameter, AdamW-state and decode-cache trees
  of all ten archs at full width (shapes from the reference's
  ``launch/specs.py``), under both rule sets, on the meshes (1, 1), (2, 4),
  (16, 16) and (2, 16, 16): the port's spec equals the reference's
  ``PartitionSpec`` exactly.  The reference resolves against a stand-in
  mesh that has ``axis_names`` and ``devices.shape``, the port against a
  mapping of axis sizes: neither needs 256 devices.
* ``classify_leaf`` on every rule name at every rank up to 7; the batch
  and bank specs; ``sharded_fraction`` against the reference's on a real
  1 x 1 mesh; ``placements``.
* Meshes: each (data, model) request clamped as the reference clamps to
  the devices there are, row-major coordinates, each axis group's ranks,
  and an all-reduce over each group.
* No module of the mesh runtime, nor the tests' worker module, imports
  JAX or the JAX package.
"""
import ast
import functools
import pathlib
import types

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS, SHAPES
from repro.launch import sharding as JS
from repro.launch.specs import cache_specs, opt_state_specs, param_specs
from repro_torch.launch import sharding as S
from repro_torch.launch.sharding import PartitionSpec as P
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.tree import tree_paths
from torch_mesh_cases import MESH_SHAPES, mesh_case, run_world

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESHES = {"1x1": {"data": 1, "model": 1}, "2x4": {"data": 2, "model": 4},
          "16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


def _duck(sizes):
    """What the reference's ``partition_spec`` reads of a mesh."""
    return types.SimpleNamespace(
        axis_names=tuple(sizes),
        devices=types.SimpleNamespace(shape=tuple(sizes.values())))


@functools.lru_cache(maxsize=None)
def _trees(arch):
    cfg = JARCHS[arch]
    params = param_specs(cfg)
    trees = {"params": params, "adamw": opt_state_specs(cfg, params)}
    if cfg.family != "audio":             # an encoder has no decode cache
        trees["cache"] = cache_specs(cfg, SHAPES["decode_32k"])
    return trees


def _ref_specs(tree, sizes, rules):
    """{path: spec} by the reference's own naming and resolution."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name = ""
        for p in reversed(path):
            key = getattr(p, "key", None)
            if isinstance(key, str) and key not in ("m", "v", "mu"):
                name = key
                break
        logical = JS.classify_leaf(name, len(leaf.shape))
        out[tuple(getattr(p, "key", None) for p in path)] = \
            JS.partition_spec(leaf.shape, logical, _duck(sizes), rules)
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("rules", ["base", "fsdp"])
@pytest.mark.parametrize("arch", list(JARCHS))
def test_partition_specs_equal_reference(arch, rules, mesh):
    sizes = MESHES[mesh]
    for name, tree in _trees(arch).items():
        want = _ref_specs(tree, sizes, JS.RULE_SETS[rules])
        got = dict(tree_paths(S.tree_shardings(tree, sizes,
                                                 S.RULE_SETS[rules])))
        assert got.keys() == want.keys(), name
        for path, spec in want.items():
            assert isinstance(got[path], S.PartitionSpec)
            assert tuple(got[path]) == tuple(spec), (name, path)
    if mesh == "16x16":
        # the divisibility fallback and the per-arch head counts at work
        assert sum(any(e is not None for e in s) for s in got.values())


def test_classify_leaf_equals_reference():
    names = sorted({name for name, _ in JS._NAME_RULES}) + ["unknown"]
    for name in names:
        for ndim in range(8):
            assert S.classify_leaf(name, ndim) == JS.classify_leaf(name, ndim)
    assert S.classify_leaf("we1", 4) == (None, "expert", "embed", "moe_mlp")
    assert S.classify_leaf("w1", 3) == (None, "embed", "mlp")


@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_bank_and_replicated_specs(mesh):
    sizes = MESHES[mesh]
    batch = {"tokens": np.zeros((32, 128)), "lens": np.zeros((32,)),
             "embeds": (np.zeros((64, 16, 8)),)}
    got = S.batch_shardings(batch, sizes, S.BASE_RULES)
    jbatch = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                          batch)
    for key, leaf in (("tokens", got["tokens"]), ("lens", got["lens"]),
                      ("embeds", got["embeds"][0])):
        arr = jbatch[key] if key != "embeds" else jbatch[key][0]
        nd = len(arr.shape)
        logical = (("batch", "seq") + (None,) * (nd - 2) if nd >= 2
                   else ("batch",) * nd)
        assert tuple(leaf) == tuple(JS.partition_spec(
            arr.shape, logical, _duck(sizes), JS.BASE_RULES))
    assert tuple(S.bank_sharding(sizes)) == ("data", None)
    assert tuple(S.replicated(sizes)) == ()


def test_sharded_fraction_equals_reference():
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    for arch in ("qwen3-4b", "deepseek-v2-236b", "rwkv6-7b"):
        tree = _trees(arch)["params"]
        want = JS.sharded_fraction(tree, JS.tree_shardings(tree, jmesh,
                                                           JS.FSDP_RULES))
        sizes = {"data": 1, "model": 1}
        got = S.sharded_fraction(tree, S.tree_shardings(tree, sizes,
                                                        S.FSDP_RULES))
        assert got == pytest.approx(want, rel=1e-12) and 0 < got <= 1


def test_placements():
    from torch.distributed.tensor import Replicate, Shard
    sizes = MESHES["2x16x16"]
    assert S.placements(P(("pod", "data"), None, "model"), sizes) == \
        (Shard(0), Shard(0), Shard(2))
    assert S.placements(P(None, "data"), sizes) == \
        (Replicate(), Shard(1), Replicate())
    assert S.placements(P(), sizes) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="axis order"):
        S.placements(P(("data", "pod")), sizes)


# ---- meshes over ranks ------------------------------------------------------

@pytest.fixture(scope="module")
def worlds():
    return {n: run_world(n, mesh_case) for n in (1, 2, 4)}


@pytest.mark.parametrize("n", (1, 2, 4))
@pytest.mark.parametrize("shape", MESH_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_host_mesh(worlds, n, shape):
    data = min(shape[0], n)                     # the reference's clamp
    model = max(1, min(shape[1], n // data))
    for rank, res in enumerate(worlds[n]):
        rec = res[shape]
        assert rec["shape"] == (data, model)
        if rank >= data * model:                # outside the mesh
            assert rec["coords"] is None
            continue
        d, m = rank // model, rank % model
        assert rec["coords"] == (d, m)
        data_ranks = [i * model + m for i in range(data)]
        model_ranks = [d * model + j for j in range(model)]
        assert rec["data"] == (data_ranks, float(sum(data_ranks) + data))
        assert rec["model"] == (model_ranks,
                                float(sum(model_ranks) + model))
        assert res["data_mesh"] == {"shape": (n, 1), "coords": (rank, 0)}


def test_cuda_mesh_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        make_host_mesh()
    assert not torch.distributed.is_initialized()


NEW_MODULES = ["src/repro_torch/launch/mesh.py",
               "src/repro_torch/launch/sharding.py",
               "src/repro_torch/fl/sharded.py",
               "src/repro_torch/models/moe_ep.py",
               "src/repro_torch/core/epoch_step.py",
               "tests/torch_mesh_cases.py"]


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
