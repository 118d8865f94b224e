"""Logical-axis sharding rules (MaxText-style, data not code), as the JAX
package's ``launch/sharding.py``, with a partition-spec type of the port's
own.

Every parameter / cache / batch leaf is classified into a tuple of
*logical* dimension names by (leaf name, rank); a rules dict maps logical
names to mesh axes.  ``partition_spec`` also enforces divisibility: a
dimension that does not divide by its mesh axis's size is replicated
(starcoder2's kv_heads=2 or internvl2's 14 query heads on a 16-way model
axis), which keeps every (arch x mesh) combination valid without per-arch
special cases.  No mesh axis is used twice in one spec.

Rule sets:
  BASE_RULES  — tensor parallelism on 'model', batch on ('pod', 'data').
  FSDP_RULES  — adds ZeRO-3-style parameter sharding: the 'embed'
                dimension of weight matrices shards over 'data'.

Everything here is pure logic over shapes: a mesh is a
``launch.mesh.Mesh``, a ``DeviceMesh`` or a mapping of axis sizes, so a
(16, 16) or (2, 16, 16) layout resolves without 256 ranks.
``placements`` turns a spec into DTensor placements.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple

from repro_torch.tree import tree_paths, tree_unflatten

Logical = Tuple[Optional[str], ...]


class PartitionSpec(tuple):
    """One entry per tensor dimension: None (replicated), a mesh axis name,
    or a tuple of axis names (the dimension split over all of them, the
    first major).  Trailing dimensions not listed are replicated."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


# ---- leaf classification ----------------------------------------------------

_NAME_RULES: Dict[Tuple[str, int], Logical] = {
    # embeddings / head
    ("embedding", 2): ("vocab", "embed"),
    ("unembed", 2): ("embed", "vocab"),
    ("pos_embed", 2): (None, "embed"),
    # attention (dense GQA)
    ("wq", 3): ("embed", "heads", "head"),
    ("wk", 3): ("embed", "kv_heads", "head"),
    ("wv", 3): ("embed", "kv_heads", "head"),
    ("wo", 3): ("heads", "head", "embed"),
    # MLP / MoE (routed-expert weights are named we* so the stacked dense
    # (layer, d, f) tensors never collide with the (expert, d, f) rule)
    ("w1", 2): ("embed", "mlp"),
    ("w3", 2): ("embed", "mlp"),
    ("w2", 2): ("mlp", "embed"),
    ("we1", 3): ("expert", "embed", "moe_mlp"),
    ("we3", 3): ("expert", "embed", "moe_mlp"),
    ("we2", 3): ("expert", "moe_mlp", "embed"),
    ("router", 2): ("embed", "expert"),
    # MLA
    ("w_dkv", 2): ("embed", "kv_lora"),
    ("w_kr", 2): ("embed", None),
    ("w_uk", 3): ("kv_lora", "heads", "head"),
    ("w_uv", 3): ("kv_lora", "heads", "head"),
    ("w_dq", 2): ("embed", "q_lora"),
    ("w_uq", 3): ("q_lora", "heads", "head"),
    # RWKV (time-mix projections are tm_w* to avoid dense-attention collisions)
    ("tm_wr", 2): ("embed", "inner"),
    ("tm_wg", 2): ("embed", "inner"),
    ("tm_wk", 2): ("embed", "inner"),
    ("tm_wv", 2): ("embed", "inner"),
    ("tm_wo", 2): ("inner", "embed"),
    ("tm_w1", 2): ("embed", None),
    ("tm_w2", 3): (None, None, "embed"),
    ("td_w1", 2): ("embed", None),
    ("td_w2", 2): (None, "embed"),
    ("cm_wk", 2): ("embed", "mlp"),
    ("cm_wv", 2): ("mlp", "embed"),
    ("cm_wr", 2): ("embed", "inner"),
    ("u", 2): ("heads", "head"),
    # Mamba
    ("in_proj", 2): ("embed", "inner"),
    ("conv_w", 2): (None, "inner"),
    ("out_proj", 2): ("inner", "embed"),
    # decode caches
    ("k", 5): ("layer", "batch", "kv_seq", "kv_heads", "head"),
    ("v", 5): ("layer", "batch", "kv_seq", "kv_heads", "head"),
    ("attn_k", 5): ("layer", "batch", "kv_seq", "kv_heads", "head"),
    ("attn_v", 5): ("layer", "batch", "kv_seq", "kv_heads", "head"),
    ("c_kv", 4): ("layer", "batch", "kv_seq", "kv_lora"),
    ("k_rope", 4): ("layer", "batch", "kv_seq", None),
    ("ssm", 5): ("layer", "batch", "heads", None, None),
    ("ssm", 6): ("layer", None, "batch", "heads", None, None),
    ("conv", 4): ("layer", "batch", None, "inner"),
    ("conv", 5): ("layer", None, "batch", None, "inner"),
    ("wkv", 5): ("layer", "batch", "heads", "head", None),
    ("tm_x", 3): ("layer", "batch", "embed"),
    ("cm_x", 3): ("layer", "batch", "embed"),
}


def classify_leaf(name: str, ndim: int) -> Logical:
    """Logical dims for a leaf; extra leading dims (layer stacking,
    optimizer slots) are padded with None on the left."""
    for extra in range(ndim + 1):
        rule = _NAME_RULES.get((name, ndim - extra))
        if rule is not None:
            return (None,) * extra + rule
    return (None,) * ndim


# ---- rules ------------------------------------------------------------------

BASE_RULES: Dict[str, object] = {
    "vocab": "model", "heads": "model", "kv_heads": "model", "mlp": "model",
    "moe_mlp": "model", "expert": "model", "inner": "model",
    "embed": None, "head": None, "kv_lora": None, "q_lora": None,
    "batch": ("pod", "data"), "seq": None, "kv_seq": "data", "layer": None,
}

FSDP_RULES = dict(BASE_RULES, embed="data")

RULE_SETS = {"base": BASE_RULES, "fsdp": FSDP_RULES}


def mesh_sizes(mesh) -> Dict[str, int]:
    """{axis: size} of a mesh (anything with ``axis_names`` and ``shape``,
    or a ``DeviceMesh`` with ``mesh_dim_names``) or of a mapping of axis
    sizes."""
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    names = getattr(mesh, "axis_names", None) or mesh.mesh_dim_names
    return dict(zip(names, (int(s) for s in mesh.shape)))


def partition_spec(shape, logical: Logical, mesh,
                   rules: Dict[str, object]) -> PartitionSpec:
    """Resolve logical dims to a PartitionSpec with divisibility checks and
    no mesh axis used twice."""
    sizes = mesh_sizes(mesh)
    used = set()
    out = []
    for dim, lg in zip(shape, logical):
        if lg is None or lg not in rules or rules[lg] is None:
            out.append(None)
            continue
        axes = rules[lg]
        if isinstance(axes, str):
            axes = (axes,)
        picked = []
        rem = dim
        for ax in axes:
            if ax not in sizes or ax in used:
                continue
            if rem % sizes[ax] != 0:
                continue
            picked.append(ax)
            used.add(ax)
            rem //= sizes[ax]
        if not picked:
            out.append(None)
        elif len(picked) == 1:
            out.append(picked[0])
        else:
            out.append(tuple(picked))
    return PartitionSpec(*out)


def _leaf_name(path) -> str:
    """The innermost key of a leaf's path that is not an optimizer slot."""
    for key in reversed(path):
        if key not in ("m", "v", "mu"):
            return key
    return ""


def tree_shardings(tree, mesh, rules: Dict[str, object]):
    """One PartitionSpec per leaf of a params / cache / optimizer-state
    tree (nested dicts whose leaves have a ``shape``), same structure."""
    pairs = tree_paths(tree)
    specs = [partition_spec(tuple(leaf.shape),
                            classify_leaf(_leaf_name(path), len(leaf.shape)),
                            mesh, rules)
             for path, leaf in pairs]
    if not isinstance(tree, dict):
        return specs[0]
    return tree_unflatten([path for path, _ in pairs], specs)


def batch_shardings(batch, mesh, rules: Dict[str, object]):
    """Specs for input batches (a leaf, or dicts, tuples and lists of
    leaves): the leading dim is 'batch', dim 1 is 'seq'."""
    if isinstance(batch, dict):
        return {k: batch_shardings(v, mesh, rules) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(batch_shardings(x, mesh, rules) for x in batch)
    ndim = len(batch.shape)
    logical = (("batch", "seq") + (None,) * (ndim - 2) if ndim >= 2
               else ("batch",) * ndim)
    return partition_spec(tuple(batch.shape), logical, mesh, rules)


def bank_sharding(mesh) -> PartitionSpec:
    """The federated model bank's (C, N) layout: the participant axis
    shards over "data", the flattened-parameter axis is replicated (each
    rank owns whole rows; contractions reduce over C with one all-reduce,
    see ``core/epoch_step.py``)."""
    return PartitionSpec("data", None)


def replicated(mesh) -> PartitionSpec:
    return PartitionSpec()


def sharded_fraction(tree, shardings) -> float:
    """Fraction of elements that is sharded (a diagnostic of rule
    coverage); ``shardings`` is ``tree_shardings``' result for ``tree``."""
    leaves = [leaf for _, leaf in tree_paths(tree)]
    specs = ([shardings] if isinstance(shardings, PartitionSpec)
             else [s for _, s in tree_paths(shardings)])
    total = sharded = 0
    for leaf, spec in zip(leaves, specs):
        n = math.prod(leaf.shape)
        total += n
        if any(s is not None for s in spec):
            sharded += n
    return sharded / max(total, 1)


def placements(spec: PartitionSpec, mesh) -> tuple:
    """DTensor placements over ``mesh``'s axes for ``spec``: ``Shard(dim)``
    on each mesh axis that splits tensor dimension ``dim``, ``Replicate()``
    on the rest.  A dimension split over several axes must name them in
    the mesh's axis order (DTensor shards it major to minor that way)."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh_sizes(mesh))
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        order = [names.index(ax) for ax in axes if ax in names]
        if order != sorted(order):
            raise ValueError(f"{spec}: dim {dim} names {axes} out of the "
                             f"mesh's axis order {names}")
        for i in order:
            out[i] = Shard(dim)
    return tuple(out)
