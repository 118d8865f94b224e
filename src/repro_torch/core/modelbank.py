"""Stacked model storage on the device (the ``ModelBank``).

The server path (grouping and staleness-discounted aggregation, paper
§IV-C) only needs models as vectors, so the client population lives as one
``(C, N)`` float32 tensor from training through grouping and aggregation.
A ``FlatSpec`` records how a parameter tree (a dict of tensors, or the LM
families' nested dicts) flattens into the ``N`` axis.

Layout (DESIGN.md §2): row ``c`` is client ``c``'s model; columns are the
parameters in sorted-key order at every level of the tree — the order
``jax.tree_util.tree_leaves`` gives a dict, so a bank here compares row
for row with the JAX package's — each raveled C-contiguously,
concatenated.  For the CNN that order is
``b1, b2, bc1, bc2, conv1, conv2, w1, w2``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.tree import (Path, tree_leaves, tree_map, tree_paths,
                               tree_unflatten)


@dataclasses.dataclass(frozen=True)
class FlatSpec:
    """Flatten/unflatten recipe for one parameter-tree structure: a dict of
    tensors, or nested dicts of them (the LM parameter trees)."""
    paths: Tuple[Path, ...]
    shapes: Tuple[Tuple[int, ...], ...]
    sizes: Tuple[int, ...]

    @property
    def num_params(self) -> int:
        return int(sum(self.sizes))

    @property
    def keys(self) -> Tuple[str, ...]:
        """Each leaf's key path, '/'-joined (a flat dict's keys)."""
        return tuple("/".join(p) for p in self.paths)

    @staticmethod
    def of(model) -> "FlatSpec":
        pairs = tree_paths(model)
        shapes = tuple(tuple(leaf.shape) for _, leaf in pairs)
        return FlatSpec(tuple(p for p, _ in pairs), shapes,
                        tuple(int(np.prod(s)) if s else 1 for s in shapes))

    def flatten(self, model) -> torch.Tensor:
        """Parameter tree -> new (N,) float32 tensor."""
        return flatten_tree(model)

    def flatten_stacked(self, stacked) -> torch.Tensor:
        """Tree whose tensors share a leading axis C -> (C, N)."""
        leaves = tree_leaves(stacked)
        c = leaves[0].shape[0]
        return torch.cat([leaf.reshape(c, -1).float() for leaf in leaves],
                         dim=1)

    def unflatten(self, flat: torch.Tensor):
        """(N,) -> parameter tree of views into ``flat`` (no copy)."""
        views, off = [], 0
        for size, shape in zip(self.sizes, self.shapes):
            views.append(flat[off:off + size].view(shape))
            off += size
        return tree_unflatten(self.paths, views)

    def unflatten_host(self, flat):
        """(N,) tensor or array -> parameter tree of host numpy arrays (one
        copy of the vector to the host; the leaves are views into it)."""
        if isinstance(flat, torch.Tensor):
            flat = flat.detach().cpu().numpy()
        flat = np.asarray(flat)
        parts, off = [], 0
        for size, shape in zip(self.sizes, self.shapes):
            parts.append(flat[off:off + size].reshape(shape))
            off += size
        return tree_unflatten(self.paths, parts)


def flatten_tree(model) -> torch.Tensor:
    """A parameter tree (a dict, nested dicts allowed) -> new (N,) float32
    tensor in the §2 layout: sorted keys at every level, the order
    ``jax.tree_util.tree_leaves`` gives the reference's dicts, each tensor
    raveled C-contiguously."""
    return torch.cat([torch.as_tensor(leaf).reshape(-1).float()
                      for leaf in tree_leaves(model)])


def flat_base(spec: FlatSpec, base):
    """Base model as a flat (N,) float32 tensor (None passes through): a
    flat tensor as it is, a parameter dict through ``spec``."""
    if base is None:
        return None
    if isinstance(base, torch.Tensor) and base.dim() == 1:
        return base.float()
    return spec.flatten(base)


def gather_rows(stack: torch.Tensor, idx) -> torch.Tensor:
    """Row gather (a new tensor) with host indices."""
    return stack[torch.as_tensor(np.asarray(idx, np.int64),
                                 device=stack.device)]


def pad_bucket_ids(ids: Sequence[int]) -> Tuple[np.ndarray, int]:
    """Pad an index list to the next power-of-two bucket by repeating the
    first id, returning (padded int32 ids, true count).  Padded rows are
    trained and discarded; the bucketing keeps the bank shapes the JAX
    package's, so the two compare row for row."""
    arr = np.asarray(list(ids), dtype=np.int32)
    n = len(arr)
    if n == 0:
        return arr, 0
    b = 1 << max(n - 1, 0).bit_length()
    if b > n:
        arr = np.concatenate([arr, np.full(b - n, arr[0], dtype=np.int32)])
    return arr, n


@dataclasses.dataclass
class ModelBank:
    """C models held as one (C, N) float32 tensor."""
    spec: FlatSpec
    stack: torch.Tensor

    @classmethod
    def from_pytrees(cls, models: Sequence) -> "ModelBank":
        """From per-client parameter trees (one stacked copy)."""
        spec = FlatSpec.of(models[0])
        return cls(spec, torch.stack([spec.flatten(m) for m in models]))

    @classmethod
    def from_stacked_tree(cls, stacked) -> "ModelBank":
        """From a training output: a tree whose tensors share a leading
        client axis."""
        spec = FlatSpec.of(tree_map(lambda v: v[0], stacked))
        return cls(spec, spec.flatten_stacked(stacked))

    @classmethod
    def from_rows(cls, spec: FlatSpec, rows: Sequence) -> "ModelBank":
        """From per-client (N,) flat vectors (tensors or host arrays)."""
        return cls(spec, torch.stack([torch.as_tensor(r) for r in rows]))

    def __len__(self) -> int:
        return int(self.stack.shape[0])

    @property
    def num_params(self) -> int:
        return int(self.stack.shape[1])

    def select(self, idx: Sequence[int]) -> "ModelBank":
        return ModelBank(self.spec, gather_rows(self.stack, list(idx)))

    def row(self, i: int) -> torch.Tensor:
        """Client ``i``'s flat (N,) model: a view of its row."""
        return self.stack[i]

    def pytree(self, i: int):
        """Client ``i``'s parameter tree: views into its row, on the
        stack's device (no copy)."""
        return self.spec.unflatten(self.stack[i])

    def to_pytrees(self) -> List:
        """Materialise one parameter tree per client: each row copied out
        of the stack, on the stack's device (the reference copies its rows
        to the host in one transfer)."""
        return [self.spec.unflatten(self.stack[c].clone())
                for c in range(len(self))]


def params_from_jax(np_params, *, device="cuda"):
    """The JAX package's parameters, as numpy arrays
    (``jax.device_get(init_params(...))``), as float32 tensors on
    ``device`` with the same keys and shapes.  Nested dicts (the LM
    parameter tree, with its layer-stacked leaves) keep their nesting."""
    dev = resolve_device(device)
    return tree_map(lambda v: torch.tensor(np.asarray(v, np.float32),
                                           device=dev), np_params)


def params_to_jax(params):
    """Inverse of :func:`params_from_jax`: float32 numpy arrays, nested as
    ``params`` is, that the JAX package takes as parameters."""
    return tree_map(lambda t: t.detach().cpu().numpy().astype(
        np.float32, copy=True), params)
