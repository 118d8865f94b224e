"""Stacked model storage on the device (the ``ModelBank``).

The server path (grouping and staleness-discounted aggregation, paper
§IV-C) only needs models as vectors, so the client population lives as one
``(C, N)`` float32 tensor from training through grouping and aggregation.
A ``FlatSpec`` records how a parameter dict flattens into the ``N`` axis.

Layout (DESIGN.md §2): row ``c`` is client ``c``'s model; columns are the
parameters in sorted-key order — the order ``jax.tree_util.tree_leaves``
gives a dict, so a bank here compares row for row with the JAX package's —
each raveled C-contiguously, concatenated.  For the CNN that order is
``b1, b2, bc1, bc2, conv1, conv2, w1, w2``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class FlatSpec:
    """Flatten/unflatten recipe for one parameter-dict structure."""
    keys: Tuple[str, ...]
    shapes: Tuple[Tuple[int, ...], ...]
    sizes: Tuple[int, ...]

    @property
    def num_params(self) -> int:
        return int(sum(self.sizes))

    @staticmethod
    def of(model: Dict[str, torch.Tensor]) -> "FlatSpec":
        keys = tuple(sorted(model))
        shapes = tuple(tuple(model[k].shape) for k in keys)
        return FlatSpec(keys, shapes,
                        tuple(int(np.prod(s)) if s else 1 for s in shapes))

    def flatten(self, model: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Parameter dict -> new (N,) float32 tensor."""
        return torch.cat([model[k].reshape(-1).float() for k in self.keys])

    def flatten_stacked(self, stacked: Dict[str, torch.Tensor]
                        ) -> torch.Tensor:
        """Dict whose tensors share a leading axis C -> (C, N)."""
        c = stacked[self.keys[0]].shape[0]
        return torch.cat([stacked[k].reshape(c, -1).float()
                          for k in self.keys], dim=1)

    def unflatten(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """(N,) -> parameter dict of views into ``flat`` (no copy)."""
        out, off = {}, 0
        for k, size, shape in zip(self.keys, self.sizes, self.shapes):
            out[k] = flat[off:off + size].view(shape)
            off += size
        return out


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
    def from_stacked_tree(cls, stacked: Dict[str, torch.Tensor]
                          ) -> "ModelBank":
        """From a training output: a dict with a shared leading client
        axis."""
        spec = FlatSpec.of({k: v[0] for k, v in stacked.items()})
        return cls(spec, spec.flatten_stacked(stacked))

    def __len__(self) -> int:
        return int(self.stack.shape[0])

    @property
    def num_params(self) -> int:
        return int(self.stack.shape[1])

    def select(self, idx: Sequence[int]) -> "ModelBank":
        return ModelBank(self.spec, gather_rows(self.stack, list(idx)))


def params_from_jax(np_params, *, device="cuda"):
    """The JAX package's parameters, as numpy arrays
    (``jax.device_get(init_params(...))``), as float32 tensors on
    ``device`` with the same keys and shapes.  Nested dicts (the LM
    parameter tree, with its layer-stacked leaves) keep their nesting."""
    dev = resolve_device(device)

    def conv(v):
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        return torch.tensor(np.asarray(v, np.float32), device=dev)

    return conv(np_params)


def params_to_jax(params):
    """Inverse of :func:`params_from_jax`: float32 numpy arrays, nested as
    ``params`` is, that the JAX package takes as parameters."""
    if isinstance(params, dict):
        return {k: params_to_jax(v) for k, v in params.items()}
    return params.detach().cpu().numpy().astype(np.float32, copy=True)
