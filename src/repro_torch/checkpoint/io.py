"""Parameter-tree checkpoints in the JAX package's file format.

Each leaf is saved under its '/'-joined key path in one
``np.savez_compressed`` file; the tree is rebuilt from the key paths, so
nested dicts of tensors round-trip.  FL server state (global model +
epoch + grouping + metadata) is the same file holding
``{"global_model": ...}`` beside a ``.json`` sidecar.  Either package
reads a file the other wrote: leaves are stored as host numpy arrays, and
``load_pytree`` puts them on ``device`` as tensors.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.tree import tree_map, tree_paths, tree_unflatten


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten_with_paths(tree) -> Dict[str, np.ndarray]:
    return {"/".join(map(str, path)): _host(leaf)
            for path, leaf in tree_paths(tree)}


def save_pytree(path: str, tree) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **_flatten_with_paths(tree))


def load_pytree(path: str, *, device="cuda"):
    """The tree saved at ``path``, its leaves as tensors on ``device`` with
    the dtypes they were saved with."""
    dev = resolve_device(device)
    with np.load(path, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    tree = tree_unflatten([k.split("/") for k in flat], list(flat.values()))
    return tree_map(lambda a: torch.from_numpy(a).to(dev), tree)


def save_server_state(path: str, *, global_model, epoch: int,
                      grouping=None, metadata=None) -> None:
    save_pytree(path, {"global_model": global_model})
    side = {"epoch": int(epoch),
            "grouping": grouping if grouping is not None else [],
            "metadata": metadata if metadata is not None else {}}
    with open(path + ".json", "w") as f:
        json.dump(side, f)


def load_server_state(path: str, *, device="cuda"):
    """(the global model as a tree of tensors on ``device``, the sidecar
    dict: epoch, grouping, metadata)."""
    tree = load_pytree(path, device=device)
    with open(path + ".json") as f:
        side: Dict[str, Any] = json.load(f)
    return tree["global_model"], side
