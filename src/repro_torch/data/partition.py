"""Federated data partitioning across satellites (paper §V-A).

IID: shuffle and split evenly — every satellite sees all 10 classes.
non-IID (the paper's setting): satellites of two orbits hold four classes,
satellites of the other three orbits hold the remaining six classes.
A Dirichlet partitioner is included for broader ablations.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def iid_partition(labels: np.ndarray, num_clients: int, seed: int) -> List[np.ndarray]:
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(labels))
    return [np.sort(s) for s in np.array_split(order, num_clients)]


def paper_noniid_partition(labels: np.ndarray, orbits: Sequence[int],
                           seed: int, *, num_classes: int = 10,
                           split_classes: int = 4,
                           low_orbits: int = 2) -> List[np.ndarray]:
    """``orbits[i]`` = orbit id of satellite i.  Satellites in the first
    ``low_orbits`` orbits draw from classes [0, split_classes); the rest draw
    from [split_classes, num_classes) — the paper's 4/6 class split."""
    rng = np.random.default_rng(seed)
    orbits = np.asarray(orbits)
    group_a = np.flatnonzero(np.isin(labels, np.arange(split_classes)))
    group_b = np.flatnonzero(np.isin(labels, np.arange(split_classes, num_classes)))
    rng.shuffle(group_a)
    rng.shuffle(group_b)
    sats_a = np.flatnonzero(orbits < low_orbits)
    sats_b = np.flatnonzero(orbits >= low_orbits)
    out: List[np.ndarray] = [None] * len(orbits)   # type: ignore[list-item]
    for sats, pool in ((sats_a, group_a), (sats_b, group_b)):
        chunks = np.array_split(pool, max(len(sats), 1))
        for s, c in zip(sats, chunks):
            out[int(s)] = np.sort(c)
    return out


def dirichlet_partition(labels: np.ndarray, num_clients: int, alpha: float,
                        seed: int, num_classes: int = 10) -> List[np.ndarray]:
    rng = np.random.default_rng(seed)
    idx_by_class = [np.flatnonzero(labels == c) for c in range(num_classes)]
    for idx in idx_by_class:
        rng.shuffle(idx)
    shares = rng.dirichlet([alpha] * num_clients, size=num_classes)
    client_idx: List[list] = [[] for _ in range(num_clients)]
    for c, idx in enumerate(idx_by_class):
        cuts = (np.cumsum(shares[c])[:-1] * len(idx)).astype(int)
        for cid, part in enumerate(np.split(idx, cuts)):
            client_idx[cid].extend(part.tolist())
    return [np.sort(np.array(ci, dtype=np.int64)) for ci in client_idx]
