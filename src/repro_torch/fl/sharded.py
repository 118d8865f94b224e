"""Constellation-parallel FL round over ``torch.distributed`` (beyond-paper;
DESIGN.md §3), as the JAX package's ``fl/sharded.py``.

The paper simulates satellites one after another on one machine.  Here the
whole constellation trains at once across the ranks of a mesh
(``launch/mesh.py``):

  * satellites split into contiguous blocks over the mesh's satellite
    axes (``sat_axis``, and ``pod_axis`` before it, major); every rank
    takes the full stacked batches and weights and trains its own block;
  * each rank runs J local SGD steps (eq. 3) on each of its satellites at
    once: ``torch.func.vmap`` over the satellites of ``torch.func.grad``
    through the loss, and the port's ``optim.sgd``;
  * aggregation (eq. 14) is one all-reduce over the satellite axes of
    [each leaf's weighted sum | gamma | the rank's mean loss]: the
    staleness-discounted convex combination w' = (1 - gamma) w +
    sum_n p_n w_n, with gamma the sum of the weights; the mean loss is
    the average of the ranks' means, as the reference's ``pmean``;
  * on a mesh with a ``pod`` axis the sums run over ``pod`` too, which
    mirrors the source -> sink IHL relay.

The reference also passes each shard's trained models to its ISL ring
neighbour with ``jax.lax.ppermute`` and throws the result away (``del
relayed``).  JAX drops that exchange when it lowers the round: the jaxpr
holds one ``ppermute``, the lowered and the optimised HLO hold no
``collective-permute`` (4 forced CPU devices; ``tests/test_torch_sharded.py``
checks it).  So the port has no ring exchange: it would move every trained
model once for nothing.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.optim import apply_updates, sgd
from repro_torch.tree import tree_map, tree_paths, tree_unflatten


def _batch_map(fn, batch):
    """``fn`` on every tensor of a batch: a tensor, or tuples, lists and
    dicts of them."""
    if isinstance(batch, dict):
        return {k: _batch_map(fn, v) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(_batch_map(fn, x) for x in batch)
    return fn(batch)


def _local_train(loss_fn, params, batches, *, local_iters: int, lr: float):
    """J local SGD steps (paper eq. 3) from ``params`` for each satellite
    of ``batches`` (leaves (S, J, ...)) at once.  Returns (the trained
    parameters, leaves (S, ...); (S,) mean losses over the J steps)."""
    opt = sgd(lr)
    sizes = []
    _batch_map(lambda t: sizes.append(t.shape[0]), batches)
    S = sizes[0]
    p = tree_map(lambda x: x.detach().unsqueeze(0).expand(S, *x.shape)
                 .clone(), params)
    state = opt.init(p)
    step = torch.func.vmap(torch.func.grad_and_value(loss_fn))
    losses = []
    for j in range(local_iters):
        grads, loss = step(p, _batch_map(lambda t: t[:, j], batches))
        upd, state = opt.update(grads, state, p)
        p = apply_updates(p, upd)
        losses.append(loss.detach())
    return p, torch.stack(losses).mean(dim=0)


def make_fl_round(loss_fn: Callable, mesh, *, local_iters: int = 4,
                  lr: float = 0.01, sat_axis: str = "data",
                  pod_axis: Optional[str] = None):
    """Build the sharded FL round:

        fl_round(global_params, stacked_batches, weights)
            -> (new_global_params, mean_loss)

    ``loss_fn(params, batch) -> scalar``: a parameter tree and one
    minibatch of one satellite.  ``stacked_batches`` leaves: (num_sats, J,
    ...); ``weights``: (num_sats,) staleness-discounted aggregation
    weights summing to gamma.
    Every rank of the mesh passes the same full arguments and gets the
    same new global model (the all-reduce hands every rank one result).
    """
    axes = (pod_axis, sat_axis) if pod_axis else (sat_axis,)
    shards = 1
    for ax in axes:
        shards *= mesh.size(ax)

    def fl_round(global_params, stacked_batches, weights):
        # this rank's satellite block: pod-major over the satellite axes
        block = 0
        for ax in axes:
            block = block * mesh.size(ax) + mesh.coord(ax)
        num_sats = int(weights.shape[0])
        if num_sats % shards:
            raise ValueError(f"{num_sats} satellites over {shards} shards")
        lo, hi = (block * num_sats // shards,
                  (block + 1) * num_sats // shards)
        batches = _batch_map(lambda t: t[lo:hi], stacked_batches)
        local, losses = _local_train(loss_fn, global_params, batches,
                                     local_iters=local_iters, lr=lr)

        # ---- aggregation: one all-reduce (eq. 14) -------------------------
        w = weights[lo:hi].float()
        pairs = tree_paths(local)
        parts = [torch.tensordot(w, leaf.float(), dims=1).reshape(-1)
                 for _, leaf in pairs]
        parts += [w.sum()[None], losses.mean()[None]]
        buf = torch.cat(parts)
        for ax in axes:
            dist.all_reduce(buf, group=mesh.group(ax))
        gamma, mean_loss = buf[-2], buf[-1] / shards
        g_leaves = [leaf for _, leaf in tree_paths(global_params)]
        new, off = [], 0
        for (_, leaf), g in zip(pairs, g_leaves):
            n = g.numel()
            total = buf[off:off + n].view(g.shape)
            new.append(((1.0 - gamma) * g.float() + total).to(g.dtype))
            off += n
        return tree_unflatten([path for path, _ in pairs], new), mean_loss

    return fl_round
