"""FL client pool: on-board local training (paper eq. 3).

Each satellite trains the received global model for J local SGD iterations
on its own shard.  ``ImageClassifierPool`` is the paper's workload (CNN/MLP
on image classification).  Its fused-epoch protocol is the one the epoch
program consumes (DESIGN.md §6): ``epoch_inputs`` puts the participants'
shards on the device, ``epoch_train_fn`` trains them all at once.

The JAX package ``vmap``s one satellite's training over the participants.
Here the participant axis is a batch dimension written out: the stacked
(C, ...) parameters train together, and one gradient of the sum of the
per-participant mean losses gives every participant its own gradient
(no parameter is shared between participants).  The J local steps are a
Python loop.  ``train_many_stacked`` (a ``ModelBank``), ``train_many``
(one parameter dict per satellite) and ``train`` serve the stacked and
legacy simulator paths with the same training and the same
``batch_indices`` hook.  ``LMPool`` comes with the LM slice.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.paper_models import SmallNetConfig
from repro_torch.core.modelbank import FlatSpec, ModelBank, pad_bucket_ids
from repro_torch.models import cnn
from repro_torch.optim import apply_updates, sgd

# (epoch seed, padded participant ids) -> (C, J, b) minibatch indices
BatchIndexFn = Callable[[int, np.ndarray], torch.Tensor]


@dataclasses.dataclass
class ImageClassifierPool:
    cfg: SmallNetConfig
    images: np.ndarray                 # (N, H, W, C)
    labels: np.ndarray                 # (N,)
    shards: List[np.ndarray]           # per-satellite index arrays
    local_iters: int = 30              # J
    batch_size: int = 32               # b
    lr: float = 0.01                   # eta (Table I)
    device: object = "cuda"
    # minibatch indices: None draws them from a torch.Generator seeded per
    # (epoch seed, sat id); a function replaces the draw (the parity tests
    # feed the indices the JAX package draws)
    batch_indices: Optional[BatchIndexFn] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self._opt = sgd(self.lr)
        self._true_sizes = [len(s) for s in self.shards]
        m = min(self._true_sizes)                     # equalize the batch axis
        # host-side (S, m) index grid: the participants' shards are gathered
        # and put on the device per call (the full dataset never lives there)
        self._sel = np.stack([s[:m] for s in self.shards])

    @property
    def num_clients(self) -> int:
        return len(self.shards)

    def data_size(self, sat: int) -> int:
        return int(self._true_sizes[sat])

    def epoch_inputs(self, ids_np: np.ndarray):
        """The padded participants' shards on the device: images
        (C, m, H, W, channels) float32 and labels (C, m) int64."""
        sel = self._sel[ids_np]
        return (torch.from_numpy(self.images[sel]).to(self.device),
                torch.from_numpy(self.labels[sel].astype(np.int64)).to(
                    self.device))

    def minibatch_indices(self, seed: int, ids_np: np.ndarray,
                          n: int) -> torch.Tensor:
        """(C, J, b) int64 indices into each participant's shard of ``n``
        samples, on the pool's device."""
        shape = (len(ids_np), self.local_iters, self.batch_size)
        if self.batch_indices is not None:
            idx = torch.as_tensor(self.batch_indices(seed, ids_np))
            if tuple(idx.shape) != shape:
                raise ValueError(f"batch_indices gave {tuple(idx.shape)}, "
                                 f"expected {shape}")
        else:
            draws = []
            for sid in ids_np:
                g = torch.Generator().manual_seed(
                    (int(seed) * 9973 + int(sid)) & 0xFFFFFFFF)
                draws.append(torch.randint(0, n, shape[1:], generator=g))
            idx = torch.stack(draws)
        return idx.to(device=self.device, dtype=torch.int64)

    def train_stacked(self, params, inputs, ids_np: np.ndarray, seed: int):
        """Train every participant from the same global ``params`` (no
        participant axis).  Returns (dict of (C, ...) trained parameters,
        (C,) mean losses over the J steps)."""
        imgs, labs = inputs
        C, n = labs.shape
        idx = self.minibatch_indices(seed, ids_np, n)
        rows = torch.arange(C, device=self.device)[:, None]
        keys = sorted(params)
        p = {k: params[k].detach().unsqueeze(0)
             .expand(C, *params[k].shape).clone().requires_grad_(True)
             for k in keys}
        state = self._opt.init(p)
        losses = []
        for j in range(self.local_iters):
            bj = idx[:, j]
            loss = cnn.loss_fn(p, self.cfg, imgs[rows, bj], labs[rows, bj])
            grads = torch.autograd.grad(loss.sum(), [p[k] for k in keys])
            with torch.no_grad():
                upd, state = self._opt.update(dict(zip(keys, grads)), state,
                                              p)
                p = apply_updates(p, upd)
            if j + 1 < self.local_iters:
                p = {k: v.requires_grad_(True) for k, v in p.items()}
            losses.append(loss.detach())
        return p, torch.stack(losses).mean(dim=0)

    def epoch_train_fn(self):
        """(params, inputs, ids_np, seed) -> (stacked params, losses), the
        training function of the fused epoch program."""
        return self.train_stacked

    def train_many_stacked(self, sat_ids: Sequence[int], params, seed: int):
        """Train the given satellites from the same global model in one
        call, as the fused program does (participants padded to a
        power-of-two bucket, padded rows dropped).  Returns (ModelBank of
        the per-satellite models, (C,) losses), both on the device."""
        ids_np, n = pad_bucket_ids(sat_ids)
        if n == 0:
            spec = FlatSpec.of(params)
            return (ModelBank(spec, torch.zeros((0, spec.num_params),
                                                device=self.device)),
                    torch.zeros(0, device=self.device))
        stacked, losses = self.train_stacked(params,
                                             self.epoch_inputs(ids_np),
                                             ids_np, seed)
        bank = ModelBank.from_stacked_tree(stacked)
        return ModelBank(bank.spec, bank.stack[:n]), losses[:n]

    def train_many(self, sat_ids: Sequence[int], params, seed: int):
        """Legacy form: (one parameter dict per satellite, losses)."""
        bank, losses = self.train_many_stacked(sat_ids, params, seed)
        return bank.to_pytrees(), losses

    def train(self, sat: int, params, seed: int):
        outs, losses = self.train_many([sat], params, seed)
        return outs[0], float(losses[0])


@dataclasses.dataclass
class Evaluator:
    cfg: SmallNetConfig
    images: np.ndarray
    labels: np.ndarray
    device: object = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        # the evaluation set goes to the device once, not per epoch
        self._imgs = torch.from_numpy(self.images).to(self.device)[None]
        self._labs = torch.from_numpy(
            self.labels.astype(np.int64)).to(self.device)[None]

    @torch.no_grad()
    def eval_async(self, params) -> torch.Tensor:
        """Accuracy as a 0-dim device tensor: the simulator reads it only
        when the history is finalized, so evaluation overlaps the next
        epoch's host work."""
        p = {k: v[None] for k, v in params.items()}
        return cnn.accuracy(p, self.cfg, self._imgs, self._labs)[0]

    def __call__(self, params) -> float:
        return float(self.eval_async(params))
