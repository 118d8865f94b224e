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
``batch_indices`` hook.

``LMPool`` trains transformer LMs (the federated LM pretraining example)
with AdamW, one participant after another: at full width one
participant's weights, gradients and two moments take 16 bytes a
parameter, so a stacked batch of C of them would not fit the card.  Each
trained model is written straight into its row of the (C, N) bank.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.paper_models import SmallNetConfig
from repro_torch.core.modelbank import FlatSpec, ModelBank, pad_bucket_ids
from repro_torch.launch.steps import loss_and_grads
from repro_torch.models import cnn
from repro_torch.optim import adamw, apply_updates, sgd
from repro_torch.tree import tree_leaves, tree_map

# (epoch seed, padded participant ids) -> (C, J, b) minibatch indices
BatchIndexFn = Callable[[int, np.ndarray], torch.Tensor]


def draw_minibatches(pool, seed: int, ids_np: np.ndarray, n: int,
                     mult: int) -> torch.Tensor:
    """(C, J, b) int64 minibatch indices into each participant's shard of
    ``n`` samples, on ``pool.device``: ``pool.batch_indices(seed, ids_np)``
    when the pool has the hook, else one ``torch.Generator`` a participant
    seeded with ``seed * mult + id`` (mod 2^32)."""
    shape = (len(ids_np), pool.local_iters, pool.batch_size)
    if pool.batch_indices is not None:
        idx = torch.as_tensor(pool.batch_indices(seed, ids_np))
        if tuple(idx.shape) != shape:
            raise ValueError(f"batch_indices gave {tuple(idx.shape)}, "
                             f"expected {shape}")
    else:
        draws = []
        for sid in ids_np:
            g = torch.Generator().manual_seed(
                (int(seed) * mult + int(sid)) & 0xFFFFFFFF)
            draws.append(torch.randint(0, n, shape[1:], generator=g))
        idx = torch.stack(draws)
    return idx.to(device=pool.device, dtype=torch.int64)


def _empty_bank(params, device):
    """Zero-participant result: an empty bank and no losses."""
    spec = FlatSpec.of(params)
    return (ModelBank(spec, torch.zeros((0, spec.num_params),
                                        device=device)),
            torch.zeros(0, device=device))


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
        return draw_minibatches(self, seed, ids_np, n, 9973)

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
            return _empty_bank(params, self.device)
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


@dataclasses.dataclass
class LMPool:
    """Federated LM pretraining pool (tokens partitioned across satellites).

    Shards are truncated to a common sequence count, as in the JAX
    package, whose ``vmap`` over the participants needs one shape.

    ``size_mode`` picks what ``data_size`` (the D_n of eqs. 13/14) reports:
    ``"on_board"`` (default) keeps the paper's reading — the full shard a
    satellite holds — while ``"trained"`` reports the truncated per-call
    sequence count the participants actually trained on (DESIGN.md §3).

    Each participant trains from the global model with a fresh AdamW state
    (``adamw(lr)``, no decay) for J steps of ``batch_size`` sequences, and
    reports the mean of its J losses.  Training differentiates the plain
    route of ``R.train_loss`` (the reference's ``impl="xla"``).
    ``model_cfg`` may be None for a pool that only answers ``data_size``.
    """
    model_cfg: object                  # ModelConfig
    tokens: np.ndarray                 # (N_seqs, seq_len)
    shards: List[np.ndarray]
    local_iters: int = 4
    batch_size: int = 4
    lr: float = 1e-3
    size_mode: str = "on_board"        # "on_board" (paper D_n) | "trained"
    device: object = "cuda"
    # minibatch indices: None draws them from a torch.Generator seeded per
    # (epoch seed, sat id); a function replaces the draw (the parity tests
    # feed the indices the JAX package draws)
    batch_indices: Optional[BatchIndexFn] = None

    def __post_init__(self):
        if self.size_mode not in ("on_board", "trained"):
            raise ValueError(
                f"size_mode must be 'on_board' or 'trained', "
                f"got {self.size_mode!r}")
        self.device = resolve_device(self.device)
        self._opt = adamw(self.lr)
        self._true_sizes = [len(s) for s in self.shards]
        m = min(self._true_sizes)                     # equalize the shards
        self._sel = np.stack([s[:m] for s in self.shards])  # (S, m)
        # tokens stay host-side: only the participants' shards are put on
        # the device per call (an LLM-scale corpus must not live there)

    @property
    def num_clients(self) -> int:
        return len(self.shards)

    def data_size(self, sat: int) -> int:
        if self.size_mode == "trained":
            return int(self._sel.shape[1])     # truncated common length
        return int(self._true_sizes[sat])      # full on-board shard (D_n)

    def epoch_inputs(self, ids_np: np.ndarray) -> torch.Tensor:
        """The padded participants' shards on the device: (C, m, seq)
        int64 tokens."""
        return torch.from_numpy(
            self.tokens[self._sel[ids_np]].astype(np.int64)).to(self.device)

    def _train_one(self, params, toks: torch.Tensor, idx: torch.Tensor):
        """One participant's J AdamW steps from ``params``: (trained
        parameter tree, mean loss as a 0-dim tensor)."""
        p = tree_map(lambda t: t.detach().clone(), params)
        state = self._opt.init(p)
        losses = []
        for j in range(self.local_iters):
            loss, _, grads = loss_and_grads(p, self.model_cfg,
                                            {"tokens": toks[idx[j]]})
            with torch.no_grad():
                upd, state = self._opt.update(grads, state, p)
                del grads
                p = apply_updates(p, upd)
                del upd
            losses.append(loss)
        return p, torch.stack(losses).mean()

    def train_stacked(self, params, inputs, ids_np: np.ndarray, seed: int):
        """Train every participant from the same global ``params``, one
        after another, each trained model written into its row of a new
        (C, N) float32 bank.  Returns (the bank, (C,) mean losses).  A
        padded row that repeats an earlier participant with the same
        minibatches would train to the same model: its row is copied."""
        toks = inputs
        C, n = toks.shape[0], toks.shape[1]
        idx = draw_minibatches(self, seed, ids_np, n, 7919)
        spec = FlatSpec.of(params)
        stack = torch.empty((C, spec.num_params), dtype=torch.float32,
                            device=self.device)
        losses = torch.empty(C, dtype=torch.float32, device=self.device)
        done = {}
        for c in range(C):
            first = done.get(int(ids_np[c]))
            if first is not None and torch.equal(idx[c], idx[first]):
                stack[c] = stack[first]
                losses[c] = losses[first]
                continue
            p, loss = self._train_one(params, toks[c], idx[c])
            with torch.no_grad():
                for row, leaf in zip(tree_leaves(spec.unflatten(stack[c])),
                                     tree_leaves(p)):
                    row.copy_(leaf)
            del p
            losses[c] = loss
            done.setdefault(int(ids_np[c]), c)
        return stack, losses

    def epoch_train_fn(self):
        """(params, inputs, ids_np, seed) -> ((C, N) bank, losses), the
        training function of the fused epoch program."""
        return self.train_stacked

    def train_many_stacked(self, sat_ids: Sequence[int], params, seed: int):
        """Train the given satellites from the same global model, as the
        fused program does (participants padded to a power-of-two bucket,
        padded rows dropped).  Returns (ModelBank of the per-satellite
        models, (C,) losses), both on the device."""
        ids_np, n = pad_bucket_ids(sat_ids)
        if n == 0:
            return _empty_bank(params, self.device)
        stack, losses = self.train_stacked(params, self.epoch_inputs(ids_np),
                                           ids_np, seed)
        return ModelBank(FlatSpec.of(params), stack[:n]), losses[:n]

    def train_many(self, sat_ids: Sequence[int], params, seed: int):
        """Legacy form: (one parameter tree per satellite, losses)."""
        bank, losses = self.train_many_stacked(sat_ids, params, seed)
        return bank.to_pytrees(), losses

    def train(self, sat: int, params, seed: int):
        outs, losses = self.train_many([sat], params, seed)
        return outs[0], float(losses[0])
