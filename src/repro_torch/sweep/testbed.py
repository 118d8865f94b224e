"""The deterministic fused-protocol trainer and evaluator the sweep engine
uses, as the JAX package's ``repro.sweep.testbed``.

The batched driver needs the trainer to declare a ``scenario_batch_key``:
the equivalence class under which different scenarios' epoch steps may
share one physical step.  Two trainers with equal keys MUST run identical
device math (the same ``epoch_train_fn`` for the same inputs); the
``DispatchBatcher`` runs a whole group through one of their programs.
Trainers without the attribute (key ``None``) always run solo — correct,
just unbatched.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.modelbank import (FlatSpec, ModelBank, flatten_tree,
                                        pad_bucket_ids)


def make_model(key_seed: int = 0, width: int = 64, device="cuda"):
    """The testbed's model: two (width, width) matrices and a bias, all
    zeros (``2 width² + width`` parameters), as float32 tensors on
    ``device``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(key_seed)
    host = {
        "w1": rng.standard_normal((width, width)).astype(np.float32) * 0.0,
        "w2": rng.standard_normal((width, width)).astype(np.float32) * 0.0,
        "b": np.zeros((width,), np.float32),
    }
    return {k: torch.tensor(v, device=dev) for k, v in host.items()}


class ConvergingTrainer:
    """Deterministic fused-protocol trainer: every local step moves the
    model halfway toward the all-ones optimum (plus a zero-mean per-sat
    perturbation), so accuracy-vs-epoch is identical across policies and
    the measured difference is PURE scheduling delay.  Its train function
    is plain tensor math, which ``torch.func.vmap`` traces (the batched
    step's vmap mode)."""

    def __init__(self, w0, rate: float = 0.5, jitter: float = 1e-3):
        self.spec = FlatSpec.of(w0)
        self._rate = rate
        self._jitter = jitter
        # scenarios whose trainers share this key run identical device
        # math, so their epoch steps may be batched together
        self.scenario_batch_key = ("converging", float(rate), float(jitter))

    def data_size(self, sat: int) -> int:
        return 100 + (sat % 7) * 10

    def epoch_inputs(self, ids_np):
        return None

    def epoch_train_fn(self):
        rate, jitter = self._rate, self._jitter

        def _fn(params, inputs, ids, seed):
            flat = flatten_tree(params)
            ids = torch.as_tensor(ids, device=flat.device).long()
            # zero-mean per-(sat, seed) jitter: cancels in aggregation up
            # to weighting differences, so policies stay comparable
            phase = ((ids * 37 + seed) % 13 - 6).float() * jitter
            stack = flat[None, :] * (1.0 - rate) + rate + phase[:, None]
            return stack, torch.zeros(ids.shape[0], device=flat.device)
        return _fn

    def train_many_stacked(self, sats, params, seed):   # stacked protocol
        ids, n = pad_bucket_ids(list(sats))
        stack, _ = self.epoch_train_fn()(params, None, ids, int(seed))
        return ModelBank(self.spec, stack[:n]), np.zeros(n)


class MeanDistanceEvaluator:
    """acc = 1 - mean|w - 1| (clipped): 0 at w0 = zeros, 1 at the optimum.
    Host numpy over the flat model, as the reference."""

    def __call__(self, params) -> float:
        flat = flatten_tree(params).cpu().numpy()
        return 1.0 - min(1.0, float(np.mean(np.abs(flat - 1.0))))
