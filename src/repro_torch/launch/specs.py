"""Abstract input specs for the dry-run, as the JAX package's
``launch/specs.py``: every model input, parameter, optimizer leaf and
decode-cache leaf as a tensor on the ``meta`` device, which has a shape,
a dtype and a storage size but no data, so nothing is allocated.  Where
the reference gives ``jax.ShapeDtypeStruct`` trees, these are trees of
the same paths, shapes and dtypes (``tests/test_torch_specs.py``), with
one difference: the decode cache's ``index`` is a host int, as
``models.registry.init_cache`` keeps it.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch.steps import cache_len_for, make_optimizer
from repro_torch.models import registry as R

META = torch.device("meta")


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict:
    """Abstract batch for (arch, shape): the assigned global shapes."""
    B, S = shape.global_batch, shape.seq_len
    dtype = getattr(torch, cfg.dtype)
    if shape.kind == "decode":
        return {"tokens": _spec((B, 1), torch.int32)}
    if cfg.frontend == "audio_stub":
        out = {"frame_embeds": _spec((B, S, cfg.d_model), dtype),
               "labels": _spec((B, S), torch.int32),
               "mask": _spec((B, S), torch.bool)}
        if shape.kind == "prefill":
            out.pop("labels")
            out.pop("mask")
        return out
    if cfg.frontend == "vision_stub":
        P = cfg.num_prefix_embeds
        return {"tokens": _spec((B, max(S - P, 1)), torch.int32),
                "prefix_embeds": _spec((B, P, cfg.d_model), dtype)}
    return {"tokens": _spec((B, S), torch.int32)}


def param_specs(cfg: ModelConfig):
    return R.init_params(0, cfg, device=META)


def opt_state_specs(cfg: ModelConfig, params=None):
    """The AdamW state of ``launch.steps.make_optimizer`` for ``params``
    (default ``param_specs(cfg)``)."""
    return make_optimizer().init(params if params is not None
                                 else param_specs(cfg))


def cache_specs(cfg: ModelConfig, shape: ShapeConfig):
    assert shape.kind == "decode"
    return R.init_cache(cfg, shape.global_batch, cache_len_for(cfg, shape),
                        getattr(torch, cfg.dtype), device=META)
