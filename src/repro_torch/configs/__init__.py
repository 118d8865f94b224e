"""Architecture registry: ``get_config(arch_id)`` and the assigned shapes
(plain data, copied field for field from the JAX package)."""
from repro_torch.configs.base import (ModelConfig, ShapeConfig, SHAPES,
                                      LONG_CONTEXT_WINDOW)

from repro_torch.configs import (
    qwen3_4b, llama3_8b, internvl2_1b, deepseek_v2_236b, rwkv6_7b,
    zamba2_2_7b, kimi_k2_1t, hubert_xlarge, granite_8b, starcoder2_3b,
)
from repro_torch.configs.paper_models import (
    SmallNetConfig, MNIST_CNN, MNIST_MLP, CIFAR_CNN, CIFAR_MLP,
)

ARCHS = {
    m.CONFIG.name: m.CONFIG
    for m in (qwen3_4b, llama3_8b, internvl2_1b, deepseek_v2_236b, rwkv6_7b,
              zamba2_2_7b, kimi_k2_1t, hubert_xlarge, granite_8b, starcoder2_3b)
}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; available: {sorted(ARCHS)}")
    return ARCHS[arch_id]


def get_shape(shape_id: str) -> ShapeConfig:
    if shape_id not in SHAPES:
        raise KeyError(f"unknown shape {shape_id!r}; available: {sorted(SHAPES)}")
    return SHAPES[shape_id]


def applicable(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    """Whether (arch, shape) is runnable (DESIGN.md applicability matrix)."""
    if cfg.is_encoder_only and shape.kind == "decode":
        return False              # encoder-only: no decode step
    return True


__all__ = [
    "ModelConfig", "ShapeConfig", "SHAPES", "ARCHS", "LONG_CONTEXT_WINDOW",
    "get_config", "get_shape", "applicable",
    "SmallNetConfig", "MNIST_CNN", "MNIST_MLP", "CIFAR_CNN", "CIFAR_MLP",
]
