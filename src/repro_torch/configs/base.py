"""Configuration system for repro_torch (copied from the JAX package).

Two levels:
  * ``ModelConfig`` — a single dataclass describing every supported
    architecture family (dense / moe / ssm / hybrid / vlm / audio).  One
    module per assigned architecture instantiates it with the exact
    published numbers (citation in the module docstring).
  * ``ShapeConfig`` — the assigned input shapes (train_4k, prefill_32k,
    decode_32k, long_500k).

Configs are plain frozen dataclasses — hashable, printable, and safe to close
over in jit.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int                    # query heads (0 for attn-free)
    num_kv_heads: int                 # GQA kv heads
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 -> d_model // num_heads

    # --- attention options ------------------------------------------------
    qk_norm: bool = False             # RMSNorm on q/k per head (qwen3)
    rope_theta: float = 10000.0
    use_rope: bool = True
    causal: bool = True               # False for encoder-only (hubert)
    sliding_window: int = 0           # 0 = full attention; >0 = window size

    # --- MoE --------------------------------------------------------------
    num_experts: int = 0              # 0 = dense FFN
    num_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0                 # per-expert hidden (d_ff used for dense/shared)
    first_dense_layers: int = 0       # leading dense layers before MoE (dsv2 style)
    moe_capacity_factor: float = 1.25  # per-expert capacity (tokens over cap drop)

    # --- MLA (deepseek) ----------------------------------------------------
    use_mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    rope_head_dim: int = 64           # decoupled rope dims for MLA
    nope_head_dim: int = 128

    # --- SSM / hybrid -------------------------------------------------------
    ssm_state: int = 0                # mamba2 d_state
    ssm_heads: int = 0                # mamba2 / rwkv6 heads
    ssm_head_dim: int = 0             # mamba2 head dim (d_inner = heads*this)
    attn_every: int = 0               # hybrid: shared attn block period (zamba2)
    chunk_size: int = 128             # chunked-scan chunk length

    # --- modality frontend stubs -------------------------------------------
    frontend: str = "none"            # none | vision_stub | audio_stub
    num_prefix_embeds: int = 0        # patch/frame embeddings prepended (stub)

    # --- training ----------------------------------------------------------
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: bool = True                # checkpoint each scanned layer
    tie_embeddings: bool = False

    citation: str = ""

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def is_encoder_only(self) -> bool:
        return not self.causal

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    def param_count(self) -> int:
        """Analytic parameter count (exact for our implementation)."""
        from repro_torch.models.registry import analytic_param_count
        return analytic_param_count(self)

    def active_param_count(self) -> int:
        """Parameters one token uses: an MoE model counted with ``top_k``
        experts a layer (the dense families: ``param_count``)."""
        from repro_torch.models.registry import analytic_param_count
        return analytic_param_count(self, active_only=True)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """Reduced variant for CPU smoke tests: 2 layers, d_model<=512, <=4 experts."""
        d_model = min(self.d_model, 256)
        heads = min(self.num_heads, 4) if self.num_heads else 0
        kv = min(self.num_kv_heads, heads) if heads else 0
        kw = dict(
            num_layers=2,
            d_model=d_model,
            num_heads=heads,
            num_kv_heads=max(kv, 1) if heads else 0,
            d_ff=min(self.d_ff, 512),
            vocab_size=min(self.vocab_size, 512),
            head_dim=64 if self.head_dim else 0,
        )
        if self.is_moe:
            kw.update(num_experts=4, top_k=min(self.top_k, 2),
                      moe_d_ff=min(self.moe_d_ff or self.d_ff, 256),
                      num_shared_experts=min(self.num_shared_experts, 1),
                      first_dense_layers=min(self.first_dense_layers, 1))
        if self.use_mla:
            kw.update(kv_lora_rank=64, q_lora_rank=0, rope_head_dim=32,
                      nope_head_dim=32, head_dim=32)
        if self.ssm_state:
            kw.update(ssm_state=min(self.ssm_state, 16),
                      ssm_heads=min(self.ssm_heads or 4, 4), chunk_size=32,
                      ssm_head_dim=min(self.ssm_head_dim, 64)
                      if self.ssm_head_dim else 0)
        if self.family == "ssm":
            kw.update(ssm_heads=min(self.ssm_heads or 4, 4), chunk_size=32)
        if self.attn_every:
            kw.update(attn_every=2)
        if self.num_prefix_embeds:
            kw.update(num_prefix_embeds=8)
        return self.replace(**kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                         # train | prefill | decode

    def reduced(self) -> "ShapeConfig":
        return dataclasses.replace(
            self, seq_len=min(self.seq_len, 128), global_batch=min(self.global_batch, 4))


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

# Sliding-window size applied to full-attention archs for long_500k decode
# (sub-quadratic carve-out documented in DESIGN.md §4).
LONG_CONTEXT_WINDOW = 8192
