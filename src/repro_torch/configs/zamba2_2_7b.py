"""zamba2-2.7b — Mamba2 backbone + shared attention blocks. [arXiv:2411.15242]

54 Mamba2 layers, d_model 2560, ssm_state 64; a single *shared* attention+MLP
block (32 heads) is invoked every 6 mamba layers (same weights each call).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    num_layers=54, d_model=2560, num_heads=32, num_kv_heads=32,
    d_ff=10240, vocab_size=32000,
    ssm_state=64, ssm_heads=40, ssm_head_dim=128,    # d_inner = 2*d_model
    chunk_size=128, attn_every=6,
    citation="arXiv:2411.15242",
)
