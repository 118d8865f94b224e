"""rwkv6-7b (Finch) — attention-free, data-dependent decay. [arXiv:2404.05892]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b", family="ssm",
    num_layers=32, d_model=4096, num_heads=0, num_kv_heads=0,
    d_ff=14336, vocab_size=65536,
    use_rope=False,
    ssm_heads=64, head_dim=64, chunk_size=128,
    citation="arXiv:2404.05892",
)
