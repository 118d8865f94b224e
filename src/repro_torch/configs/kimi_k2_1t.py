"""kimi-k2-1t-a32b — trillion-param MoE, 384 experts top-8. [arXiv:2501.kimi2]

61 layers, d_model 7168, 64 heads (GQA kv=8... per assignment table), MoE
per-expert hidden 2048, 1 shared expert, first layer dense, MLA-style not
assigned — plain GQA per the table.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    num_layers=61, d_model=7168, num_heads=64, num_kv_heads=8,
    d_ff=18432,                # dense/first-layer FFN hidden
    moe_d_ff=2048,             # per-expert hidden
    vocab_size=163840,
    num_experts=384, num_shared_experts=1, top_k=8, first_dense_layers=1,
    head_dim=128, rope_theta=50000.0,
    citation="arXiv:2501.kimi2 (paper-table)",
)
