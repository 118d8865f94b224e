"""deepseek-v2-236b — MoE 160e top-6 with 2 shared experts, MLA kv_lora=512.

[arXiv:2405.04434] — 60 layers, d_model 5120, 128 heads, per-expert ffn 1536,
first layer dense (d_ff 12288), MLA with kv_lora_rank 512, q_lora_rank 1536,
decoupled rope head dim 64, nope head dim 128.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b", family="moe",
    num_layers=60, d_model=5120, num_heads=128, num_kv_heads=128,
    d_ff=12288,                 # dense/first-layer FFN hidden
    moe_d_ff=1536,              # per-routed-expert hidden
    vocab_size=102400,
    num_experts=160, num_shared_experts=2, top_k=6, first_dense_layers=1,
    use_mla=True, kv_lora_rank=512, q_lora_rank=1536,
    rope_head_dim=64, nope_head_dim=128, head_dim=192,
    rope_theta=10000.0,
    citation="arXiv:2405.04434",
)
