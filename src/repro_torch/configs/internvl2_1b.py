"""internvl2-1b — VLM: InternViT (stub frontend) + InternLM2 LM backbone.

[arXiv:2404.16821] — the transformer backbone below is the Qwen2-0.5B-ish
InternLM2 decoder; the vision tower supplies 256 patch embeddings per image
via the ``vision_stub`` frontend (DESIGN.md carve-out).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b", family="vlm",
    num_layers=24, d_model=896, num_heads=14, num_kv_heads=2,
    d_ff=4864, vocab_size=151655, head_dim=64,
    rope_theta=1_000_000.0,
    frontend="vision_stub", num_prefix_embeds=256,
    citation="arXiv:2404.16821",
)
