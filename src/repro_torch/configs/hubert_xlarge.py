"""hubert-xlarge — encoder-only audio transformer. [arXiv:2106.07447]

Conv feature extractor is an ``audio_stub`` frontend (precomputed frame
embeddings); the 48-layer encoder + masked-prediction head are real.
vocab_size=504 is the k-means codebook size for masked-unit prediction.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge", family="audio",
    num_layers=48, d_model=1280, num_heads=16, num_kv_heads=16,
    d_ff=5120, vocab_size=504,
    causal=False, use_rope=False,     # learned/conv pos — we use sinusoidal-free abs pos
    frontend="audio_stub",
    citation="arXiv:2106.07447",
)
