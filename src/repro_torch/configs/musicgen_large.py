"""musicgen-large — decoder-only over EnCodec tokens [arXiv:2306.05284].

Backbone only: the EnCodec/conv frontend is a stub; a batch carries
precomputed frame embeddings (B, S, d_model). The decoder predicts codebook
tokens, vocab=2048.
"""
from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=8192,
    vocab_size=2048, act="gelu",
    frontend_tokens=-1, frontend_kind="audio",   # -1: embeddings replace tokens 1:1
    source="arXiv:2306.05284",
)

REDUCED = CONFIG.replace(
    name="musicgen-reduced", n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
    d_ff=256, vocab_size=256,
)
