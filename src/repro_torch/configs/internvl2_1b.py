"""internvl2-1b — InternViT + Qwen2-0.5B LM backbone [arXiv:2404.16821].

Backbone only: the ViT/projector is a stub; a batch carries 256 patch
embeddings (B, 256, d_model) prepended to the text tokens.
"""
from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b", family="vlm",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, d_ff=4864,
    vocab_size=151655, qkv_bias=True, tie_embeddings=True,
    frontend_tokens=256, frontend_kind="vision",
    source="arXiv:2404.16821",
)

REDUCED = CONFIG.replace(
    name="internvl2-reduced", n_layers=2, d_model=112, n_heads=4, n_kv_heads=2,
    d_ff=224, vocab_size=512, frontend_tokens=16,
)
