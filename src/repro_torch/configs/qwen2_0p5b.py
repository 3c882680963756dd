"""qwen2-0.5b — dense, GQA kv=2, QKV bias [arXiv:2407.10671]."""
from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b", family="dense",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, d_ff=4864,
    vocab_size=151936, qkv_bias=True, tie_embeddings=True,
    source="arXiv:2407.10671",
)

REDUCED = CONFIG.replace(
    name="qwen2-0.5b-reduced", n_layers=2, d_model=112, n_heads=4, n_kv_heads=2,
    d_ff=224, vocab_size=512,
)
