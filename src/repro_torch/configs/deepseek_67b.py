"""deepseek-67b — dense llama-arch, 95L, GQA kv=8 [arXiv:2401.02954]."""
from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b", family="dense",
    n_layers=95, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=22016,
    vocab_size=102400,
    source="arXiv:2401.02954",
)

REDUCED = CONFIG.replace(
    name="deepseek-67b-reduced", n_layers=2, d_model=256, n_heads=8, n_kv_heads=2,
    d_ff=512, vocab_size=512,
)
