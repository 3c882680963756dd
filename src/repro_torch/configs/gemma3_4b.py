"""gemma3-4b — dense, 5:1 local(sliding-1024):global attention, 128k ctx
[hf:google/gemma-3-1b-pt]."""
from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b", family="dense",
    n_layers=34, d_model=2560, n_heads=8, n_kv_heads=4, d_ff=10240,
    vocab_size=262144, d_head=256, qk_norm=True, act="gelu",
    sliding_window=1024, local_global_ratio=5, rope_theta=1_000_000.0,
    tie_embeddings=True,
    source="hf:google/gemma-3-1b-pt",
)

REDUCED = CONFIG.replace(
    name="gemma3-reduced", n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
    d_ff=256, vocab_size=512, d_head=32, sliding_window=64,
    local_global_ratio=1,
)
