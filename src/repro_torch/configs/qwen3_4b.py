"""qwen3-4b — dense, GQA kv=8, qk-norm [hf:Qwen/Qwen3-8B]."""
from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b", family="dense",
    n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8, d_ff=9728,
    vocab_size=151936, d_head=128, qk_norm=True, rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen3-8B",
)

# beyond-assignment variant: sliding-window attention so long_500k decode is
# legal for a dense arch (selectable: --arch qwen3-4b-swa)
CONFIG_SWA = CONFIG.replace(name="qwen3-4b-swa", sliding_window=8192)

REDUCED = CONFIG.replace(
    name="qwen3-reduced", n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
    d_ff=256, vocab_size=512, d_head=32,
)
