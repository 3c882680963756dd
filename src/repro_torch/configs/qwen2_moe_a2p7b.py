"""qwen2-moe-a2.7b — 4 shared + 60 routed top-4 experts [hf:Qwen/Qwen1.5-MoE-A2.7B]."""
from repro_torch.configs import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1408,
    vocab_size=151936, qkv_bias=True,
    moe=MoEConfig(n_experts=60, n_shared=4, top_k=4, d_ff_expert=1408,
                  d_ff_shared=5632, capacity_factor=1.25),
    source="hf:Qwen/Qwen1.5-MoE-A2.7B",
)

REDUCED = CONFIG.replace(
    name="qwen2-moe-reduced", n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
    d_ff=64, vocab_size=512,
    moe=MoEConfig(n_experts=4, n_shared=1, top_k=2, d_ff_expert=64,
                  d_ff_shared=128, capacity_factor=1.5),
)
