"""deepseek-v2-236b — MoE 160e top-6 (+2 shared), MLA kv_lora=512 [arXiv:2405.04434]."""
from repro_torch.configs import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b", family="moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128, d_ff=1536,
    vocab_size=102400,
    moe=MoEConfig(n_experts=160, n_shared=2, top_k=6, d_ff_expert=1536,
                  d_ff_shared=3072, capacity_factor=1.25,
                  moe_layer_start=1, d_ff_dense=12288),
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    source="arXiv:2405.04434",
)

REDUCED = CONFIG.replace(
    name="deepseek-v2-reduced", n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=512,
    moe=MoEConfig(n_experts=4, n_shared=1, top_k=2, d_ff_expert=64,
                  d_ff_shared=64, capacity_factor=1.5,
                  moe_layer_start=1, d_ff_dense=256),
    mla=MLAConfig(kv_lora_rank=32, q_lora_rank=48,
                  qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32),
)
