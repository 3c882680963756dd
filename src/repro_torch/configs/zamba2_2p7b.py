"""zamba2-2.7b — hybrid Mamba2 + shared attention blocks [arXiv:2411.15242].

54 Mamba2 layers, d_model=2560; a single weight-tied attention(+MLP) block runs
every 6 layers (Zamba2's shared transformer block), 32 heads (kv=32), d_ff=10240,
vocab=32000, ssm_state=64.
"""
from repro_torch.configs import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, d_ff=10240,
    vocab_size=32000, d_head=80,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, chunk=256),
    hybrid_attn_every=6, sliding_window=0,
    source="arXiv:2411.15242",
)

REDUCED = CONFIG.replace(
    name="zamba2-reduced", n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
    d_ff=256, vocab_size=512, d_head=32,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=32, chunk=32),
    hybrid_attn_every=2,
)
