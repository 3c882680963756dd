"""mamba2-1.3b — attention-free SSD (state-space duality)
[arXiv:2405.21060]."""
from repro_torch.configs import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab_size=50280,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=256),
    source="arXiv:2405.21060",
)

REDUCED = CONFIG.replace(
    name="mamba2-reduced", n_layers=2, d_model=128, vocab_size=512,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=32, chunk=32),
)
