"""nemotron3-nano-30b-a3b — hybrid Mamba-2 / MoE / attention
[hf:nvidia/NVIDIA-Nemotron-3-Nano-30B-A3B-BF16, ``model_type`` nemotron_h].

52 layers, each ``x + mixer(RMSNorm(x))``, of the kind the pattern's letter
gives: 23 Mamba-2 (M: 64 heads × 64, 8 groups of B/C, state 128, chunk
128, a conv bias, the gated RMSNorm over groups of 512), 23 expert layers
(E: sigmoid router over 128 experts, the top 6 by score + correction bias,
their scores normalised and × 2.5; relu² experts of width 1856 and one
shared of 3712) and 6 attention layers (*: GQA 32/2, head 128, no
positional embedding); an untied head over 131,072 ids. d = 2688.

``CONFIG_EP16`` is one chip's share of the deployment the benchmark
states: 8 of each layer's 128 experts held (experts over 16 chips) and
32,768 of the ids (embedding and head rows over 4 chips); its depth is cut
where it is run.
"""
from repro_torch.configs import MoEConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="nemotron3-nano-30b-a3b", family="nemotron_h",
    n_layers=52, d_model=2688, n_heads=32, n_kv_heads=2, d_ff=1856,
    vocab_size=131072, d_head=128, rope=False, norm_eps=1e-5, act="relu2",
    layer_pattern="MEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEMEM*EMEMEMEME",
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=128,
                  ngroups=8, n_heads=64, conv_bias=True),
    moe=MoEConfig(n_experts=128, n_shared=1, top_k=6, d_ff_expert=1856,
                  d_ff_shared=3712, router_aux_weight=0.0, routed_scale=2.5),
    source="hf:nvidia/NVIDIA-Nemotron-3-Nano-30B-A3B-BF16",
)

CONFIG_EP16 = CONFIG.replace(
    name="nemotron3-nano-30b-a3b-ep16", vocab_size=32768,
    moe=MoEConfig(**{**CONFIG.moe.__dict__, "n_held": 8}),
)

REDUCED = CONFIG.replace(
    name="nemotron3-reduced", n_layers=7, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=32, vocab_size=512, d_head=16,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=8, chunk=8,
                  ngroups=2, n_heads=8, conv_bias=True),
    moe=MoEConfig(n_experts=8, n_shared=1, top_k=3, d_ff_expert=32,
                  d_ff_shared=48, router_aux_weight=0.0, routed_scale=2.5),
)
