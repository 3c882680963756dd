"""FLOPs of one gradient (forward and backward) a token of a dense
decoder: 6 a matmul parameter (the projections, the MLP and the
unembedding over the real vocabulary), plus the attention's two products,
QKᵀ and PV, over the (S + 1) / 2 keys a query sees on average under the
causal mask: 4·H·hd·(S + 1) / 2 a layer forward, three times that for a
gradient."""


def matmul_params(cfg) -> int:
    d, H, Hk, f = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"], \
        cfg["d_ff"]
    hd = d // H
    layer = d * H * hd + 2 * d * Hk * hd + H * hd * d + 3 * d * f
    return cfg["n_layers"] * layer + d * cfg["vocab_size"]


def attention_flops_fwd(cfg, seq: int) -> float:
    """Forward attention FLOPs a token, all layers."""
    d = cfg["d_model"]
    return cfg["n_layers"] * 4 * d * (seq + 1) / 2


def grad_flops_per_token(cfg, seq: int) -> float:
    return 6 * matmul_params(cfg) + 3 * attention_flops_fwd(cfg, seq)
