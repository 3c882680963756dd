"""FLOPs of one gradient (forward and backward) a token of a Mamba-2
model: 6 a matmul parameter (the input projections, the depthwise
convolution's taps, the output projection and the head over the real
vocabulary), plus the SSD layer's chunked algorithm at chunk Q, forward a
token and a layer, with n = d_state, p = head_dim, h heads and g groups:

* C·Bᵀ inside the chunk, causal: 2·n·g·(Q + 1) / 2;
* (C·Bᵀ ∘ L)·X, causal: 2·p·h·(Q + 1) / 2;
* the chunk states Bᵀ·X and the state-to-output C·h: 2·n·p·h each;
* the recurrence over the chunk states: 2·n·p·h / Q;

three times that for a gradient."""


def matmul_params(cfg) -> int:
    d, s = cfg["d_model"], cfg["ssm"]
    d_in = s["expand"] * d
    nh, gn = d_in // s["head_dim"], s["ngroups"] * s["d_state"]
    layer = d * (2 * d_in + 2 * gn + nh) + d_in * d \
        + (d_in + 2 * gn) * s["d_conv"]
    return cfg["n_layers"] * layer + d * cfg["vocab_size"]


def ssd_flops_fwd(cfg, seq: int) -> float:
    """Forward SSD FLOPs a token, all layers."""
    s = cfg["ssm"]
    n, p, g = s["d_state"], s["head_dim"], s["ngroups"]
    h = s["expand"] * cfg["d_model"] // p
    Q = min(s["chunk"], seq)
    per_layer = n * g * (Q + 1) + p * h * (Q + 1) + 4 * n * p * h \
        + 2 * n * p * h / Q
    return cfg["n_layers"] * per_layer


def grad_flops_per_token(cfg, seq: int) -> float:
    return 6 * matmul_params(cfg) + 3 * ssd_flops_fwd(cfg, seq)
