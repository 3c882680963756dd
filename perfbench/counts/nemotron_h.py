"""FLOPs of one gradient (forward and backward) a token of a Nemotron-H
stack (``nemotron_h``): 6 a matmul parameter a token uses, plus three
times the forward FLOPs of causal attention and of the SSD.

* M: the x, z, B, C and dt projections, the depthwise convolution's taps
  and the output projection; the SSD at G groups as ``counts/ssm.py``
  counts it (C·Bᵀ once a group);
* E: the router (d·E), the shared expert (2·d·f_shared) and the held
  experts' expected share of the K choices, K·n_held/E choices of
  2·d·f_expert each (6·8/128 = 0.375 of them in the benchmark's cell);
* ``*``: the q, k, v and o projections, and QKᵀ and PV over the (S + 1)/2
  keys a query sees on average: 4·H·hd·(S + 1)/2 a layer forward;
* the head over the real vocabulary.

Recompute is not counted.
"""
from perfbench.counts import ssm


def _kinds(cfg) -> str:
    return cfg["hybrid_override_pattern"][:cfg["n_layers"]]


def layer_matmul_params(cfg) -> dict:
    """Matmul parameters a token uses in one layer of each kind."""
    d, s = cfg["d_model"], cfg["ssm"]
    nh = s["n_heads"]
    d_in, gn = nh * s["head_dim"], s["ngroups"] * s["d_state"]
    H, Hk, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    E, K = cfg["n_routed_experts"], cfg["num_experts_per_tok"]
    held = K * cfg["n_experts"] / E
    return {"M": d * (2 * d_in + 2 * gn + nh) + d_in * d
            + (d_in + 2 * gn) * s["d_conv"],
            "E": d * E + 2 * d * cfg["moe_shared_expert_intermediate_size"]
            + held * 2 * d * cfg["moe_intermediate_size"],
            "*": 2 * d * H * hd + 2 * d * Hk * hd}


def matmul_params(cfg) -> float:
    per = layer_matmul_params(cfg)
    return sum(per[k] for k in _kinds(cfg)) \
        + cfg["d_model"] * cfg["vocab_size"]


def attention_flops_fwd(cfg, seq: int) -> float:
    return _kinds(cfg).count("*") * 4 * cfg["n_heads"] * cfg["head_dim"] \
        * (seq + 1) / 2


def ssd_flops_fwd(cfg, seq: int) -> float:
    s = cfg["ssm"]
    one = {"n_layers": 1, "d_model": s["n_heads"] * s["head_dim"],
           "ssm": dict(s, expand=1)}
    return _kinds(cfg).count("M") * ssm.ssd_flops_fwd(one, seq)


def grad_flops_per_token(cfg, seq: int) -> float:
    return 6 * matmul_params(cfg) + 3 * (attention_flops_fwd(cfg, seq)
                                         + ssd_flops_fwd(cfg, seq))
