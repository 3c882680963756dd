"""A dense decoder (qwen2) in plain PyTorch, fp32: pre-norm blocks of
grouped-query attention with QKV biases and rotary positions, then a
SwiGLU MLP; a final RMSNorm and the tied unembedding; the mean next-token
cross entropy over the real vocabulary.

Written from the Qwen2 report (arXiv:2407.10671) with the departures that
the configuration file lists (``departures``): the program scales the tied
head's logits by d^-1/2 and keeps the config's ``rope_theta``. The
embedding table has ``padded_vocab`` rows; logits are taken over the first
``vocab_size`` (the other rows get no gradient).

Leaves are stacked over the layers (the program's tree): ``blocks/stack/
...`` with a leading L dim; each layer runs under ``torch.utils.checkpoint``
so that the reference fits beside nothing but itself.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def param_spec(cfg):
    d, L, H, Hk = cfg["d_model"], cfg["n_layers"], cfg["n_heads"], \
        cfg["n_kv_heads"]
    hd, f, Vp = d // H, cfg["d_ff"], cfg["padded_vocab"]
    st = ("blocks", "stack")
    spec = [(("embed", "table"), (Vp, d), "normal", 0.02),
            (("final_norm", "scale"), (d,), "ones", None),
            (st + ("norm1", "scale"), (L, d), "ones", None),
            (st + ("norm2", "scale"), (L, d), "ones", None),
            (st + ("attn", "wo", "w"), (L, H, hd, d), "normal",
             (H * hd) ** -0.5),
            (st + ("ffn", "wg", "w"), (L, d, f), "normal", d ** -0.5),
            (st + ("ffn", "wu", "w"), (L, d, f), "normal", d ** -0.5),
            (st + ("ffn", "wd", "w"), (L, f, d), "normal", f ** -0.5)]
    for name, heads in (("wq", H), ("wk", Hk), ("wv", Hk)):
        spec.append((st + ("attn", name, "w"), (L, d, heads, hd), "normal",
                     d ** -0.5))
        if cfg["qkv_bias"]:
            spec.append((st + ("attn", name, "b"), (L, heads, hd), "zeros",
                         None))
    return spec


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def rope(x, cos, sin):
    """Rotate the two halves of the head dim (x (B, S, H, hd))."""
    half = x.shape[-1] // 2
    a, b = x[..., :half], x[..., half:]
    c, s = cos[:, None, :], sin[:, None, :]
    return torch.cat([a * c - b * s, b * c + a * s], dim=-1)


def _block(x, cos, sin, mask, lp, cfg, ein):
    H, Hk = cfg["n_heads"], cfg["n_kv_heads"]
    hd, eps = cfg["d_model"] // H, cfg["norm_eps"]
    a = lp["attn"]
    h = rmsnorm(x, lp["norm1"]["scale"], eps)

    def proj(name):
        y = ein("bsd,dhk->bshk", h, a[name]["w"])
        return y + a[name]["b"] if "b" in a[name] else y

    q, k, v = proj("wq"), proj("wk"), proj("wv")
    q, k = rope(q, cos, sin), rope(k, cos, sin)
    rep = H // Hk
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    scores = ein("bqhk,bshk->bhqs", q * hd ** -0.5, k) + mask
    o = ein("bhqs,bshk->bqhk", torch.softmax(scores, dim=-1), v)
    x = x + ein("bqhk,hkd->bqd", o, a["wo"]["w"])
    h = rmsnorm(x, lp["norm2"]["scale"], eps)
    fp = lp["ffn"]
    g = ein("bsd,df->bsf", h, fp["wg"]["w"])
    u = ein("bsd,df->bsf", h, fp["wu"]["w"])
    return x + ein("bsf,fd->bsd", F.silu(g) * u, fp["wd"]["w"])


def _layers(stack, L):
    """The L per-layer dicts of the stacked leaves (one unbind a leaf)."""
    if isinstance(stack, dict):
        parts = {k: _layers(v, L) for k, v in stack.items()}
        return [{k: parts[k][i] for k in parts} for i in range(L)]
    return stack.unbind(0)


def loss(params, tokens, labels, cfg, ein=torch.einsum):
    """Mean next-token cross entropy of one microbatch (tokens, labels:
    (b, S) int64)."""
    d, H, L, V = cfg["d_model"], cfg["n_heads"], cfg["n_layers"], \
        cfg["vocab_size"]
    hd, S = d // H, tokens.shape[1]
    table = params["embed"]["table"]
    x = table[tokens]
    pos = torch.arange(S, device=x.device, dtype=torch.float32)
    inv = cfg["rope_theta"] ** (-torch.arange(hd // 2, device=x.device,
                                              dtype=torch.float32)
                                / (hd // 2))
    ang = pos[:, None] * inv[None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    mask = torch.zeros(S, S, device=x.device).masked_fill(~causal, -1e30)
    for lp in _layers(params["blocks"]["stack"], L):
        x = checkpoint(_block, x, cos, sin, mask, lp, cfg, ein,
                       use_reentrant=False)
    x = rmsnorm(x, params["final_norm"]["scale"], cfg["norm_eps"])
    logits = ein("bsd,vd->bsv", x, table[:V]) * d ** -0.5
    return F.cross_entropy(logits.reshape(-1, V), labels.reshape(-1))
