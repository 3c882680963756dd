"""A Mamba-2 language model in plain PyTorch, fp32 (arXiv:2405.21060):
pre-norm blocks of input projections, a causal depthwise convolution with
SiLU on x, B and C, the state-space dual (SSD) layer with one group of B
and C, the D skip, a gated RMSNorm and the output projection; a final
RMSNorm, an untied head, and the mean next-token cross entropy over the
real vocabulary.

The SSD is the paper's chunked algorithm (its "SSD minimal" listing): the
quadratic intra-chunk term, chunk states, a recurrence over the chunk
states and the state-to-output term. The segment sums of dt·A inside a
chunk are taken as differences of a cumulative sum accumulated in fp64 and
rounded once to fp32, as the configuration states
(``cumsum: fp64, rounded once``); every other operation is fp32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.reference.dense import _layers, rmsnorm


def _dims(cfg):
    s = cfg["ssm"]
    d_in = s["expand"] * cfg["d_model"]
    return s, d_in, d_in // s["head_dim"]


def param_spec(cfg):
    d, L, Vp = cfg["d_model"], cfg["n_layers"], cfg["padded_vocab"]
    s, d_in, nh = _dims(cfg)
    gn, K = s["ngroups"] * s["d_state"], s["d_conv"]
    m = ("blocks", "stack", "mamba")
    return [(("embed", "table"), (Vp, d), "normal", 0.02),
            (("embed", "head"), (d, Vp), "normal", d ** -0.5),
            (("final_norm", "scale"), (d,), "ones", None),
            (("blocks", "stack", "norm1", "scale"), (L, d), "ones", None),
            (m + ("wx", "w"), (L, d, d_in), "normal", d ** -0.5),
            (m + ("wz", "w"), (L, d, d_in), "normal", d ** -0.5),
            (m + ("wB", "w"), (L, d, gn), "normal", d ** -0.5),
            (m + ("wC", "w"), (L, d, gn), "normal", d ** -0.5),
            (m + ("wdt", "w"), (L, d, nh), "normal", d ** -0.5),
            (m + ("conv_x",), (L, d_in, K), "normal", 0.1),
            (m + ("conv_B",), (L, gn, K), "normal", 0.1),
            (m + ("conv_C",), (L, gn, K), "normal", 0.1),
            (m + ("dt_bias",), (L, nh), "zeros", None),
            (m + ("A_log",), (L, nh), "alog", nh),
            (m + ("Dskip",), (L, nh), "ones", None),
            (m + ("gate_norm", "scale"), (L, d_in), "ones", None),
            (m + ("wo", "w"), (L, d_in, d), "normal", d_in ** -0.5)]


def causal_conv(x, w):
    """Depthwise causal convolution: x (B, S, C), w (C, K); output t reads
    inputs t-K+1 … t, weight K-1 on input t."""
    K, S = w.shape[1], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    return sum(xp[:, k:k + S] * w[:, k] for k in range(K))


def ssd(x, dt, A, B, C, chunk, ein):
    """y (b, S, h, p) of the SSD with inputs x (b, S, h, p), dt (b, S, h),
    A (h,), one group of B and C (b, S, n), from a zero state."""
    b, S, h, p = x.shape
    Q = min(chunk, S)
    c = S // Q
    xdt = (x * dt[..., None]).reshape(b, c, Q, h, p)
    Bc, Cc = B.reshape(b, c, Q, -1), C.reshape(b, c, Q, -1)
    dA = (dt * A).reshape(b, c, Q, h).permute(0, 3, 1, 2)     # (b, h, c, Q)
    cum = torch.cumsum(dA.double(), dim=-1).float()
    tril = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    seg = (cum[..., :, None] - cum[..., None, :]).masked_fill(~tril, -1e30)
    Lmat = torch.exp(seg)                                       # (b,h,c,Q,Q)
    scores = ein("bcln,bcsn->bcls", Cc, Bc)
    y_diag = ein("bcls,bhcls,bcshp->bclhp", scores, Lmat, xdt)
    decay_states = torch.exp(cum[..., -1:] - cum)               # (b,h,c,Q)
    states = ein("bcln,bhcl,bclhp->bchpn", Bc, decay_states, xdt)
    last = cum[..., -1]                                         # (b, h, c)
    h_run = torch.zeros_like(states[:, 0])
    prev = []
    for i in range(c):
        prev.append(h_run)
        h_run = torch.exp(last[:, :, i])[..., None, None] * h_run \
            + states[:, i]
    prev = torch.stack(prev, dim=1)                             # (b,c,h,p,n)
    y_off = ein("bcln,bchpn,bhcl->bclhp", Cc, prev, torch.exp(cum))
    return (y_diag + y_off).reshape(b, S, h, p)


def _block(x, lp, cfg, ein):
    s, d_in, nh = _dims(cfg)
    bsz, S, _ = x.shape
    m = lp["mamba"]
    u = rmsnorm(x, lp["norm1"]["scale"], cfg["norm_eps"])
    lin = lambda name: ein("bsd,df->bsf", u, m[name]["w"])
    xs = F.silu(causal_conv(lin("wx"), m["conv_x"]))
    B = F.silu(causal_conv(lin("wB"), m["conv_B"]))
    C = F.silu(causal_conv(lin("wC"), m["conv_C"]))
    z = lin("wz")
    raw = lin("wdt") + m["dt_bias"]
    dt = torch.logaddexp(raw, torch.zeros_like(raw))           # softplus
    A = -torch.exp(m["A_log"])
    xh = xs.reshape(bsz, S, nh, s["head_dim"])
    y = ssd(xh, dt, A, B, C, s["chunk"], ein) + m["Dskip"][:, None] * xh
    y = rmsnorm(y.reshape(bsz, S, d_in) * F.silu(z), m["gate_norm"]["scale"],
                cfg["norm_eps"])
    return x + ein("bsf,fd->bsd", y, m["wo"]["w"])


def loss(params, tokens, labels, cfg, ein=torch.einsum):
    V, L = cfg["vocab_size"], cfg["n_layers"]
    x = params["embed"]["table"][tokens]
    for lp in _layers(params["blocks"]["stack"], L):
        x = checkpoint(_block, x, lp, cfg, ein, use_reentrant=False)
    x = rmsnorm(x, params["final_norm"]["scale"], cfg["norm_eps"])
    logits = ein("bsd,dv->bsv", x, params["embed"]["head"][:, :V])
    return F.cross_entropy(logits.reshape(-1, V), labels.reshape(-1))
