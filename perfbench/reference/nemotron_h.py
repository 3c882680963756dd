"""Nemotron-H (Nemotron-3-Nano-30B-A3B's ``nemotron_h`` stack) in plain
PyTorch, fp32: layer i is ``x + mixer(RMSNorm(x))`` with the mixer that
letter i of ``hybrid_override_pattern`` names; then a final RMSNorm, the
untied head and the mean next-token cross entropy over the vocabulary.

* M, Mamba-2: x, z, B, C and dt projections (no bias); a causal depthwise
  convolution with a bias and SiLU on x, B and C; dt = softplus(dt +
  dt_bias) with no clamp; the SSD over G groups of B and C (head h reads
  group h // (H/G)), the paper's chunked algorithm (its "SSD minimal"
  listing) with the segment sums of dt·A taken from a cumulative sum in
  fp64 rounded once to fp32; the D skip; RMSNorm of y·silu(z) over groups
  of d_inner / ``ngroups``; the output projection.
* E, the expert layer: router logits x·W in fp32, scores sigmoid(logits);
  the top K of all ``n_routed_experts`` by score + ``score_bias`` (a
  stable descending sort: ties to the lower expert); weights the chosen
  scores normalised to sum 1, times ``routed_scaling_factor``; each expert
  ``down(relu(up(x))²)``. Only experts ``[first_expert, first_expert +
  n_experts)`` are held: the choices on them add weight × expert(x), one
  expert at a time over the tokens that chose it, and the others add
  nothing. The shared expert, of the same form, is added whole.
* ``*``, attention: GQA with no bias and no positional embedding, causal
  softmax at scale head_dim^-½, taken a block of queries at a time.

Written from the model's ``config.json`` and the public ``nemotron_h``
modelling code, with the departures that the configuration lists. Leaves
are stacked a kind at a time (``blocks/mamba``, ``blocks/moe``,
``blocks/attention``); the M and * layers run under
``torch.utils.checkpoint``, the E layers do not, so the reference routes
once a layer.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.reference.dense import _layers, rmsnorm
from perfbench.reference.ssm import causal_conv

KINDS = {"M": "mamba", "E": "moe", "*": "attention"}
Q_BLOCK = 1024


def _kinds(cfg) -> str:
    return cfg["hybrid_override_pattern"][:cfg["n_layers"]]


def _ssm_dims(cfg):
    s = cfg["ssm"]
    return s, s["n_heads"] * s["head_dim"], s["n_heads"]


def param_spec(cfg):
    d, Vp = cfg["d_model"], cfg["padded_vocab"]
    kinds = _kinds(cfg)
    spec = [(("embed", "table"), (Vp, d), "normal", 0.02),
            (("embed", "head"), (d, Vp), "normal", d ** -0.5),
            (("final_norm", "scale"), (d,), "ones", None)]
    for kind, name in KINDS.items():
        L = kinds.count(kind)
        if not L:
            continue
        st = ("blocks", name)
        spec.append((st + ("norm1", "scale"), (L, d), "ones", None))
        spec += [(st + path, (L,) + shape, kind_, arg)
                 for path, shape, kind_, arg in _BLOCK_SPECS[kind](cfg)]
    return spec


def _mamba_spec(cfg):
    d = cfg["d_model"]
    s, d_in, nh = _ssm_dims(cfg)
    gn, K = s["ngroups"] * s["d_state"], s["d_conv"]
    m = ("mamba",)
    return [(m + ("wx", "w"), (d, d_in), "normal", d ** -0.5),
            (m + ("wz", "w"), (d, d_in), "normal", d ** -0.5),
            (m + ("wB", "w"), (d, gn), "normal", d ** -0.5),
            (m + ("wC", "w"), (d, gn), "normal", d ** -0.5),
            (m + ("wdt", "w"), (d, nh), "normal", d ** -0.5),
            (m + ("conv_x",), (d_in, K), "normal", 0.1),
            (m + ("conv_B",), (gn, K), "normal", 0.1),
            (m + ("conv_C",), (gn, K), "normal", 0.1),
            (m + ("conv_x_b",), (d_in,), "normal", 0.1),
            (m + ("conv_B_b",), (gn,), "normal", 0.1),
            (m + ("conv_C_b",), (gn,), "normal", 0.1),
            (m + ("dt_bias",), (nh,), "zeros", None),
            (m + ("A_log",), (nh,), "alog", nh),
            (m + ("Dskip",), (nh,), "ones", None),
            (m + ("gate_norm", "scale"), (d_in,), "ones", None),
            (m + ("wo", "w"), (d_in, d), "normal", d_in ** -0.5)]


def _moe_spec(cfg):
    d, E, n = cfg["d_model"], cfg["n_routed_experts"], cfg["n_experts"]
    f, fs = cfg["moe_intermediate_size"], \
        cfg["moe_shared_expert_intermediate_size"]
    m = ("moe",)
    return [(m + ("router", "w"), (d, E), "normal", d ** -0.5),
            (m + ("score_bias",), (E,), "normal", 0.01),
            (m + ("experts", "wu"), (n, d, f), "normal", d ** -0.5),
            (m + ("experts", "wd"), (n, f, d), "normal", f ** -0.5),
            (m + ("shared", "wu", "w"), (d, fs), "normal", d ** -0.5),
            (m + ("shared", "wd", "w"), (fs, d), "normal", fs ** -0.5)]


def _attention_spec(cfg):
    d, H, Hk, hd = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"], \
        cfg["head_dim"]
    a = ("attn",)
    return [(a + ("wq", "w"), (d, H, hd), "normal", d ** -0.5),
            (a + ("wk", "w"), (d, Hk, hd), "normal", d ** -0.5),
            (a + ("wv", "w"), (d, Hk, hd), "normal", d ** -0.5),
            (a + ("wo", "w"), (H, hd, d), "normal", (H * hd) ** -0.5)]


_BLOCK_SPECS = {"M": _mamba_spec, "E": _moe_spec, "*": _attention_spec}


def ssd(x, dt, A, B, C, chunk, ein):
    """y (b, S, h, p) of the SSD with inputs x (b, S, h, p), dt (b, S, h),
    A (h,), G groups of B and C (b, S, G, n) (head h reads group h // r,
    r = h / G), from a zero state."""
    b, S, h, p = x.shape
    g = B.shape[2]
    r = h // g
    Q = min(chunk, S)
    c = S // Q
    xdt = (x * dt[..., None]).reshape(b, c, Q, g, r, p)
    Bc, Cc = B.reshape(b, c, Q, g, -1), C.reshape(b, c, Q, g, -1)
    dA = (dt * A).reshape(b, c, Q, g, r).permute(0, 3, 4, 1, 2)  # b,g,r,c,Q
    cum = torch.cumsum(dA.double(), dim=-1).float()
    tril = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    seg = (cum[..., :, None] - cum[..., None, :]).masked_fill(~tril, -1e30)
    Lmat = torch.exp(seg)                                   # b,g,r,c,Q,Q
    scores = ein("bclgn,bcsgn->bcgls", Cc, Bc)
    y_diag = ein("bcgls,bgrcls,bcsgrp->bclgrp", scores, Lmat, xdt)
    decay_states = torch.exp(cum[..., -1:] - cum)           # b,g,r,c,Q
    states = ein("bclgn,bgrcl,bclgrp->bcgrpn", Bc, decay_states, xdt)
    last = cum[..., -1]                                     # b,g,r,c
    h_run = torch.zeros_like(states[:, 0])
    prev = []
    for i in range(c):
        prev.append(h_run)
        h_run = torch.exp(last[..., i])[..., None, None] * h_run \
            + states[:, i]
    prev = torch.stack(prev, dim=1)                         # b,c,g,r,p,n
    y_off = ein("bclgn,bcgrpn,bgrcl->bclgrp", Cc, prev, torch.exp(cum))
    return (y_diag + y_off).reshape(b, S, h, p)


def _mamba(x, lp, cfg, ein):
    s, d_in, nh = _ssm_dims(cfg)
    bsz, S, _ = x.shape
    G, n = s["ngroups"], s["d_state"]
    m = lp["mamba"]
    u = rmsnorm(x, lp["norm1"]["scale"], cfg["norm_eps"])
    lin = lambda name: ein("bsd,df->bsf", u, m[name]["w"])
    conv = lambda name: F.silu(causal_conv(lin("w" + name[5:]), m[name])
                               + m[name + "_b"])
    xs, B, C = conv("conv_x"), conv("conv_B"), conv("conv_C")
    z = lin("wz")
    raw = lin("wdt") + m["dt_bias"]
    dt = torch.logaddexp(raw, torch.zeros_like(raw))        # softplus
    A = -torch.exp(m["A_log"])
    xh = xs.reshape(bsz, S, nh, s["head_dim"])
    y = ssd(xh, dt, A, B.reshape(bsz, S, G, n), C.reshape(bsz, S, G, n),
            s["chunk"], ein) + m["Dskip"][:, None] * xh
    t = (y.reshape(bsz, S, d_in) * F.silu(z)).reshape(bsz, S, G, -1)
    t = t * torch.rsqrt((t * t).mean(-1, keepdim=True) + cfg["norm_eps"])
    y = t.reshape(bsz, S, d_in) * m["gate_norm"]["scale"]
    return x + ein("bsf,fd->bsd", y, m["wo"]["w"])


def route(t, mp, cfg, ein):
    """(top (T, K) expert ids, weights (T, K)) of tokens t (T, d)."""
    scores = torch.sigmoid(ein("td,de->te", t, mp["router"]["w"]))
    with torch.no_grad():
        top = torch.sort(scores + mp["score_bias"], dim=-1, descending=True,
                         stable=True)[1][:, :cfg["num_experts_per_tok"]]
    w = scores.gather(1, top)
    w = w / (w.sum(-1, keepdim=True) + 1e-20)
    # the bias takes no gradient; it enters the graph at a factor of 0 only
    # because the round (reference/savic.py) differentiates every leaf
    w = w + 0.0 * mp["score_bias"][top]
    return top, w * cfg["routed_scaling_factor"]


def _moe(x, lp, cfg, ein):
    bsz, S, d = x.shape
    mp = lp["moe"]
    t = rmsnorm(x, lp["norm1"]["scale"], cfg["norm_eps"]).reshape(-1, d)
    top, w = route(t, mp, cfg, ein)
    relu2 = lambda a: torch.square(F.relu(a))
    out = torch.zeros_like(t)
    first = cfg.get("first_expert", 0)
    wu, wd = mp["experts"]["wu"], mp["experts"]["wd"]
    for j in range(cfg["n_experts"]):
        hit = top == first + j                              # (T, K)
        rows = hit.any(-1).nonzero()[:, 0]
        we = (w * hit).sum(-1)[rows]
        h = relu2(ein("td,df->tf", t[rows], wu[j]))
        out = out.index_add(0, rows, ein("tf,fd->td", h, wd[j])
                            * we[:, None])
    sh = mp["shared"]
    out = out + ein("tf,fd->td", relu2(ein("td,df->tf", t, sh["wu"]["w"])),
                    sh["wd"]["w"])
    return x + out.reshape(bsz, S, d)


def _attention(x, lp, cfg, ein):
    H, Hk, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    a = lp["attn"]
    u = rmsnorm(x, lp["norm1"]["scale"], cfg["norm_eps"])
    proj = lambda name: ein("bsd,dhk->bshk", u, a[name]["w"])
    q, k, v = proj("wq"), proj("wk"), proj("wv")
    k = k.repeat_interleave(H // Hk, dim=2)
    v = v.repeat_interleave(H // Hk, dim=2)
    S = x.shape[1]
    keys = torch.arange(S, device=x.device)
    outs = []
    for q0 in range(0, S, Q_BLOCK):
        qb = q[:, q0:q0 + Q_BLOCK]
        pos = torch.arange(q0, q0 + qb.shape[1], device=x.device)
        mask = torch.zeros(qb.shape[1], S, device=x.device).masked_fill(
            keys[None, :] > pos[:, None], -1e30)
        sc = ein("bqhk,bshk->bhqs", qb * hd ** -0.5, k) + mask
        outs.append(ein("bhqs,bshk->bqhk", torch.softmax(sc, dim=-1), v))
    o = torch.cat(outs, dim=1)
    return x + ein("bqhk,hkd->bqd", o, a["wo"]["w"])


_BLOCKS = {"M": _mamba, "E": _moe, "*": _attention}


def loss(params, tokens, labels, cfg, ein=torch.einsum):
    """Mean next-token cross entropy of one microbatch (tokens, labels:
    (b, S) int64)."""
    V, kinds = cfg["vocab_size"], _kinds(cfg)
    x = params["embed"]["table"][tokens]
    stacks = {kind: iter(_layers(params["blocks"][name], kinds.count(kind)))
              for kind, name in KINDS.items() if kind in kinds}
    for kind in kinds:
        lp = next(stacks[kind])
        if kind == "E":
            x = _moe(x, lp, cfg, ein)
        else:
            x = checkpoint(_BLOCKS[kind], x, lp, cfg, ein,
                           use_reentrant=False)
    x = rmsnorm(x, params["final_norm"]["scale"], cfg["norm_eps"])
    logits = ein("bsd,dv->bsv", x, params["embed"]["head"][:, :V])
    return F.cross_entropy(logits.reshape(-1, V), labels.reshape(-1))
