"""Mamba2 state-space duality (SSD) blocks (counterpart of
``repro/models/ssm.py``, arXiv:2405.21060).

Training and prefill run the chunked SSD algorithm: an intra-chunk quadratic
(attention-like) term plus an inter-chunk linear state recurrence, a Python
loop over the S/chunk chunks where the reference scans. Decode carries a
constant-size recurrent state (B, H, P, N) and the depthwise-conv input
tails, so a decode step costs the same at any context length.

On the card ``ssd_chunked`` runs the intra-chunk term on kernel K7 and,
where it is differentiated, its hand-written VJP K7b (``_takes_k7``: the
inputs decide, as ``layers._takes_k4`` does for attention); the CPU runs
the plain ``_ssd_chunked``, which is also the card's oracle.

Parameters are stored in fp32 and cast to the compute ``dtype`` at use, as
in ``models/layers.py``. The single group of B and C (ngroups = 1) reaches
the H heads as an ``expand``ed view with a head stride of 0, where the
reference repeats it.

The nemotron_h family's Mamba-2 layer sets its heads itself
(``SSMConfig.n_heads``: d_inner = n_heads·head_dim), adds a bias to the
depthwise conv's x, B and C (``conv_bias``) and takes the gated RMSNorm
over its ``ngroups`` groups of d_inner; 1 < G < H groups of B and C
reach K7 as per-head copies (``broadcast_heads``). The defaults are
mamba2's and zamba2's layer, unchanged; ``mamba2_decode`` takes none of the three (the
pattern stack has no decode cache).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch.configs import ModelConfig
from repro_torch.kernels import ssd_scan
from repro_torch.models.layers import (_dense_init, _normal, init_rmsnorm,
                                       linear, rmsnorm)
from repro_torch.utils import trace


def _dims(cfg: ModelConfig):
    """(ssm config, d_inner, heads): ``n_heads`` × ``head_dim`` where the
    config gives the heads (nemotron_h), else ``expand`` × d."""
    s = cfg.ssm
    if s.n_heads:
        return s, s.n_heads * s.head_dim, s.n_heads
    d_in = s.expand * cfg.d_model
    nheads = d_in // s.head_dim
    return s, d_in, nheads


def init_mamba2(gen, cfg: ModelConfig):
    """One mamba2 block's parameters, drawn from ``gen`` (on its device) in
    the reference's order of keys; with ``conv_bias``, zero biases
    ``conv_x_b``, ``conv_B_b``, ``conv_C_b`` after them."""
    s, d_in, nh = _dims(cfg)
    gn = s.ngroups * s.d_state
    d = cfg.d_model
    dev = gen.device
    p = {"wx": _dense_init(gen, d, d_in), "wz": _dense_init(gen, d, d_in),
         "wB": _dense_init(gen, d, gn), "wC": _dense_init(gen, d, gn),
         "wdt": _dense_init(gen, d, nh),
         "conv_x": _normal(gen, (d_in, s.d_conv), 0.1),
         "conv_B": _normal(gen, (gn, s.d_conv), 0.1),
         "conv_C": _normal(gen, (gn, s.d_conv), 0.1)}
    p["dt_bias"] = torch.zeros((nh,), device=dev)
    p["A_log"] = torch.log(torch.linspace(1.0, 16.0, nh, device=dev))
    p["Dskip"] = torch.ones((nh,), device=dev)
    p["gate_norm"] = init_rmsnorm(d_in, dev)
    p["wo"] = _dense_init(gen, d_in, d)
    if s.conv_bias:
        for name, width in (("conv_x_b", d_in), ("conv_B_b", gn),
                            ("conv_C_b", gn)):
            p[name] = torch.zeros((width,), device=dev)
    return p


def _softplus(x):
    """jax.nn.softplus: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _causal_conv(x, w, b=None):
    """Depthwise causal conv: x (B,S,C), w (C,K) -> (B,S,C), as the
    reference's K shifted multiply-adds (no cuDNN, which would run fp32 in
    TF32 on the card); ``b`` (C,) added last where given."""
    K = w.shape[-1]
    S = x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros_like(x)
    for k in range(K):
        out = out + xp[:, k:k + S, :] * w[None, None, :, k]
    return out if b is None else out + b


def _segsum_exp(cum):
    """cum (..., Q) cumulative dA -> L (..., Q, Q); L[i,j] = exp(cum_i -
    cum_j) for i >= j, else 0. Masked BEFORE the exp (with -1e30): an upper
    diff can overflow to inf, and inf·0 is NaN (in the backward too)."""
    Q = cum.shape[-1]
    diff = cum[..., :, None] - cum[..., None, :]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=cum.device))
    return torch.exp(torch.where(mask, diff, -1e30)) * mask


def ssd_chunked(xh, dt, A, Bm, Cm, chunk, h0=None):
    """Chunked SSD scan.

    xh (B,S,H,P) input heads; dt (B,S,H) > 0; A (H,) < 0; Bm/Cm (B,S,G,N)
    with G dividing H, head h reading group h // (H/G) (G = H: per head;
    any strides). Returns (y (B,S,H,P) fp32, h_final (B,H,P,N) fp32);
    ``h0`` is the state before the first token (zeros when None).

    A call that ``_takes_k7`` (any call on the card, with grad or
    without) runs the intra-chunk term on K7, and its VJP on K7b
    (``ssd_scan.intra_chunk``; counter ``model.ssd_k7``), the rest of the
    scan in torch (``ssd_scan.ssd_kernel_forward``); the CPU and fake
    tensors run ``_ssd_chunked``."""
    with trace.span("model.ssd") as sp:
        xh, dt, A, Bm, Cm, h0 = sp.inputs(xh, dt, A, Bm, Cm, h0)
        H = xh.shape[2]
        if _takes_k7(xh):
            trace.count("model.ssd_k7")
            if Bm.shape[2] not in (1, H):   # K7 takes one group or H
                Bm, Cm = broadcast_heads(Bm, H), broadcast_heads(Cm, H)
            y, h = ssd_scan.ssd_kernel_forward(xh, dt, A, Bm, Cm, chunk, h0,
                                               intra=ssd_scan.intra_chunk)
        else:
            y, h = _ssd_chunked(xh, dt, A, broadcast_heads(Bm, H),
                                broadcast_heads(Cm, H), chunk, h0)
        return sp.output(y), h


def _takes_k7(xh):
    """The card's route: real CUDA tensors, with grad or without. The CPU
    and fake tensors (the dry run's: K7 and K7b have no fake kernels) run
    ``_ssd_chunked``. K7 checks its own limits (``ssd_scan.check_args``)
    and raises ValueError past them: the card never falls back to the plain
    scan quietly."""
    return xh.is_cuda and not isinstance(xh, FakeTensor)


def _ssd_chunked(xh, dt, A, Bm, Cm, chunk, h0):
    Bsz, S, H, P = xh.shape
    N = Bm.shape[-1]
    Q = chunk
    if S % Q:
        raise ValueError(f"S={S} is not a multiple of chunk={Q}")
    nc = S // Q

    dA = dt.float() * A.float()[None, None, :]                  # (B,S,H)
    xdt = xh.float() * dt.float()[..., None]                     # (B,S,H,P)

    def r(t):
        return t.reshape((Bsz, nc, Q) + tuple(t.shape[2:]))

    dA_c, xdt_c = r(dA), r(xdt)
    B_c, C_c = r(Bm.float()), r(Cm.float())
    # accumulated in fp64, rounded once: the same cum on every device and
    # in K7 (see kernels/ref.py::ssd_cumsum)
    cum = torch.cumsum(dA_c.double(), dim=2).float()             # (B,nc,Q,H)

    # intra-chunk: Y[i] = sum_{j<=i} C_i·B_j L_ij x_j dt_j
    L = _segsum_exp(cum.transpose(2, 3))                         # (B,nc,H,Q,Q)
    G = torch.einsum("bcihn,bcjhn->bchij", C_c, B_c)
    Y_diag = torch.einsum("bchij,bchij,bcjhp->bcihp", G, L, xdt_c)

    # end-of-chunk states
    decay_out = torch.exp(cum[:, :, -1:, :] - cum)               # (B,nc,Q,H)
    S_c = torch.einsum("bcjhn,bcjh,bcjhp->bchpn", B_c, decay_out, xdt_c)
    total = torch.exp(cum[:, :, -1, :])                          # (B,nc,H)

    h = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=xh.device) \
        if h0 is None else h0.float()
    h_prevs = []
    for c in range(nc):                                # emit pre-update
        h_prevs.append(h)
        h = total[:, c, :, None, None] * h + S_c[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)                        # (B,nc,H,P,N)

    decay_in = torch.exp(cum)                                    # (B,nc,Q,H)
    Y_off = torch.einsum("bcihn,bcih,bchpn->bcihp", C_c, decay_in, h_prevs)
    y = (Y_diag + Y_off).reshape(Bsz, S, H, P)
    return y, h


def _conv_tail(x, K):
    """Last K-1 causal-conv inputs (left zero-padded when S < K-1): the conv
    state a decode step starting at pos = S expects. A copy, so the cache
    does not keep the whole (B,S,C) input alive."""
    S = x.shape[1]
    if S >= K - 1:
        return x[:, S - (K - 1):, :].clone()
    return F.pad(x, (0, 0, K - 1 - S, 0))


def _groups(t, s):
    """(B,S,G·N) -> (B,S,G,N) fp32, a view."""
    return t.float().reshape(t.shape[0], t.shape[1], s.ngroups, s.d_state)


def broadcast_heads(g, nh):
    """(B,S,G,N) -> (B,S,H,N): head h reads group h // (H/G). For one group
    an expanded view (head stride 0), not a copy."""
    Bsz, S, G, N = g.shape
    t = g.reshape(Bsz, S, G, 1, N).expand(Bsz, S, G, nh // G, N)
    if G == 1:
        return t[:, :, 0]
    return t.reshape(Bsz, S, nh, N)


def _heads(t, s, nh):
    """(B,S,G·N) -> (B,S,H,N) fp32 (``broadcast_heads`` of ``_groups``)."""
    return broadcast_heads(_groups(t, s), nh)


def _conv_bias(p, name, dtype):
    b = p.get(name + "_b")
    return None if b is None else b.to(dtype)


def _gated_norm(p, y, z, cfg: ModelConfig):
    """RMSNorm of y·silu(z), over the whole d_inner or, with ``ngroups``
    G > 1, over each of G groups of d_inner / G (nemotron_h), then the
    scale."""
    G = cfg.ssm.ngroups
    if G == 1:
        return rmsnorm(p["gate_norm"], y * F.silu(z), cfg.norm_eps)
    t = (y * F.silu(z)).float()
    g = t.reshape(t.shape[:-1] + (G, t.shape[-1] // G))
    g = g * torch.rsqrt(torch.mean(g * g, dim=-1, keepdim=True)
                        + cfg.norm_eps)
    return (g.reshape(t.shape) * p["gate_norm"]["scale"].float()).to(y.dtype)


def mamba2_forward(p, cfg: ModelConfig, u, dtype, h0=None, return_state=False,
                   return_cache=False):
    """u (B,S,d) -> (B,S,d). Full sequence (training / prefill).

    ``return_cache=True`` also returns a decode cache (the tree of
    ``mamba2_init_cache``) positioned after the last token: the final SSD
    state and the depthwise-conv input tails."""
    s, d_in, nh = _dims(cfg)
    Bsz, S, _ = u.shape
    x_pre = linear(p["wx"], u, dtype)
    B_pre = linear(p["wB"], u, dtype)
    C_pre = linear(p["wC"], u, dtype)
    x = F.silu(_causal_conv(x_pre, p["conv_x"].to(dtype),
                            _conv_bias(p, "conv_x", dtype)))
    Bm = F.silu(_causal_conv(B_pre, p["conv_B"].to(dtype),
                             _conv_bias(p, "conv_B", dtype)))
    Cm = F.silu(_causal_conv(C_pre, p["conv_C"].to(dtype),
                             _conv_bias(p, "conv_C", dtype)))
    z = linear(p["wz"], u, dtype)
    dt = _softplus(linear(p["wdt"], u, torch.float32)
                   + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())

    xh = x.reshape(Bsz, S, nh, s.head_dim)
    chunk = min(s.chunk, S)
    y, h_fin = ssd_chunked(xh.float(), dt, A, _groups(Bm, s), _groups(Cm, s),
                           chunk, h0=h0)
    y = y + p["Dskip"].float()[None, None, :, None] * xh.float()
    y = y.reshape(Bsz, S, d_in).to(dtype)
    y = _gated_norm(p, y, z, cfg)
    out = linear(p["wo"], y, dtype)
    if return_cache:
        K = s.d_conv
        cache = {"h": h_fin, "conv_x": _conv_tail(x_pre, K).float(),
                 "conv_B": _conv_tail(B_pre, K).float(),
                 "conv_C": _conv_tail(C_pre, K).float()}
        return out, cache
    if return_state:
        return out, h_fin
    return out


def mamba2_init_cache(cfg: ModelConfig, batch, device):
    """An empty decode cache. Every leaf is fp32: the conv tails like h,
    since ``_conv_step`` promotes the rolled window to fp32 anyway and the
    cache dtype must be a fixed point of the decode step (the
    continuous-batching slot insert copies leaves as they are)."""
    s, d_in, nh = _dims(cfg)
    gn = s.ngroups * s.d_state
    f32 = torch.float32
    return {
        "h": torch.zeros((batch, nh, s.head_dim, s.d_state), dtype=f32,
                         device=device),
        "conv_x": torch.zeros((batch, s.d_conv - 1, d_in), dtype=f32,
                              device=device),
        "conv_B": torch.zeros((batch, s.d_conv - 1, gn), dtype=f32,
                              device=device),
        "conv_C": torch.zeros((batch, s.d_conv - 1, gn), dtype=f32,
                              device=device),
    }


def _conv_step(state, xt, w):
    """state (B,K-1,C) fp32, xt (B,C), w (C,K) -> (out (B,C) fp32, the new
    state (B,K-1,C))."""
    window = torch.cat([state, xt[:, None, :].to(state.dtype)], dim=1)
    out = (window * w.t().to(window.dtype)[None]).sum(1)
    return out, window[:, 1:, :]


def mamba2_decode(p, cfg: ModelConfig, u, cache, dtype):
    """u (B,1,d) -> (B,1,d); O(1) state update.

    Unlike the reference, which returns a new cache, the leaves of ``cache``
    (h, conv_x, conv_B, conv_C; views into the stacked decode cache) are
    updated IN PLACE; the same dict is returned."""
    s, d_in, nh = _dims(cfg)
    Bsz = u.shape[0]
    ut = u[:, 0, :]
    x_t = linear(p["wx"], ut, dtype)
    B_t = linear(p["wB"], ut, dtype)
    C_t = linear(p["wC"], ut, dtype)
    x_t, cx = _conv_step(cache["conv_x"], x_t, p["conv_x"].to(dtype))
    B_t, cb = _conv_step(cache["conv_B"], B_t, p["conv_B"].to(dtype))
    C_t, cc = _conv_step(cache["conv_C"], C_t, p["conv_C"].to(dtype))
    x_t, B_t, C_t = F.silu(x_t), F.silu(B_t), F.silu(C_t)
    z = linear(p["wz"], ut, dtype)
    dt = _softplus(linear(p["wdt"], ut, torch.float32)
                   + p["dt_bias"].float())                       # (B,H)
    A = -torch.exp(p["A_log"].float())

    xh = x_t.reshape(Bsz, nh, s.head_dim).float()
    Bh = _heads(B_t[:, None], s, nh)[:, 0]                       # (B,H,N)
    Ch = _heads(C_t[:, None], s, nh)[:, 0]

    dA = torch.exp(dt * A[None, :])                              # (B,H)
    h = cache["h"]
    h.mul_(dA[..., None, None]).add_(
        (dt[..., None] * xh)[..., None] * Bh[:, :, None, :])
    y = torch.einsum("bhpn,bhn->bhp", h, Ch) \
        + p["Dskip"].float()[None, :, None] * xh
    y = y.reshape(Bsz, d_in).to(dtype)
    y = rmsnorm(p["gate_norm"], y * F.silu(z), cfg.norm_eps)
    out = linear(p["wo"], y, dtype)[:, None, :]
    for key, new in (("conv_x", cx), ("conv_B", cb), ("conv_C", cc)):
        cache[key].copy_(new)
    return out, cache


def ssd_reference(xh, dt, A, Bm, Cm):
    """Naive sequential SSD (the oracle of the tests): one state update per
    token. Returns (y (B,S,H,P), h_final (B,H,P,N)), fp32."""
    Bsz, S, H, P = xh.shape
    N = Bm.shape[-1]
    h = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=xh.device)
    A = A.float()
    ys = []
    for t in range(S):
        dt_t = dt[:, t].float()
        dA = torch.exp(dt_t * A[None, :])                         # (B,H)
        h = h * dA[..., None, None] + torch.einsum(
            "bh,bhp,bhn->bhpn", dt_t, xh[:, t].float(), Bm[:, t].float())
        ys.append(torch.einsum("bhpn,bhn->bhp", h, Cm[:, t].float()))
    return torch.stack(ys, dim=1), h

