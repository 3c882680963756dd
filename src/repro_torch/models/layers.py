"""Transformer layers (counterpart of ``repro/models/layers.py``; MLA is in
``models/mla.py``).

Parameters are plain dicts of tensors with the reference's tree paths and
layouts (head-major QKV weights (d, H, hd), output (H, hd, d)); they are
stored in fp32 and cast to the compute ``dtype`` at use. Attention takes
the reference's routes: dense (``_sdpa_dense``), KV-chunked
(``models/flash.py``) for long sequences, or kernel K4 with
``use_flash_kernel``; a differentiated call on the card takes K4 and its
VJP K4b instead (``_takes_k4``); one-token decode runs dense or on kernel
K5.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.configs import ModelConfig
from repro_torch.kernels import flash_attention as fa
from repro_torch.models.flash import HUGE_WINDOW, flash_attention_bshd
from repro_torch.utils import trace

# --------------------------------------------------------------------------- #
# initializers / basics
# --------------------------------------------------------------------------- #


def _normal(gen, shape, scale, dtype=torch.float32):
    """Normal draws times ``scale``, scaled in place (no second buffer: a
    deepseek-v2 expert leaf is 5 GB)."""
    return torch.randn(shape, generator=gen, dtype=dtype,
                       device=gen.device).mul_(scale)


def _dense_init(gen, d_in, d_out, bias=False, scale=None):
    scale = scale if scale is not None else d_in ** -0.5
    p = {"w": _normal(gen, (d_in, d_out), scale)}
    if bias:
        p["b"] = torch.zeros((d_out,), device=gen.device)
    return p


def linear(p, x, dtype):
    y = x.to(dtype) @ p["w"].to(dtype)
    if "b" in p:
        y = y + p["b"].to(dtype)
    return y


def init_rmsnorm(d, device):
    return {"scale": torch.ones((d,), device=device)}


def rmsnorm(p, x, eps=1e-6):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * p["scale"].float()).to(dt)


# --------------------------------------------------------------------------- #
# RoPE
# --------------------------------------------------------------------------- #


def rope_cos_sin(positions, head_dim, theta):
    """positions (...,) int -> cos/sin of shape (..., head_dim//2), fp32."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x (..., S, H, D); cos/sin (..., S, D//2) broadcast over heads."""
    x = x.float()
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


# --------------------------------------------------------------------------- #
# Attention
# --------------------------------------------------------------------------- #


def init_attention(gen, cfg: ModelConfig):
    """QKV/O projections stored head-major 3D: (d, H, hd) / (H, hd, d)."""
    d, h, hk, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def proj(nheads):
        p = {"w": _normal(gen, (d, nheads, hd), d ** -0.5)}
        if cfg.qkv_bias:
            p["b"] = torch.zeros((nheads, hd), device=gen.device)
        return p

    p = {"wq": proj(h), "wk": proj(hk), "wv": proj(hk),
         "wo": {"w": _normal(gen, (h, hd, d), (h * hd) ** -0.5)}}
    if cfg.qk_norm:
        p["q_norm"] = init_rmsnorm(hd, gen.device)
        p["k_norm"] = init_rmsnorm(hd, gen.device)
    return p


def _proj_heads(p, x, dtype):
    """x (B,S,d) @ (d,H,hd) -> (B,S,H,hd)."""
    y = torch.einsum("bsd,dhk->bshk", x.to(dtype), p["w"].to(dtype))
    if "b" in p:
        y = y + p["b"].to(dtype)[None, None]
    return y


def _proj_out(p, x, dtype):
    """x (B,S,H,hd) @ (H,hd,d) -> (B,S,d)."""
    return torch.einsum("bshk,hkd->bsd", x.to(dtype), p["w"].to(dtype))


def _softcap(x, cap):
    return cap * torch.tanh(x / cap) if cap else x


def _mask_bias(q_pos, k_pos, window, k_valid=None):
    """Additive fp32 mask bias: causal + optional sliding window + validity.

    ``q_pos``/``k_pos`` are (Sq,)/(Sk,) for a shared position grid, or carry
    leading batch dims, (B,Sq)/(B,Sk) for per-slot decode positions in the
    continuous-batching ring, giving a (B,Sq,Sk) bias. ``window`` is 0 (full
    attention) or a positive int (``HUGE_WINDOW`` on global layers)."""
    ok = k_pos[..., None, :] <= q_pos[..., :, None]
    if _window_on(window):
        ok &= (q_pos[..., :, None] - k_pos[..., None, :]) < window
    if k_valid is not None:
        ok &= k_valid[..., None, :]
    zero = torch.zeros((), dtype=torch.float32, device=q_pos.device)
    return torch.where(ok, zero, torch.full_like(zero, -1e30))


def _window_on(window) -> bool:
    """A window that masks: a positive int below ``HUGE_WINDOW``. (The
    reference's per-layer windows are traced inside its layer scan, so its
    ``_window_on`` counts ``HUGE_WINDOW`` as on; the port's are ints.)"""
    return bool(window) and 0 < window < HUGE_WINDOW


def _sdpa_dense(q, k, v, q_pos, k_pos, window, softcap, k_valid=None):
    """q (B,Sq,H,D), k (B,Sk,Hk,D), v (B,Sk,Hk,Dv) -> (B,Sq,H,Dv). fp32
    softmax; the scale is D^-½ (the value head dim may differ: MLA's).

    Positions are (Sq,)/(Sk,) shared across the batch, or (B,Sq)/(B,Sk) for
    per-slot decode positions (continuous batching)."""
    B, Sq, H, D = q.shape
    Hk = k.shape[2]
    rep = H // Hk
    qf = (q.float() * (D ** -0.5)).reshape(B, Sq, Hk, rep, D)
    kf = k.float()
    vf = v.float()
    logits = torch.einsum("bqhrd,bkhd->bhrqk", qf, kf)
    logits = _softcap(logits, softcap)
    bias = _mask_bias(q_pos, k_pos, window, k_valid)
    # (Sq,Sk) -> (1,1,Sq,Sk) broadcast; (B,Sq,Sk) -> (B,1,1,Sq,Sk)
    logits = logits + bias[..., None, None, :, :]
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhrqk,bkhd->bqhrd", w, vf)
    return out.reshape(B, Sq, H, v.shape[-1])


@dataclasses.dataclass
class AttnCall:
    """Runtime knobs for an attention call (not parameters). ``window`` is
    0 (full attention) or a positive int; ``force_window`` overrides every
    layer's window (the ring-buffer decode cache of ``decode_window``)."""
    window: int = 0
    softcap: float = 0.0
    chunk: int = 0                  # 0 = dense; else KV-chunked online softmax
    use_flash_kernel: bool = False  # K4 (flash attention), any window
    use_decode_kernel: bool = False  # K5, single-query decode attention
    force_window: int = 0
    exact_moe: bool = False         # MoE capacity = tokens·K (no drops)
    moe_shard: object = None        # hook on the MoE buffers (see moe_apply)


def attention(p, cfg: ModelConfig, x, positions, call: AttnCall, dtype):
    """Full causal self-attention over x (B,S,d) at integer positions (S,).
    Returns (out (B,S,d), (k, v)): the compact Hk-head keys (after RoPE) and
    values, for the decode cache. A config with ``rope`` off (nemotron_h)
    gives the queries and keys no position.

    A call that ``_takes_k4`` (a differentiated call on the card) runs K4's
    training instance and its VJP K4b (``fa.flash_attention_train``;
    counter ``model.attn_k4``, forward and remat recompute alike), with the
    layer's window and softcap, at every S. Every other call takes the
    reference's three routes, in its order: K4's serving instance
    (``kernels.ops.flash_attention``, no gradient) when
    ``use_flash_kernel`` is set, at every S, with the layer's window
    (gemma3's local layers, qwen3-4b-swa, a ``decode_window``); else the
    KV-chunked online softmax of ``models/flash.py`` when ``chunk`` is set
    and S > ``chunk``; else dense attention. (The reference takes K4 only
    where no window masks: its per-layer windows are traced in its layer
    scan, so its model never reaches K4. The TPU kernel takes a window, and
    the port's skips the tiles beyond it.) K4 reads the compact Hk-head K/V
    (query head h on kv head h // rep, as the TPU kernel's index map does);
    the other two routes repeat KV to the full head count first, as the
    reference does."""
    S = x.shape[1]
    h, hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = _proj_heads(p["wq"], x, dtype)
    k = _proj_heads(p["wk"], x, dtype)
    v = _proj_heads(p["wv"], x, dtype)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    if cfg.rope:
        cos, sin = rope_cos_sin(positions, hd, cfg.rope_theta)
        q = apply_rope(q, cos, sin).to(dtype)
        k = apply_rope(k, cos, sin).to(dtype)
    cache_kv = (k, v)
    rep = h // hk
    with trace.span("model.attention") as sp:
        q, k, v = sp.inputs(q, k, v)
        win = call.window if _window_on(call.window) else 0
        if _takes_k4(q, k, v):
            trace.count("model.attn_k4")
            out = fa.flash_attention_train(q, k, v, window=win,
                                           softcap=call.softcap)
        elif call.use_flash_kernel:
            from repro_torch.kernels import ops as kops
            out = kops.flash_attention(q, k, v, window=win,
                                       softcap=call.softcap)
        elif call.chunk and S > call.chunk:
            out = flash_attention_bshd(q, *_repeat_kv(k, v, rep), positions,
                                       positions, window=win,
                                       softcap=call.softcap, bq=call.chunk,
                                       bk=call.chunk)
        else:
            out = _sdpa_dense(q, *_repeat_kv(k, v, rep), positions,
                              positions, call.window, call.softcap)
        out = sp.output(out)
    return _proj_out(p["wo"], out.to(dtype), dtype), cache_kv


def _takes_k4(q, k, v):
    """The card's training route: CUDA tensors, grad enabled and an input
    that requires it, and a head dim and dtype that K4b takes
    (``fa.bwd_takes``: fp32, D <= 128 a multiple of 4; every window and
    softcap). Fake CUDA tensors (the dry run on a CUDA build) take it too:
    K4 and K4b are operators with fake kernels and FLOP formulas, so the
    dry run traces and counts the program the card runs. What the inputs
    show decides, not a model's name or a knob: every transformer family's
    attention (qwen2, qwen3, qwen2-moe, internvl2, musicgen, zamba2's
    shared block, nemotron_h's ``*`` layers) takes it alike, and
    ``dense_attn_max`` and ``attn_chunk`` do not reach it. Today's routes
    keep the CPU (every CPU test), no-grad calls (serving, on its own
    ``use_flash_kernel`` choice), bf16 compute, gemma3's D 256 and any D
    past 128 or not a multiple of 4; MLA (``models/mla.py``) does not call
    ``attention``. A differentiated backward (the Hessian-vector products)
    goes through the plain forward's graph (``fa._vjp_graph``)."""
    return (q.is_cuda and torch.is_grad_enabled()
            and any(t.requires_grad for t in (q, k, v))
            and fa.bwd_takes(q.shape[-1], q.dtype))


def _repeat_kv(k, v, rep):
    """(B,S,Hk,D) K/V repeated to the full head count, each kv head rep
    times in a row (query head h reads kv head h // rep)."""
    if rep == 1:
        return k, v
    return (torch.repeat_interleave(k, rep, dim=2),
            torch.repeat_interleave(v, rep, dim=2))


def attention_decode(p, cfg: ModelConfig, x, pos, kcache, vcache,
                     call: AttnCall, dtype):
    """Decode one token: x (B,1,d); cache (B,C,Hk,D) bf16.

    ``pos`` is an int (one shared position, the batched-serve path) or a
    (B,) int tensor of per-slot positions (continuous batching: every slot
    of the ring is at its own depth in its own sequence). The cache may be a
    ring buffer (C == window): the new key and value go to slot pos % C and
    the absolute positions of the slots are reconstructed, so the causal and
    window masks stay right.

    Unlike the reference, which returns updated copies, the new token's K/V
    are written into ``kcache``/``vcache`` IN PLACE; the same tensors are
    returned. With ``call.use_decode_kernel`` the attention runs on kernel
    K5 (``kernels.ops.decode_attention``)."""
    B = x.shape[0]
    hd = cfg.head_dim
    C = kcache.shape[1]
    dev = x.device
    q = _proj_heads(p["wq"], x, dtype)
    k = _proj_heads(p["wk"], x, dtype)
    v = _proj_heads(p["wv"], x, dtype)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    idx = torch.arange(C, dtype=torch.int32, device=dev)
    if not torch.is_tensor(pos) or pos.dim() == 0:
        pos = int(pos)
        posv = torch.full((1,), pos, dtype=torch.int32, device=dev)
        cos, sin = rope_cos_sin(posv, hd, cfg.rope_theta)
        q = apply_rope(q, cos, sin).to(dtype)
        k = apply_rope(k, cos, sin).to(dtype)
        slot = pos % C
        kcache[:, slot] = k[:, 0].to(kcache.dtype)
        vcache[:, slot] = v[:, 0].to(vcache.dtype)
        # absolute positions of the cache slots of a ring buffer
        wrap = (pos // C) * C
        k_pos = torch.where(idx <= slot, wrap + idx, wrap - C + idx)
        q_pos = posv
    else:
        posb = pos.to(device=dev, dtype=torch.int32)            # (B,)
        cos, sin = rope_cos_sin(posb[:, None], hd, cfg.rope_theta)  # (B,1,·)
        q = apply_rope(q, cos, sin).to(dtype)
        k = apply_rope(k, cos, sin).to(dtype)
        slot = torch.remainder(posb, C)                         # (B,)
        rows = torch.arange(B, device=dev)
        kcache[rows, slot] = k[:, 0].to(kcache.dtype)
        vcache[rows, slot] = v[:, 0].to(vcache.dtype)
        wrap = torch.div(posb, C, rounding_mode="floor") * C    # (B,)
        k_pos = torch.where(idx[None, :] <= slot[:, None],
                            wrap[:, None] + idx[None, :],
                            wrap[:, None] - C + idx[None, :])   # (B,C)
        q_pos = posb[:, None]                                   # (B,1)
    k_valid = k_pos >= 0
    if call.use_decode_kernel:
        from repro_torch.kernels import ops as kops
        bias = _mask_bias(q_pos, k_pos, call.window, k_valid)   # (·,1,C)
        bias = bias.reshape(-1, C).expand(B, C).contiguous()
        out = kops.decode_attention(q[:, 0].float().contiguous(), kcache,
                                    vcache, bias,
                                    softcap=call.softcap)[:, None]
    else:
        out = _sdpa_dense(q, kcache, vcache, q_pos, k_pos, call.window,
                          call.softcap, k_valid=k_valid)
    return _proj_out(p["wo"], out.to(dtype), dtype), kcache, vcache


# --------------------------------------------------------------------------- #
# MLP: gated (SwiGLU / GeGLU), or relu² without a gate
# --------------------------------------------------------------------------- #


def init_mlp(gen, d, f, act="silu"):
    """``wu`` and ``wd``, and the gate ``wg`` unless ``act`` is relu²."""
    if act == "relu2":
        return {"wu": _dense_init(gen, d, f), "wd": _dense_init(gen, f, d)}
    return {"wg": _dense_init(gen, d, f), "wu": _dense_init(gen, d, f),
            "wd": _dense_init(gen, f, d)}


def relu2(x):
    return torch.square(F.relu(x))


def mlp(p, x, act, dtype):
    if act == "relu2":                  # down(relu(up(x))²)
        return linear(p["wd"], relu2(linear(p["wu"], x, dtype)), dtype)
    g = linear(p["wg"], x, dtype)
    u = linear(p["wu"], x, dtype)
    # jax.nn.gelu defaults to the tanh approximation
    a = F.silu(g) if act == "silu" else F.gelu(g, approximate="tanh")
    return linear(p["wd"], a * u, dtype)


# --------------------------------------------------------------------------- #
# Embedding / head
# --------------------------------------------------------------------------- #


def padded_vocab(v, multiple=2048):
    return ((v + multiple - 1) // multiple) * multiple


def init_embed(gen, cfg: ModelConfig):
    V = padded_vocab(cfg.vocab_size)
    p = {"table": _normal(gen, (V, cfg.d_model), 0.02)}
    if not cfg.tie_embeddings:
        p["head"] = _normal(gen, (cfg.d_model, V), cfg.d_model ** -0.5)
    return p


def embed(p, tokens, dtype):
    return p["table"].to(dtype)[tokens]


def unembed(p, x, cfg: ModelConfig, dtype):
    if cfg.tie_embeddings:
        logits = x.to(dtype) @ p["table"].to(dtype).T
        return logits * (cfg.d_model ** -0.5)  # gemma-style tied-head scaling
    return x.to(dtype) @ p["head"].to(dtype)


def cross_entropy(logits, labels, vocab_size, norm=None):
    """Mean CE over positions; labels < 0 are masked out; padded vocab
    masked. ``norm`` (a tensor) replaces the count of unmasked positions
    as the denominator."""
    V = logits.shape[-1]
    logits = logits.float()
    if V > vocab_size:
        pad = torch.arange(V, device=logits.device) >= vocab_size
        logits = logits.masked_fill(pad, -1e30)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        labels.clamp_min(0).long()[..., None])[..., 0]
    nll = logz - gold
    mask = (labels >= 0).float()
    if norm is not None:
        return (nll * mask).sum() / norm
    return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
