"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434; counterpart
of ``repro/models/mla.py``).

KV is compressed into a per-token latent c_kv (``kv_lora_rank``) plus one
RoPE key head shared by every query head (``qk_rope_head_dim``). The decode
cache stores only (c_kv, k_pe), 512 + 64 values a token at full width.

The parameters keep the reference's tree, scales and head-major layouts:
``wq_a`` (d, q_lora), ``q_norm``, ``wq_b`` (q_lora, H, nope + rope),
``wkv_a`` (d, kv_lora + rope), ``kv_norm``, ``wk_b`` (kv_lora, H, nope),
``wv_b`` (kv_lora, H, v), ``wo`` (H, v, d).

``mla_attention`` (training and prefill) takes three routes, in this
order: kernel K4 (``kernels.ops.flash_attention``) under
``use_flash_kernel``; the KV-chunked online softmax of ``models/flash.py``
when ``chunk`` is set and S > ``chunk``; else dense attention
(``layers._sdpa_dense``, whose value head dim may differ from the query's).
K4 and the chunked route take q and k at D = nope + rope and V padded with
zeros to that width, then keep V's first ``v_head_dim`` columns: the
reference's own padding on its chunked route (its MLA never reaches its
K4: its block calls ``mla_attention`` with ``chunk`` only).

``mla_decode`` runs one token against the latent cache, as the reference
does, on PyTorch tensor ops (its attention is einsums there, not a
kernel): ``absorbed`` (the default) folds W_uk into the query and W_uv
after the attention, which then runs in the latent space; ``naive``
rebuilds K and V from the latent every step.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs import ModelConfig
from repro_torch.models.flash import flash_attention_bshd
from repro_torch.models.layers import (_dense_init, _normal, _sdpa_dense,
                                       apply_rope, init_rmsnorm, linear,
                                       rmsnorm, rope_cos_sin)

INT32_MAX = 2 ** 31 - 1


def init_mla(gen, cfg: ModelConfig):
    """The MLA tree, drawn from ``gen`` in the reference's order (``wq_a``,
    ``wq_b``, ``wkv_a``, ``wk_b``, ``wv_b``, ``wo``) at its scales:
    (fan-in)^-½ for the projections, (H·v)^-½ for ``wo``."""
    m, d, H = cfg.mla, cfg.d_model, cfg.n_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim

    def hproj(r, nd):
        return {"w": _normal(gen, (r, H, nd), r ** -0.5)}

    return {
        "wq_a": _dense_init(gen, d, m.q_lora_rank),
        "q_norm": init_rmsnorm(m.q_lora_rank, gen.device),
        "wq_b": hproj(m.q_lora_rank, qk),
        "wkv_a": _dense_init(gen, d, m.kv_lora_rank + m.qk_rope_head_dim),
        "kv_norm": init_rmsnorm(m.kv_lora_rank, gen.device),
        "wk_b": hproj(m.kv_lora_rank, m.qk_nope_head_dim),
        "wv_b": hproj(m.kv_lora_rank, m.v_head_dim),
        "wo": {"w": _normal(gen, (H, m.v_head_dim, d),
                            (H * m.v_head_dim) ** -0.5)},
    }


def _hproj(p, x, dtype):
    """x (B,S,r) @ (r,H,nd) -> (B,S,H,nd)."""
    return torch.einsum("bsr,rhn->bshn", x.to(dtype), p["w"].to(dtype))


def _project_q(p, cfg: ModelConfig, x, positions, dtype):
    """q through its LoRA (``wq_a``, RMSNorm, ``wq_b``), split into its
    nope and rope parts, RoPE on the rope part: (q_nope, q_pe), each
    (B,S,H,·) in ``dtype``."""
    m = cfg.mla
    q = _hproj(p["wq_b"], rmsnorm(p["q_norm"], linear(p["wq_a"], x, dtype),
                                  cfg.norm_eps), dtype)
    q_nope = q[..., :m.qk_nope_head_dim]
    q_pe = q[..., m.qk_nope_head_dim:]
    cos, sin = rope_cos_sin(positions, m.qk_rope_head_dim, cfg.rope_theta)
    return q_nope, apply_rope(q_pe, cos, sin).to(dtype)


def _latent_kv(p, cfg: ModelConfig, x, positions, dtype):
    """The latent cache entries of x (B,S,d): c_kv (B,S,kv_lora), RMSNorm'd,
    and the one shared rope key k_pe (B,S,rope), RoPE applied; in
    ``dtype``."""
    m = cfg.mla
    kv = linear(p["wkv_a"], x, dtype)
    c_kv = rmsnorm(p["kv_norm"], kv[..., :m.kv_lora_rank], cfg.norm_eps)
    k_pe = kv[..., m.kv_lora_rank:][..., None, :]            # (B,S,1,rope)
    cos, sin = rope_cos_sin(positions, m.qk_rope_head_dim, cfg.rope_theta)
    k_pe = apply_rope(k_pe, cos, sin).to(dtype)[..., 0, :]
    return c_kv, k_pe


def mla_attention(p, cfg: ModelConfig, x, positions, dtype, chunk=0,
                  use_flash_kernel=False):
    """Full-sequence causal MLA over x (B,S,d) at positions (S,). Returns
    (y (B,S,d), (c_kv, k_pe)): the latent cache of every position. K is
    [W_uk·c_kv ‖ k_pe broadcast to the H heads], V = W_uv·c_kv; the
    scale is (nope + rope)^-½ on every route."""
    m, H = cfg.mla, cfg.n_heads
    B, S, _ = x.shape
    q_nope, q_pe = _project_q(p, cfg, x, positions, dtype)
    c_kv, k_pe = _latent_kv(p, cfg, x, positions, dtype)
    k_nope = _hproj(p["wk_b"], c_kv, dtype)
    v = _hproj(p["wv_b"], c_kv, dtype)
    k_pe_b = k_pe[:, :, None, :].expand(B, S, H, m.qk_rope_head_dim)
    q = torch.cat([q_nope, q_pe], -1)
    k = torch.cat([k_nope, k_pe_b], -1)
    if use_flash_kernel or (chunk and S > chunk):
        # pad V's head dim up to QK's so one kernel handles both
        vp = F.pad(v, (0, q.shape[-1] - v.shape[-1]))
        if use_flash_kernel:
            from repro_torch.kernels import ops as kops
            out = kops.flash_attention(q, k, vp)
        else:
            out = flash_attention_bshd(q, k, vp, positions, positions,
                                       bq=chunk, bk=chunk)
        out = out[..., :m.v_head_dim]
    else:
        out = _sdpa_dense(q, k, v, positions, positions, 0, 0.0)
    y = torch.einsum("bshv,hvd->bsd", out.to(dtype), p["wo"]["w"].to(dtype))
    return y, (c_kv, k_pe)


def mla_decode(p, cfg: ModelConfig, x, pos, ckv_cache, kpe_cache, dtype,
               absorbed=True):
    """Decode one token x (B,1,d) against the latent cache ``ckv_cache``
    (B,C,kv_lora) and ``kpe_cache`` (B,C,rope): the slot is the position
    (no ring buffer; the MLA archs attend to their whole context).

    ``pos`` is an int (one shared position) or a (B,) int tensor of
    per-slot positions (continuous batching). The token's c_kv and k_pe
    are written into the caches IN PLACE (the reference returns updated
    copies); the same tensors are returned beside y (B,1,d).

    ``absorbed``: q_lat[h] = q_nope[h]·W_uk[h]ᵀ, scores and the weighted
    sum in the latent space, W_uv after, all in fp32 whatever ``dtype``
    (the reference's). Else K and V are rebuilt from the cache in
    ``dtype`` and attended densely."""
    m, H = cfg.mla, cfg.n_heads
    B = x.shape[0]
    C = ckv_cache.shape[1]
    dev = x.device
    idx = torch.arange(C, dtype=torch.int32, device=dev)
    if not torch.is_tensor(pos) or pos.dim() == 0:
        pos = int(pos)
        posv = torch.full((1,), pos, dtype=torch.int32, device=dev)
        q_nope, q_pe = _project_q(p, cfg, x, posv, dtype)    # (B,1,H,·)
        c_kv, k_pe = _latent_kv(p, cfg, x, posv, dtype)
        ckv_cache[:, pos] = c_kv[:, 0].to(ckv_cache.dtype)
        kpe_cache[:, pos] = k_pe[:, 0].to(kpe_cache.dtype)
        valid = idx <= pos                                   # (C,)
        vmask = valid[None, None, None]
        q_pos = posv
    else:
        posb = pos.to(device=dev, dtype=torch.int32)         # (B,)
        q_pos = posb[:, None]                                # (B,1)
        q_nope, q_pe = _project_q(p, cfg, x, q_pos, dtype)
        c_kv, k_pe = _latent_kv(p, cfg, x, q_pos, dtype)
        rows = torch.arange(B, device=dev)
        ckv_cache[rows, posb] = c_kv[:, 0].to(ckv_cache.dtype)
        kpe_cache[rows, posb] = k_pe[:, 0].to(kpe_cache.dtype)
        valid = idx[None, :] <= posb[:, None]                # (B,C)
        vmask = valid[:, None, None, :]
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5

    if absorbed:
        f32 = torch.float32
        ckv = ckv_cache.to(f32)
        q_lat = torch.einsum("bqhd,rhd->bqhr", q_nope.to(f32),
                             p["wk_b"]["w"].to(f32))
        logits = (torch.einsum("bqhr,bkr->bhqk", q_lat, ckv)
                  + torch.einsum("bqhd,bkd->bhqk", q_pe.to(f32),
                                 kpe_cache.to(f32))) * scale
        logits = torch.where(vmask, logits, -1e30)
        w = torch.softmax(logits, dim=-1)
        o_lat = torch.einsum("bhqk,bkr->bqhr", w, ckv)
        out = torch.einsum("bqhr,rhd->bqhd", o_lat, p["wv_b"]["w"].to(f32))
    else:
        lat = ckv_cache.to(dtype)
        k_nope = _hproj(p["wk_b"], lat, dtype)
        v = _hproj(p["wv_b"], lat, dtype)
        kpe_b = kpe_cache[:, :, None, :].to(dtype).expand(
            B, C, H, m.qk_rope_head_dim)
        q = torch.cat([q_nope, q_pe], -1)
        k = torch.cat([k_nope, kpe_b], -1)
        k_pos = torch.where(valid, idx.expand(valid.shape),
                            torch.full_like(idx, INT32_MAX))
        out = _sdpa_dense(q, k, v, q_pos, k_pos, 0, 0.0, k_valid=valid)
    y = torch.einsum("bshv,hvd->bsd", out.to(dtype), p["wo"]["w"].to(dtype))
    return y, ckv_cache, kpe_cache
