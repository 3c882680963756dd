"""Memory-efficient (flash-style) attention in plain PyTorch with a recompute
backward (counterpart of ``repro/models/flash.py``).

Forward: an online softmax over KV blocks for each Q block, so only O(S·D)
residuals (out, row max m, row sum l) are kept, never the S×S scores.
Backward: the FlashAttention-2 recompute, a ``torch.autograd.Function``:
each block pair's scores are rebuilt from the saved (q, k, v, out, m, l); dq
is summed over KV blocks, dk/dv over Q blocks. Peak memory is O(block²)
rather than O(S²): differentiating through the forward's loop would keep
every block's probabilities (45 GB per device on qwen2-0.5b at 4096 tokens,
as the reference's docstring records).

This is the model's plain route for prompts longer than ``dense_attn_max``
when kernel K4 (``use_flash_kernel``) is off and the call is not on the
card's training route (K4 + K4b, ``layers._takes_k4``). It computes every
block pair, masked ones included, as the reference does.

Layout: q (B,H,Sq,D), k/v (B,H,Sk,D), KV already repeated to the full head
count (``flash_attention_bshd`` takes (B,S,H,D)). Each operation follows the
reference's order: q·scale before the dot, the softcap, masked scores set to
NEG = -1e30, m starting at NEG, out = acc / max(l, 1e-30).
"""
from __future__ import annotations

import torch

NEG = -1e30
HUGE_WINDOW = 2 ** 30   # a window this wide never masks: full attention


def _blk_mask(q_pos, k_pos, window):
    """(bq, bk) bool: causal and inside the window (``HUGE_WINDOW`` = full)."""
    ok = k_pos[None, :] <= q_pos[:, None]
    ok &= (q_pos[:, None] - k_pos[None, :]) < window
    return ok


def _scores(qq, kk, qp, kp, window, softcap, scale):
    """Masked (softcapped) fp32 scores of one block pair and the raw dot."""
    raw = torch.einsum("bhqd,bhkd->bhqk", qq.float() * scale, kk.float())
    s = softcap * torch.tanh(raw / softcap) if softcap else raw
    s = torch.where(_blk_mask(qp, kp, window)[None, None], s, NEG)
    return s, raw


def _blocks(x, n, b):
    """(B,H,n·b,...) -> the n blocks along dim 2, as views."""
    return x.unflatten(2, (n, b)).unbind(2)


def _flash_fwd_all(q, k, v, q_pos, k_pos, window, softcap, bq, bk):
    """(out in q's dtype, m, l), m and l (B,H,Sq) fp32."""
    B, H, Sq, D = q.shape
    nq, nk = Sq // bq, k.shape[2] // bk
    scale = D ** -0.5
    kbs, vbs = _blocks(k, nk, bk), _blocks(v, nk, bk)
    kps = k_pos.reshape(nk, bk).unbind(0)
    outs, ms, ls = [], [], []
    for qq, qp in zip(_blocks(q, nq, bq), q_pos.reshape(nq, bq).unbind(0)):
        m = torch.full((B, H, bq), NEG, dtype=torch.float32, device=q.device)
        l = torch.zeros((B, H, bq), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, H, bq, D), dtype=torch.float32, device=q.device)
        for kk, vv, kp in zip(kbs, vbs, kps):
            s, _ = _scores(qq, kk, qp, kp, window, softcap, scale)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum("bhqk,bhkd->bhqd", p,
                                                       vv.float())
            m = m_new
        outs.append(acc / torch.clamp_min(l, 1e-30)[..., None])
        ms.append(m)
        ls.append(l)
    return torch.cat(outs, 2).to(q.dtype), torch.cat(ms, 2), torch.cat(ls, 2)


class _FlashMHA(torch.autograd.Function):
    """The reference's ``flash_mha``: q (B,H,Sq,D), k/v (B,H,Sk,D), a
    positive int ``window`` (``HUGE_WINDOW`` = full attention), Sq % bq ==
    Sk % bk == 0. Forward ``_flash_fwd_all``; backward the reference's
    ``_bwd_rule``."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, k_pos, window, softcap, bq, bk):
        out, m, l = _flash_fwd_all(q, k, v, q_pos, k_pos, window, softcap,
                                   bq, bk)
        ctx.save_for_backward(q, k, v, out, m, l, q_pos, k_pos)
        ctx.cfg = (window, softcap, bq, bk)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, m, l, q_pos, k_pos = ctx.saved_tensors
        window, softcap, bq, bk = ctx.cfg
        D = q.shape[-1]
        nq, nk = q.shape[2] // bq, k.shape[2] // bk
        scale = D ** -0.5
        f32 = torch.float32
        delta = (dout.float() * out.float()).sum(-1)             # (B,H,Sq)
        qbs, dobs = _blocks(q, nq, bq), _blocks(dout, nq, bq)
        mbs, lbs, dbs = (_blocks(x[..., None], nq, bq) for x in (m, l, delta))
        qps = q_pos.reshape(nq, bq).unbind(0)
        kbs, vbs = _blocks(k, nk, bk), _blocks(v, nk, bk)
        kps = k_pos.reshape(nk, bk).unbind(0)

        def p_block(qq, kk, qp, kp, mm, ll):
            s, raw = _scores(qq, kk, qp, kp, window, softcap, scale)
            p = torch.exp(s - mm) / torch.clamp_min(ll, 1e-30)
            return p, raw

        def ds_block(p, dp, dd, raw):
            ds = p * (dp - dd)
            if softcap:
                ds = ds * (1.0 - torch.tanh(raw / softcap) ** 2)
            return ds

        dq = []
        for qq, do, mm, ll, dd, qp in zip(qbs, dobs, mbs, lbs, dbs, qps):
            acc = torch.zeros(qq.shape, dtype=f32, device=q.device)
            for kk, vv, kp in zip(kbs, vbs, kps):
                p, raw = p_block(qq, kk, qp, kp, mm, ll)
                dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), vv.float())
                ds = ds_block(p, dp, dd, raw)
                acc = acc + torch.einsum("bhqk,bhkd->bhqd", ds,
                                         kk.float()) * scale
            dq.append(acc)
        dk, dv = [], []
        for kk, vv, kp in zip(kbs, vbs, kps):
            dk_acc = torch.zeros(kk.shape, dtype=f32, device=q.device)
            dv_acc = torch.zeros(kk.shape[:3] + vv.shape[3:], dtype=f32,
                                 device=q.device)
            for qq, do, mm, ll, dd, qp in zip(qbs, dobs, mbs, lbs, dbs, qps):
                p, raw = p_block(qq, kk, qp, kp, mm, ll)
                dv_acc = dv_acc + torch.einsum("bhqk,bhqd->bhkd", p,
                                               do.float())
                dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), vv.float())
                ds = ds_block(p, dp, dd, raw)
                dk_acc = dk_acc + torch.einsum("bhqk,bhqd->bhkd", ds,
                                               qq.float()) * scale
            dk.append(dk_acc)
            dv.append(dv_acc)
        return (torch.cat(dq, 2).to(q.dtype), torch.cat(dk, 2).to(k.dtype),
                torch.cat(dv, 2).to(v.dtype), None, None, None, None, None,
                None)


def flash_attention_bshd(q, k, v, q_pos, k_pos, *, window=None, softcap=0.0,
                         bq=1024, bk=1024):
    """(B,S,H,D) layout wrapper; KV already repeated to H heads.

    ``window`` is None, 0 (full attention) or a positive int. ``bq``/``bk``
    are clipped to the lengths; a length that is not a multiple of its
    block raises ValueError (the reference fails on a reshape there)."""
    Sq, Sk = q.shape[1], k.shape[1]
    bq, bk = min(bq, Sq), min(bk, Sk)
    if Sq % bq or Sk % bk:
        raise ValueError(f"flash attention needs Sq % bq == 0 and Sk % bk == "
                         f"0; got Sq={Sq}, bq={bq}, Sk={Sk}, bk={bk}")
    window = HUGE_WINDOW if not window else int(window)
    if window < 0:
        raise ValueError(f"window must be None, 0 or positive; got {window}")
    o = _FlashMHA.apply(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), q_pos, k_pos, window,
                        float(softcap), bq, bk)
    return o.transpose(1, 2)
