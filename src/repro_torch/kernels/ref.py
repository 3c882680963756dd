"""Plain PyTorch versions of the port's kernels (counterpart of
``repro/kernels/ref.py``): the contract each CUDA kernel is held against on
the card, and what the wrappers run for tensors that lie on the CPU."""
from __future__ import annotations

import torch

from repro_torch.core import preconditioner as PC


def scaled_update_ref(p, m, g, d, *, gamma, beta1, alpha, squared=True):
    """The legacy per-leaf scaled step on fp32 tensors of one shape:

        m' = β₁m + g;  D̂ = max(α, √d) (|d| when not ``squared``);
        p' = p − (γ·m')/D̂

    in the reference's order of fp32 operations (``gamma * m / dhat`` is
    (γ·m')/D̂). β₁m and + g are separate roundings, never one FMA, and the
    max passes a NaN through, as ``jnp.maximum`` does. Returns ``(p', m')``.
    The plain version of kernel K2."""
    m_new = torch.mul(m, beta1).add_(g)
    mag = torch.sqrt(d) if squared else torch.abs(d)
    dhat = torch.clamp(mag, min=alpha)
    return p - torch.mul(m_new, gamma).div_(dhat), m_new


def fused_step_math(p, m, g, d, h, t, s, *, gamma, beta1, weight_decay,
                    alpha, beta2, kind, clip, schedule, update_d):
    """One generic-scaling local step, the paper's unified Assumption-4 rule.

    Delegates the D math to ``preconditioner.update``/``dhat`` (the bare
    buffers are valid one-leaf trees), so the fused path and the engine's tree
    path share one copy of the formulas. Every operation is a separate eager
    op rounded to fp32, in the reference's order: g·s, the D update, g + wd·p,
    m' = β₁m + g, then m'/D̂ first and ×γ after (DESIGN.md §7). The CUDA kernel
    repeats exactly this sequence.

    ``d``/``h``/``t``/``s`` may be None when the mode does not use them;
    ``t``/``s`` must already broadcast against ``p`` ((M, 1) here). Returns
    ``(p', m', d')`` with ``d'`` None unless ``update_d``.
    """
    cfg = PC.PrecondConfig(kind=kind, beta2=beta2, alpha=alpha, clip=clip,
                           beta_schedule=schedule)
    if s is not None:
        g = g * s                       # engine._clip's per-client scale
    d_new = None
    if update_d:                        # local scaling: D advances every step
        stat = (g ** 2) if h is None else h   # grad_stat | external stat
        tt = t if t is not None else torch.zeros((), dtype=torch.int32,
                                                 device=p.device)
        d_new = PC.update(cfg, {"d": d, "t": tt}, stat)["d"]
        d = d_new
    if weight_decay:
        g = g + weight_decay * p
    m_new = beta1 * m + g
    if kind == "identity":
        p_new = p - gamma * m_new
    else:
        p_new = p - gamma * (m_new / PC.dhat(cfg, None, leaf_of=d))
    return p_new, m_new, d_new


def fused_step_ref(p, m, g, d=None, h=None, t=None, s=None, *, gamma, beta1,
                   weight_decay=0.0, alpha, beta2=0.999, kind, clip="max",
                   schedule="const", update_d=False):
    """(M, n) plain version of the fused kernel: per-row ``t`` (M,) int32 and
    ``s`` (M,) fp32 broadcast over n. Pure: returns new tensors."""
    t2 = None if t is None else t[:, None]
    s2 = None if s is None else s[:, None]
    return fused_step_math(p, m, g, d, h, t2, s2, gamma=gamma, beta1=beta1,
                           weight_decay=weight_decay, alpha=alpha, beta2=beta2,
                           kind=kind, clip=clip, schedule=schedule,
                           update_d=update_d)


def quantize_update_ref(x, u, scale):
    """Stochastic int8 quantize-dequantize of (M, n) fp32 ``x`` with U[0, 1)
    draws ``u`` (M, n) and a per-row scale ``scale`` (M,):

        v = x / s (0 where s <= 0);  q = clip(floor(v + u), ±127);  dec = q·s

    in the reference's order of fp32 operations. Returns ``(q int8, dec
    fp32)``, both (M, n). The plain version of kernel K3."""
    s = scale.reshape(-1, 1)
    pos = s > 0
    v = torch.where(pos, x / torch.where(pos, s, 1.0), 0.0)
    qf = v.add_(u).floor_().clamp_(-127.0, 127.0)
    return qf.to(torch.int8), qf * s


def flash_attention_ref(q, k, v, *, window=0, softcap=0.0):
    """Causal attention, dense: q (B,S,H,D), k/v (B,S,Hk,D) -> (B,S,H,D) in
    q's dtype. Query head h reads kv head h // (H/Hk). In fp32, in the
    reference's order: q·D^-½ first, then the softcap, then masked scores
    set to -1e30 (causal col <= row, and row - col < ``window`` when
    ``window`` > 0), then the softmax over the keys. The plain version of
    kernel K4; it holds all (B, H, S, S) scores at once."""
    B, S, H, D = q.shape
    Hk = k.shape[2]
    qf = (q.float() * (D ** -0.5)).reshape(B, S, Hk, H // Hk, D)
    s = torch.einsum("bqgrd,bkgd->bgrqk", qf, k.float())
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    i = torch.arange(S, device=q.device)
    mask = i[None, :] <= i[:, None]
    if window and window > 0:
        mask &= (i[:, None] - i[None, :]) < window
    s = torch.where(mask, s, -1e30)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrqk,bkgd->bqgrd", w, v.float())
    return out.reshape(B, S, H, v.shape[-1]).to(q.dtype)


def decode_attention_math(q, k, v, bias, softcap):
    """Single-query decode attention for (batch-slot, kv-head) cells.

    q (..., R, D) query heads sharing one kv head; k (..., C, D),
    v (..., C, Dv); bias (..., C) additive fp32 mask (causal / window / ring
    validity, from ``models.layers._mask_bias``). In the reference's order of
    fp32 operations: q·D^-½ first, then the softcap, then + bias, then the
    softmax; contractions are elementwise-mul + axis-sum, as the reference
    writes them. The plain version of kernel K5."""
    qf = q.float() * (q.shape[-1] ** -0.5)
    kf = k.float()
    s = (qf[..., :, None, :] * kf[..., None, :, :]).sum(-1)       # (..., R, C)
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    s = s + bias[..., None, :].float()
    w = torch.softmax(s, dim=-1)
    vf = v.float()
    return (w[..., :, :, None] * vf[..., None, :, :]).sum(-2)  # (..., R, Dv)


def decode_attention_ref(q, k, v, bias, *, softcap=0.0):
    """q (B,H,D), k/v (B,C,Hk,D|Dv) cache layout, bias (B,C) -> (B,H,Dv)
    fp32."""
    B, H, D = q.shape
    Hk = k.shape[2]
    qr = q.reshape(B, Hk, H // Hk, D)
    kr = k.transpose(1, 2)                                        # (B,Hk,C,D)
    vr = v.transpose(1, 2)
    out = decode_attention_math(qr, kr, vr, bias[:, None, :], softcap)
    return out.reshape(B, H, -1)


def decode_attention_split_ref(q, k, v, bias, *, split, softcap=0.0):
    """K5's split-and-merge arithmetic in plain PyTorch (for the tests): the
    scores of ``decode_attention_math``, cut over C into runs of ``split``
    positions; each run's max m_s, sum l_s = Σ e^(s - m_s) and unnormalised
    acc_s = Σ e^(s - m_s)·v, then the merge in run order, m* = max_s m_s,
    out = Σ_s e^(m_s - m*)·acc_s / Σ_s e^(m_s - m*)·l_s. Same layouts as
    ``decode_attention_ref``."""
    B, H, D = q.shape
    C, Hk = k.shape[1], k.shape[2]
    qf = (q.float() * (D ** -0.5)).reshape(B, Hk, H // Hk, D)
    kf = k.float().transpose(1, 2)                                # (B,Hk,C,D)
    vf = v.float().transpose(1, 2)
    s = (qf[..., :, None, :] * kf[..., None, :, :]).sum(-1)       # (B,Hk,R,C)
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    s = s + bias[:, None, None, :].float()
    ms, ls, accs = [], [], []
    for lo in range(0, C, split):
        x = s[..., lo:lo + split]
        m = x.amax(-1)
        p = torch.exp(x - m[..., None])
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append((p[..., None] * vf[:, :, None, lo:lo + split]).sum(-2))
    m, l, acc = torch.stack(ms), torch.stack(ls), torch.stack(accs)
    w = torch.exp(m - m.amax(0))
    out = (w[..., None] * acc).sum(0) / (w * l).sum(0)[..., None]
    return out.reshape(B, H, -1)


def decode_sample_math(y, table, noise, scale):
    """One vocab-block logit tile: (y·table_v)·scale + noise, two fp32
    roundings. y (B,d), table (blk,d), noise (B,blk) -> (B,blk) fp32;
    mul + sum contraction, as the reference writes it."""
    s = (y.float()[:, None, :] * table.float()[None, :, :]).sum(-1)
    return s * scale + noise.float()


def decode_sample_logits(y, table, noise, *, scale, v_real, block=2048):
    """The (B, V) logits the TPU kernel walks: ``decode_sample_math`` per
    vocab block of ``block`` rows, ids >= ``v_real`` set to -1e30."""
    V = table.shape[0]
    block = min(block, V)
    if V % block:
        raise ValueError(f"V={V} is not a multiple of block={block}")
    logits = torch.cat([decode_sample_math(y, table[lo:lo + block],
                                           noise[:, lo:lo + block], scale)
                        for lo in range(0, V, block)], dim=1)
    if v_real < V:
        logits[:, v_real:] = -1e30
    return logits


def decode_sample_ref(y, table, noise, *, scale, v_real, block=2048,
                      return_best=False):
    """Blockwise argmax over ``decode_sample_logits`` in the TPU kernel's
    block order: the strict ``>`` running compare across blocks keeps the
    first index of the maximum, as a full argmax does. Returns token ids
    (B,) int32 (and the winning values (B,) fp32 with ``return_best``). The
    plain version of kernel K6."""
    logits = decode_sample_logits(y, table, noise, scale=scale,
                                  v_real=v_real, block=block)
    B, V = logits.shape
    block = min(block, V)
    best = torch.full((B,), float("-inf"), dtype=torch.float32,
                      device=y.device)
    arg = torch.zeros((B,), dtype=torch.int32, device=y.device)
    for lo in range(0, V, block):
        blk = logits[:, lo:lo + block]
        a = torch.argmax(blk, dim=1)             # first index of the max
        m = blk.gather(1, a[:, None])[:, 0]
        upd = m > best
        arg = torch.where(upd, (a + lo).to(torch.int32), arg)
        best = torch.where(upd, m, best)
    return (arg, best) if return_best else arg


def near_tie_check(logits, ids, want, v_real, rel=1e-5):
    """Hold token ids ``ids`` of one implementation against ``want`` of
    another, both (B,), under the near-tie rule, with ``logits`` the plain
    (B, V) logits (noise added) that ``want`` was chosen from. Per row, over
    the real ids < ``v_real``, let τ = rel·(1 + max|ℓ|): where the top-2 gap
    of ℓ is > τ the ids must be equal; where it is not, ℓ[id] must be
    >= max ℓ − τ. Two implementations that sum in different orders may
    only disagree inside such a tie.

    Returns ``(exceptions, violations)``: rows whose ids differ inside a
    near tie, and rows that break the rule (an id >= v_real breaks it)."""
    lg = logits[:, :v_real].float()
    ids = ids.long().to(lg.device)
    want = want.long().to(lg.device)
    tau = rel * (1.0 + lg.abs().amax(dim=1))
    top = lg.topk(min(2, v_real), dim=1).values
    if v_real > 1:
        gap = top[:, 0] - top[:, 1]
    else:
        gap = torch.full_like(tau, float("inf"))
    in_range = ids < v_real
    chosen = lg.gather(1, ids.clamp(max=v_real - 1)[:, None])[:, 0]
    differ = ids != want
    tie = gap <= tau
    bad = ~in_range | (differ & ~tie) | (tie & (chosen < top[:, 0] - tau))
    return int((differ & tie & in_range).sum()), int(bad.sum())


def ssd_cumsum(dA):
    """Cumulative sum over the last axis, accumulated in fp64 and rounded
    once to fp32: within half an ulp of the exact sum, whatever order the
    device adds in, so kernel K7 (which adds in fp64 in order) and this
    plain version agree on cum bit for bit, but for an fp64 sum that lands
    within ~2^-29 relative of an fp32 rounding boundary (then one ulp).
    dA (..., Q) fp32 -> (..., Q) fp32."""
    return torch.cumsum(dA.double(), dim=-1).float()


def ssd_intra_chunk_ref(xh, dt, A, Bm, Cm, chunk):
    """The SSD intra-chunk term of each (batch, chunk, head) cell, batched
    over cells, in fp32: for a cell's x (Q,P), dt (Q,), B/C (Q,N),

        cum = cumsum(dt·A) (``ssd_cumsum``: fp64, rounded once);
        L = exp(cum_i - cum_j)·[i >= j], masked to -1e30 before the exp;
        Y_diag = ((C·Bᵀ) ⊙ L)·(x·dt);
        S_chunk = Bᵀ·((x·dt)·exp(cum_Q - cum));  total = exp(cum_Q).

    xh (B,S,H,P), dt (B,S,H), A (H,), Bm/Cm (B,S,H,N) (any strides), S %
    chunk == 0. Returns (Y_diag (B,S,H,P), S_chunk (B,nc,H,N,P), total
    (B,nc,H)). The plain version of kernel K7 (the TPU kernel's body at
    ``repro/kernels/ssd_scan.py:26``)."""
    B, S, H, P = xh.shape
    Q = chunk
    nc = S // Q

    def cells(t):               # (B,S,H,...) -> (B,nc,H,Q,...)
        t = t.float().reshape((B, nc, Q) + tuple(t.shape[2:]))
        return t.transpose(2, 3)

    x, dtc, Bc, Cc = cells(xh), cells(dt), cells(Bm), cells(Cm)
    cum = ssd_cumsum(dtc * A.float()[None, None, :, None])      # (B,nc,H,Q)
    xdt = x * dtc[..., None]                                     # (B,nc,H,Q,P)
    diff = cum[..., :, None] - cum[..., None, :]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                 device=xh.device))
    Lm = torch.exp(torch.where(mask, diff, -1e30)) * mask
    G = Cc @ Bc.transpose(-1, -2)                                # (B,nc,H,Q,Q)
    y = ((G * Lm) @ xdt).transpose(2, 3).reshape(B, S, H, P)
    decay_out = torch.exp(cum[..., -1:] - cum)                   # (B,nc,H,Q)
    s_chunk = Bc.transpose(-1, -2) @ (xdt * decay_out[..., None])
    return y, s_chunk, torch.exp(cum[..., -1])


def ssd_ref(xh, dt, A, Bm, Cm):
    """Naive sequential SSD recurrence (``models.ssm.ssd_reference``)."""
    from repro_torch.models.ssm import ssd_reference
    return ssd_reference(xh, dt, A, Bm, Cm)
