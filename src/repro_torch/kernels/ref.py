"""Plain PyTorch versions of the port's kernels (counterpart of
``repro/kernels/ref.py``): the contract each CUDA kernel is held against on
the card, and what the wrappers run for tensors that lie on the CPU."""
from __future__ import annotations

import torch

from repro_torch.core import preconditioner as PC


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
