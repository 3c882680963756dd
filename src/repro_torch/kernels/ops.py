"""Public wrappers around the port's kernels (counterpart of
``repro/kernels/ops.py``).

A wrapper routes by the device of the tensors it is given: a CUDA tensor goes
to the hand-written kernel (or raises), a CPU tensor to the kernel's plain
PyTorch version in ``kernels/ref.py``. There is no fallback from one to the
other.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import decode_step as _ds
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import quantize_update as _qu
from repro_torch.kernels import ref
from repro_torch.kernels import scaled_update as _su
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.utils import trace
from repro_torch.utils.tree import tree_leaves, tree_unflatten


def scaled_update(p, m, g, d, *, gamma, beta1, alpha, squared=True):
    """The per-leaf scaled step on tensors of any shape (one number of
    elements): flattened, run in fp32 on K2 (CUDA) or its plain version
    (CPU), and returned as ``(p', m')`` in the shape and dtypes of ``p`` and
    ``m``."""
    shape = p.shape
    flat = lambda x: x.reshape(-1).to(torch.float32).contiguous()
    args = (flat(p), flat(m), flat(g), flat(d))
    kw = dict(gamma=float(gamma), beta1=float(beta1), alpha=float(alpha),
              squared=squared)
    if p.device.type == "cuda":
        po, mo = _su.scaled_update_flat(*args, **kw)
    elif p.device.type == "cpu":
        _su.check_flat_args(*args)
        po, mo = ref.scaled_update_ref(*args, **kw)
    else:
        raise ValueError(f"no scaled_update for device {p.device}")
    return po.reshape(shape).to(p.dtype), mo.reshape(shape).to(m.dtype)


def scaled_update_tree(params, mom, d_tree, gamma, alpha, squared=True):
    """p' = p − (γ·m)/D̂ for every leaf, the momentum ``mom`` already
    carrying β₁ (the pre-refactor SAVIC round's fused update): each leaf is
    one ``scaled_update`` with zeros in the momentum slot, β₁ = 0 and the
    momentum passed as g, as the reference calls it. Returns the new params
    tree."""
    news = [scaled_update(p, torch.zeros_like(m), m, d, gamma=gamma,
                          beta1=0.0, alpha=alpha, squared=squared)[0]
            for p, m, d in zip(tree_leaves(params), tree_leaves(mom),
                               tree_leaves(d_tree))]
    return tree_unflatten(params, news)


def fused_local_step(p, m, g, d=None, h=None, t=None, s=None, *, gamma, beta1,
                     weight_decay=0.0, alpha, beta2=0.999, kind, clip="max",
                     schedule="const", update_d=False):
    """One fused generic-scaling local step on (M, n) flat client buffers.

    The engine's ``use_fused_kernel`` fast path: the D̂ update, weight decay,
    momentum and scaled parameter step of all M clients in one launch. ``d``
    is (M, n) for local scaling, (n,) for global, None for identity; ``h`` is
    an external stat; ``t``/``s`` are per-client step counters / grad-clip
    scales. Updates ``p``, ``m`` (and ``d`` with ``update_d``) in place on
    both devices and returns ``(p, m, d | None)``.
    """
    trace.count("engine.k1_launches")
    kw = dict(gamma=float(gamma), beta1=float(beta1),
              weight_decay=float(weight_decay), alpha=float(alpha),
              beta2=float(beta2), kind=kind, clip=clip, schedule=schedule,
              update_d=update_d)
    if p.device.type == "cuda":
        return _su.fused_step_flat(p, m, g, d, h, t, s, **kw)
    if p.device.type != "cpu":
        raise ValueError(f"no fused_local_step for device {p.device}")
    _su.check_args(p, m, g, d, h, t, s, kind=kind, schedule=schedule,
                   update_d=update_d)
    # the operator's CPU kernel is the plain version (a traced round sees
    # one fused_step_flat on either device)
    _su.fused_step_op()(p, m, g, d, h, t, s, **kw)
    return p, m, (d if update_d else None)


def quantize_update(x, u, scale):
    """Stochastic int8 encode + fp32 decode of (M, n) per-client rows ``x``
    with U[0, 1) draws ``u`` (M, n) and per-row scales ``scale`` (M,).
    Returns ``(q int8, dec fp32)``, both (M, n)."""
    if x.device.type == "cuda":
        return _qu.quantize_update_flat(x, u, scale)
    if x.device.type != "cpu":
        raise ValueError(f"no quantize_update for device {x.device}")
    _qu.check_args(x, u, scale)
    return ref.quantize_update_ref(x, u, scale)


def flash_attention(q, k, v, *, window=0, softcap=0.0):
    """Causal attention of q (B, S, H, D) over the compact kv heads k/v
    (B, S, Hk, D) -> (B, S, H, D) in q's dtype; ``window`` 0 is full
    attention. Forward only: raises for an input that requires grad."""
    if q.device.type == "cuda":
        return _fa.flash_attention(q, k, v, window=window, softcap=softcap)
    if q.device.type != "cpu":
        raise ValueError(f"no flash_attention for device {q.device}")
    _fa.check_args(q, k, v)
    return ref.flash_attention_ref(q, k, v, window=window, softcap=softcap)


def decode_attention(q, k, v, bias, *, softcap=0.0):
    """Single-query decode attention: ``q`` (B, H, D) fp32 over the bf16
    cache ``k``/``v`` (B, C, Hk, D|Dv) with the additive fp32 mask ``bias``
    (B, C) -> (B, H, Dv) fp32."""
    if q.device.type == "cuda":
        return _ds.decode_attention(q, k, v, bias, softcap=softcap)
    if q.device.type != "cpu":
        raise ValueError(f"no decode_attention for device {q.device}")
    _ds.check_attention_args(q, k, v, bias)
    return ref.decode_attention_ref(q, k, v, bias, softcap=softcap)


def decode_sample(y, table, noise, *, scale, v_real):
    """Token ids (B,) int32 = argmax over ids < ``v_real`` of
    (y·table)·scale + noise, first index on ties; ``y`` (B, d), ``table``
    (V, d), ``noise`` (B, V), all fp32. The logits are not returned."""
    if y.device.type == "cuda":
        return _ds.decode_sample(y, table, noise, scale=scale, v_real=v_real)
    if y.device.type != "cpu":
        raise ValueError(f"no decode_sample for device {y.device}")
    _ds.check_sample_args(y, table, noise, v_real)
    return ref.decode_sample_ref(y, table, noise, scale=scale, v_real=v_real)


def ssd(xh, dt, A, Bm, Cm, *, chunk, h0=None):
    """The chunked SSD scan on the intra-chunk kernel (equal to
    ``models.ssm.ssd_chunked``): -> (y (B, S, H, P), h_final (B, H, P, N)),
    fp32, from the state ``h0`` (zeros when None). Forward only: the
    counterpart of the reference's public ``ops.ssd``, off the model's path
    (the model calls ``ssd_chunked``, which takes K7 on the card itself)."""
    if xh.device.type == "cuda":
        return _ssd.ssd_kernel_forward(xh, dt, A, Bm, Cm, chunk, h0=h0)
    if xh.device.type != "cpu":
        raise ValueError(f"no ssd for device {xh.device}")
    _ssd.check_args(xh, dt, A, Bm, Cm, chunk)
    return _ssd.ssd_kernel_forward(xh, dt, A, Bm, Cm, chunk, h0=h0,
                                   intra=ref.ssd_intra_chunk_ref)
