"""Fused local-step kernel K1 (counterpart of
``repro/kernels/scaled_update.py``).

``fused_step_flat`` is the whole generic-scaling local step of the paper's
Assumption-4 rule in one pass over per-client flat buffers ``(M, n)``: the D̂
update (rule-2 squared EMA, rule-3 linear EMA, AdaGrad accumulate; β_t const
or Adam-debias) fused with weight decay, momentum and the scaled parameter
step, for every ``PrecondConfig`` kind including identity.

* Replaces the TPU kernel ``repro/kernels/scaled_update.py::fused_step_flat``
  (``pl.pallas_call`` at scaled_update.py:201).
* Kernel: ``csrc/fused_step.cu`` (CUDA C++ for sm_90a, built by
  ``kernels/build.py``, bound with ctypes). It launches on PyTorch's current
  stream and is checked with ``cudaGetLastError`` right after the launch.
* Plain version: ``kernels/ref.py::fused_step_ref``, which the kernel matches
  bitwise (same fp32 operations in the same order, no FMA contraction).
* Bound on an H100 (3.35 TB/s): bandwidth. Global D without an update moves
  (5·M·n + n)·4 bytes (41.6 GB at M=4 on full-width qwen2-0.5b, ≥ 12.4 ms);
  local D with an update moves 7·M·n·4 bytes (55.5 GB, ≥ 16.6 ms).
* The legacy per-leaf ``scaled_update_flat`` (K2) is not ported yet.

The kernel writes p', m' (and d' with ``update_d``) IN PLACE over ``p``,
``m`` and ``d``, which saves three (M, n) buffers (~24 GB at full width).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import preconditioner as PC

_KIND_CODE = {"identity": 0, "adam": 1, "rmsprop": 1, "adahessian": 1,
              "adagrad": 2, "oasis": 3}


def check_args(p, m, g, d=None, h=None, t=None, s=None, *, kind,
               schedule="const", update_d=False):
    """The shape/dtype/contiguity contract shared by the kernel and its plain
    version; raises ValueError on what the kernel does not take."""
    if p.dim() != 2:
        raise ValueError(f"p must be (M, n), got {tuple(p.shape)}")
    M, n = p.shape
    dev = p.device
    named = {"p": p, "m": m, "g": g, "d": d, "h": h}
    for name, x in named.items():
        if x is None:
            continue
        if x.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {x.dtype}")
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, p on {dev}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name in ("m", "g", "h"):
        x = named[name]
        if x is not None and tuple(x.shape) != (M, n):
            raise ValueError(f"{name} must be {(M, n)}, got {tuple(x.shape)}")
    if d is not None and tuple(d.shape) not in ((M, n), (n,)):
        raise ValueError(f"d must be {(M, n)} or {(n,)}, got "
                         f"{tuple(d.shape)}")
    if (d is None) != (kind == "identity"):
        raise ValueError(f"kind {kind!r} {'needs' if d is None else 'takes no'}"
                         f" d buffer")
    if update_d and (d is None or d.dim() == 1):
        raise ValueError("update_d needs a per-client (M, n) d buffer")
    needs_t = update_d and schedule == "debias" and kind != "adagrad"
    if needs_t and t is None:
        raise ValueError("debias schedule needs per-client t")
    if t is not None and (tuple(t.shape) != (M,) or t.dtype != torch.int32
                          or t.device != dev):
        raise ValueError(f"t must be int32 {(M,)} on {dev}")
    if s is not None and (tuple(s.shape) != (M,) or s.dtype != torch.float32
                          or s.device != dev):
        raise ValueError(f"s must be float32 {(M,)} on {dev}")
    if kind not in _KIND_CODE:
        raise ValueError(f"kind {kind!r}; expected one of {tuple(_KIND_CODE)}")


@functools.cache
def _lib():
    """The kernel's C entry point, built, loaded and bound once."""
    from repro_torch.kernels import build
    lib = build.load("fused_step.cu")
    fn = lib.fused_step_f32
    vp = ctypes.c_void_p
    fn.argtypes = [vp, vp, vp, vp, vp, vp, vp, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_float, ctypes.c_float,
                   ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, vp]
    fn.restype = ctypes.c_int
    return fn


def fused_step_flat(p, m, g, d=None, h=None, t=None, s=None, *, gamma, beta1,
                    weight_decay=0.0, alpha, beta2=0.999, kind, clip="max",
                    schedule="const", update_d=False):
    """One fused local step on CUDA per-client flat buffers, in place.

    Shapes: ``p/m/g`` (M, n) fp32; ``d`` (M, n) for local scaling, (n,) for
    global (client-shared D̂), None for identity; ``h`` (M, n) external stat
    or None for the in-kernel g² stat; ``t`` (M,) int32 per-client step
    counters (needed by the debias schedule); ``s`` (M,) fp32 per-client
    grad-clip scales or None. Returns ``(p, m, d | None)``: the same tensors,
    updated in place (``d`` returned only with ``update_d``).
    """
    check_args(p, m, g, d, h, t, s, kind=kind, schedule=schedule,
               update_d=update_d)
    if p.device.type != "cuda":
        raise ValueError(f"fused_step_flat launches on CUDA tensors; got "
                         f"{p.device} (ops.fused_local_step routes CPU "
                         f"tensors to the plain version)")
    M, n = p.shape
    if M > 65535:
        raise ValueError(f"M={M} exceeds the grid's y limit of 65535")
    beta = None
    if update_d and kind != "adagrad":
        # β_t per client with the plain version's own ops (bitwise the same)
        cfg = PC.PrecondConfig(kind=kind, beta2=beta2, beta_schedule=schedule)
        tt = t if t is not None else torch.zeros((M,), dtype=torch.int32,
                                                 device=p.device)
        beta = PC.beta_t(cfg, tt).contiguous()
    ptrs = [x.data_ptr() if x is not None else None
            for x in (p, m, g, d, h, beta, s)]
    vec4 = int(n % 4 == 0 and all(q % 16 == 0 for q in ptrs[:5]
                                  if q is not None))
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        err = _lib()(*ptrs, M, n, gamma, beta1, weight_decay, alpha,
                     _KIND_CODE[kind], int(clip == "add"), int(update_d),
                     int(d is not None and d.dim() == 1), vec4, stream)
    if err != 0:
        raise RuntimeError(f"fused_step_f32 launch failed: CUDA error {err}")
    fused_step_flat.launches += 1
    return p, m, (d if update_d else None)


fused_step_flat.launches = 0   # kernel launches since the count was last reset
