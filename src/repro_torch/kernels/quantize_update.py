"""Stochastic int8 quantize-dequantize kernel K3 (counterpart of
``repro/kernels/quantize_update.py``).

``quantize_update_flat`` encodes one compressed leaf of the round's deltas,
(M, n) per-client rows, as int8 with a per-client fp32 scale and decodes it
back for the sync average, in one pass:

    v = x / s (0 where s == 0);  q = clip(floor(v + u), ±127);  dec = q·s

* Replaces the TPU kernel
  ``repro/kernels/quantize_update.py::quantize_update_flat``
  (``pl.pallas_call`` at quantize_update.py:56).
* Kernel: ``csrc/quantize_update.cu`` (CUDA C++ for sm_90a, built by
  ``kernels/build.py``, bound with ctypes). It launches on PyTorch's current
  stream and is checked with ``cudaGetLastError`` right after the launch.
* Plain version: ``kernels/ref.py::quantize_update_ref``; the kernel gives the
  same q and bitwise the same dec.
* Bound on an H100 (3.35 TB/s): bandwidth. It reads x and u and writes q and
  dec, 13 bytes per element: the (4, 137,625,600) ``embed.table`` leaf of
  full-width qwen2-0.5b moves 7.157 GB, ≥ 2.136 ms.

The scale is one fp32 per row (the engine's absmax/127 per client), where the
TPU kernel took an (n,)-broadcast s; that saves 4 bytes per element. The
U[0, 1) draws are an input, as in the TPU kernel, so the draws the tests
replay stay the reference's.
"""
from __future__ import annotations

import ctypes
import functools

import torch


def check_args(x, u, scale):
    """The shape/dtype/contiguity contract of the kernel and its plain
    version; raises ValueError on what the kernel does not take."""
    if x.dim() != 2:
        raise ValueError(f"x must be (M, n), got {tuple(x.shape)}")
    M, n = x.shape
    for name, t, shape in (("x", x, (M, n)), ("u", u, (M, n)),
                           ("scale", scale, (M,))):
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


@functools.cache
def _lib():
    """The kernel's C entry point, built, loaded and bound once."""
    from repro_torch.kernels import build
    fn = build.load("quantize_update.cu").quantize_update_f32
    vp = ctypes.c_void_p
    fn.argtypes = [vp, vp, vp, vp, vp, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_int, vp]
    fn.restype = ctypes.c_int
    return fn


def quantize_update_flat(x, u, scale):
    """K3 on CUDA tensors: ``x``, ``u`` (M, n) fp32, ``scale`` (M,) fp32 ->
    ``(q int8 (M, n), dec fp32 (M, n))``, new tensors."""
    check_args(x, u, scale)
    if x.device.type != "cuda":
        raise ValueError(f"quantize_update_flat launches on CUDA tensors; got "
                         f"{x.device} (ops.quantize_update routes CPU tensors "
                         f"to the plain version)")
    M, n = x.shape
    if M > 65535:
        raise ValueError(f"M={M} exceeds the grid's y limit of 65535")
    q = torch.empty((M, n), dtype=torch.int8, device=x.device)
    dec = torch.empty_like(x)
    ptrs = [t.data_ptr() for t in (x, u, scale, q, dec)]
    vec4 = int(n % 4 == 0 and ptrs[0] % 16 == 0 and ptrs[1] % 16 == 0
               and ptrs[3] % 4 == 0 and ptrs[4] % 16 == 0)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib()(*ptrs, M, n, vec4, stream)
    if err != 0:
        raise RuntimeError(f"quantize_update_f32 launch failed: CUDA error "
                           f"{err}")
    quantize_update_flat.launches += 1
    return q, dec


quantize_update_flat.launches = 0  # kernel launches since the count was reset
