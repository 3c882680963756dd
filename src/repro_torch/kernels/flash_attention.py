"""Flash-attention kernel K4 (counterpart of
``repro/kernels/flash_attention.py``).

``flash_attention`` is causal attention of a whole prompt in the port's
projection layout: q (B, S, H, D), k/v (B, S, Hk, D), query head h reading
kv head h // (H/Hk),

    s = (q·D^-½)·k;  s = cap·tanh(s/cap) if softcap;
    s = -1e30 where col > row (or row - col >= window);
    out = softmax(s)·v                       -> (B, S, H, D) in q's dtype

* Replaces ``repro/kernels/flash_attention.py::flash_attention_bhsd``
  (``pl.pallas_call`` at flash_attention.py:91).
* Kernel: ``csrc/flash_attention.cu``: one block per (b, h, 64-row query
  tile), an online softmax over 64-key tiles staged in shared memory,
  tiles wholly above the diagonal or beyond the window skipped; fp32
  arithmetic on the CUDA cores, for fp32 or bf16 inputs read through their
  strides, any S >= 1 (the TPU kernel needs S % 128 == 0) and D <= 256
  (the TPU kernel's head dim is free; gemma3's is 256). fp32 key and value
  tiles with 16-byte rows stream in with ``cp.async`` (the next key tile
  under the current tile's two products, the value tile under the
  scores). D pads to 32, 64 or 128 (128 threads, 64-key tiles; three
  blocks an SM at D <= 64) or to 256 (256 threads, 16 a query row, 32-key
  tiles: 162 KB of shared memory, one block an SM).
* Bound on an H100: operations. At the long-prompt prefill's shape (B=2,
  H=14, Hk=2, S=8192, D=64, fp32) the causal pairs need 240.5 GFLOP,
  >= 3.59 ms at 67 TFLOP/s (fp32 outside the tensor cores); at gemma3-4b's
  (B=2, H=8, Hk=4, S=4096, D=256) a global layer 137.5 GFLOP, >= 2.05 ms,
  a layer with the 1024 window 60.1 GFLOP, >= 0.90 ms.
* Forward only, as the TPU kernel is (it has no VJP): the wrapper raises
  for an input that requires grad. Training differentiates through
  ``models/flash.py``.

Plain version: ``kernels/ref.py::flash_attention_ref``. The kernel launches
on PyTorch's current stream and is checked with ``cudaGetLastError`` right
after the launch; it sums in another order than PyTorch, so it agrees with
the plain version to rounding, not bitwise.
"""
from __future__ import annotations

import ctypes
import functools

import torch

HEAD_MAX = 256          # the kernel pads D to 32, 64, 128 or 256
BQ = 64                 # query rows per block (csrc constant)
GRID_Y_MAX = 65535
_DTYPES = (torch.float32, torch.bfloat16)


def check_args(q, k, v):
    """K4's contract, shared with its plain version; raises ValueError."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q must be (B, S, H, D) and k/v (B, S, Hk, D)")
    B, S, H, D = q.shape
    Hk = k.shape[2]
    if tuple(k.shape) != (B, S, Hk, D) or tuple(v.shape) != (B, S, Hk, D):
        raise ValueError(f"k and v must be {(B, S, Hk, D)}; got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share one dtype of {_DTYPES}; got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"q, k, v must be on one device; got {q.device}, "
                         f"{k.device}, {v.device}")
    if S < 1 or Hk < 1 or H % Hk:
        raise ValueError(f"need S >= 1 and H % Hk == 0 (S={S}, H={H}, "
                         f"Hk={Hk})")
    if not 1 <= D <= HEAD_MAX:
        raise ValueError(f"K4 takes 1 <= D <= {HEAD_MAX}; got D={D}")
    if any(t.requires_grad for t in (q, k, v)):
        raise ValueError("K4 is forward-only (the TPU kernel has no VJP); "
                         "differentiate through models/flash.py instead")


@functools.cache
def _lib():
    from repro_torch.kernels import build
    fn = build.load("flash_attention.cu").flash_attention_fwd
    vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    st = ctypes.POINTER(ctypes.c_longlong)
    fn.argtypes = [vp, vp, vp, vp, cll, cll, ci, ci, ci, st, st, st,
                   ctypes.c_float, ctypes.c_float, ci, ci, ci, vp]
    fn.restype = ci
    return fn


def _vec(ts, width):
    """16-byte loads: unit d stride, every other stride a multiple of the
    load's width, 16-byte aligned base and D a multiple of the width."""
    return all(t.stride(3) == 1 and t.data_ptr() % 16 == 0
               and t.shape[3] % width == 0
               and all(s % width == 0 for s in t.stride()[:3]) for t in ts)


def flash_attention(q, k, v, *, window=0, softcap=0.0):
    """K4 on CUDA tensors: causal attention of q (B, S, H, D) over k/v
    (B, S, Hk, D), fp32 or bf16, any strides -> a new (B, S, H, D) tensor
    in q's dtype. ``window`` 0 (or None) is full causal attention, a
    positive int a sliding window."""
    check_args(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention launches on CUDA tensors; got "
                         f"{q.device} (ops.flash_attention routes CPU "
                         f"tensors to the plain version)")
    B, S, H, D = q.shape
    Hk = k.shape[2]
    window = int(window or 0)
    if window < 0:
        raise ValueError(f"window must be 0 or positive; got {window}")
    if -(-S // BQ) > GRID_Y_MAX or B * H >= 2 ** 31:
        raise ValueError(f"S={S} or B*H={B * H} exceeds K4's grid")
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    strides = [(ctypes.c_longlong * 4)(*t.stride()) for t in (q, k, v)]
    vec = int(_vec((q, k, v), 16 // q.element_size()))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     B, S, H, Hk, D, *strides, D ** -0.5, float(softcap),
                     min(window, 2 ** 31 - 1),
                     int(q.dtype == torch.bfloat16), vec, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: CUDA error "
                           f"{err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0    # kernel launches since the count was reset
