"""Mamba2 SSD intra-chunk kernel K7 (counterpart of
``repro/kernels/ssd_scan.py``).

``ssd_intra_chunk`` computes, per (batch, chunk, head) cell, the chunk-local
SSD quantities:

    cum      = cumsum(dt·A)                        (Q,)
    L        = exp(cum_i - cum_j)·1[i >= j]        (Q, Q)
    Y_diag   = ((C Bᵀ) ⊙ L)(x·dt)                  (Q, P)
    S_chunk  = Bᵀ diag(exp(cum_Q - cum))(x·dt)     (N, P)
    total    = exp(cum_Q)

* Replaces ``repro/kernels/ssd_scan.py::ssd_intra_chunk`` (``pl.pallas_call``
  at ssd_scan.py:71).
* Kernel: ``csrc/ssd_intra_chunk.cu``: per cell, one block per 64-row tile
  of the chunk (the column tiles j <= i walked in a loop, the 64 × 64 tile
  of C·Bᵀ built from N-slices in shared memory) and one block per 64 rows
  of N for the chunk state; fp32 on the CUDA cores; cum accumulated in
  fp64 and rounded once (``ref.ssd_cumsum``). Limits: chunk Q <= 256
  dividing S, N <= 128, P <= 128; B and C read through any strides (a head
  stride of 0 for one group repeated over the heads).
* Bound on an H100: operations. At the serve prefill's shape (B=4, S=2048,
  H=64, P=64, N=128, Q=256) the causal half of the products is 34.4 GFLOP,
  >= 0.51 ms at 67 TFLOP/s; about 0.35 GB to move, 0.10 ms.
* Forward only, as the TPU kernel is: the wrapper raises for an input that
  requires grad.

``ssd_kernel_forward`` is the whole SSD on top of it, as in the reference:
the intra-chunk term, then the inter-chunk recurrence (a Python loop over
the chunks) and the ``Y_off`` contraction in plain torch.

Plain version: ``kernels/ref.py::ssd_intra_chunk_ref``. The kernel launches
on PyTorch's current stream and is checked with ``cudaGetLastError`` right
after the launch; it sums its products in another order than cuBLAS, so it
agrees with the plain version to rounding, not bitwise.
"""
from __future__ import annotations

import ctypes
import functools

import torch

QMAX, NMAX, PMAX = 256, 128, 128   # csrc limits
GRID_X_MAX = 2 ** 31 - 1


def check_args(xh, dt, A, Bm, Cm, chunk):
    """K7's contract, shared with its plain version; raises ValueError."""
    if xh.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or Bm.dim() != 4 \
            or Cm.dim() != 4:
        raise ValueError("xh must be (B, S, H, P), dt (B, S, H), A (H,) and "
                         "Bm/Cm (B, S, H, N)")
    B, S, H, P = xh.shape
    N = Bm.shape[3]
    for name, t, shape in (("dt", dt, (B, S, H)), ("A", A, (H,)),
                           ("Bm", Bm, (B, S, H, N)), ("Cm", Cm, (B, S, H, N))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}; got {tuple(t.shape)}")
    for name, t in (("xh", xh), ("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32; got {t.dtype}")
        if t.device != xh.device:
            raise ValueError(f"all inputs must be on one device; {name} is on "
                             f"{t.device}, xh on {xh.device}")
        if t.requires_grad:
            raise ValueError("K7 is forward-only (the TPU kernel has no "
                             "VJP); differentiate through "
                             "models.ssm.ssd_chunked instead")
    chunk = int(chunk)
    if not 1 <= chunk <= QMAX or S % chunk:
        raise ValueError(f"K7 takes a chunk 1 <= Q <= {QMAX} dividing S; got "
                         f"Q={chunk}, S={S}")
    if not 1 <= N <= NMAX or not 1 <= P <= PMAX:
        raise ValueError(f"K7 takes N <= {NMAX} and P <= {PMAX}; got N={N}, "
                         f"P={P}")


@functools.cache
def _lib():
    from repro_torch.kernels import build
    fn = build.load("ssd_intra_chunk.cu").ssd_intra_chunk_f32
    vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    st = ctypes.POINTER(ctypes.c_longlong)
    fn.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, cll, cll, ci, ci, ci, ci,
                   st, st, cll, st, st, vp]
    fn.restype = ci
    return fn


def ssd_intra_chunk(xh, dt, A, Bm, Cm, chunk):
    """K7 on CUDA tensors: xh (B, S, H, P), dt (B, S, H), A (H,), Bm/Cm
    (B, S, H, N), fp32, any strides -> new contiguous (Y_diag (B, S, H, P),
    S_chunk (B, nc, H, N, P), total (B, nc, H)), nc = S / chunk."""
    check_args(xh, dt, A, Bm, Cm, chunk)
    if xh.device.type != "cuda":
        raise ValueError(f"ssd_intra_chunk launches on CUDA tensors; got "
                         f"{xh.device} (ops.ssd routes CPU tensors to the "
                         f"plain version)")
    B, S, H, P = xh.shape
    N = Bm.shape[3]
    Q = int(chunk)
    nc = S // Q
    if B * nc * H > GRID_X_MAX:
        raise ValueError(f"B·nc·H = {B * nc * H} exceeds K7's grid")
    dev = xh.device
    y = torch.empty((B, S, H, P), dtype=torch.float32, device=dev)
    s = torch.empty((B, nc, H, N, P), dtype=torch.float32, device=dev)
    tot = torch.empty((B, nc, H), dtype=torch.float32, device=dev)
    x_st, dt_st, b_st, c_st = ((ctypes.c_longlong * t.dim())(*t.stride())
                               for t in (xh, dt, Bm, Cm))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib()(xh.data_ptr(), dt.data_ptr(), A.data_ptr(),
                     Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(),
                     s.data_ptr(), tot.data_ptr(), B, S, H, P, N, Q, x_st,
                     dt_st, A.stride(0), b_st, c_st, stream)
    if err != 0:
        raise RuntimeError(f"ssd_intra_chunk_f32 launch failed: CUDA error "
                           f"{err}")
    ssd_intra_chunk.launches += 1
    return y, s, tot


ssd_intra_chunk.launches = 0    # kernel launches since the count was reset


def ssd_kernel_forward(xh, dt, A, Bm, Cm, chunk, h0=None,
                       intra=ssd_intra_chunk):
    """The whole SSD from the intra-chunk term ``intra`` (K7 by default;
    ``ops.ssd`` passes the plain version for CPU tensors), the inter-chunk
    recurrence from ``h0`` (zeros when None) and the ``Y_off`` term. Equal
    to ``models.ssm.ssd_chunked``: returns (y (B, S, H, P), h_final
    (B, H, P, N)), fp32."""
    B, S, H, P = xh.shape
    N = Bm.shape[-1]
    nc = S // chunk
    Yd, S_c, total = intra(xh, dt, A, Bm, Cm, chunk)
    h = torch.zeros((B, H, P, N), dtype=torch.float32, device=xh.device) \
        if h0 is None else h0.float()
    s_cs = S_c.transpose(-1, -2)                     # (B,nc,H,P,N)
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = total[:, c, :, None, None] * h + s_cs[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)            # (B,nc,H,P,N)

    dA = dt.float() * A.float()[None, None, :]
    cum = torch.cumsum(dA.reshape(B, nc, chunk, H).double(), dim=2).float()
    decay_in = torch.exp(cum)                        # (B,nc,Q,H)
    Cc = Cm.float().reshape(B, nc, chunk, H, N)
    Y_off = torch.einsum("bcihn,bcih,bchpn->bcihp", Cc, decay_in, h_prevs)
    y = Yd.reshape(B, nc, chunk, H, P) + Y_off
    return y.reshape(B, S, H, P), h
