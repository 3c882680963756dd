"""Decode-step kernels K5 and K6 (counterpart of
``repro/kernels/decode_step.py``).

``decode_attention`` (K5) is single-query attention of one decode step over
the bf16 KV cache: for each slot b and kv head g, the rep = H/Hk query heads
that share g,

    s = (q·D^-½)·k;  s = cap·tanh(s/cap) if softcap;  s += bias[b];
    w = softmax_C(s);  out = Σ_C w·v          -> (B, H, Dv) fp32

* Replaces ``repro/kernels/decode_step.py::decode_attention``
  (``pl.pallas_call`` at decode_step.py:71).
* Kernel: ``csrc/decode_attention.cu``, split-C flash-decoding in two
  launches. Pass 1 gives each (kv head, slot, split of C) one block: the
  split's k/v rows stream through a 4-stage cp.async ring, q sits in
  registers, and the block writes its split's unnormalised partials (m, l,
  acc) to an fp32 scratch buffer; pass 2 merges the splits in a fixed
  order (no atomics). ``attention_plan`` picks the split length so that
  the grid puts about two blocks on every SM. Any C ≥ 1 fits.
* Bound on an H100: bytes. At the serve path's shape (B=8, C=576, Hk=2,
  rep=7, D=64) q, k, v, bias and out are 2,435,072 B, ≥ 0.73 µs at
  3.35 TB/s; at the long prompt's (B=2, C=8224) 8,501,504 B, ≥ 2.54 µs:
  launch latency and filling the card, not bandwidth, set its time.

``decode_sample`` (K6) is the logits → token tail of a decode step:

    id[b] = argmax_{v < v_real} (y[b]·table[v])·scale + noise[b, v]

with the first index winning ties, without writing the (B, V) logits.

* Replaces ``repro/kernels/decode_step.py::decode_sample``
  (``pl.pallas_call`` at decode_step.py:133).
* Kernel: ``csrc/decode_sample.cu``: pass 1 reads each table row once for
  all B rows of y (staged in shared memory, in slices over d where all of
  it does not fit: any d % 4 == 0) and writes one (best, id) pair per block
  and row; pass 2 reduces the pairs, ordering candidates by (value
  descending, id ascending). One wrapper call is one launch.
* Bound on an H100: bytes. At the serve path's shape (B=8, v_real=151,936,
  d=896) the real table rows are 544.5 MB, ≥ 0.163 ms per decode step.

Plain versions: ``kernels/ref.py::decode_attention_ref`` and
``decode_sample_ref``. Both kernels launch on PyTorch's current stream and
are checked with ``cudaGetLastError`` right after the launch; they sum in
another order than PyTorch, so they agree with the plain versions to
rounding (K6's ids under the near-tie rule), not bitwise.
"""
from __future__ import annotations

import ctypes
import functools

import torch

RMAX, OMAX_ELEMS, HEAD_MAX = 16, 1024, 128   # K5 limits
SPLIT_GRAIN = 32             # K5 positions a pipeline stage (csrc TILE)
TARGET_BLOCKS = 264          # two K5 blocks on each of an H100's 132 SMs
BMAX, SLICE_MAX = 64, 2048                   # K6: rows of y, y floats a slice
SMEM_MAX = 232_448                           # a block's shared memory (H100)
_WARPS = 8                                   # K6 warps per block
_SLICED_ROWS = 256                           # K6 rows a block, d in slices


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_attention_args(q, k, v, bias):
    """K5's contract, shared with its plain version; raises ValueError."""
    if q.dim() != 3 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q must be (B, H, D) and k/v (B, C, Hk, D|Dv)")
    B, H, D = q.shape
    C, Hk = k.shape[1], k.shape[2]
    Dv = v.shape[3]
    _check("q", q, torch.float32, (B, H, D), q.device)
    _check("k", k, torch.bfloat16, (B, C, Hk, D), q.device)
    _check("v", v, torch.bfloat16, (B, C, Hk, Dv), q.device)
    _check("bias", bias, torch.float32, (B, C), q.device)
    if C < 1 or Hk < 1 or H % Hk:
        raise ValueError(f"need C >= 1 and H % Hk == 0 (C={C}, H={H}, "
                         f"Hk={Hk})")
    rep = H // Hk
    if rep > RMAX or rep * Dv > OMAX_ELEMS or D > HEAD_MAX or Dv > HEAD_MAX:
        raise ValueError(f"K5 takes rep <= {RMAX}, rep·Dv <= {OMAX_ELEMS}, "
                         f"D, Dv <= {HEAD_MAX}; got rep={rep}, D={D}, "
                         f"Dv={Dv}")
    if B > 65535:
        raise ValueError(f"B={B} exceeds the grid's y limit of 65535")


def check_sample_args(y, table, noise, v_real):
    """K6's contract, shared with its plain version; raises ValueError."""
    if y.dim() != 2 or table.dim() != 2:
        raise ValueError("y must be (B, d) and table (V, d)")
    B, d = y.shape
    V = table.shape[0]
    _check("y", y, torch.float32, (B, d), y.device)
    _check("table", table, torch.float32, (V, d), y.device)
    _check("noise", noise, torch.float32, (B, V), y.device)
    if not 1 <= v_real <= V < 2 ** 31:
        raise ValueError(f"need 1 <= v_real <= V < 2^31 (v_real={v_real}, "
                         f"V={V})")
    if not 1 <= B <= BMAX or d % 4 or d < 4:
        raise ValueError(f"K6 takes 1 <= B <= {BMAX} and d % 4 == 0; got "
                         f"B={B}, d={d}")


@functools.cache
def _attention_lib():
    from repro_torch.kernels import build
    fn = build.load("decode_attention.cu").decode_attention_f32
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, vp, vp, vp, vp, ctypes.c_longlong,
                   ctypes.c_longlong, ci, ci, ci, ci, ci, ci, ctypes.c_float,
                   ctypes.c_float, ci, vp]
    fn.restype = ci
    return fn


@functools.cache
def _sample_lib():
    from repro_torch.kernels import build
    fn = build.load("decode_sample.cu").decode_sample_f32
    vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, cll, cll, cll,
                   ci, ctypes.c_float, vp]
    fn.restype = ci
    return fn


def _need_cuda(name, t, router):
    if t.device.type != "cuda":
        raise ValueError(f"{name} launches on CUDA tensors; got {t.device} "
                         f"(ops.{router} routes CPU tensors to the plain "
                         f"version)")


@functools.lru_cache(maxsize=1024)
def attention_plan(B: int, Hk: int, C: int):
    """(split, splits) of K5's first pass: C cut into ``splits`` runs of
    ``split`` positions, the last one ragged and never empty. The split
    length is the one that puts ``TARGET_BLOCKS`` blocks on the grid,
    rounded up to a multiple of ``SPLIT_GRAIN``, so the grid holds fewer
    than ``TARGET_BLOCKS`` blocks plus one split per (b, g) (fewer where
    the rounding is large). C ≤ ``SPLIT_GRAIN`` gives one split. At
    the serve path's B·Hk = 16, C = 576: splits of 64, 9 splits, 144
    blocks (splits of 32, 288 blocks, are slower there: ``chip_smoke.py``
    times both); at the long prompt's B·Hk = 4, C = 8224: splits of 128,
    65 splits, 260 blocks."""
    want = -(-TARGET_BLOCKS // (B * Hk))
    split = -(-C // want)
    split = max(SPLIT_GRAIN, -(-split // SPLIT_GRAIN) * SPLIT_GRAIN)
    return split, -(-C // split)


def decode_attention(q, k, v, bias, *, softcap=0.0):
    """K5 on CUDA tensors: ``q`` (B, H, D) fp32, ``k``/``v`` (B, C, Hk,
    D|Dv) bf16, ``bias`` (B, C) fp32 -> (B, H, Dv) fp32, a new tensor. Two
    kernel launches: the split partials, then their merge."""
    check_attention_args(q, k, v, bias)
    _need_cuda("decode_attention", q, "decode_attention")
    B, H, D = q.shape
    C, Hk, Dv = k.shape[1], k.shape[2], v.shape[3]
    split, splits = attention_plan(B, Hk, C)
    out = torch.empty((B, H, Dv), dtype=torch.float32, device=q.device)
    part = torch.empty(B * H * splits * (Dv + 2), dtype=torch.float32,
                       device=q.device)
    vec = int(D % 8 == 0 and Dv % 8 == 0 and k.data_ptr() % 16 == 0
              and v.data_ptr() % 16 == 0)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _attention_lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               bias.data_ptr(), part.data_ptr(),
                               out.data_ptr(), B, C, H, Hk, D, Dv, split,
                               splits, D ** -0.5, float(softcap), vec, stream)
    if err != 0:
        raise RuntimeError(f"decode_attention_f32 launch failed: CUDA error "
                           f"{err}")
    decode_attention.launches += 2
    return out


# kernel launches since the count was reset: 2 a call (pass 1 and merge)
decode_attention.launches = 0


def sample_grid(v_real: int):
    """(rows per block, blocks) of K6's first pass: about 18 rows per warp,
    at most 1056 blocks (8 per SM of an H100)."""
    nblocks = max(1, min(1056, -(-v_real // (_WARPS * 16))))
    rows = -(-v_real // nblocks)
    return rows, -(-v_real // rows)


def sample_plan(B: int, d: int, v_real: int):
    """(rows per block, blocks, ds) of K6's first pass, ds the floats of y
    staged in shared memory at a time. All of d in one pass where d <=
    ``SLICE_MAX`` and y fits beside the warps' bests (the sum order of every
    head measured so far); else slices of ds floats, a multiple of 128,
    beside (rows, B) partial sums, with rows capped at ``_SLICED_ROWS``
    (for B <= ``BMAX`` that leaves room for ds >= 512)."""
    rows, nblocks = sample_grid(v_real)
    fixed = 8 * _WARPS * B
    if d <= SLICE_MAX and 4 * B * d + fixed <= SMEM_MAX:
        return rows, nblocks, d
    if rows > _SLICED_ROWS:
        nblocks = -(-v_real // _SLICED_ROWS)
        rows = -(-v_real // nblocks)
        nblocks = -(-v_real // rows)
    room = (SMEM_MAX - fixed - 4 * rows * B) // (4 * B)
    return rows, nblocks, min(SLICE_MAX, room // 128 * 128)


def decode_sample(y, table, noise, *, scale, v_real, return_best=False):
    """K6 on CUDA tensors: ``y`` (B, d) fp32, ``table`` (V, d) fp32,
    ``noise`` (B, V) fp32 -> token ids (B,) int32 (and the winning values
    (B,) fp32 with ``return_best``), new tensors."""
    check_sample_args(y, table, noise, v_real)
    _need_cuda("decode_sample", y, "decode_sample")
    if table.data_ptr() % 16:
        raise ValueError("table must be 16-byte aligned (float4 loads)")
    B, d = y.shape
    V = table.shape[0]
    rows, nblocks, ds = sample_plan(B, d, v_real)
    part_val = torch.empty((nblocks, B), dtype=torch.float32,
                           device=y.device)
    part_arg = torch.empty((nblocks, B), dtype=torch.int32, device=y.device)
    ids = torch.empty((B,), dtype=torch.int32, device=y.device)
    best = torch.empty((B,), dtype=torch.float32, device=y.device)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = _sample_lib()(y.data_ptr(), table.data_ptr(), noise.data_ptr(),
                            part_val.data_ptr(), part_arg.data_ptr(),
                            ids.data_ptr(), best.data_ptr(), B, d, ds, V,
                            v_real, rows, nblocks, float(scale), stream)
    if err != 0:
        raise RuntimeError(f"decode_sample_f32 launch failed: CUDA error "
                           f"{err}")
    decode_sample.launches += 1
    return (ids, best) if return_best else ids


decode_sample.launches = 0      # wrapper calls (two kernels each) since reset
