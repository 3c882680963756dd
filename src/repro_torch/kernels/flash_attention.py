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
* Two instances: serving's (``flash_attention``) writes out alone;
  training's (``flash_attention_lse``: fp32, D <= 128, what K4b takes)
  also writes each row's log-sum-exp, fp32 (B, H, S), with the same bits
  of out.

``flash_attention_bwd`` is K4b, K4's VJP (the TPU kernel has none):
``csrc/flash_attention_bwd.cu``, from q, k, v, out, lse and dout to dq, dk,
dv, fp32, deterministic (no atomics; fixed-order sums). Three launches a
call: dq (and delta = rowsum(dout * out)) a block per (b, h, query tile);
dk, dv a block per (b, kv head, split of the rep query heads, key tile),
summed over the splits in order by a fourth launch where ``bwd_splits``
splits. Key tiles above the diagonal or beyond the window are skipped. It
takes fp32 with D <= 128 a multiple of 4, windows and softcap
(``bwd_takes``). The training instance and K4b are the operators
``repro_torch::flash_attention_lse`` and ``repro_torch::flash_attention_bwd``,
with fake kernels and FLOP formulas (``work``, ``work_bwd``: the dry run
and ``FlopCounterMode`` count them). ``flash_attention_train`` is the
pair as an ``autograd.Function``: the training route on the card
(``models/layers._takes_k4``); a backward that is itself differentiated
(``create_graph``) takes autograd of the plain forward instead. Bound on
an H100: operations, 10 D flops a causal pair (18.8 GFLOP, >= 0.281 ms at
qwen2-0.5b's training call (B=4, S=1024, H=14, Hk=2, D=64); 687 GFLOP,
>= 10.26 ms at nemotron's (2, 4096, 32, 2, 128)).

Plain versions: ``kernels/ref.py::flash_attention_ref`` (``with_lse``
for the training instance) and ``flash_attention_vjp_ref``. The kernels
launch on PyTorch's current stream and are checked with ``cudaGetLastError``
after every launch; they sum in another order than PyTorch, so they agree
with the plain versions to rounding, not bitwise.
"""
from __future__ import annotations

import ctypes
import functools

import torch

HEAD_MAX = 256          # the kernel pads D to 32, 64, 128 or 256
BWD_HEAD_MAX = 128      # K4b pads D to 64 or 128
BQ = 64                 # query rows per block (csrc constant)
GRID_Y_MAX = 65535
GRID_X_MAX = 2 ** 31 - 1
# K4b's dk/dv launch aims at four blocks for each of an H100's 132 SMs
BWD_TARGET_BLOCKS = 4 * 132
_DTYPES = (torch.float32, torch.bfloat16)


def check_args(q, k, v, *, forward_only=True):
    """K4's contract, shared with its plain version; raises ValueError.
    ``forward_only`` (serving's instance) refuses inputs that require
    grad."""
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
    if forward_only and any(t.requires_grad for t in (q, k, v)):
        raise ValueError("K4's serving instance is forward-only; "
                         "differentiate through flash_attention_train")


@functools.cache
def _lib():
    from repro_torch.kernels import build
    fn = build.load("flash_attention.cu").flash_attention_fwd
    vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    st = ctypes.POINTER(ctypes.c_longlong)
    fn.argtypes = [vp, vp, vp, vp, cll, cll, ci, ci, ci, st, st, st,
                   ctypes.c_float, ctypes.c_float, ci, ci, ci, vp, vp]
    fn.restype = ci
    return fn


@functools.cache
def _lib_bwd():
    from repro_torch.kernels import build
    fn = build.load("flash_attention_bwd.cu").flash_attention_bwd
    vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    st = ctypes.POINTER(ctypes.c_longlong)
    fn.argtypes = [vp] * 12 + [cll, cll, ci, ci, ci, ci] + [st] * 5 + [
        ctypes.c_float, ctypes.c_float, ci, vp]
    fn.restype = ci
    return fn


def _vec(ts, width):
    """16-byte loads: unit d stride, every other stride a multiple of the
    load's width, 16-byte aligned base and D a multiple of the width."""
    return all(t.stride(3) == 1 and t.data_ptr() % 16 == 0
               and t.shape[3] % width == 0
               and all(s % width == 0 for s in t.stride()[:3]) for t in ts)


def _check_forward(q, k, v, window, with_lse):
    check_args(q, k, v, forward_only=not with_lse)
    if with_lse and (q.dtype != torch.float32 or q.shape[3] > BWD_HEAD_MAX):
        raise ValueError(f"K4's training instance takes fp32 with D <= "
                         f"{BWD_HEAD_MAX}; got {q.dtype}, D={q.shape[3]}")
    if window < 0:
        raise ValueError(f"window must be 0 or positive; got {window}")


def _forward(q, k, v, window, softcap, with_lse):
    window = int(window or 0)
    _check_forward(q, k, v, window, with_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention launches on CUDA tensors; got "
                         f"{q.device} (ops.flash_attention routes CPU "
                         f"tensors to the plain version)")
    B, S, H, D = q.shape
    Hk = k.shape[2]
    if -(-S // BQ) > GRID_Y_MAX or B * H >= 2 ** 31:
        raise ValueError(f"S={S} or B*H={B * H} exceeds K4's grid")
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device) \
        if with_lse else None
    strides = [(ctypes.c_longlong * 4)(*t.stride()) for t in (q, k, v)]
    vec = int(_vec((q, k, v), 16 // q.element_size()))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     B, S, H, Hk, D, *strides, D ** -0.5, float(softcap),
                     min(window, 2 ** 31 - 1),
                     int(q.dtype == torch.bfloat16), vec,
                     lse.data_ptr() if with_lse else None, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: CUDA error "
                           f"{err}")
    flash_attention.launches += 1
    return (out, lse) if with_lse else out


def flash_attention(q, k, v, *, window=0, softcap=0.0):
    """K4 on CUDA tensors: causal attention of q (B, S, H, D) over k/v
    (B, S, Hk, D), fp32 or bf16, any strides -> a new (B, S, H, D) tensor
    in q's dtype. ``window`` 0 (or None) is full causal attention, a
    positive int a sliding window. Serving's instance: inputs that require
    grad raise."""
    return _forward(q, k, v, window, softcap, False)


flash_attention.launches = 0    # K4 launches (both instances) since reset


def flash_attention_lse(q, k, v, *, window=0, softcap=0.0):
    """K4's training instance: ``flash_attention``'s out, with the same
    bits, and each row's log-sum-exp, a new fp32 (B, H, S) tensor; fp32
    with D <= 128. Inputs may require grad (it reads their data;
    ``flash_attention_train`` differentiates). One dispatch of the operator
    ``repro_torch::flash_attention_lse``."""
    return torch.ops.repro_torch.flash_attention_lse(
        q.detach(), k.detach(), v.detach(), int(window or 0), float(softcap))


def bwd_takes(D, dtype) -> bool:
    """Whether K4b takes a head dim and dtype: fp32, D <= 128 and a
    multiple of 4 (16-byte rows). Windows and softcap it takes at every
    value."""
    return dtype == torch.float32 and 1 <= D <= BWD_HEAD_MAX and D % 4 == 0


def bwd_splits(B, S, Hk, rep) -> int:
    """The splits of a kv head's rep query heads in K4b's dk/dv launch:
    the smallest divisor of rep whose grid, B·Hk·splits·⌈S/64⌉ blocks,
    reaches ``BWD_TARGET_BLOCKS``; rep where none does. A function of the
    shapes alone, so a shape's bits are the same on every card."""
    base = B * Hk * -(-S // BQ)
    for ns in range(1, rep + 1):
        if rep % ns == 0 and base * ns >= BWD_TARGET_BLOCKS:
            return ns
    return rep


def pairs(B, S, H, window=0) -> int:
    """The (query, key) pairs that the causal mask, and ``window`` where
    positive, keeps: B·H·Σ_r min(r + 1, window)."""
    w = window if 0 < window < S else S
    return B * H * (w * (w + 1) // 2 + (S - w) * w)


def work(B, S, H, Hk, D, window=0):
    """(flops, bytes) of K4's training instance: 4·D flops a kept pair
    (q·k and p·v); read q, k, v once, write out and lse."""
    return (4 * D * pairs(B, S, H, window),
            4 * (2 * B * S * H * D + 2 * B * S * Hk * D + B * H * S))


def work_bwd(B, S, H, Hk, D, window=0):
    """(flops, bytes) of K4b: 10·D flops a kept pair (the scores and
    dout·vᵀ recomputed, dv, dk, dq: five D-long dots); read q, k, v, out,
    dout and lse once, write dq, dk, dv."""
    return (10 * D * pairs(B, S, H, window),
            4 * (4 * B * S * H * D + 4 * B * S * Hk * D + B * H * S))


def check_bwd_args(q, k, v, out, lse, dout):
    """K4b's contract, shared with its plain version; raises ValueError."""
    check_args(q, k, v, forward_only=False)
    B, S, H, D = q.shape
    if not bwd_takes(D, q.dtype):
        raise ValueError(f"K4b takes fp32 with D <= {BWD_HEAD_MAX} a "
                         f"multiple of 4; got {q.dtype}, D={D}")
    for name, t in (("out", out), ("dout", dout)):
        if tuple(t.shape) != (B, S, H, D) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be fp32 {(B, S, H, D)}; got "
                             f"{t.dtype} {tuple(t.shape)}")
    if tuple(lse.shape) != (B, H, S) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be fp32 {(B, H, S)}; got {lse.dtype} "
                         f"{tuple(lse.shape)}")
    if any(t.device != q.device for t in (out, lse, dout)):
        raise ValueError("q, k, v, out, lse and dout must be on one device")


def _backward(q, k, v, out, lse, dout, window, softcap):
    window = int(window or 0)
    check_bwd_args(q, k, v, out, lse, dout)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd launches on CUDA tensors; got "
                         f"{q.device}")
    if window < 0:
        raise ValueError(f"window must be 0 or positive; got {window}")
    q, k, v, out, dout = (t if _vec((t,), 4) else
                          t.clone(memory_format=torch.contiguous_format)
                          for t in (q, k, v, out, dout))
    lse = lse.contiguous()
    B, S, H, D = q.shape
    Hk = k.shape[2]
    ns = bwd_splits(B, S, Hk, H // Hk)
    if -(-S // BQ) > GRID_Y_MAX or B * H * ns > GRID_X_MAX:
        raise ValueError(f"S={S} or B*H={B * H} exceeds K4b's grid")
    f32 = dict(dtype=torch.float32, device=q.device)
    dq = torch.empty((B, S, H, D), **f32)
    dk = torch.empty((B, S, Hk, D), **f32)
    dv = torch.empty((B, S, Hk, D), **f32)
    delta = torch.empty((B, H, S), **f32)
    part = [torch.empty((ns, B, S, Hk, D), **f32) for _ in range(2)] \
        if ns > 1 else [None, None]
    strides = [(ctypes.c_longlong * 4)(*t.stride())
               for t in (q, k, v, out, dout)]
    ptrs = [t.data_ptr() if t is not None else None
            for t in (q, k, v, out, dout, lse, delta, dq, dk, dv, *part)]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _lib_bwd()(*ptrs, B, S, H, Hk, D, ns, *strides, D ** -0.5,
                         float(softcap), min(window, 2 ** 31 - 1), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd launch failed: CUDA error "
                           f"{err}")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


def flash_attention_bwd(q, k, v, out, lse, dout, *, window=0, softcap=0.0):
    """K4b on CUDA tensors: the VJP of K4 at q (B, S, H, D), k/v (B, S, Hk,
    D), from K4's out and lse and the cotangent dout -> new contiguous
    (dq, dk, dv) in the shapes of q, k, v, fp32. Views with 16-byte rows
    and a unit d stride are read through their strides, others copied.
    3 launches, 4 where ``bwd_splits`` splits; ``launches`` counts calls.
    One dispatch of the operator ``repro_torch::flash_attention_bwd``."""
    return torch.ops.repro_torch.flash_attention_bwd(
        *(t.detach() for t in (q, k, v, out, lse, dout)), int(window or 0),
        float(softcap))


flash_attention_bwd.launches = 0    # K4b calls (3 or 4 launches each)


def _define_ops():
    """K4's training instance and K4b as the operators
    ``repro_torch::flash_attention_lse`` and ``repro_torch::flash_attention_bwd``:
    the CUDA kernel is the hand-written launch; the fake kernel
    (``FakeTensorMode``: the dry run) checks the contract and gives the
    outputs' shapes; the FLOP formulas (``work``, ``work_bwd``) let
    ``FlopCounterMode`` and the dry run's ``utils.cost.CostMode`` count the
    route the card runs. Registered at import, since ``FlopCounterMode``
    copies the FLOP registry when it is made."""
    from torch.utils.flop_counter import register_flop_formula

    @torch.library.custom_op("repro_torch::flash_attention_lse",
                             mutates_args=())
    def fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               window: int, softcap: float
               ) -> tuple[torch.Tensor, torch.Tensor]:
        return _forward(q, k, v, window, softcap, True)

    @fwd_op.register_fake
    def _(q, k, v, window, softcap):
        _check_forward(q, k, v, window, True)
        B, S, H, D = q.shape
        return q.new_empty((B, S, H, D)), q.new_empty((B, H, S))

    @torch.library.custom_op("repro_torch::flash_attention_bwd",
                             mutates_args=())
    def bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
               window: int, softcap: float
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        return _backward(q, k, v, out, lse, dout, window, softcap)

    @bwd_op.register_fake
    def _(q, k, v, out, lse, dout, window, softcap):
        check_bwd_args(q, k, v, out, lse, dout)
        return (q.new_empty(q.shape), k.new_empty(k.shape),
                v.new_empty(v.shape))

    @register_flop_formula(torch.ops.repro_torch.flash_attention_lse)
    def _(q, k, v, window, softcap, *args, **kwargs):
        return work(*q[:3], k[2], q[3], window)[0]

    @register_flop_formula(torch.ops.repro_torch.flash_attention_bwd)
    def _(q, k, v, out, lse, dout, window, softcap, *args, **kwargs):
        return work_bwd(*q[:3], k[2], q[3], window)[0]


_define_ops()


class _FlashAttention(torch.autograd.Function):
    """Causal attention whose forward is ``fwd`` (K4's training instance)
    on detached inputs and whose backward is ``vjp`` (K4b) from q, k, v,
    out and lse alone: autograd holds no S x S tensor."""

    @staticmethod
    def forward(ctx, q, k, v, window, softcap, fwd, vjp):
        out, lse = fwd(q.detach(), k.detach(), v.detach(), window=window,
                       softcap=softcap)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.cfg = (window, softcap, vjp)
        return out

    @staticmethod
    def backward(ctx, dout):
        window, softcap, vjp = ctx.cfg
        q, k, v, out, lse = ctx.saved_tensors
        if torch.is_grad_enabled():
            return (*_vjp_graph(ctx, q, k, v, dout, window, softcap), None,
                    None, None, None)
        dq, dk, dv = vjp(q, k, v, out, lse, dout, window=window,
                         softcap=softcap)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None)


def _vjp_graph(ctx, q, k, v, dout, window, softcap):
    """A backward that is itself differentiated (``create_graph``: the
    Hessian-vector products of ``core/preconditioner.py``): autograd of
    the plain forward, whose graph the second backward goes through; K4b's
    output would be a constant there. Returns (dq, dk, dv), None where an
    input needs no gradient."""
    from repro_torch.kernels import ref
    need = [t for t, n in zip((q, k, v), ctx.needs_input_grad[:3]) if n]
    with torch.enable_grad():
        out = ref.flash_attention_ref(q, k, v, window=window,
                                      softcap=softcap)
        got = iter(torch.autograd.grad(out, need, dout, create_graph=True))
    return [next(got) if n else None for n in ctx.needs_input_grad[:3]]


def flash_attention_train(q, k, v, *, window=0, softcap=0.0,
                          fwd=flash_attention_lse, vjp=flash_attention_bwd):
    """K4's out, differentiable through K4b. ``fwd`` and ``vjp`` default to
    the kernels (the tests put the plain versions in their place on the
    CPU: ``ref.flash_attention_ref`` with ``with_lse=True`` and
    ``ref.flash_attention_vjp_ref``)."""
    return _FlashAttention.apply(q, k, v, int(window or 0), float(softcap),
                                 fwd, vjp)
