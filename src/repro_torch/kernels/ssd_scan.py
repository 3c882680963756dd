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
* Kernel: ``csrc/ssd_intra_chunk.cu``, two launches a call, from ``plan``:
  a prep launch builds G = C·Bᵀ once per (batch, chunk, group), only its
  causal 64 × 64 tiles (one group when B and C both have a head stride of
  0, as ``models/ssm.py`` passes them; else one a head), and scans cum
  once per cell (fp64, each prefix rounded once: ``ref.ssd_cumsum``) into
  scratch beside the cell's dt and decay; the main launch has one block
  per (cell, 64-row tile), a Y block per row tile of the chunk and a state
  block per 64 rows of N, streaming 32-row slices through a two-stage
  cp.async ring into 8 × 8 register tiles. fp32 on the CUDA cores.
  Limits: chunk Q <= 256 dividing S, N <= 128, P <= 128; x, dt, B and C
  read through any strides.
* Bound on an H100: operations (``work``). At the serve prefill's shape
  (B=4, S=2048, H=64, P=64, N=128, Q=256, one group) the inputs need
  17.48 GFLOP, >= 0.261 ms at 67 TFLOP/s; 0.35 GB to move, 0.10 ms.
* Forward only, as the TPU kernel is: the wrapper raises for an input that
  requires grad. The model (``models.ssm.ssd_chunked``) calls it through
  ``intra_chunk``, an ``autograd.Function`` whose backward is K7b
  (``ssd_intra_chunk_bwd``, ``csrc/ssd_intra_chunk_bwd.cu``): a
  hand-written VJP that replaces no TPU kernel (the Pallas K7 has none)
  and, like K7, never writes a (Q, Q)
  tensor per head. Four launches a call (``plan_bwd``); its plain version
  is ``kernels/ref.py::ssd_intra_chunk_vjp_ref``; bound: operations
  (``work_bwd``), 17.6 GFLOP at mamba2-1.3b's training shape (B=2, S=2048,
  H=64, P=64, N=128, Q=256, one group), >= 0.263 ms at 67 TFLOP/s.

``ssd_kernel_forward`` is the whole SSD on top of it, as in the reference:
the intra-chunk term, then the inter-chunk recurrence (a Python loop over
the chunks) and the ``Y_off`` contraction in plain torch.

Plain version: ``kernels/ref.py::ssd_intra_chunk_ref``. The kernels launch
on PyTorch's current stream and are checked with ``cudaGetLastError`` right
after each launch. Every output is one fmaf chain in index order (no
atomics, no sum split across blocks), so a call gives the same bits every
time; it sums in another order than cuBLAS, so it agrees with the plain
version to a rounding bound (``tests/test_torch_cuda.py::k7_bounds``), not
bitwise.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

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


TILE = 64            # rows and columns of a tile (csrc T)
CUM_CELLS = 8        # cells a cum block scans, one a warp


def work(B, S, H, P, N, Q, groups):
    """(flops, bytes) K7's inputs need: G = C·Bᵀ once per (batch, chunk,
    group), its causal half (2N per pair i >= j); per cell (G⊙L)·(x·dt)
    over the causal pairs (2P each) and the chunk state (2QNP); x, dt, A
    and B/C (``groups`` of (B, S, N) each) read once, Y, S_chunk and total
    written once, fp32."""
    nc = S // Q
    cells = B * nc * H
    pairs = Q * (Q + 1) // 2
    flops = B * nc * groups * pairs * 2 * N \
        + cells * (pairs * 2 * P + 2 * Q * N * P)
    nbytes = 4 * (2 * B * S * H * P + B * S * H + H + 2 * B * S * groups * N
                  + cells * N * P + cells)
    return flops, nbytes


@dataclasses.dataclass(frozen=True)
class Plan:
    """K7's launches for one call (``plan``)."""
    B: int
    nc: int
    H: int
    Q: int
    groups: int       # 1 (B and C one group over the heads) or H
    pd: int           # P padded to 32, 64 or 128: the main block's threads
    nrt: int          # 64-row tiles of a chunk
    nst: int          # 64-row tiles of N
    hg = 1            # heads a main block computes (G reaches them via L2)

    @property
    def cells(self):
        """(batch, chunk, head) cells."""
        return self.B * self.nc * self.H

    @property
    def npairs(self):
        """Causal tile pairs (i, j), j <= i, of a chunk."""
        return self.nrt * (self.nrt + 1) // 2

    @property
    def g_blocks(self):
        """Prep blocks that build G tiles; the rest scan cum."""
        return self.B * self.nc * self.groups * self.npairs

    @property
    def prep_grid(self):
        return self.g_blocks + -(-self.cells // CUM_CELLS)

    @property
    def main_grid(self):
        return self.cells * (self.nrt + self.nst)

    @property
    def g_shape(self):
        """G scratch: tile (i, j) of a (batch, chunk, group) at i·nrt + j,
        stored [j][i] (only the causal tiles are written)."""
        return (self.B, self.nc, self.groups, self.nrt * self.nrt, TILE,
                TILE)

    @property
    def cell_shape(self):
        """Per-cell scratch: cum, dt and exp(cum_{Q-1} - cum), contiguous."""
        return (self.B, self.nc, self.H, 3, self.Q)

    @property
    def scratch_bytes(self):
        return {"g": 4 * math.prod(self.g_shape),
                "cell": 4 * math.prod(self.cell_shape)}


def plan(B, S, H, P, N, Q, b_strides, c_strides):
    """K7's launches for xh (B, S, H, P), B/C (B, S, H, N) of the given
    strides and chunk Q: one G group when B and C both have a head stride
    of 0, else one a head; a prep grid of the causal G tiles of every
    (batch, chunk, group) and the cum blocks; a main grid of
    cells·(nrt + nst) blocks (``main_block``)."""
    return Plan(B=B, nc=S // Q, H=H, Q=Q,
                groups=1 if b_strides[2] == 0 and c_strides[2] == 0 else H,
                pd=32 if P <= 32 else 64 if P <= 64 else 128,
                nrt=-(-Q // TILE), nst=-(-N // TILE))


def prep_block(p, blk):
    """What block ``blk`` of the prep launch computes, as the kernel decodes
    it: ("g", b, c, group, i, j) for G tile (i, j), j <= i, or ("cum",
    cells) for the cells whose cum it scans."""
    if blk < p.g_blocks:
        gid, j = divmod(blk, p.npairs)
        i = 0
        while j > i:
            j -= i + 1
            i += 1
        return ("g", gid // (p.groups * p.nc), (gid // p.groups) % p.nc,
                gid % p.groups, i, j)
    first = (blk - p.g_blocks) * CUM_CELLS
    return ("cum", tuple(range(first, min(first + CUM_CELLS, p.cells))))


def main_block(p, blk):
    """What block ``blk`` of the main launch computes, as the kernel decodes
    it: ("y", b, c, h, row tile) or ("state", b, c, h, N tile). Block
    ((b·nc + c)·(nrt + nst) + slot)·H + h: the blocks of a (batch, chunk)
    run together (its x stays in L2); slot 0 is the last row tile, slots
    1..nst the state tiles, then row tiles nrt - 2 .. 0, the heaviest
    first."""
    rest, h = divmod(blk, p.H)
    bc, slot = divmod(rest, p.nrt + p.nst)
    b, c = divmod(bc, p.nc)
    if 1 <= slot <= p.nst:
        return ("state", b, c, h, slot - 1)
    return ("y", b, c, h, p.nrt - 1 if slot == 0 else p.nrt - 1
            - (slot - p.nst))


def _rows_in_float4s(t):
    """1 when every row of t (B, S, H, W) is aligned float4s: unit last
    stride, W and the other strides multiples of 4, a 16-byte base."""
    st = t.stride()
    return int(st[3] == 1 and t.shape[3] % 4 == 0
               and all(v % 4 == 0 for v in st[:3]) and t.data_ptr() % 16 == 0)


@functools.cache
def _lib():
    from repro_torch.kernels import build
    fn = build.load("ssd_intra_chunk.cu").ssd_intra_chunk_f32
    vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    st = ctypes.POINTER(ctypes.c_longlong)
    fn.argtypes = [vp] * 10 + [cll, cll] + [ci] * 7 + [cll, cll, cll, st,
                                                       st, cll, st, st, vp]
    fn.restype = ci
    return fn


def ssd_intra_chunk(xh, dt, A, Bm, Cm, chunk):
    """K7 on CUDA tensors: xh (B, S, H, P), dt (B, S, H), A (H,), Bm/Cm
    (B, S, H, N), fp32, any strides -> new contiguous (Y_diag (B, S, H, P),
    S_chunk (B, nc, H, N, P), total (B, nc, H)), nc = S / chunk. Two
    launches (``plan``); ``launches`` counts calls."""
    check_args(xh, dt, A, Bm, Cm, chunk)
    if xh.device.type != "cuda":
        raise ValueError(f"ssd_intra_chunk launches on CUDA tensors; got "
                         f"{xh.device} (ops.ssd routes CPU tensors to the "
                         f"plain version)")
    B, S, H, P = xh.shape
    N = Bm.shape[3]
    Q = int(chunk)
    pl = plan(B, S, H, P, N, Q, Bm.stride(), Cm.stride())
    if max(pl.prep_grid, pl.main_grid) > GRID_X_MAX:
        raise ValueError(f"K7's grids ({pl.prep_grid}, {pl.main_grid} "
                         f"blocks) exceed {GRID_X_MAX}")
    dev = xh.device
    f32 = dict(dtype=torch.float32, device=dev)
    y = torch.empty((B, S, H, P), **f32)
    s = torch.empty((B, pl.nc, H, N, P), **f32)
    tot = torch.empty((B, pl.nc, H), **f32)
    g = torch.empty(pl.g_shape, **f32)
    cellbuf = torch.empty(pl.cell_shape, **f32)
    x_st, dt_st, b_st, c_st = ((ctypes.c_longlong * t.dim())(*t.stride())
                               for t in (xh, dt, Bm, Cm))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib()(xh.data_ptr(), dt.data_ptr(), A.data_ptr(),
                     Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(),
                     s.data_ptr(), tot.data_ptr(), g.data_ptr(),
                     cellbuf.data_ptr(), B, S, H, P, N, Q, pl.groups,
                     _rows_in_float4s(xh), _rows_in_float4s(Bm), pl.g_blocks, pl.prep_grid, pl.main_grid, x_st, dt_st,
                     A.stride(0), b_st, c_st, stream)
    if err != 0:
        raise RuntimeError(f"ssd_intra_chunk_f32 launch failed: CUDA error "
                           f"{err}")
    ssd_intra_chunk.launches += 1
    return y, s, tot


ssd_intra_chunk.launches = 0    # wrapper calls (2 launches each) since reset

HEADS_A_SPLIT = 8    # heads a K7b block sums for dG and dB (one group)


def work_bwd(B, S, H, P, N, Q, groups):
    """(flops, bytes) K7b's inputs need, on the causal pairs: per cell
    M = dY·xdtᵀ and Wᵀ·dY (2P each a pair), B·dS and (xdt·decay)·dSᵀ (2QNP
    each); per (batch, chunk, group) G = C·Bᵀ, dG·B and dGᵀ·C (2N each a
    pair). Bytes: K7's inputs and the cotangents dY, dS, dtot read once,
    dx, ddt, dA, dB and dC written once, fp32."""
    nc = S // Q
    cells = B * nc * H
    pairs = Q * (Q + 1) // 2
    flops = cells * (2 * pairs * 2 * P + 2 * 2 * Q * N * P) \
        + B * nc * groups * 3 * pairs * 2 * N
    nbytes = 4 * (3 * B * S * H * P + 2 * B * S * H + 2 * H
                  + 4 * B * S * groups * N + cells * N * P + cells)
    return flops, nbytes


@dataclasses.dataclass(frozen=True)
class BwdPlan:
    """K7b's four launches and scratch for one call (``plan_bwd``)."""
    B: int
    nc: int
    H: int
    P: int
    N: int
    Q: int
    groups: int       # 1 or H
    hs: int           # heads a split (one group), else 1

    @property
    def cells(self):
        return self.B * self.nc * self.H

    @property
    def bcgs(self):
        """(batch, chunk, group) triples."""
        return self.B * self.nc * self.groups

    @property
    def nrt(self):
        return -(-self.Q // TILE)

    @property
    def nnt(self):
        return -(-self.N // TILE)

    @property
    def npairs(self):
        return self.nrt * (self.nrt + 1) // 2

    @property
    def nsplit(self):
        return -(-self.H // self.hs) if self.groups == 1 else 1

    @property
    def grids(self):
        """Blocks of the prep (G tiles, Bᵀ tiles, cum), heads (dG, dBu),
        dx and finish (one a head, then dB / dC tiles) launches."""
        b = self.bcgs
        return (b * self.npairs + b * self.nrt + -(-self.cells // CUM_CELLS),
                b * self.npairs * self.nsplit
                + b * self.nrt * self.nnt * self.nsplit,
                self.cells * self.nrt,
                self.H + b * self.nrt * self.nnt * 2)

    @property
    def scratch_shapes(self):
        b, T = self.bcgs, TILE
        return {"g": (b, self.nrt * self.nrt, T, T),
                "bt": (b, self.N, self.Q),
                "cell": (self.cells, 3, self.Q),
                "dgp": (b, self.npairs, self.nsplit, T, T),
                "rsp": (self.cells, self.npairs, T),
                "dbu": (b, self.nsplit, self.Q, self.N),
                "rows": (self.cells, 3, self.Q)}


def plan_bwd(B, S, H, P, N, Q, groups):
    """K7b's launches for K7's shapes and B/C ``groups`` (1 or H): a split
    of ``HEADS_A_SPLIT`` heads for one group, else one head."""
    return BwdPlan(B=B, nc=S // Q, H=H, P=P, N=N, Q=Q, groups=groups,
                   hs=HEADS_A_SPLIT if groups == 1 else 1)


def check_bwd_args(xh, dt, A, Bm, Cm, chunk, dY, dS, dtot):
    """K7b's contract: K7's inputs with B/C (B, S, G, N), G 1 or H, and
    the cotangents of K7's three outputs; raises ValueError."""
    B, S, H, P = xh.shape
    if Bm.dim() != 4 or Bm.shape != Cm.shape \
            or Bm.shape[2] not in (1, H) or Bm.shape[:2] != (B, S):
        raise ValueError(f"K7b takes Bm/Cm (B, S, 1 or H, N); got "
                         f"{tuple(Bm.shape)} and {tuple(Cm.shape)}")
    G = Bm.shape[2]
    check_args(xh, dt, A, heads(Bm, H), heads(Cm, H), chunk)
    nc = S // int(chunk)
    for name, t, shape in (("dY", dY, (B, S, H, P)),
                           ("dS", dS, (B, nc, H, Bm.shape[3], P)),
                           ("dtot", dtot, (B, nc, H))):
        if tuple(t.shape) != shape or t.dtype != torch.float32 \
                or t.device != xh.device:
            raise ValueError(f"{name} must be {shape} float32 on "
                             f"{xh.device}; got {tuple(t.shape)} {t.dtype} "
                             f"on {t.device}")
    return G


def heads(g, H):
    """B or C (B, S, G, N), G 1 or H -> (B, S, H, N): one group as an
    expanded view (head stride 0, K7's one-group layout)."""
    return g.expand(g.shape[0], g.shape[1], H, g.shape[3]) \
        if g.shape[2] == 1 else g


@functools.cache
def _lib_bwd():
    from repro_torch.kernels import build
    fn = build.load("ssd_intra_chunk_bwd.cu").ssd_intra_chunk_bwd_f32
    vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    st = ctypes.POINTER(ctypes.c_longlong)
    fn.argtypes = [vp] * 20 + [cll, cll] + [ci] * 7 + [st, st, st, cll, st,
                                                       st, vp]
    fn.restype = ci
    return fn


def ssd_intra_chunk_bwd(xh, dt, A, Bm, Cm, chunk, dY, dS, dtot):
    """K7b on CUDA tensors: K7's inputs (B/C as (B, S, G, N), G 1 or H, any
    strides) and the cotangents dY (B, S, H, P), dS (B, nc, H, N, P), dtot
    (B, nc, H) -> new contiguous (dx, ddt, dA, dB, dC) in the shapes of xh,
    dt, A, Bm and Cm, fp32. Four launches (``plan_bwd``); ``launches``
    counts calls."""
    xh, dt, A, Bm, Cm = (t.detach() for t in (xh, dt, A, Bm, Cm))
    dY, dS, dtot = (t.detach().contiguous() for t in (dY, dS, dtot))
    G = check_bwd_args(xh, dt, A, Bm, Cm, chunk, dY, dS, dtot)
    if xh.device.type != "cuda":
        raise ValueError(f"ssd_intra_chunk_bwd launches on CUDA tensors; "
                         f"got {xh.device}")
    B, S, H, P = xh.shape
    N = Bm.shape[3]
    Q = int(chunk)
    pl = plan_bwd(B, S, H, P, N, Q, G)
    if max(pl.grids) > GRID_X_MAX:
        raise ValueError(f"K7b's grids {pl.grids} exceed {GRID_X_MAX}")
    f32 = dict(dtype=torch.float32, device=xh.device)
    outs = [torch.empty(t.shape, **f32) for t in (xh, dt, A, Bm, Cm)]
    scratch = [torch.empty(shape, **f32)
               for shape in pl.scratch_shapes.values()]
    grids = (ctypes.c_longlong * 4)(*pl.grids)
    x_st, dt_st, b_st, c_st = ((ctypes.c_longlong * t.dim())(*t.stride())
                               for t in (xh, dt, Bm, Cm))
    ptrs = [t.data_ptr() for t in [xh, dt, A, Bm, Cm, dY, dS, dtot]
            + outs + scratch]
    vec = (_rows_in_float4s(xh) | 2 * _rows_in_float4s(dY)
           | 4 * int(P % 4 == 0 and dS.data_ptr() % 16 == 0))
    with torch.cuda.device(xh.device):
        stream = torch.cuda.current_stream(xh.device).cuda_stream
        err = _lib_bwd()(*ptrs, B, S, H, P, N, Q, G, pl.hs, vec, grids, x_st,
                         dt_st, A.stride(0), b_st, c_st, stream)
    if err != 0:
        raise RuntimeError(f"ssd_intra_chunk_bwd_f32 launch failed: CUDA "
                           f"error {err}")
    ssd_intra_chunk_bwd.launches += 1
    return tuple(outs)


ssd_intra_chunk_bwd.launches = 0   # wrapper calls (4 launches each)


class _IntraChunk(torch.autograd.Function):
    """The intra-chunk term with B/C as groups (B, S, G, N), G 1 or H:
    ``fwd`` (K7) on detached inputs, ``vjp`` (K7b) from the saved inputs
    alone, so autograd holds no (Q, Q) tensor."""

    @staticmethod
    def forward(ctx, xh, dt, A, Bm, Cm, chunk, fwd, vjp):
        ctx.save_for_backward(xh, dt, A, Bm, Cm)
        ctx.chunk, ctx.vjp = chunk, vjp
        H = xh.shape[2]
        xh, dt, A, Bm, Cm = (t.detach() for t in (xh, dt, A, Bm, Cm))
        return fwd(xh, dt, A, heads(Bm, H), heads(Cm, H), chunk)

    @staticmethod
    def backward(ctx, dY, dS, dtot):
        grads = ctx.vjp(*ctx.saved_tensors, ctx.chunk, dY, dS, dtot)
        return (*grads, None, None, None)


def intra_chunk(xh, dt, A, Bm, Cm, chunk, fwd=ssd_intra_chunk,
                vjp=ssd_intra_chunk_bwd):
    """K7's outputs, differentiable through K7b; B/C as groups (B, S, G,
    N), G 1 or H. ``fwd`` and ``vjp`` default to the kernels (the tests put
    the plain versions in their place on the CPU)."""
    return _IntraChunk.apply(xh, dt, A, Bm, Cm, chunk, fwd, vjp)


def ssd_kernel_forward(xh, dt, A, Bm, Cm, chunk, h0=None,
                       intra=ssd_intra_chunk):
    """The whole SSD from the intra-chunk term ``intra`` (K7 by default;
    ``ops.ssd`` passes the plain version for CPU tensors, the model's route
    ``intra_chunk``), the inter-chunk recurrence from ``h0`` (zeros when
    None) and the ``Y_off`` term. B/C are what ``intra`` takes: (B, S, H, N)
    per head, or (B, S, G, N) groups read by H / G heads each. Equal to
    ``models.ssm.ssd_chunked``: returns (y (B, S, H, P), h_final
    (B, H, P, N)), fp32."""
    B, S, H, P = xh.shape
    G, N = Cm.shape[2], Cm.shape[3]
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
    # C·h per group: a group's C is read once for its H / G heads
    Cc = Cm.float().reshape(B, nc, chunk, G, N)
    ch = torch.einsum("bcign,bcgkpn->bcigkp", Cc,
                      h_prevs.reshape(B, nc, G, H // G, P, N))
    Y_off = ch.reshape(B, nc, chunk, H, P) * decay_in[..., None]
    y = Yd.reshape(B, nc, chunk, H, P) + Y_off
    return y.reshape(B, S, H, P), h
