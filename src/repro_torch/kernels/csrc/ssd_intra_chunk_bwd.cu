// Mamba2 SSD intra-chunk term, backward (kernel K7b): the VJP of K7.
//
// Replaces no TPU kernel. The Pallas K7 (repro/kernels/ssd_scan.py) is
// forward-only and the JAX package trains through its plain chunked SSD,
// whose autograd writes the (Q, Q) decay matrix L, G = C B^T and G * L per
// head to device memory and reads them back. This kernel exists so that the
// port's training path can run K7 forward and still never hold a (Q, Q)
// tensor per head: it recomputes G once per (batch, chunk, group) and L tile
// by tile, from K7's inputs alone. Its plain PyTorch version is
// repro_torch/kernels/ref.py::ssd_intra_chunk_vjp_ref.
//
// For one cell (batch b, chunk c, head h) with K7's inputs x (Q, P), dt
// (Q,), A, B and C (Q, N) and the cotangents dY (Q, P), dS (N, P) and dtot:
//
//   cum, L, xdt = x dt, decay_j = exp(cum_{Q-1} - cum_j): as K7 computes
//   W = G * L,  M = dY xdt^T (causal pairs i >= j),  R = M * W
//   dxdt    = W^T dY + decay * (B dS)                  (Q, P)
//   e_j     = decay_j sum_p (B dS)_jp xdt_jp
//   dcum_j  = sum_i' R_ji' - sum_p xdt_jp dxdt_jp      (R's row sum, less
//             R's column sum and e_j, which the xdt . dxdt product holds)
//   dcum_{Q-1} += sum_j e_j + dtot exp(cum_{Q-1})
//   ddA     = reverse cumsum of dcum (fp64, rounded once)
//   dx = dxdt dt,  ddt = ddA A + sum_p x dxdt,  dA_h = sum ddA dt
//   dG      = sum over the group's heads of L * M      (Q, Q)
//   dC = dG B,  dB = dG^T C + sum over the group's heads of (xdt decay) dS^T
//
// x, dt, B and C are read through their strides; B and C are (B, S,
// groups, N), groups 1 (one group read by every head) or H; dY (B, S, H, P),
// dS (B, nc, H, N, P) and dtot (B, nc, H) are contiguous. dx, ddt, dA, dB
// and dC are written contiguous, dB and dC in B's and C's (B, S, groups, N):
// for one group the head sum is taken here.
//
// Design: four launches a call, planned by kernels/ssd_scan.py::plan_bwd;
// 256 threads a block, 64 x 64 output tiles in 4 x 4 (or 4 x 8) register
// tiles, every product an fmaf chain in index order.
//  1. prep: a G block builds one causal 64 x 64 tile of G = C B^T per
//     (batch, chunk, group), stored [i][j]; a B^T block writes B^T of a row
//     tile, [n][j]; a cum block scans 8 cells in fp64 (K7's scan,
//     ssd_cum.cuh) into a [cum | dt | decay] scratch.
//  2. heads: a dG block takes one causal tile pair (i, j) of a (batch,
//     chunk, group) and a split of 8 of its heads; per head it forms M's
//     tile from dY and xdt rows in shared memory, adds L * M to its dG tile
//     in registers and writes R's partial row sums; the split's dG tile goes
//     to a scratch of partials (one per split, summed later in split order).
//     A dBu block sums (xdt decay) dS^T over the heads of a split for a
//     64 x 64 tile of dB.
//  3. dx: a block per (cell, 64-row tile j) accumulates B dS over N, takes
//     e_j and scales by decay, then adds W^T dY over the rows i >= j, W
//     built slice by slice from G and cum (masked pairs set to 0, never
//     exp'd); it writes dx and the row sums x . dxdt, xdt . dxdt and e.
//  4. finish: a block per head scans each of the head's cells' dcum in
//     fp64 (a warp a cell) into ddt and sums dA over the cells in a fixed
//     order; a dB or dC block sums the split partials of dG in order and
//     multiplies by C or B (dB adds the dBu partials first).
// No atomics: every sum across heads, tiles, splits or cells is taken in a
// fixed order, so a call gives the same bits every time. fp32 on the CUDA
// cores (fmaf under -fmad=false); TF32 is never used. Offsets are 64-bit.
//
// Bound on an H100: operations (ssd_scan.work_bwd). At mamba2-1.3b's
// training shape (B = 2, S = 2048, H = 64, P = 64, N = 128, Q = 256, one
// B/C group) the causal pairs need 17.6 GFLOP: >= 0.26 ms at 67 TFLOP/s.
#include <atomic>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "smem_once.cuh"
#include "ssd_cum.cuh"

namespace {

constexpr int T = 64;                   // rows and columns of a tile
constexpr int TT = T * T;
constexpr int NT = 256;                 // threads of every block
constexpr int BK = 32;                  // rows of a k-slice
constexpr int QMAX = 256;
constexpr int CUM_CELLS = NT / 32;      // cells of a cum block
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const float* x;
  const float* dt;
  const float* A;
  const float* Bm;
  const float* Cm;
  const float* dy;
  const float* ds;
  const float* dtot;
  float* dx;
  float* ddt;
  float* dA;
  float* dB;
  float* dC;
  float* g;     // G tiles (bcg, nrt * nrt, 64, 64), [i][j]
  float* bt;    // B^T (bcg, N, Q)
  float* cell;  // [cum | dt | decay] of every cell (cells, 3, Q)
  float* dgp;   // dG partials (bcg, npairs, nsplit, 64, 64), [i][j]
  float* rsp;   // R's row sums by tile pair (cells, npairs, 64)
  float* dbu;   // (xdt decay) dS^T partials (bcg, nsplit, Q, N)
  float* rows;  // [x . dxdt | xdt . dxdt | e] (cells, 3, Q)
  int64_t xs[4], ds3[3], bs[4], cs[4];  // element strides (b, s, head, .)
  int64_t as;
  int64_t S, nc, cells, bcgs;
  int H, P, N, Q, groups, hs, nsplit;
  int nrt, nnt, npairs;
  int vec;      // rows read as aligned float4s: x 1, dY 2, dS 4
  int64_t g_blocks, bt_blocks, dg_blocks;
};

__host__ __device__ constexpr int round4(int k) { return (k + 3) & ~3; }

// row pitch of a k-contiguous tile of k4 = round4(k) columns: 4 mod 8
// floats, so 8 threads reading 8 rows at one column hit 8 bank groups
__host__ __device__ constexpr int pitch4(int k) {
  return round4(k) % 8 ? round4(k) : round4(k) + 4;
}

__device__ __forceinline__ void pair_tiles(int pair, int& ti, int& tj) {
  ti = 0;
  tj = pair;
  while (tj > ti) {                 // pair index -> (ti, tj), tj <= ti
    tj -= ti + 1;
    ++ti;
  }
}

__device__ __forceinline__ float sum16(float v) {  // over tx = lane % 16
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// acc[r][c] += sum_k a[(ty + 16 r) ld + k] b[(tx + 16 c) ld + k], k < kn
// (kn a multiple of 4): both operands k-contiguous rows
__device__ __forceinline__ void mma_inner(float (&acc)[4][4], const float* a,
                                          const float* b, int kn, int ld) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  for (int k = 0; k < kn; k += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      av[r] = *reinterpret_cast<const float4*>(a + (ty + 16 * r) * ld + k);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      bv[c] = *reinterpret_cast<const float4*>(b + (tx + 16 * c) * ld + k);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float s = acc[r][c];
        s = __fmaf_rn(av[r].x, bv[c].x, s);
        s = __fmaf_rn(av[r].y, bv[c].y, s);
        s = __fmaf_rn(av[r].z, bv[c].z, s);
        acc[r][c] = __fmaf_rn(av[r].w, bv[c].w, s);
      }
  }
}

// acc[r][4 g + q] += sum_k a[k T + 4 ty + r] b[k ldb + 64 g + 4 tx + q],
// k < kn: both operands k-major slices
template <int NC>
__device__ __forceinline__ void mma_outer(float (&acc)[4][4 * NC],
                                          const float* a, const float* b,
                                          int kn, int ldb) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll 4
  for (int k = 0; k < kn; ++k) {
    const float4 a4 = *reinterpret_cast<const float4*>(a + k * T + 4 * ty);
    const float av[4] = {a4.x, a4.y, a4.z, a4.w};
    float bv[4 * NC];
#pragma unroll
    for (int g = 0; g < NC; ++g) {
      const float4 b4 =
          *reinterpret_cast<const float4*>(b + k * ldb + 64 * g + 4 * tx);
      bv[4 * g] = b4.x;
      bv[4 * g + 1] = b4.y;
      bv[4 * g + 2] = b4.z;
      bv[4 * g + 3] = b4.w;
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 4 * NC; ++j)
        acc[r][j] = __fmaf_rn(av[r], bv[j], acc[r][j]);
  }
}

struct Cell {  // (batch, chunk, head) of a cell, its group and G group
  int64_t b, c, bc, bcg;
  int h, grp;
};

__device__ __forceinline__ Cell cell_of(const Args& a, int64_t cell) {
  Cell o;
  o.h = (int)(cell % a.H);
  o.bc = cell / a.H;
  o.c = o.bc % a.nc;
  o.b = o.bc / a.nc;
  o.grp = a.groups == 1 ? 0 : o.h;
  o.bcg = o.bc * a.groups + o.grp;
  return o;
}

__device__ __forceinline__ Cell group_of(const Args& a, int64_t bcg) {
  Cell o;
  o.grp = (int)(bcg % a.groups);
  o.bc = bcg / a.groups;
  o.c = o.bc % a.nc;
  o.b = o.bc / a.nc;
  o.bcg = bcg;
  o.h = o.grp;
  return o;
}

// ------------------------------ launch 1 ---------------------------------

__device__ void g_tile(const Args& a, int64_t id, float* smem) {
  const int ld = pitch4(a.N), t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;
  float* cs = smem;           // 64 x ld: C rows i0 + r
  float* bsm = cs + T * ld;   // 64 x ld: B rows j0 + r
  int ti, tj;
  pair_tiles((int)(id % a.npairs), ti, tj);
  const Cell o = group_of(a, id / a.npairs);
  const int64_t row0 = o.c * a.Q;
  const int i0 = ti * T, j0 = tj * T;
  const float* Cb = a.Cm + o.b * a.cs[0] + o.grp * a.cs[2];
  const float* Bb = a.Bm + o.b * a.bs[0] + o.grp * a.bs[2];
  for (int e = t; e < T * ld; e += NT) {
    const int r = e / ld, n = e % ld;
    cs[e] = i0 + r < a.Q && n < a.N
                ? Cb[(row0 + i0 + r) * a.cs[1] + n * a.cs[3]]
                : 0.0f;
    bsm[e] = j0 + r < a.Q && n < a.N
                 ? Bb[(row0 + j0 + r) * a.bs[1] + n * a.bs[3]]
                 : 0.0f;
  }
  __syncthreads();
  float acc[4][4] = {};
  mma_inner(acc, cs, bsm, round4(a.N), ld);
  float* gt = a.g + ((o.bcg * a.nrt + ti) * a.nrt + tj) * TT;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) gt[(ty + 16 * r) * T + tx + 16 * c] = acc[r][c];
}

__device__ void bt_tile(const Args& a, int64_t id, float* smem) {
  const int t = threadIdx.x, ld = a.N + 1;
  const Cell o = group_of(a, id / a.nrt);
  const int j0 = (int)(id % a.nrt) * T, rows = min(T, a.Q - j0);
  const int64_t row0 = o.c * a.Q;
  const float* Bb = a.Bm + o.b * a.bs[0] + o.grp * a.bs[2];
  for (int e = t; e < rows * a.N; e += NT) {
    const int r = e / a.N, n = e % a.N;
    smem[r * ld + n] = Bb[(row0 + j0 + r) * a.bs[1] + n * a.bs[3]];
  }
  __syncthreads();
  float* out = a.bt + o.bcg * a.N * a.Q + j0;
  for (int e = t; e < rows * a.N; e += NT) {
    const int n = e / rows, r = e % rows;
    out[(int64_t)n * a.Q + r] = smem[r * ld + n];
  }
}

// cum of cells id * CUM_CELLS .. + CUM_CELLS - 1, one a warp, as K7 scans
// it (ssd_cum.cuh), into the [cum | dt | decay] scratch
__device__ void cum_cells(const Args& a, int64_t id) {
  const int64_t cell = id * CUM_CELLS + threadIdx.x / 32;
  if (cell >= a.cells) return;      // the whole warp
  const Cell o = cell_of(a, cell);
  ssd_cum_cell(a.dt + o.b * a.ds3[0] + o.c * a.Q * a.ds3[1] + o.h * a.ds3[2],
               a.ds3[1], a.A[o.h * a.as], a.Q, a.cell + cell * 3 * a.Q);
}

__global__ void __launch_bounds__(NT) ssd_bwd_prep(const Args a) {
  extern __shared__ float4 prep_smem4[];
  float* smem = reinterpret_cast<float*>(prep_smem4);
  const int64_t id = blockIdx.x;
  if (id < a.g_blocks)
    g_tile(a, id, smem);
  else if (id < a.g_blocks + a.bt_blocks)
    bt_tile(a, id - a.g_blocks, smem);
  else
    cum_cells(a, id - a.g_blocks - a.bt_blocks);
}

// ------------------------------ launch 2 ---------------------------------

// dst[r][p] = f(r, src[r rs + p ps]) for r < rows, p < P, else 0, over a
// 64 x ld tile (ld a multiple of 4); float4 reads where vec (ps = 1, rows
// 16-byte aligned, P % 4 = 0)
template <typename F>
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* src,
                                          int64_t rs, int64_t ps, int rows,
                                          int P, bool vec, F f) {
  const int t = threadIdx.x;
  if (vec) {
    const int q4 = ld / 4;
    for (int e = t; e < T * q4; e += NT) {
      const int r = e / q4, p = 4 * (e % q4);
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (r < rows && p < P) {
        v = *reinterpret_cast<const float4*>(src + r * rs + p);
        v = make_float4(f(r, v.x), f(r, v.y), f(r, v.z), f(r, v.w));
      }
      *reinterpret_cast<float4*>(dst + r * ld + p) = v;
    }
  } else {
    for (int e = t; e < T * ld; e += NT) {
      const int r = e / ld, p = e % ld;
      dst[e] = r < rows && p < P ? f(r, src[r * rs + p * ps]) : 0.0f;
    }
  }
}

// the heads of split s of group grp: [h0, h1)
__device__ __forceinline__ void split_heads(const Args& a, int grp, int s,
                                            int& h0, int& h1) {
  if (a.groups == 1) {
    h0 = s * a.hs;
    h1 = min(a.H, h0 + a.hs);
  } else {
    h0 = grp;
    h1 = grp + 1;
  }
}

__device__ void dg_block(const Args& a, int64_t id, float* smem) {
  const int ld = pitch4(a.P), t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;
  float* gs = smem;               // 64 x 65: the G tile [i][j]
  float* ys = gs + T * (T + 1);   // 64 x ld: dY rows i
  float* xsm = ys + T * ld;       // 64 x ld: x dt rows j
  float* ci = xsm + T * ld;       // 64: cum of rows i
  float* cj = ci + T;             // 64: cum of rows j
  const int s = (int)(id % a.nsplit);
  const int64_t rest = id / a.nsplit;
  const int pair = (int)(rest % a.npairs);
  const Cell o = group_of(a, rest / a.npairs);
  int ti, tj;
  pair_tiles(pair, ti, tj);
  const int i0 = ti * T, j0 = tj * T;
  const int64_t row0 = o.c * a.Q;
  const float* gt = a.g + ((o.bcg * a.nrt + ti) * a.nrt + tj) * TT;
  for (int e = t; e < TT; e += NT) gs[(e / T) * (T + 1) + e % T] = gt[e];
  int h0, h1;
  split_heads(a, o.grp, s, h0, h1);
  float dg[4][4] = {};
  for (int h = h0; h < h1; ++h) {
    const int64_t cell = o.bc * a.H + h;
    const float* cb = a.cell + cell * 3 * a.Q;
    const float* xb =
        a.x + o.b * a.xs[0] + h * a.xs[2] + (row0 + j0) * a.xs[1];
    const int64_t yrow = (int64_t)a.H * a.P;
    const float* yb = a.dy + ((o.b * a.S + row0) * a.H + h) * a.P + i0 * yrow;
    __syncthreads();              // the last head's readers are done
    load_rows(ys, ld, yb, yrow, 1, min(T, a.Q - i0), a.P, a.vec & 2,
              [](int, float v) { return v; });
    load_rows(xsm, ld, xb, a.xs[1], a.xs[3], min(T, a.Q - j0), a.P,
              a.vec & 1,
              [&](int r, float v) { return __fmul_rn(v, cb[a.Q + j0 + r]); });
    if (t < T) {
      ci[t] = i0 + t < a.Q ? cb[i0 + t] : 0.0f;
      cj[t] = j0 + t < a.Q ? cb[j0 + t] : 0.0f;
    }
    __syncthreads();
    float m[4][4] = {};
    mma_inner(m, ys, xsm, round4(a.P), ld);
    float rs[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int il = ty + 16 * r;
      rs[r] = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int jl = tx + 16 * c;
        if (i0 + il < a.Q && j0 + jl <= i0 + il) {
          const float lm = __fmul_rn(expf(__fsub_rn(ci[il], cj[jl])), m[r][c]);
          dg[r][c] = __fadd_rn(dg[r][c], lm);
          rs[r] = __fmaf_rn(lm, gs[il * (T + 1) + jl], rs[r]);
        }
      }
      rs[r] = sum16(rs[r]);
    }
    if (tx == 0) {
      float* out = a.rsp + (cell * a.npairs + pair) * T;
#pragma unroll
      for (int r = 0; r < 4; ++r)
        if (i0 + ty + 16 * r < a.Q) out[ty + 16 * r] = rs[r];
    }
  }
  float* out = a.dgp + ((o.bcg * a.npairs + pair) * a.nsplit + s) * TT;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) out[(ty + 16 * r) * T + tx + 16 * c] = dg[r][c];
}

__device__ void dbu_block(const Args& a, int64_t id, float* smem) {
  const int ld = pitch4(a.P), t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;
  float* us = smem;               // 64 x ld: x dt decay rows j
  float* dsm = us + T * ld;       // 64 x ld: dS rows n
  const int s = (int)(id % a.nsplit);
  int64_t rest = id / a.nsplit;
  const int n0 = (int)(rest % a.nnt) * T;
  rest /= a.nnt;
  const int j0 = (int)(rest % a.nrt) * T;
  const Cell o = group_of(a, rest / a.nrt);
  const int64_t row0 = o.c * a.Q;
  int h0, h1;
  split_heads(a, o.grp, s, h0, h1);
  float acc[4][4] = {};
  for (int h = h0; h < h1; ++h) {
    const int64_t cell = o.bc * a.H + h;
    const float* cb = a.cell + cell * 3 * a.Q;
    const float* xb =
        a.x + o.b * a.xs[0] + h * a.xs[2] + (row0 + j0) * a.xs[1];
    const float* db = a.ds + (cell * a.N + n0) * a.P;
    __syncthreads();
    load_rows(us, ld, xb, a.xs[1], a.xs[3], min(T, a.Q - j0), a.P, a.vec & 1,
              [&](int r, float v) {
                return __fmul_rn(__fmul_rn(v, cb[a.Q + j0 + r]),
                                 cb[2 * a.Q + j0 + r]);
              });
    load_rows(dsm, ld, db, a.P, 1, min(T, a.N - n0), a.P, a.vec & 4,
              [](int, float v) { return v; });
    __syncthreads();
    mma_inner(acc, us, dsm, round4(a.P), ld);
  }
  float* out = a.dbu + ((o.bcg * a.nsplit + s) * a.Q + j0) * a.N + n0;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = ty + 16 * r, n = tx + 16 * c;
      if (j0 + j < a.Q && n0 + n < a.N) out[(int64_t)j * a.N + n] = acc[r][c];
    }
}

__global__ void __launch_bounds__(NT) ssd_bwd_heads(const Args a) {
  extern __shared__ float4 heads_smem4[];
  float* smem = reinterpret_cast<float*>(heads_smem4);
  const int64_t id = blockIdx.x;
  if (id < a.dg_blocks)
    dg_block(a, id, smem);
  else
    dbu_block(a, id - a.dg_blocks, smem);
}

// ------------------------------ launch 3 ---------------------------------

template <int NC>  // P padded to 64 NC
__global__ void __launch_bounds__(NT) ssd_bwd_dx(const Args a) {
  constexpr int PD = 64 * NC;
  extern __shared__ float4 dx_smem4[];
  float* smem = reinterpret_cast<float*>(dx_smem4);
  float* as = smem;               // BK x 64: B^T slice [n][j] or W [i][j]
  float* bsm = as + BK * T;       // BK x PD: dS slice [n][p] or dY [i][p]
  float* cum = bsm + BK * PD;     // QMAX each: cum, dt, decay of the cell
  float* dts = cum + QMAX;
  float* dec = dts + QMAX;
  const int t = threadIdx.x, tx = t % 16, ty = t / 16;
  const int64_t cell = blockIdx.x / a.nrt;
  const int tj = (int)(blockIdx.x % a.nrt), j0 = tj * T;
  const Cell o = cell_of(a, cell);
  const int64_t row0 = o.c * a.Q;
  const float* cb = a.cell + cell * 3 * a.Q;
  for (int q = t; q < 3 * a.Q; q += NT) cum[q / a.Q * QMAX + q % a.Q] = cb[q];
  float acc[4][4 * NC] = {};

  // B dS: k = n
  const float* btb = a.bt + o.bcg * a.N * a.Q;
  const float* db = a.ds + cell * a.N * a.P;
  for (int n0 = 0; n0 < a.N; n0 += BK) {
    __syncthreads();
    for (int e = t; e < BK * T; e += NT) {
      const int k = e / T, j = e % T;
      as[e] = n0 + k < a.N && j0 + j < a.Q
                  ? btb[(int64_t)(n0 + k) * a.Q + j0 + j]
                  : 0.0f;
    }
    for (int e = t; e < BK * PD; e += NT) {
      const int k = e / PD, p = e % PD;
      bsm[e] = n0 + k < a.N && p < a.P ? db[(int64_t)(n0 + k) * a.P + p]
                                        : 0.0f;
    }
    __syncthreads();
    mma_outer<NC>(acc, as, bsm, min(BK, a.N - n0), PD);
  }

  // e_j = decay_j sum_p (B dS)_jp xdt_jp; then B dS times decay
  const float* xb = a.x + o.b * a.xs[0] + o.h * a.xs[2];
  float ev[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = j0 + 4 * ty + r;
    const bool in = j < a.Q;
    float part = 0.0f;
#pragma unroll
    for (int q = 0; q < 4 * NC; ++q) {
      const int p = 64 * (q / 4) + 4 * tx + q % 4;
      if (in && p < a.P)
        part = __fmaf_rn(acc[r][q],
                         __fmul_rn(xb[(row0 + j) * a.xs[1] + p * a.xs[3]],
                                   dts[j]),
                         part);
    }
    part = sum16(part);
    const float dj = in ? dec[j] : 0.0f;
    ev[r] = __fmul_rn(part, dj);
#pragma unroll
    for (int q = 0; q < 4 * NC; ++q) acc[r][q] = __fmul_rn(acc[r][q], dj);
  }

  // W^T dY: k = i over the rows i >= j0, W = G * L built in place
  const float* yb = a.dy + ((o.b * a.S + row0) * a.H + o.h) * a.P;
  for (int i0 = j0; i0 < a.Q; i0 += BK) {
    const int ti = i0 / T;
    const float* gt = a.g + ((o.bcg * a.nrt + ti) * a.nrt + tj) * TT +
                      (i0 - ti * T) * T;
    __syncthreads();
    for (int e = t; e < BK * T; e += NT) {
      const int i = i0 + e / T, j = j0 + e % T;
      as[e] = i < a.Q && j <= i
                  ? __fmul_rn(gt[e], expf(__fsub_rn(cum[i], cum[j])))
                  : 0.0f;
    }
    for (int e = t; e < BK * PD; e += NT) {
      const int k = e / PD, p = e % PD;
      bsm[e] = i0 + k < a.Q && p < a.P
                   ? yb[(int64_t)(i0 + k) * a.H * a.P + p]
                   : 0.0f;
    }
    __syncthreads();
    mma_outer<NC>(acc, as, bsm, min(BK, a.Q - i0), PD);
  }

  // dx = dxdt dt; the row sums x . dxdt and xdt . dxdt
  float* dxb = a.dx + ((o.b * a.S + row0) * a.H + o.h) * a.P;
  float* rw = a.rows + cell * 3 * a.Q;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = j0 + 4 * ty + r;
    const bool in = j < a.Q;
    float tau = 0.0f, sig = 0.0f;
#pragma unroll
    for (int q = 0; q < 4 * NC; ++q) {
      const int p = 64 * (q / 4) + 4 * tx + q % 4;
      if (in && p < a.P) {
        const float xv = xb[(row0 + j) * a.xs[1] + p * a.xs[3]];
        tau = __fmaf_rn(xv, acc[r][q], tau);
        sig = __fmaf_rn(__fmul_rn(xv, dts[j]), acc[r][q], sig);
        dxb[(int64_t)j * a.H * a.P + p] = __fmul_rn(acc[r][q], dts[j]);
      }
    }
    tau = sum16(tau);
    sig = sum16(sig);
    if (tx == 0 && in) {
      rw[j] = tau;
      rw[a.Q + j] = sig;
      rw[2 * a.Q + j] = ev[r];
    }
  }
}

// ------------------------------ launch 4 ---------------------------------

// ddt of every cell of head h (a warp a cell) and dA_h, summed in order
__device__ void fin_head(const Args& a, int h, double* red) {
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int L = (a.Q + 31) / 32;
  const float Ah = a.A[h * a.as];
  double dsum = 0.0;
  for (int64_t bc = w; bc < a.cells / a.H; bc += NT / 32) {
    const int64_t cell = bc * a.H + h;
    const Cell o = cell_of(a, cell);
    const float* cb = a.cell + cell * 3 * a.Q;
    const float* rw = a.rows + cell * 3 * a.Q;
    const float* rs = a.rsp + cell * a.npairs * T;
    float dc[QMAX / 32];
    float esum = 0.0f;
#pragma unroll
    for (int u = 0; u < QMAX / 32; ++u) {
      const int q = lane * L + u;
      dc[u] = 0.0f;
      if (u < L && q < a.Q) {
        const int ti = q / T;
        float rsum = 0.0f;
        for (int tj = 0; tj <= ti; ++tj)
          rsum = __fadd_rn(rsum, rs[(ti * (ti + 1) / 2 + tj) * T + q % T]);
        dc[u] = __fsub_rn(rsum, rw[a.Q + q]);
        esum = __fadd_rn(esum, rw[2 * a.Q + q]);
      }
    }
#pragma unroll
    for (int o2 = 16; o2 > 0; o2 >>= 1)
      esum = __fadd_rn(esum, __shfl_xor_sync(FULL, esum, o2));
    const float last =
        __fadd_rn(esum, __fmul_rn(a.dtot[cell], expf(cb[a.Q - 1])));
#pragma unroll
    for (int u = 0; u < QMAX / 32; ++u)
      if (u < L && lane * L + u == a.Q - 1) dc[u] = __fadd_rn(dc[u], last);
    // ddA_q = sum_{k >= q} dcum_k in fp64, rounded once
    double suf[QMAX / 32];
    double run = 0.0;
#pragma unroll
    for (int u = QMAX / 32 - 1; u >= 0; --u) {
      if (u < L) run = __dadd_rn(run, (double)dc[u]);
      suf[u] = run;
    }
    double incl = run;              // inclusive scan from the last lane down
#pragma unroll
    for (int o2 = 1; o2 < 32; o2 <<= 1) {
      const double v = __shfl_down_sync(FULL, incl, o2);
      if (lane + o2 < 32) incl = __dadd_rn(incl, v);
    }
    double excl = __shfl_down_sync(FULL, incl, 1);
    if (lane == 31) excl = 0.0;
#pragma unroll
    for (int u = 0; u < QMAX / 32; ++u) {
      const int q = lane * L + u;
      if (u < L && q < a.Q) {
        const float dda = __double2float_rn(__dadd_rn(excl, suf[u]));
        const float dtq = cb[a.Q + q];
        a.ddt[(o.b * a.S + o.c * a.Q + q) * a.H + h] =
            __fadd_rn(__fmul_rn(dda, Ah), rw[q]);
        dsum = __dadd_rn(dsum, __dmul_rn((double)dda, (double)dtq));
      }
    }
  }
#pragma unroll
  for (int o2 = 16; o2 > 0; o2 >>= 1)
    dsum = __dadd_rn(dsum, __shfl_xor_sync(FULL, dsum, o2));
  if (lane == 0) red[w] = dsum;
  __syncthreads();
  if (threadIdx.x == 0) {
    double tot = 0.0;
    for (int i = 0; i < NT / 32; ++i) tot = __dadd_rn(tot, red[i]);
    a.dA[h] = __double2float_rn(tot);
  }
}

// dC (kind 0) or dB (kind 1) for a 64 x 64 tile (rows r0.., N columns n0..)
// of a (batch, chunk, group)
__device__ void dbc_block(const Args& a, int64_t id, float* smem) {
  const int t = threadIdx.x, tx = t % 16, ty = t / 16;
  const int kind = (int)(id % 2);
  int64_t rest = id / 2;
  const int n0 = (int)(rest % a.nnt) * T;
  rest /= a.nnt;
  const int tr = (int)(rest % a.nrt), r0 = tr * T;
  const Cell o = group_of(a, rest / a.nrt);
  const int64_t row0 = o.c * a.Q;
  const float* dgb = a.dgp + o.bcg * a.npairs * a.nsplit * TT;
  float* out = (kind ? a.dB : a.dC) +
               ((o.b * a.S + row0) * a.groups + o.grp) * a.N;
  const int64_t pitch = (int64_t)a.groups * a.N;
  if (kind == 0) {
    // dC_i = sum_{j <= i} dG_ij B_j: k = j, rows of dG and of B^T
    constexpr int LD = BK + 4;
    float* gsm = smem;            // 64 x LD: dG rows i
    float* bsm = gsm + T * LD;    // 64 x LD: B^T rows n
    const float* btb = a.bt + o.bcg * a.N * a.Q;
    float acc[4][4] = {};
    for (int j0 = 0; j0 < min(a.Q, r0 + T); j0 += BK) {
      const int tj = j0 / T;
      const float* dg = dgb + (int64_t)(tr * (tr + 1) / 2 + tj) * a.nsplit * TT;
      __syncthreads();
      for (int e = t; e < T * BK; e += NT) {
        const int i = e / BK, k = e % BK, j = j0 + k;
        float v = 0.0f;
        if (j < a.Q)
          for (int s = 0; s < a.nsplit; ++s)
            v = __fadd_rn(v, dg[(int64_t)s * TT + i * T + j - tj * T]);
        gsm[i * LD + k] = v;
        bsm[i * LD + k] = n0 + i < a.N && j < a.Q
                              ? btb[(int64_t)(n0 + i) * a.Q + j]
                              : 0.0f;
      }
      __syncthreads();
      mma_inner(acc, gsm, bsm, BK, LD);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = r0 + ty + 16 * r, n = n0 + tx + 16 * c;
        if (i < a.Q && n < a.N) out[i * pitch + n] = acc[r][c];
      }
    return;
  }
  // dB_j = sum over splits of the dBu partials + sum_{i >= j} dG_ij C_i:
  // k = i, dG [i][j] and C [i][n] slices
  float* gsm = smem;              // BK x 64
  float* csm = gsm + BK * T;      // BK x 64
  const float* Cb = a.Cm + o.b * a.cs[0] + o.grp * a.cs[2];
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = r0 + 4 * ty + r, n = n0 + 4 * tx + q;
      float v = 0.0f;
      if (j < a.Q && n < a.N)
        for (int s = 0; s < a.nsplit; ++s)
          v = __fadd_rn(v, a.dbu[((o.bcg * a.nsplit + s) * a.Q + j) * a.N + n]);
      acc[r][q] = v;
    }
  for (int i0 = r0; i0 < a.Q; i0 += BK) {
    const int ti = i0 / T;
    const float* dg = dgb + (int64_t)(ti * (ti + 1) / 2 + tr) * a.nsplit * TT +
                      (i0 - ti * T) * T;
    __syncthreads();
    for (int e = t; e < BK * T; e += NT) {
      const int k = e / T, col = e % T;
      float v = 0.0f;
      if (i0 + k < a.Q)
        for (int s = 0; s < a.nsplit; ++s)
          v = __fadd_rn(v, dg[(int64_t)s * TT + e]);
      gsm[e] = v;
      csm[e] = i0 + k < a.Q && n0 + col < a.N
                   ? Cb[(row0 + i0 + k) * a.cs[1] + (n0 + col) * a.cs[3]]
                   : 0.0f;
    }
    __syncthreads();
    mma_outer<1>(acc, gsm, csm, min(BK, a.Q - i0), T);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = r0 + 4 * ty + r, n = n0 + 4 * tx + q;
      if (j < a.Q && n < a.N) out[j * pitch + n] = acc[r][q];
    }
}

__global__ void __launch_bounds__(NT) ssd_bwd_finish(const Args a) {
  extern __shared__ float4 fin_smem4[];
  float* smem = reinterpret_cast<float*>(fin_smem4);
  const int64_t id = blockIdx.x;
  if (id < a.H)
    fin_head(a, (int)id, reinterpret_cast<double*>(smem));
  else
    dbc_block(a, id - a.H, smem);
}

int launch(void (*kernel)(const Args), std::atomic<int>* done, int64_t blocks,
           size_t smem, cudaStream_t st, const Args& a) {
  cudaError_t err = allow_smem(kernel, done, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, NT, smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Pointers: x, dt, A, Bm, Cm (K7's fp32 inputs, read through the strides
// x_st (b, s, head, p), dt_st (b, s, head), a_st, b_st / c_st (b, s, group,
// n)); dy (B, S, H, P), ds (B, nc, H, N, P), dtot (B, nc, H) contiguous; dx
// (B, S, H, P), ddt (B, S, H), dA (H,), dB / dC (B, S, groups, N)
// contiguous outputs; g, bt, cell, dgp, rsp, dbu, rows fp32 scratch of
// ssd_scan.BwdPlan's shapes. groups is 1 or H; hs the heads of a split;
// vec the rows read as aligned float4s (bits: x 1, dY 2, dS 4).
// grids: the four launches' blocks (prep, heads, dx, finish), checked here
// against the geometry. Q <= 256 divides S; N <= 128; P <= 128. Returns
// the CUDA error of the launches (0 = none).
extern "C" int ssd_intra_chunk_bwd_f32(
    const float* x, const float* dt, const float* A, const float* Bm,
    const float* Cm, const float* dy, const float* ds, const float* dtot,
    float* dx, float* ddt, float* dA, float* dB, float* dC, float* g,
    float* bt, float* cell, float* dgp, float* rsp, float* dbu, float* rows,
    long long B, long long S, int H, int P, int N, int Q, int groups, int hs,
    int vec, const long long* grids, const long long* x_st, const long long* dt_st,
    long long a_st, const long long* b_st, const long long* c_st,
    void* stream) {
  Args a;
  a.x = x;
  a.dt = dt;
  a.A = A;
  a.Bm = Bm;
  a.Cm = Cm;
  a.dy = dy;
  a.ds = ds;
  a.dtot = dtot;
  a.dx = dx;
  a.ddt = ddt;
  a.dA = dA;
  a.dB = dB;
  a.dC = dC;
  a.g = g;
  a.bt = bt;
  a.cell = cell;
  a.dgp = dgp;
  a.rsp = rsp;
  a.dbu = dbu;
  a.rows = rows;
  for (int i = 0; i < 4; ++i) {
    a.xs[i] = x_st[i];
    a.bs[i] = b_st[i];
    a.cs[i] = c_st[i];
  }
  for (int i = 0; i < 3; ++i) a.ds3[i] = dt_st[i];
  a.as = a_st;
  a.S = S;
  a.nc = S / Q;
  a.cells = B * a.nc * H;
  a.bcgs = B * a.nc * groups;
  a.H = H;
  a.P = P;
  a.N = N;
  a.Q = Q;
  a.groups = groups;
  a.vec = vec;
  a.hs = groups == 1 ? hs : 1;
  a.nsplit = groups == 1 ? (H + hs - 1) / hs : 1;
  a.nrt = (Q + T - 1) / T;
  a.nnt = (N + T - 1) / T;
  a.npairs = a.nrt * (a.nrt + 1) / 2;
  a.g_blocks = a.bcgs * a.npairs;
  a.bt_blocks = a.bcgs * a.nrt;
  a.dg_blocks = a.bcgs * a.npairs * a.nsplit;
  if (Q < 1 || Q > QMAX || S % Q || N < 1 || N > 128 || P < 1 || P > 128 ||
      hs < 1 || (groups != 1 && groups != H) ||
      grids[0] != a.g_blocks + a.bt_blocks +
                      (a.cells + CUM_CELLS - 1) / CUM_CELLS ||
      grids[1] != a.dg_blocks + a.bcgs * a.nrt * a.nnt * a.nsplit ||
      grids[2] != a.cells * a.nrt ||
      grids[3] != H + a.bcgs * a.nrt * a.nnt * 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ldn = pitch4(N), ldp = pitch4(P);
  const size_t prep_smem =
      sizeof(float) * (size_t)(2 * ldn > N + 1 ? 2 * T * ldn : T * (N + 1));
  const size_t heads_smem =
      sizeof(float) * (size_t)(T * (T + 1) + 2 * T * ldp + 2 * T);
  const size_t fin_smem = sizeof(float) * (size_t)(2 * T * (BK + 4));
  static std::atomic<int> done_prep[SMEM_MAX_DEVICES];
  static std::atomic<int> done_heads[SMEM_MAX_DEVICES];
  static std::atomic<int> done_dx[2][SMEM_MAX_DEVICES];
  static std::atomic<int> done_fin[SMEM_MAX_DEVICES];
  int err = launch(ssd_bwd_prep, done_prep, grids[0], prep_smem, st, a);
  if (err) return err;
  err = launch(ssd_bwd_heads, done_heads, grids[1], heads_smem, st, a);
  if (err) return err;
  if (P <= 64)
    err = launch(ssd_bwd_dx<1>, done_dx[0], grids[2],
                 sizeof(float) * (BK * T + BK * 64 + 3 * QMAX), st, a);
  else
    err = launch(ssd_bwd_dx<2>, done_dx[1], grids[2],
                 sizeof(float) * (BK * T + BK * 128 + 3 * QMAX), st, a);
  if (err) return err;
  return launch(ssd_bwd_finish, done_fin, grids[3], fin_smem, st, a);
}
