// Mamba2 SSD intra-chunk term, forward (kernel K7).
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py::ssd_intra_chunk
// (pallas_call at ssd_scan.py:71, body _kernel at :26). Its plain PyTorch
// version is repro_torch/kernels/ref.py::ssd_intra_chunk_ref. For one cell
// (batch b, chunk c, head h) with x (Q, P), dt (Q,), A, B and C (Q, N):
//
//   cum     = cumsum(dt * A)                       fp64 sum, rounded once
//   L[i][j] = exp(cum_i - cum_j) for j <= i, else 0
//   Y[i]    = sum_{j <= i} (C_i . B_j) * L[i][j] * (x_j * dt_j)   (Q, P)
//   S_chunk = sum_j B_j^T ((x_j * dt_j) * exp(cum_{Q-1} - cum_j))  (N, P)
//   total   = exp(cum_{Q-1})
//
// x, dt, B and C are read through their strides; A is (H,). All fp32. Y is
// written (B, S, H, P), S_chunk (B, nc, H, N, P) and total (B, nc, H), all
// contiguous.
//
// Design: two launches a call, planned by kernels/ssd_scan.py::plan.
//  1. ssd_intra_chunk_prep, 256 threads a block, two kinds of block:
//     * a G block computes one causal 64 x 64 tile (i >= j) of G = C B^T
//       for one (batch, chunk, group): each element one fmaf chain over n
//       in index order, from C and B rows staged (transposed, by cp.async)
//       in shared memory. When B and C both have a head stride of 0 (one
//       group over the heads, as models/ssm.py passes them) there is one
//       group, so G is built once per (batch, chunk), not once per head;
//       otherwise a group is a head. Tiles go to a scratch (B, nc, groups,
//       nrt * nrt, 64, 64) (tile (i, j) at i * nrt + j, stored [j][i]).
//     * a cum block scans 8 cells, one a warp (ssd_cum.cuh): each lane adds
//       its run of rows in order in fp64, a shuffle scan adds the lanes'
//       sums, and each prefix is rounded once to fp32 (within half an ulp
//       of the exact sum, whatever the order of the fp64 adds:
//       ref.ssd_cumsum).
//       It writes the cell's cum, dt and decay exp(cum_{Q-1} - cum) to a
//       scratch (B, nc, H, 3, Q), contiguous for the main blocks, and
//       total = exp(cum_{Q-1}).
//  2. ssd_intra_chunk_main<PD>, PD threads a block (P padded to PD in
//     {32, 64, 128}), one block per (cell, 64-row tile): a Y block for row
//     tile i, or a state block for 64 rows of N. A block streams 32-row
//     k-slices (of its G tiles j <= i, or of B over the chunk) and the
//     matching x rows through a two-stage cp.async ring (float4 copies
//     where x's and B's rows allow), so the next slice loads while this
//     one is used. In place it turns a G slice into W = G exp(cum_i -
//     cum_j) (masked pairs are set to 0, never exp'd: above the diagonal
//     exp can overflow) and x into x dt (Y) or x dt decay (state), then
//     accumulates Y_i += W (x dt) or S += B^T (x dt decay) in 8 x 8
//     register tiles (thread (ty, tx): rows 8 ty .. 8 ty + 7, columns
//     4 tx .. 4 tx + 3 and PD/2 + 4 tx .. + 3; float4 reads, no bank
//     conflicts). On the diagonal a warp stops after its last row: W is 0
//     beyond it. A (batch, chunk)'s blocks run together (its x stays in
//     L2), the heaviest first: the last Y row tile and the state blocks
//     (nrt tiles of work each), then the Y row tiles nrt-2 .. 0. 36 KB of
//     shared memory and 167 registers a thread at PD = 64: six blocks an SM.
// No atomics and no sum split across blocks: every output of Y and S is one
// fmaf chain in index order, so a call gives the same bits every time. It
// sums in another order than cuBLAS and its cum may differ by an ulp where
// an fp64 sum straddles an fp32 rounding boundary, so it agrees with the
// plain version to a rounding bound (u (4 max|cum| + 2 (N + Q) + 16) of the
// magnitude sum), not bitwise. Offsets are 64-bit.
//
// Bound on an H100: operations. At the serve prefill's shape (B = 4,
// S = 2048, H = 64, P = 64, N = 128, Q = 256, one B/C group) the inputs
// need 17.5 GFLOP (G once per (batch, chunk); per cell the causal half of
// (G * L) x dt and the chunk state): >= 0.26 ms at the 67 TFLOP/s of fp32
// outside the tensor cores; the bytes are about 0.35 GB, 0.10 ms at
// 3.35 TB/s (ssd_scan.work). fp32 on the CUDA cores, TF32 off; 3xTF32 or
// wgmma are later work.
#include <atomic>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "smem_once.cuh"
#include "ssd_cum.cuh"

namespace {

constexpr int T = 64;                       // rows and columns of a tile
constexpr int TT = T * T;
constexpr int BK = 32;                      // chunk rows of a k-slice
constexpr int PT = T + 4;                   // pitch of the G block's C/B
constexpr int QMAX = 256;
constexpr int PREP_THREADS = 256;
constexpr int CUM_CELLS = PREP_THREADS / 32;  // cells of a cum block

struct Args {
  const float* x;
  const float* dt;
  const float* A;
  const float* Bm;
  const float* Cm;
  float* y;
  float* s;
  float* tot;
  float* g;                            // G tiles (scratch)
  float* cellbuf;                      // [cum | dt | decay] of every cell
  int64_t xs[4], ds[3], bs[4], cs[4];  // element strides (b, s, head, ·)
  int64_t as;
  int64_t nc, cells, g_blocks;
  int H, P, N, Q;
  int nrt, nst, npairs, groups;
  int xvec, bvec;  // x / B rows in aligned float4s (stride 1, P / N % 4 = 0)
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ------------------------------ launch 1 ---------------------------------

// G tile (ti, tj) of group gid = (b * nc + c) * groups + grp, stored [j][i]
__device__ void g_tile(const Args& a, int64_t id, float* smem) {
  float* cs = smem;                 // N x PT: C rows i0.., transposed
  float* bsm = cs + a.N * PT;       // N x PT: B rows j0.., transposed
  const int t = threadIdx.x, tx = t % 16, ty = t / 16;
  const int64_t gid = id / a.npairs;
  int tj = (int)(id % a.npairs), ti = 0;
  while (tj > ti) {                 // pair index -> (ti, tj), tj <= ti
    tj -= ti + 1;
    ++ti;
  }
  const int grp = (int)(gid % a.groups);
  const int64_t c = (gid / a.groups) % a.nc;
  const int64_t b = gid / ((int64_t)a.groups * a.nc);
  const int64_t row0 = c * a.Q;
  const int i0 = ti * T, j0 = tj * T;
  const float* Cb = a.Cm + b * a.cs[0] + grp * a.cs[2];
  const float* Bb = a.Bm + b * a.bs[0] + grp * a.bs[2];
  for (int e = t; e < T * a.N; e += PREP_THREADS) {
    const int n = e % a.N, r = e / a.N;
    if (i0 + r < a.Q)
      cp_async4(cs + n * PT + r, Cb + (row0 + i0 + r) * a.cs[1] + n * a.cs[3]);
    else
      cs[n * PT + r] = 0.0f;
    if (j0 + r < a.Q)
      cp_async4(bsm + n * PT + r, Bb + (row0 + j0 + r) * a.bs[1] + n * a.bs[3]);
    else
      bsm[n * PT + r] = 0.0f;
  }
  cp_commit();
  cp_wait_all();
  __syncthreads();
  float g[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int k = 0; k < 4; ++k) g[r][k] = 0.0f;
#pragma unroll 4
  for (int n = 0; n < a.N; ++n) {
    const float4 cv = *reinterpret_cast<const float4*>(cs + n * PT + 4 * ty);
    const float4 bv = *reinterpret_cast<const float4*>(bsm + n * PT + 4 * tx);
    const float cr[4] = {cv.x, cv.y, cv.z, cv.w};
    const float bk[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int k = 0; k < 4; ++k) g[r][k] = __fmaf_rn(cr[r], bk[k], g[r][k]);
  }
  float* gt = a.g + ((gid * a.nrt + ti) * a.nrt + tj) * TT;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    *reinterpret_cast<float4*>(gt + (4 * tx + k) * T + 4 * ty) =
        make_float4(g[0][k], g[1][k], g[2][k], g[3][k]);
}

// cum and total of cells id * CUM_CELLS .. + CUM_CELLS - 1, one a warp
__device__ void cum_cells(const Args& a, int64_t id) {
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t cell = id * CUM_CELLS + w;
  if (cell >= a.cells) return;      // the whole warp
  const int h = (int)(cell % a.H);
  const int64_t c = (cell / a.H) % a.nc;
  const int64_t b = cell / ((int64_t)a.H * a.nc);
  const float* d = a.dt + b * a.ds[0] + c * a.Q * a.ds[1] + h * a.ds[2];
  // [cum | dt | decay] of the cell
  const float last = ssd_cum_cell(d, a.ds[1], a.A[h * a.as], a.Q,
                                  a.cellbuf + cell * 3 * a.Q);
  if (lane == 0) a.tot[cell] = expf(last);
}

__global__ void __launch_bounds__(PREP_THREADS)
    ssd_intra_chunk_prep(const Args a) {
  extern __shared__ float4 prep_smem4[];
  if ((int64_t)blockIdx.x < a.g_blocks)
    g_tile(a, blockIdx.x, reinterpret_cast<float*>(prep_smem4));
  else
    cum_cells(a, (int64_t)blockIdx.x - a.g_blocks);
}

// ------------------------------ launch 2 ---------------------------------

// Start the copies of k-slice `it` (chunk rows it * BK ..) into ring slot
// (tb, xd): the BK x 64 A slice (rows of a G tile [j][i] for a Y block, B
// rows [q][n] for a state block) and the BK x PD x slice [row][p]; zeros
// past Q, N and P.
template <int PD>
__device__ __forceinline__ void load_slice(const Args& a, bool state,
                                           const float* gtile,
                                           const float* bb, const float* xb,
                                           int64_t row0, int m0, int it,
                                           float* tb, float* xd) {
  constexpr int TPR = PD < T ? PD : T;   // threads along a 64-wide row
  constexpr int RPP = PD / TPR;          // rows a pass covers
  const int t = threadIdx.x;
  const int k0 = it * BK;
  if (state && a.bvec) {
    for (int k = t / (T / 4); k < BK; k += PD / (T / 4)) {
      const int n = 4 * (t % (T / 4));
      if (k0 + k < a.Q && m0 + n < a.N)
        cp_async16(tb + k * T + n, bb + (row0 + k0 + k) * a.bs[1] + m0 + n);
      else
        *reinterpret_cast<float4*>(tb + k * T + n) = make_float4(0, 0, 0, 0);
    }
  } else if (state) {
    for (int k = t / TPR; k < BK; k += RPP)
      for (int n = t % TPR; n < T; n += TPR) {
        if (k0 + k < a.Q && m0 + n < a.N)
          cp_async4(tb + k * T + n,
                    bb + (row0 + k0 + k) * a.bs[1] + (m0 + n) * a.bs[3]);
        else
          tb[k * T + n] = 0.0f;
      }
  } else {  // slice it of the row tile's G tiles, tile j = it / (T / BK)
    const float* src = gtile + (int64_t)k0 * T;
    for (int e = 4 * t; e < BK * T; e += 4 * PD) cp_async16(tb + e, src + e);
  }
  if (a.xvec) {
    for (int k = t / (PD / 4); k < BK; k += 4) {
      const int p = 4 * (t % (PD / 4));
      if (k0 + k < a.Q && p < a.P)
        cp_async16(xd + k * PD + p, xb + (row0 + k0 + k) * a.xs[1] + p);
      else
        *reinterpret_cast<float4*>(xd + k * PD + p) = make_float4(0, 0, 0, 0);
    }
  } else {
    const float* xr = xb + (row0 + k0) * a.xs[1] + (int64_t)t * a.xs[3];
    const bool pin = t < a.P;
    for (int k = 0; k < BK; ++k) {
      if (pin && k0 + k < a.Q)
        cp_async4(xd + k * PD + t, xr + k * a.xs[1]);
      else
        xd[k * PD + t] = 0.0f;
    }
  }
  cp_commit();
}

template <int PD>
constexpr size_t main_smem_bytes() {
  return sizeof(float) * (2 * (size_t)BK * T + 2 * (size_t)BK * PD +
                          3 * QMAX);
}

template <int PD>
__global__ void __launch_bounds__(PD) ssd_intra_chunk_main(const Args a) {
  constexpr int TX = PD / 8;       // threads along P
  constexpr int WROWS = 256 / TX;  // tile rows of one warp (8 ty a row)
  extern __shared__ float4 main_smem4[];
  float* smem = reinterpret_cast<float*>(main_smem4);
  float* tiles = smem;             // 2 x BK x T: W (Y) or B (state)
  float* xs = tiles + 2 * BK * T;  // 2 x BK x PD: x dt (Y), x dt decay (S)
  float* cum = xs + 2 * BK * PD;   // QMAX
  float* dts = cum + QMAX;         // QMAX
  float* dec = dts + QMAX;         // QMAX: exp(cum_{Q-1} - cum) (state)

  const int t = threadIdx.x, tx = t % TX, ty = t / TX, warp = t / 32;
  // block = ((b * nc + c) * (nrt + nst) + slot) * H + h: the blocks of one
  // (batch, chunk) run together, so its x stays in L2 between them
  const int h = (int)(blockIdx.x % a.H);
  const int64_t rest = blockIdx.x / a.H;
  const int slot = (int)(rest % (a.nrt + a.nst));
  const int64_t bc = rest / (a.nrt + a.nst);
  const int64_t c = bc % a.nc, b = bc / a.nc;
  const int64_t cell = bc * a.H + h;
  const int64_t row0 = c * a.Q;
  // slot 0: Y row tile nrt - 1; 1 .. nst: state N tiles; then Y row tiles
  // nrt - 2 .. 0 (the heaviest blocks of a chunk first)
  const bool state = slot >= 1 && slot <= a.nst;
  const int ti = slot == 0 ? a.nrt - 1
                           : (state ? slot - 1 : a.nrt - 1 - (slot - a.nst));
  const int i0 = ti * T;           // first chunk row (Y) or N row (state)
  // k-slices: the whole chunk (state) or its rows up to the row tile's end
  const int nslices = (min(state ? a.Q : i0 + T, a.Q) + BK - 1) / BK;
  const int grp = a.groups == 1 ? 0 : h;
  const float* gtile =
      a.g + ((((b * a.nc + c) * a.groups + grp) * a.nrt + ti) * a.nrt) * TT;
  const float* bb = a.Bm + b * a.bs[0] + h * a.bs[2];
  const float* xb = a.x + b * a.xs[0] + h * a.xs[2];

  const float* cb = a.cellbuf + cell * 3 * a.Q;  // cum, dt, decay: contiguous
  for (int q = t; q < 3 * a.Q; q += PD)
    cp_async4(cum + q / a.Q * QMAX + q % a.Q, cb + q);
  load_slice<PD>(a, state, gtile, bb, xb, row0, i0, 0, tiles, xs);

  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[r][k] = 0.0f;

  for (int it = 0; it < nslices; ++it) {
    const int buf = it & 1;
    float* tb = tiles + buf * BK * T;
    float* xd = xs + buf * BK * PD;
    const int k0 = it * BK;
    cp_wait_all();
    __syncthreads();  // slice it landed; every reader of the other slot done
    if (it + 1 < nslices)
      load_slice<PD>(a, state, gtile, bb, xb, row0, i0, it + 1,
                     tiles + (buf ^ 1) * BK * T, xs + (buf ^ 1) * BK * PD);
    if (state) {
      if (t < a.P) {
#pragma unroll 8
        for (int k = 0; k < BK; ++k)
          if (k0 + k < a.Q)
            xd[k * PD + t] = __fmul_rn(__fmul_rn(xd[k * PD + t],
                                                 dts[k0 + k]), dec[k0 + k]);
      }
    } else {
      // element (k, r) = t + m * PD of the slice: W[k][r] for row i0 + r
#pragma unroll 8
      for (int m = 0; m < BK * T / PD; ++m) {
        const int e = t + m * PD, k = e / T, r = e % T;
        const int row = i0 + r;
        float w = 0.0f;
        if (row < a.Q && k0 + k <= row)
          w = __fmul_rn(tb[e], expf(__fsub_rn(cum[row], cum[k0 + k])));
        tb[e] = w;
      }
      if (t < a.P) {
#pragma unroll 8
        for (int k = 0; k < BK; ++k)
          if (k0 + k < a.Q) xd[k * PD + t] = __fmul_rn(xd[k * PD + t],
                                                       dts[k0 + k]);
      }
    }
    __syncthreads();
    // rows past Q are 0; on the diagonal a warp stops after its last row
    // (W is 0 beyond it)
    int kend = min(BK, a.Q - k0);
    if (!state) kend = min(kend, i0 + (warp + 1) * WROWS - k0);
    const float4* a4 = reinterpret_cast<const float4*>(tb);
    const float4* b4 = reinterpret_cast<const float4*>(xd);
#pragma unroll 4
    for (int k = 0; k < kend; ++k) {
      const float4 a0 = a4[k * (T / 4) + 2 * ty];
      const float4 a1 = a4[k * (T / 4) + 2 * ty + 1];
      const float4 b0 = b4[k * (PD / 4) + tx];
      const float4 b1 = b4[k * (PD / 4) + TX + tx];
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          acc[r][j] = __fmaf_rn(av[r], bv[j], acc[r][j]);
    }
  }

  const int rmax = state ? a.N : a.Q;
  float* out = state ? a.s + cell * a.N * a.P
                     : a.y + ((b * a.nc * a.Q + row0) * a.H + h) * a.P;
  const int64_t pitch = state ? a.P : (int64_t)a.H * a.P;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int row = i0 + 8 * ty + r;
    if (row >= rmax) continue;
    if ((a.P & 3) == 0) {          // float4 stores
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = half * (PD / 2) + 4 * tx;
        if (p < a.P)
          *reinterpret_cast<float4*>(out + row * pitch + p) =
              make_float4(acc[r][4 * half], acc[r][4 * half + 1],
                          acc[r][4 * half + 2], acc[r][4 * half + 3]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int p = j < 4 ? 4 * tx + j : PD / 2 + 4 * tx + j - 4;
        if (p < a.P) out[row * pitch + p] = acc[r][j];
      }
    }
  }
}

template <int PD>
int launch_main(const Args& a, int64_t blocks, cudaStream_t stream) {
  static std::atomic<int> done[SMEM_MAX_DEVICES];
  const size_t smem = main_smem_bytes<PD>();
  cudaError_t err = allow_smem(ssd_intra_chunk_main<PD>, done, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_intra_chunk_main<PD><<<(unsigned)blocks, PD, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// x, dt, A, Bm, Cm: device pointers to fp32 inputs; *_st: their element
// strides (x, B, C: b, s, head, last; dt: b, s, head; A: head). y
// (B, S, H, P), s (B, nc, H, N, P), tot (B, nc, H): contiguous fp32
// outputs. g (B, nc, groups, nrt * nrt, 64, 64) and cum (B, nc, H, Q):
// fp32 scratch. groups is 1 (B and C one group over the heads) or H; the
// grids are ssd_scan.plan's (prep_blocks = g_blocks + ceil(cells / 8),
// main_blocks = cells * (nrt + nst)), checked here against the geometry.
// Q <= 256 divides S; N <= 128; P <= 128. Returns the CUDA error of the
// launches (0 = none).
extern "C" int ssd_intra_chunk_f32(
    const float* x, const float* dt, const float* A, const float* Bm,
    const float* Cm, float* y, float* s, float* tot, float* g, float* cellbuf,
    long long B, long long S, int H, int P, int N, int Q, int groups,
    int xvec, int bvec, long long g_blocks, long long prep_blocks, long long main_blocks,
    const long long* x_st, const long long* dt_st, long long a_st,
    const long long* b_st, const long long* c_st, void* stream) {
  Args a;
  a.x = x;
  a.dt = dt;
  a.A = A;
  a.Bm = Bm;
  a.Cm = Cm;
  a.y = y;
  a.s = s;
  a.tot = tot;
  a.g = g;
  a.cellbuf = cellbuf;
  for (int i = 0; i < 4; ++i) {
    a.xs[i] = x_st[i];
    a.bs[i] = b_st[i];
    a.cs[i] = c_st[i];
  }
  for (int i = 0; i < 3; ++i) a.ds[i] = dt_st[i];
  a.as = a_st;
  a.nc = S / Q;
  a.cells = B * a.nc * H;
  a.H = H;
  a.P = P;
  a.N = N;
  a.Q = Q;
  a.nrt = (Q + T - 1) / T;
  a.nst = (N + T - 1) / T;
  a.npairs = a.nrt * (a.nrt + 1) / 2;
  a.groups = groups;
  a.g_blocks = g_blocks;
  a.xvec = xvec;
  a.bvec = bvec;
  if (Q > QMAX || (groups != 1 && groups != H) ||
      g_blocks != B * a.nc * groups * a.npairs ||
      prep_blocks != g_blocks + (a.cells + CUM_CELLS - 1) / CUM_CELLS ||
      main_blocks != a.cells * (a.nrt + a.nst))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  static std::atomic<int> done[SMEM_MAX_DEVICES];
  const int prep_smem = (int)(sizeof(float) * 2 * N * PT);
  cudaError_t err = allow_smem(ssd_intra_chunk_prep, done, prep_smem);
  if (err != cudaSuccess) return (int)err;
  ssd_intra_chunk_prep<<<(unsigned)prep_blocks, PREP_THREADS, prep_smem,
                         st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (P <= 32) return launch_main<32>(a, main_blocks, st);
  if (P <= 64) return launch_main<64>(a, main_blocks, st);
  return launch_main<128>(a, main_blocks, st);
}
