// Causal flash attention, backward (kernel K4b): the VJP of K4.
//
// Replaces no TPU kernel: the Pallas flash kernel
// (repro/kernels/flash_attention.py::flash_attention_bhsd) has no VJP, and
// the JAX package trains through its plain recompute backward
// (repro/models/flash.py). Its plain PyTorch version is
// repro_torch/kernels/ref.py::flash_attention_vjp_ref. From q (B, S, H, D),
// k, v (B, S, Hk, D), K4's out (B, S, H, D) and log-sum-exp lse (B, H, S)
// (the training instance of flash_attention.cu), and dout (B, S, H, D), for
// query head h on kv head g = h / rep, rep = H / Hk:
//
//   s = (q * D^-1/2) . k ;  s = cap * tanh(s / cap)    if softcap
//   p = exp(s - lse) where c <= r (and r - c < window), else 0
//   delta_r = sum_d dout_rd * out_rd
//   ds = p * (dout . v - delta) * (1 - tanh^2)         (the last factor
//                                                        only with softcap)
//   dq = D^-1/2 * ds . k ;  dk = sum over g's rep heads of ds^T . (q * D^-1/2)
//   dv = sum over g's rep heads of p^T . dout
//
// All inputs fp32 with unit d stride and 16-byte rows (the wrapper copies
// any other view), read through their strides: the projection layout,
// the compact Hk-head K/V, no repeat. D <= 128, a multiple of 4, padded
// with zeros to DP = 64 or 128. fp32 arithmetic on the CUDA cores, as K4.
//
// Three launches (a fourth where the rep heads are split), no atomics, every
// sum in a fixed order, so a call gives the same bits every time:
// * flash_bwd_dq: one block per (b, h, 64-row query tile), heaviest (last)
//   tiles first. It computes its rows' delta (written for the next launch),
//   then walks the key tiles that hold an unmasked pair, as K4 does:
//   dP = dout . v^T and S = q' . k^T (a 4 x 4 tile a thread), P and dS in
//   registers, dS^T through shared memory, dq += dS . k (4 rows x DP/16
//   columns a thread).
// * flash_bwd_dkv: one block per (b, kv head, split of the rep heads,
//   64-key tile), heaviest (first) key tiles first. K and V stay in shared
//   memory; the block walks its hs = rep / ns query heads in order and, for
//   each, the query tiles from the diagonal on (to the window's end): S^T
//   and dP^T (4 keys x 4 rows a thread), P and dS through shared memory,
//   then dv += P^T . dout and dk += dS^T . q' (4 keys x DP/16 columns a
//   thread, in registers across every head and tile).
// * flash_bwd_sum (ns > 1 only): dk and dv are the sums of the ns splits'
//   partials, in split order. The split is the wrapper's: the smallest
//   divisor of rep that gives about four blocks for each of an H100's 132
//   SMs (cell shapes: B 4, S 1024, Hk 2, rep 7 -> 128 blocks unsplit, so 7
//   splits, 896 blocks; B 2, S 4096, Hk 2, rep 16 -> 256, so 4, 1024).
// Key tiles wholly above the diagonal or beyond the window are skipped, not
// computed; masks are evaluated only on tiles that reach the diagonal, the
// window's edge or the end of the sequence.
//
// The scores are the same fmaf chain over d as K4's, on the same pre-scaled
// q, so S here has the forward's bits; P = exp(S - lse) is K4's weight to
// rounding. Bound on an H100: operations. The causal pairs need 10 D flops
// each here (S and dP in both launches, dv, dk, dq: 14 D are computed, 4 D
// of them again), e.g. 18.8 GFLOP at (B 4, S 1024, H 14, D 64): >= 0.281
// ms at 67 TFLOP/s of fp32 outside the tensor cores; the bytes (q, k, v,
// out, dout, the gradients) are far below it.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "smem_once.cuh"

namespace {

constexpr int BQ = 64;          // query rows a tile
constexpr int BK = 64;          // keys a tile
constexpr int THREADS = 256;
constexpr int LPASS = 4;        // 16-byte loads in flight per thread
constexpr int PS = BQ + 4;      // pitch of a (64 x 64) score tile in smem

struct Args {
  const float* q;
  const float* k;
  const float* v;
  const float* o;
  const float* dout;
  const float* lse;     // (B, H, S)
  float* delta;         // (B, H, S), written by flash_bwd_dq
  float* dq;            // (B, S, H, D)
  float* dk;            // (B, S, Hk, D), or (ns, B, S, Hk, D) partials
  float* dv;
  int64_t qs[4], ks[4], vs[4], os[4], gs[4];  // strides of q, k, v, o, dout
  int64_t S;
  int B, H, Hk, D, ns;
  float qscale, softcap;
  int window;           // 0 = no window
};

// Rows [row0, row0 + ROWS) of one head into dst[r * pitch + d] (times
// qscale when SCALE), zeros past S and for d in [D, DP): 16-byte loads,
// LPASS a thread issued before the first is stored.
template <int DP, int ROWS, bool SCALE>
__device__ __forceinline__ void load_rows(float* dst, int pitch,
                                          const float* __restrict__ src,
                                          int64_t rs, int64_t row0, int64_t S,
                                          int D, float qscale) {
  constexpr int CH = DP / 4;
  constexpr int TOT = ROWS * CH;
  static_assert(TOT % (LPASS * THREADS) == 0, "whole passes of the block");
#pragma unroll 1
  for (int base = 0; base < TOT; base += LPASS * THREADS) {
    float4 raw[LPASS];
#pragma unroll
    for (int j = 0; j < LPASS; ++j) {
      const int i = base + threadIdx.x + j * THREADS;
      const int r = i / CH, c = (i % CH) * 4;
      raw[j] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row0 + r < S && c < D)
        raw[j] = __ldg(reinterpret_cast<const float4*>(src + (row0 + r) * rs +
                                                       c));
    }
#pragma unroll
    for (int j = 0; j < LPASS; ++j) {
      const int i = base + threadIdx.x + j * THREADS;
      const int r = i / CH, c = (i % CH) * 4;
      float4 x = raw[j];
      if (SCALE) {
        x.x = __fmul_rn(x.x, qscale);
        x.y = __fmul_rn(x.y, qscale);
        x.z = __fmul_rn(x.z, qscale);
        x.w = __fmul_rn(x.w, qscale);
      }
      *reinterpret_cast<float4*>(dst + r * pitch + c) = x;
    }
  }
}

// Row statistics [row0, row0 + BQ) of (b, h) from a (B, H, S) array, 0 past S.
__device__ __forceinline__ void load_stats(float* dst, const float* src,
                                           int64_t row0, int64_t S) {
  if (threadIdx.x < BQ) {
    const int64_t r = row0 + threadIdx.x;
    dst[threadIdx.x] = r < S ? src[r] : 0.0f;
  }
}

// Output column of a thread's j-th accumulator (j < DP / 16): groups of 4
// consecutive columns, the 16 threads of a column group side by side.
__device__ __forceinline__ int out_col(int cg, int j) {
  return (j / 4) * 64 + cg * 4 + j % 4;
}

// p and ds of one score: x the raw score (q' . k), dp = dout . v, the row's
// lse and delta; ok false gives 0 for both.
__device__ __forceinline__ void p_ds(float x, float dp, float lse, float dl,
                                     bool ok, float cap, float& p, float& ds) {
  float dcap = 1.0f;
  if (cap > 0.0f) {
    const float t = tanhf(__fdiv_rn(x, cap));
    x = __fmul_rn(cap, t);
    dcap = __fsub_rn(1.0f, __fmul_rn(t, t));
  }
  p = ok ? expf(__fsub_rn(x, lse)) : 0.0f;
  ds = __fmul_rn(p, __fsub_rn(dp, dl));
  if (cap > 0.0f) ds = __fmul_rn(ds, dcap);
}

// Whether (row - col) in [lo, hi] all pass the causal mask and the window.
__device__ __forceinline__ bool whole_tile(int64_t lo, int64_t hi,
                                           int window) {
  return lo >= 0 && (window <= 0 || hi < (int64_t)window);
}

// ------------------------------------------------------------------------ //
// dq (and delta): one block per (b, h, query tile)
// ------------------------------------------------------------------------ //

template <int DP>
constexpr size_t dq_smem_floats() {
  return 4 * (size_t)BQ * (DP + 4) + (size_t)BK * PS + 2 * BQ;
}

template <int DP>
__global__ void __launch_bounds__(THREADS, DP <= 64 ? 2 : 1)
    flash_bwd_dq(const Args a) {
  constexpr int P = DP + 4;
  constexpr int NJ = DP / 16;             // output columns a thread
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* qs = smem;                       // BQ x P, pre-scaled q
  float* gs = qs + BQ * P;                // BQ x P, dout
  float* ks = gs + BQ * P;                // BK x P
  float* vs = ks + BK * P;                // BK x P
  float* dst = vs + BK * P;               // BK x PS: dS transposed
  float* lse_s = dst + BK * PS;           // BQ
  float* dl_s = lse_s + BQ;               // BQ

  const int t = threadIdx.x, rg = t % 16, cg = t / 16;
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int g = h / (a.H / a.Hk);
  const int64_t q0 = (int64_t)(gridDim.y - 1 - blockIdx.y) * BQ;
  const float* qb = a.q + b * a.qs[0] + h * a.qs[2];
  const float* gb = a.dout + b * a.gs[0] + h * a.gs[2];
  const float* ob = a.o + b * a.os[0] + h * a.os[2];
  const float* kb = a.k + b * a.ks[0] + g * a.ks[2];
  const float* vb = a.v + b * a.vs[0] + g * a.vs[2];
  const int64_t stat0 = (int64_t)(b * a.H + h) * a.S;

  load_rows<DP, BQ, true>(qs, P, qb, a.qs[1], q0, a.S, a.D, a.qscale);
  load_rows<DP, BQ, false>(gs, P, gb, a.gs[1], q0, a.S, a.D, 1.0f);
  load_stats(lse_s, a.lse + stat0, q0, a.S);
  __syncthreads();

  // delta: a warp a row (8 rows a warp), a lane 4 columns, then a
  // butterfly over the lanes
  {
    const int w = t / 32, lane = t % 32;
#pragma unroll 1
    for (int r = w; r < BQ; r += THREADS / 32) {
      const int64_t row = q0 + r;
      float sum = 0.0f;
      if (row < a.S && lane * 4 < a.D) {
        const float4 ov =
            __ldg(reinterpret_cast<const float4*>(ob + row * a.os[1]) + lane);
        const float4 gv = *reinterpret_cast<const float4*>(gs + r * P +
                                                           lane * 4);
        sum = __fmul_rn(gv.x, ov.x);
        sum = __fmaf_rn(gv.y, ov.y, sum);
        sum = __fmaf_rn(gv.z, ov.z, sum);
        sum = __fmaf_rn(gv.w, ov.w, sum);
      }
#pragma unroll
      for (int o = 16; o >= 1; o >>= 1)
        sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, o));
      if (lane == 0) {
        dl_s[r] = sum;
        if (row < a.S) a.delta[stat0 + row] = sum;
      }
    }
  }

  // the key tiles that hold an unmasked pair, as K4 walks them
  int64_t kt_begin = 0;
  if (a.window > 0) {
    const int64_t lo = q0 - a.window - BK + 2;
    if (lo > 0) kt_begin = (lo + BK - 1) / BK;
  }
  const int64_t kt_end = q0 / BK + 1;

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;

#pragma unroll 1
  for (int64_t kt = kt_begin; kt < kt_end; ++kt) {
    const int64_t k0 = kt * BK;
    __syncthreads();  // the last tile's dS and K are read (delta: dout)
    load_rows<DP, BK, false>(ks, P, kb, a.ks[1], k0, a.S, a.D, 1.0f);
    load_rows<DP, BK, false>(vs, P, vb, a.vs[1], k0, a.S, a.D, 1.0f);
    __syncthreads();  // K, V (and, at the first tile, the row stats) landed

    // s = q' . k and dp = dout . v for rows rg + 16 i, keys 4 cg + j
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.0f;
#pragma unroll 2
    for (int d = 0; d < DP; d += 4) {
      float4 qv[4], gv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = *reinterpret_cast<const float4*>(qs + (rg + 16 * i) * P + d);
        gv[i] = *reinterpret_cast<const float4*>(gs + (rg + 16 * i) * P + d);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 kv =
            *reinterpret_cast<const float4*>(ks + (4 * cg + j) * P + d);
        const float4 vv =
            *reinterpret_cast<const float4*>(vs + (4 * cg + j) * P + d);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[i][j] = __fmaf_rn(qv[i].x, kv.x, s[i][j]);
          s[i][j] = __fmaf_rn(qv[i].y, kv.y, s[i][j]);
          s[i][j] = __fmaf_rn(qv[i].z, kv.z, s[i][j]);
          s[i][j] = __fmaf_rn(qv[i].w, kv.w, s[i][j]);
          dp[i][j] = __fmaf_rn(gv[i].x, vv.x, dp[i][j]);
          dp[i][j] = __fmaf_rn(gv[i].y, vv.y, dp[i][j]);
          dp[i][j] = __fmaf_rn(gv[i].z, vv.z, dp[i][j]);
          dp[i][j] = __fmaf_rn(gv[i].w, vv.w, dp[i][j]);
        }
      }
    }

    // dS, transposed into shared memory: dst[key][4 rg + i]
    const bool whole = whole_tile(q0 - (k0 + BK - 1), q0 + BQ - 1 - k0,
                                  a.window);
    const int rel = (int)(q0 - k0);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int dd = rel + rg + 16 * i - (4 * cg + j);   // row - col
        const bool ok = whole || (dd >= 0 && (a.window <= 0 || dd < a.window));
        float p;
        p_ds(s[i][j], dp[i][j], lse_s[rg + 16 * i], dl_s[rg + 16 * i], ok,
             a.softcap, p, ds[i]);
      }
      *reinterpret_cast<float4*>(dst + (4 * cg + j) * PS + 4 * rg) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();  // dS visible

    // dq += dS . k: rows rg + 16 i, columns out_col(cg, j)
    const int n = (int)(a.S - k0 < BK ? a.S - k0 : BK);
#pragma unroll 4
    for (int c = 0; c < n; ++c) {
      const float4 dv4 = *reinterpret_cast<const float4*>(dst + c * PS +
                                                          4 * rg);
      const float dr[4] = {dv4.x, dv4.y, dv4.z, dv4.w};
#pragma unroll
      for (int j = 0; j < NJ; j += 4) {
        const float4 kv = *reinterpret_cast<const float4*>(
            ks + c * P + out_col(cg, j));
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][j] = __fmaf_rn(dr[i], kv.x, acc[i][j]);
          acc[i][j + 1] = __fmaf_rn(dr[i], kv.y, acc[i][j + 1]);
          acc[i][j + 2] = __fmaf_rn(dr[i], kv.z, acc[i][j + 2]);
          acc[i][j + 3] = __fmaf_rn(dr[i], kv.w, acc[i][j + 3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t row = q0 + rg + 16 * i;
    if (row >= a.S) continue;
    float* orow = a.dq + ((b * a.S + row) * a.H + h) * (int64_t)a.D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = out_col(cg, j);
      if (d < a.D) orow[d] = __fmul_rn(acc[i][j], a.qscale);
    }
  }
}

// ------------------------------------------------------------------------ //
// dk, dv: one block per (b, kv head, split, key tile)
// ------------------------------------------------------------------------ //

template <int DP>
constexpr size_t dkv_smem_floats() {
  return 4 * (size_t)BQ * (DP + 4) + 2 * (size_t)BQ * PS + 2 * BQ;
}

template <int DP>
__global__ void __launch_bounds__(THREADS, DP <= 64 ? 2 : 1)
    flash_bwd_dkv(const Args a) {
  constexpr int P = DP + 4;
  constexpr int NJ = DP / 16;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* ks = smem;                       // BK x P
  float* vs = ks + BK * P;                // BK x P
  float* qs = vs + BK * P;                // BQ x P, pre-scaled q
  float* gs = qs + BQ * P;                // BQ x P, dout
  float* ps = gs + BQ * P;                // BQ x PS: p[row][key]
  float* dss = ps + BQ * PS;              // BQ x PS: ds[row][key]
  float* lse_s = dss + BQ * PS;           // BQ
  float* dl_s = lse_s + BQ;               // BQ

  const int t = threadIdx.x, kg = t / 16, qg = t % 16;
  const int x = blockIdx.x;
  const int r = x % a.ns, g = (x / a.ns) % a.Hk, b = x / (a.ns * a.Hk);
  const int rep = a.H / a.Hk, hs = rep / a.ns;
  const int64_t k0 = (int64_t)blockIdx.y * BK;
  const float* kb = a.k + b * a.ks[0] + g * a.ks[2];
  const float* vb = a.v + b * a.vs[0] + g * a.vs[2];
  load_rows<DP, BK, false>(ks, P, kb, a.ks[1], k0, a.S, a.D, 1.0f);
  load_rows<DP, BK, false>(vs, P, vb, a.vs[1], k0, a.S, a.D, 1.0f);

  // the query tiles that hold an unmasked pair: from the diagonal's to
  // the last row inside the window (row - (k0 + BK - 1) < window)
  const int64_t nqt = (a.S + BQ - 1) / BQ;
  int64_t qt_end = nqt;
  if (a.window > 0) {
    const int64_t last = (k0 + BK - 2 + a.window) / BQ + 1;
    if (last < qt_end) qt_end = last;
  }

  float dk[4][NJ], dv[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dk[i][j] = dv[i][j] = 0.0f;

#pragma unroll 1
  for (int e = 0; e < hs; ++e) {
    const int h = g * rep + r * hs + e;
    const float* qb = a.q + b * a.qs[0] + h * a.qs[2];
    const float* gb = a.dout + b * a.gs[0] + h * a.gs[2];
    const int64_t stat0 = (int64_t)(b * a.H + h) * a.S;
#pragma unroll 1
    for (int64_t qt = k0 / BQ; qt < qt_end; ++qt) {
      const int64_t q0 = qt * BQ;
      __syncthreads();  // the last tile's q, dout, p and ds are read
      load_rows<DP, BQ, true>(qs, P, qb, a.qs[1], q0, a.S, a.D, a.qscale);
      load_rows<DP, BQ, false>(gs, P, gb, a.gs[1], q0, a.S, a.D, 1.0f);
      load_stats(lse_s, a.lse + stat0, q0, a.S);
      load_stats(dl_s, a.delta + stat0, q0, a.S);
      __syncthreads();  // q, dout and the stats (and K, V) landed

      // s^T = k . q' and dp^T = v . dout for keys 4 kg + i, rows qg + 16 j
      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.0f;
#pragma unroll 2
      for (int d = 0; d < DP; d += 4) {
        float4 kv[4], vv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kv[i] = *reinterpret_cast<const float4*>(ks + (4 * kg + i) * P + d);
          vv[i] = *reinterpret_cast<const float4*>(vs + (4 * kg + i) * P + d);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 qv =
              *reinterpret_cast<const float4*>(qs + (qg + 16 * j) * P + d);
          const float4 gv =
              *reinterpret_cast<const float4*>(gs + (qg + 16 * j) * P + d);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            s[i][j] = __fmaf_rn(qv.x, kv[i].x, s[i][j]);
            s[i][j] = __fmaf_rn(qv.y, kv[i].y, s[i][j]);
            s[i][j] = __fmaf_rn(qv.z, kv[i].z, s[i][j]);
            s[i][j] = __fmaf_rn(qv.w, kv[i].w, s[i][j]);
            dp[i][j] = __fmaf_rn(gv.x, vv[i].x, dp[i][j]);
            dp[i][j] = __fmaf_rn(gv.y, vv[i].y, dp[i][j]);
            dp[i][j] = __fmaf_rn(gv.z, vv[i].z, dp[i][j]);
            dp[i][j] = __fmaf_rn(gv.w, vv[i].w, dp[i][j]);
          }
        }
      }

      // p and ds, row-major into shared memory: ps[row][4 kg + i]
      const bool whole =
          q0 + BQ <= a.S &&
          whole_tile(q0 - (k0 + BK - 1), q0 + BQ - 1 - k0, a.window);
      const int rel = (int)(q0 - k0);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = qg + 16 * j;
        float p[4], ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int dd = rel + row - (4 * kg + i);         // row - col
          const bool ok = whole ||
                          (q0 + row < a.S && dd >= 0 &&
                           (a.window <= 0 || dd < a.window));
          p_ds(s[i][j], dp[i][j], lse_s[row], dl_s[row], ok, a.softcap, p[i],
               ds[i]);
        }
        *reinterpret_cast<float4*>(ps + row * PS + 4 * kg) =
            make_float4(p[0], p[1], p[2], p[3]);
        *reinterpret_cast<float4*>(dss + row * PS + 4 * kg) =
            make_float4(ds[0], ds[1], ds[2], ds[3]);
      }
      __syncthreads();  // p and ds visible

      // dv += p^T . dout and dk += ds^T . q': keys 4 kg + i, columns
      // out_col(qg, j)
      const int n = (int)(a.S - q0 < BQ ? a.S - q0 : BQ);
#pragma unroll 4
      for (int c = 0; c < n; ++c) {
        const float4 p4 =
            *reinterpret_cast<const float4*>(ps + c * PS + 4 * kg);
        const float4 d4 =
            *reinterpret_cast<const float4*>(dss + c * PS + 4 * kg);
        const float pr[4] = {p4.x, p4.y, p4.z, p4.w};
        const float dr[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
        for (int j = 0; j < NJ; j += 4) {
          const float4 gv = *reinterpret_cast<const float4*>(
              gs + c * P + out_col(qg, j));
          const float4 qv = *reinterpret_cast<const float4*>(
              qs + c * P + out_col(qg, j));
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dv[i][j] = __fmaf_rn(pr[i], gv.x, dv[i][j]);
            dv[i][j + 1] = __fmaf_rn(pr[i], gv.y, dv[i][j + 1]);
            dv[i][j + 2] = __fmaf_rn(pr[i], gv.z, dv[i][j + 2]);
            dv[i][j + 3] = __fmaf_rn(pr[i], gv.w, dv[i][j + 3]);
            dk[i][j] = __fmaf_rn(dr[i], qv.x, dk[i][j]);
            dk[i][j + 1] = __fmaf_rn(dr[i], qv.y, dk[i][j + 1]);
            dk[i][j + 2] = __fmaf_rn(dr[i], qv.z, dk[i][j + 2]);
            dk[i][j + 3] = __fmaf_rn(dr[i], qv.w, dk[i][j + 3]);
          }
        }
      }
    }
  }

  // (ns, B, S, Hk, D) partials, or the gradients themselves when ns == 1
  const int64_t slab = (int64_t)a.B * a.S * a.Hk * a.D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t key = k0 + 4 * kg + i;
    if (key >= a.S) continue;
    const int64_t base = r * slab + ((b * a.S + key) * a.Hk + g) *
                                        (int64_t)a.D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = out_col(qg, j);
      if (d < a.D) {
        a.dk[base + d] = dk[i][j];
        a.dv[base + d] = dv[i][j];
      }
    }
  }
}

// dk = sum of the ns partial slabs in split order, and dv likewise
__global__ void flash_bwd_sum(const float* __restrict__ pk,
                              const float* __restrict__ pv, float* dk,
                              float* dv, int64_t n, int ns) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float sk = pk[i], sv = pv[i];
  for (int r = 1; r < ns; ++r) {
    sk = __fadd_rn(sk, pk[r * n + i]);
    sv = __fadd_rn(sv, pv[r * n + i]);
  }
  dk[i] = sk;
  dv[i] = sv;
}

template <int DP>
int launch(Args a, float* dk, float* dv, cudaStream_t stream) {
  static std::atomic<int> done_dq[SMEM_MAX_DEVICES];
  static std::atomic<int> done_dkv[SMEM_MAX_DEVICES];
  const int smem_dq = (int)(sizeof(float) * dq_smem_floats<DP>());
  const int smem_dkv = (int)(sizeof(float) * dkv_smem_floats<DP>());
  cudaError_t err = allow_smem(flash_bwd_dq<DP>, done_dq, smem_dq);
  if (err != cudaSuccess) return (int)err;
  err = allow_smem(flash_bwd_dkv<DP>, done_dkv, smem_dkv);
  if (err != cudaSuccess) return (int)err;
  const unsigned nt = (unsigned)((a.S + BQ - 1) / BQ);
  flash_bwd_dq<DP><<<dim3((unsigned)(a.B * a.H), nt), THREADS, smem_dq,
                     stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkv<DP><<<dim3((unsigned)(a.B * a.Hk * a.ns), nt), THREADS,
                      smem_dkv, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.ns == 1) return (int)err;
  const int64_t n = (int64_t)a.B * a.S * a.Hk * a.D;
  flash_bwd_sum<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      a.dk, a.dv, dk, dv, n, a.ns);
  return (int)cudaGetLastError();
}

static_assert(sizeof(float) * dq_smem_floats<128>() <= 232448, "dq smem");
static_assert(sizeof(float) * dkv_smem_floats<128>() <= 232448, "dkv smem");

}  // namespace

// q, k, v, o, dout: fp32 device pointers read through the four element
// strides (b, s, head, d) in *_st (unit d stride, 16-byte rows); lse:
// contiguous (B, H, S); delta: (B, H, S) scratch; dq: (B, S, H, D), dk, dv:
// (B, S, Hk, D), all contiguous. ns splits of the rep query heads (ns
// divides H / Hk): with ns > 1, pk and pv are (ns, B, S, Hk, D) scratch for
// the partials, else ignored. D <= 128. Returns the first CUDA error of the
// launches (0 = none).
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, void* pk, void* pv, long long B, long long S, int H, int Hk,
    int D, int ns, const long long* q_st, const long long* k_st,
    const long long* v_st, const long long* o_st, const long long* g_st,
    float qscale, float softcap, int window, void* stream) {
  Args a;
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.o = static_cast<const float*>(o);
  a.dout = static_cast<const float*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<float*>(delta);
  a.dq = static_cast<float*>(dq);
  a.dk = static_cast<float*>(ns > 1 ? pk : dk);
  a.dv = static_cast<float*>(ns > 1 ? pv : dv);
  for (int i = 0; i < 4; ++i) {
    a.qs[i] = q_st[i];
    a.ks[i] = k_st[i];
    a.vs[i] = v_st[i];
    a.os[i] = o_st[i];
    a.gs[i] = g_st[i];
  }
  a.S = S;
  a.B = (int)B;
  a.H = H;
  a.Hk = Hk;
  a.D = D;
  a.ns = ns;
  a.qscale = qscale;
  a.softcap = softcap;
  a.window = window;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* fk = static_cast<float*>(dk);
  float* fv = static_cast<float*>(dv);
  return D <= 64 ? launch<64>(a, fk, fv, st) : launch<128>(a, fk, fv, st);
}
