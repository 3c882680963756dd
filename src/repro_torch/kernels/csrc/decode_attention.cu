// Single-query decode attention over a bf16 KV cache (kernel K5), as
// split-C flash-decoding: two kernels, one partial pass and one merge.
//
// Replaces the TPU kernel repro/kernels/decode_step.py::decode_attention
// (pallas_call at decode_step.py:71, body _attn_kernel ->
// repro/kernels/ref.py::decode_attention_math). Its plain PyTorch version is
// repro_torch/kernels/ref.py::decode_attention_ref. For each cache slot b and
// kv head g, the rep = H / Hk query heads that share g:
//
//   s   = (q * D^-1/2) . k          over D, for every cache position c < C
//   s   = cap * tanh(s / cap)       if softcap
//   s  += bias[b, c]                additive fp32 mask (-1e30 where masked)
//   w   = softmax_C(s)
//   out = sum_C w * v               (B, H, Dv) fp32
//
// q is fp32 (B, H, D); k and v are the bf16 cache (B, C, Hk, D|Dv); bias is
// (B, C) fp32. Head h = g * rep + r.
//
// Design. C is cut into `splits` runs of `split` positions (a multiple of
// the 32-position tile; the last run is ragged and never empty), picked on
// the host (decode_step.py::attention_plan) so that the grid (Hk, B, splits)
// puts about two blocks on every SM of the card.
//
// Pass 1, decode_split: one block of 128 threads per (g, b, split). The
// split's k, v and bias rows stream through a ring of NST shared-memory
// stages of 32 positions with cp.async (16-byte copies of bf16, zero-filled
// past the split's end and past D), so NST - 1 tiles load while one is
// used. NST is 4 for rows of W <= 128 values (66 KB); at W = 256 (gemma3's
// d_head) four stages would take 131.6 KB and only one block would fit on
// an SM where the plan counts two, so the ring has 3 stages there (98.7 KB,
// two blocks an SM). A group of G lanes (a power of two, at least 8, at
// most 32: one warp, so the butterflies stay inside it) takes two positions
// at a time: each lane holds VW consecutive head dims of every query head's
// pre-scaled q in registers (no shared load per FMA), reads its VW k values
// of each position with one 16- or 8-byte shared load, and the group sums
// the rep dot products with G-lane butterflies (every lane gets the same
// bits; the two positions' chains interleave). Each group keeps its own
// online softmax: a running max m and sum l per head and a rep x VW
// accumulator, rescaled only when the max grows (exp(m_old - m_new) with
// m_old = -inf gives 0, so the first position needs no special case); the
// two positions share one update. At the end the block merges its groups
// into the split's partials m, l and acc (rep x Dv, unnormalised): the max
// per head, one weight e^(m_g - m*) per group and head, then the weighted
// sums in group order, written to an fp32 scratch buffer the wrapper
// allocates.
//
// Pass 2, decode_merge: one block per (h, b) merges the splits in a fixed
// order, no atomics, so a result is the same from run to run (the weights
// per split are computed once, in shared memory):
// m* = max_s m_s, out = sum_s e^(m_s - m*) acc_s / sum_s e^(m_s - m*) l_s.
// Every split holds at least one position, so every m_s is finite (a wholly
// masked split has m_s ~ -1e30, whose weight e^(m_s - m*) is +0 because the
// row holds one valid position); no -inf - (-inf) arises in either pass.
//
// The mask, softcap and scaling repeat the plain version's fp32 operations
// in its order (q * D^-1/2 first, then softcap, then + bias); the dots and
// sums run in another order than PyTorch, so the kernel agrees with the
// plain version to rounding, not bitwise.
//
// Bound on an H100: bytes. The work reads q, k, v and bias once and writes
// out: 2,435,072 B at the serve path's shape (B=8, C=576, Hk=2, rep=7,
// D=Dv=64), >= 0.73 us at 3.35 TB/s; 8,501,504 B at the long prompt's
// (B=2, C=8224), >= 2.54 us; 34,144,768 B at gemma3-4b's (B=2, C=4160,
// Hk=4, rep=2, D=256), >= 10.19 us. Both are below a launch's latency: the design
// aims at filling the card and overlapping the loads, not at bandwidth.
#include <atomic>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "smem_once.cuh"

namespace {

constexpr int THREADS = 128;        // pass 1
constexpr int TILE = 32;            // cache positions per stage
constexpr int MERGE_THREADS = 256;  // pass 2
constexpr int MAX_SPLITS = 1024;    // pass 2 keeps a weight per split

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// VW bf16 values at p (16-byte aligned for VW = 8, 8-byte for VW = 4) as fp32
template <int VW>
__device__ __forceinline__ void load_vals(float* o, const __nv_bfloat16* p) {
  if constexpr (VW == 8) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int e = 0; e < 8; ++e) o[e] = __bfloat162float(h[e]);
  } else {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int e = 0; e < 4; ++e) o[e] = __bfloat162float(h[e]);
  }
}

struct Args {
  const float* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const float* bias;
  float* part;     // (B, Hk, splits, rep * Dv + 2 * rep): acc, then m, l
  int64_t C;
  int H, Hk, D, Dv;
  int G, W;        // lanes per position; padded row width in shared memory
  int split, splits;
  float qscale, softcap;
  int vec;         // 16-byte copies: D, Dv % 8 == 0 and aligned k, v
};

// Pass 1. RB: the rep heads rounded up to a power of two (registers per
// lane are sized for it, heads r >= rep are skipped); VW: head dims a lane
// holds; NST: stages in the ring.
template <int RB, int VW, int NST>
__global__ void __launch_bounds__(THREADS, 2) decode_split(const Args a) {
  extern __shared__ float4 smem4[];
  // NST stages of k (TILE x W), then of v, then of the bias (TILE)
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* vs = ks + NST * TILE * a.W;
  float* bs = reinterpret_cast<float*>(vs + NST * TILE * a.W);

  const int g = blockIdx.x;
  const int64_t b = blockIdx.y;
  const int sp = blockIdx.z;
  const int rep = a.H / a.Hk;
  const int t = threadIdx.x;
  const int G = a.G, W = a.W;
  const int lane_g = t & (G - 1), grp = t / G, ngrp = THREADS / G;
  const int d0 = lane_g * VW;
  const int64_t c_begin = (int64_t)sp * a.split;
  const int n = (int)(a.C - c_begin < a.split ? a.C - c_begin : a.split);
  const int ntiles = (n + TILE - 1) / TILE;

  const int64_t krow = (int64_t)a.Hk * a.D, vrow = (int64_t)a.Hk * a.Dv;
  const __nv_bfloat16* kb = a.k + (b * a.C + c_begin) * krow + (int64_t)g * a.D;
  const __nv_bfloat16* vb =
      a.v + (b * a.C + c_begin) * vrow + (int64_t)g * a.Dv;
  const float* bb = a.bias + b * a.C + c_begin;

  // issue the copies of tile `tile` into its stage; rows past n and dims
  // past D (Dv) are zero, past-the-end bias entries are never read
  auto stage = [&](int tile) {
    const int buf = tile % NST, p0 = tile * TILE;
    __nv_bfloat16* kd = ks + buf * TILE * W;
    __nv_bfloat16* vd = vs + buf * TILE * W;
    if (a.vec) {
      const int ch = W / 8;
      for (int i = t; i < TILE * ch; i += THREADS) {
        const int p = i / ch, c = (i % ch) * 8;
        const bool row = p0 + p < n;
        const bool kok = row && c < a.D, vok = row && c < a.Dv;
        cp_async16(kd + p * W + c, kok ? kb + (p0 + p) * krow + c : kb, kok);
        cp_async16(vd + p * W + c, vok ? vb + (p0 + p) * vrow + c : vb, vok);
      }
    } else {
      const __nv_bfloat16 zero = __ushort_as_bfloat16((unsigned short)0);
      for (int i = t; i < TILE * W; i += THREADS) {
        const int p = i / W, c = i % W;
        const bool row = p0 + p < n;
        kd[i] = row && c < a.D ? kb[(p0 + p) * krow + c] : zero;
        vd[i] = row && c < a.Dv ? vb[(p0 + p) * vrow + c] : zero;
      }
    }
    if (t < TILE)
      cp_async4(bs + buf * TILE + t, p0 + t < n ? bb + p0 + t : bb,
                p0 + t < n);
  };

#pragma unroll
  for (int s = 0; s < NST - 1; ++s) {
    if (s < ntiles) stage(s);
    cp_commit();
  }

  // this lane's slice of every head's pre-scaled q; zero past D
  float qr[RB][VW];
  const float* qb = a.q + (b * a.H + (int64_t)g * rep) * a.D;
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int e = 0; e < VW; ++e)
      qr[r][e] = r < rep && d0 + e < a.D
                     ? __fmul_rn(qb[r * a.D + d0 + e], a.qscale)
                     : 0.0f;

  float m[RB], l[RB], acc[RB][VW];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.0f;
#pragma unroll
    for (int e = 0; e < VW; ++e) acc[r][e] = 0.0f;
  }

  for (int it = 0; it < ntiles; ++it) {
    cp_wait<NST - 2>();
    __syncthreads();  // tile `it` landed; every thread is done with it - 1
    if (it + NST - 1 < ntiles) stage(it + NST - 1);
    cp_commit();
    const int buf = it % NST;
    const __nv_bfloat16* kt = ks + buf * TILE * W;
    const __nv_bfloat16* vt = vs + buf * TILE * W;
    const float* bt = bs + buf * TILE;
    // two positions per group and step, p and p + ngrp (2 * ngrp divides
    // TILE: G >= 8), so every lane runs the same trip count and the
    // butterflies see full warps; the two scores of a head share one
    // online-softmax update
    for (int p = grp; p < TILE; p += 2 * ngrp) {
      const int p1 = p + ngrp;
      float k0[VW], k1[VW];
      load_vals<VW>(k0, kt + p * W + d0);
      load_vals<VW>(k1, kt + p1 * W + d0);
      float s0[RB], s1[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        s0[r] = 0.0f;
        s1[r] = 0.0f;
#pragma unroll
        for (int e = 0; e < VW; ++e) {
          s0[r] = __fmaf_rn(qr[r][e], k0[e], s0[r]);
          s1[r] = __fmaf_rn(qr[r][e], k1[e], s1[r]);
        }
      }
      for (int o = 1; o < G; o <<= 1) {
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          if (r < rep) {
            s0[r] = __fadd_rn(s0[r], __shfl_xor_sync(0xffffffffu, s0[r], o));
            s1[r] = __fadd_rn(s1[r], __shfl_xor_sync(0xffffffffu, s1[r], o));
          }
        }
      }
      // positions fill a tile in order: past n, p1 is too (its k, v are
      // zero and its score -inf, so its weight is +0)
      if (it * TILE + p >= n) continue;
      const bool ok1 = it * TILE + p1 < n;
      float v0[VW], v1[VW];
      load_vals<VW>(v0, vt + p * W + d0);
      load_vals<VW>(v1, vt + p1 * W + d0);
      const float b0 = bt[p], b1 = ok1 ? bt[p1] : 0.0f;
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        if (r >= rep) continue;
        float x0 = s0[r], x1 = s1[r];
        if (a.softcap > 0.0f) {
          x0 = __fmul_rn(a.softcap, tanhf(__fdiv_rn(x0, a.softcap)));
          x1 = __fmul_rn(a.softcap, tanhf(__fdiv_rn(x1, a.softcap)));
        }
        x0 = __fadd_rn(x0, b0);
        x1 = ok1 ? __fadd_rn(x1, b1) : -INFINITY;
        const float mx = fmaxf(x0, x1);
        if (mx > m[r]) {
          const float corr = expf(__fsub_rn(m[r], mx));
          l[r] = __fmul_rn(l[r], corr);
#pragma unroll
          for (int e = 0; e < VW; ++e) acc[r][e] = __fmul_rn(acc[r][e], corr);
          m[r] = mx;
        }
        const float w0 = expf(__fsub_rn(x0, m[r]));
        const float w1 = expf(__fsub_rn(x1, m[r]));
        l[r] = __fadd_rn(__fadd_rn(l[r], w0), w1);
#pragma unroll
        for (int e = 0; e < VW; ++e)
          acc[r][e] = __fmaf_rn(w1, v1[e], __fmaf_rn(w0, v0[e], acc[r][e]));
      }
    }
  }
  cp_wait<0>();
  __syncthreads();  // the stages are free: the merge area reuses them

  // the groups' partials, merged in group order into the split's partials:
  // the max per head, then each group's weight e^(m_g - m*) once (a group
  // that saw no position has m = -inf and weight +0), then the weighted
  // sums
  float* mg = reinterpret_cast<float*>(smem4);  // ngrp x RB
  float* lg = mg + ngrp * RB;                   // ngrp x RB
  float* wg = lg + ngrp * RB;                   // ngrp x RB
  float* ms = wg + ngrp * RB;                   // RB
  float* ag = ms + RB;                          // ngrp x RB x W
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    if (r >= rep) continue;
    if (lane_g == 0) {
      mg[grp * RB + r] = m[r];
      lg[grp * RB + r] = l[r];
    }
#pragma unroll
    for (int e = 0; e < VW; ++e) ag[(grp * RB + r) * W + d0 + e] = acc[r][e];
  }
  __syncthreads();
  if (t < rep) {
    float mx = -INFINITY;
#pragma unroll 4
    for (int j = 0; j < ngrp; ++j) mx = fmaxf(mx, mg[j * RB + t]);
    ms[t] = mx;
  }
  __syncthreads();
  for (int i = t; i < ngrp * rep; i += THREADS) {
    const int j = i / rep, r = i % rep;
    wg[j * RB + r] = expf(__fsub_rn(mg[j * RB + r], ms[r]));
  }
  __syncthreads();
  const int stride = rep * a.Dv + 2 * rep;
  float* out = a.part + ((b * a.Hk + g) * a.splits + sp) * (int64_t)stride;
  for (int o = t; o < rep * a.Dv; o += THREADS) {
    const int r = o / a.Dv, d = o % a.Dv;
    float sum = 0.0f;
#pragma unroll 4
    for (int j = 0; j < ngrp; ++j)
      sum = __fmaf_rn(wg[j * RB + r], ag[(j * RB + r) * W + d], sum);
    out[o] = sum;
  }
  if (t < rep) {
    float lsum = 0.0f;
#pragma unroll 4
    for (int j = 0; j < ngrp; ++j)
      lsum = __fmaf_rn(wg[j * RB + t], lg[j * RB + t], lsum);
    out[rep * a.Dv + t] = ms[t];
    out[rep * a.Dv + rep + t] = lsum;
  }
}

// Pass 2: block (h, b). The splits' maxima and weights go through shared
// memory once; thread (j, d) then sums splits j, j + J, ... for output
// column d and the J partial sums are added in order j = 0, 1, ...; the
// weights' sum over the splits is warp 0's, lane-strided then a butterfly.
__global__ void __launch_bounds__(MERGE_THREADS)
    decode_merge(const float* __restrict__ part, float* __restrict__ out,
                 int H, int Hk, int Dv, int splits) {
  __shared__ float sw[MAX_SPLITS], sa[MERGE_THREADS];
  __shared__ float mstar, lsum;
  const int h = blockIdx.x;
  const int64_t b = blockIdx.y;
  const int rep = H / Hk, g = h / rep, r = h % rep;
  const int J = MERGE_THREADS / Dv;
  const int t = threadIdx.x, d = t % Dv, j = t / Dv;
  const int stride = rep * Dv + 2 * rep;
  const float* base = part + (b * Hk + g) * (int64_t)splits * stride;
  const int mo = rep * Dv + r, lo = rep * Dv + rep + r;

  for (int s = t; s < splits; s += MERGE_THREADS) sw[s] = base[s * stride + mo];
  __syncthreads();
  if (t < 32) {
    float mx = -INFINITY;
    for (int s = t; s < splits; s += 32) mx = fmaxf(mx, sw[s]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    if (t == 0) mstar = mx;
  }
  __syncthreads();
  // every m_s is finite (a split holds at least one position)
  for (int s = t; s < splits; s += MERGE_THREADS)
    sw[s] = expf(__fsub_rn(sw[s], mstar));
  __syncthreads();
  if (t < 32) {
    float x = 0.0f;
    for (int s = t; s < splits; s += 32)
      x = __fmaf_rn(sw[s], base[s * stride + lo], x);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, o));
    if (t == 0) lsum = x;  // >= 1: the split holding m* has l >= 1
  }
  if (j < J) {
    float acc = 0.0f;
#pragma unroll 4
    for (int s = j; s < splits; s += J)
      acc = __fmaf_rn(sw[s], base[(int64_t)s * stride + r * Dv + d], acc);
    sa[j * Dv + d] = acc;
  }
  __syncthreads();
  if (t < Dv) {
    float A = 0.0f;
    for (int i = 0; i < J; ++i) A = __fadd_rn(A, sa[i * Dv + t]);
    out[(b * H + h) * (int64_t)Dv + t] = __fdiv_rn(A, lsum);
  }
}

template <int RB, int NST>
size_t split_smem(const Args& a) {
  const size_t stages = 2 * sizeof(__nv_bfloat16) * NST * TILE * a.W +
                        sizeof(float) * NST * TILE;
  const size_t ngrp = THREADS / a.G;
  const size_t merge = sizeof(float) * (RB * ngrp * (3 + a.W) + RB);
  return stages > merge ? stages : merge;
}

template <int RB, int VW, int NST>
int launch_split(const Args& a, long long B, cudaStream_t stream) {
  static std::atomic<int> done[SMEM_MAX_DEVICES];
  const size_t smem = split_smem<RB, NST>(a);
  cudaError_t err = allow_smem(decode_split<RB, VW, NST>, done, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)a.Hk, (unsigned)B, (unsigned)a.splits);
  decode_split<RB, VW, NST><<<grid, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// G: the lanes a position needs for max(D, Dv), one warp at most (the
// wrapper's contract: max(D, Dv) <= 32 VW)
template <int RB, int VW>
int launch(Args a, long long B, cudaStream_t stream) {
  const int dmax = a.D > a.Dv ? a.D : a.Dv;
  int G = 8;
  while (G * VW < dmax) G <<= 1;
  if (G > 32) return (int)cudaErrorInvalidValue;
  a.G = G;
  a.W = G * VW;
  return a.W > 128 ? launch_split<RB, VW, 3>(a, B, stream)
                   : launch_split<RB, VW, 4>(a, B, stream);
}

}  // namespace

// part: fp32 scratch of B * Hk * splits * (rep * Dv + 2 * rep) floats; out:
// (B, H, Dv) fp32. split: positions per split (a multiple of 32), splits =
// ceil(C / split) <= 1024. vec != 0: D % 8 == 0, Dv % 8 == 0 and 16-byte
// aligned k and v. Two launches (pass 1, then the merge) on `stream`;
// returns the first CUDA error (0 = none).
extern "C" int decode_attention_f32(const void* q, const void* k,
                                    const void* v, const void* bias,
                                    void* part, void* out, long long B,
                                    long long C, int H, int Hk, int D, int Dv,
                                    int split, int splits, float qscale,
                                    float softcap, int vec, void* stream) {
  Args a;
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.bias = static_cast<const float*>(bias);
  a.part = static_cast<float*>(part);
  a.C = C;
  a.H = H;
  a.Hk = Hk;
  a.D = D;
  a.Dv = Dv;
  a.G = a.W = 0;
  a.split = split;
  a.splits = splits;
  a.qscale = qscale;
  a.softcap = softcap;
  a.vec = vec;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (splits < 1 || splits > MAX_SPLITS) return (int)cudaErrorInvalidValue;
  const int rep = H / Hk;
  int err;
  if (rep <= 1)
    err = launch<1, 8>(a, B, st);
  else if (rep <= 2)
    err = launch<2, 8>(a, B, st);
  else if (rep <= 4)
    err = launch<4, 8>(a, B, st);
  else if (rep <= 8)
    err = launch<8, 8>(a, B, st);
  else
    err = launch<16, 4>(a, B, st);
  if (err != 0) return err;
  dim3 grid2((unsigned)H, (unsigned)B);
  decode_merge<<<grid2, MERGE_THREADS, 0, st>>>(
      static_cast<const float*>(part), static_cast<float*>(out), H, Hk, Dv,
      splits);
  return (int)cudaGetLastError();
}
