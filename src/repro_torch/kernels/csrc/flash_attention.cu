// Causal blockwise flash attention, forward (kernel K4).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::
// flash_attention_bhsd (pallas_call at flash_attention.py:91, body _kernel
// at :27). Its plain PyTorch version is
// repro_torch/kernels/ref.py::flash_attention_ref. For batch b, query head h
// (kv head g = h / rep, rep = H / Hk) and query row r:
//
//   s_c = (q_r * D^-1/2) . k_c                 for every key c <= r
//   s_c = cap * tanh(s_c / cap)                if softcap
//   s_c = -1e30 where c > r, or r - c >= window when window > 0
//   out_r = sum_c softmax(s)_c * v_c           in q's dtype
//
// q is read as (B, S, H, D) and k, v as (B, S, Hk, D) through their strides
// (the port's projection layout: no transpose, no repeated KV); out is
// (B, S, H, D) contiguous. Inputs are fp32 or bf16; all arithmetic is fp32.
//
// Design: one block per (b, h, 64-row query tile); the heaviest tiles (last
// rows, the most keys) are launched first. The block keeps its query tile
// (pre-scaled) in shared memory and walks the key tiles that hold an
// unmasked pair, with the online softmax of the TPU kernel: running max m
// (from -1e30) and sum l per row, corr = exp(m_old - m_new), l = l * corr +
// sum p, acc = acc * corr + p . v, out = acc / max(l, 1e-30). Key tiles
// above the diagonal or wholly beyond the window are skipped, not computed
// and masked. Thread t owns rows t / CG + 16 i (i < 4; rows 16 apart, so
// the row groups of a warp read q without bank conflicts); the CG threads
// of a row hold its score columns t % CG + CG j and a CG-th of its output
// columns, and reduce the row's max and sum with shuffles. The score tile
// stays in registers; the weights go through shared memory (transposed)
// for the p . v product. The head dim is padded to DP in {32, 64, 128,
// 256} with zeros (which add nothing to a dot), so any D <= 256 works, and
// rows past S are loaded as zeros: a key past S is also past every real
// row, so the causal mask hides it. Masked scores are -1e30, not -inf, as
// in the TPU kernel: a row whose first tile is all masked is rescaled by
// exp(-1e30 - m) = +0 once it meets a real score, and every real row meets
// one (its own key) in the tile that holds its diagonal.
//
// Two tilings (struct Tile):
// * DP <= 128: 128 threads, CG = 8 threads a row, 64-key tiles (8 score
//   columns a thread), DP / 8 <= 16 output columns a thread for 4 rows.
// * DP = 256 (gemma3's d_head; a D of 129-256 pads to it): the 128-thread
//   tiling would hold 32 output columns x 4 rows = 128 accumulators beside
//   32 scores a thread, and Q + 2 K + V at 64 keys is 265 KB of shared
//   memory, over the 227 KB a block may have. So CG = 16 (256 threads, 16
//   output columns x 4 rows = 64 accumulators, 2 score columns a thread)
//   and 32-key tiles: Q 64 x 260 + 2 K 32 x 260 + V 32 x 256 floats is
//   162 KB, one block (8 warps) an SM. The query tile stays 64 rows and the
//   pipeline, masks and tile skipping are the same code; a 64-row query
//   tile spans two key tiles on the diagonal. Registers and spill:
//   chip_smoke.py prints ptxas's line for every instance.
//
// Pipeline (the Hopper redesign). fp32 inputs with 16-byte rows stream in
// with cp.async: the next key tile loads into the second of two K buffers
// while the current tile's scores and p . v run, and the value tile loads
// while the next tile's scores run. The transposed weights reuse the
// current K buffer once every thread has read it, so the shared memory is
// Q + 2 K + V (68.6 KB at DP = 64) and three blocks (12 warps) fit on an
// SM at DP <= 64; __launch_bounds__(128, 3) holds the registers to 168 a
// thread (the kernel before this pipeline took 255, and 2 blocks). The
// accumulator is rescaled
// before p . v adds into it, so no second (rows x columns) array of
// partial sums is live. Masks are computed in 32-bit row - column offsets,
// and only for tiles that reach the diagonal or the window's edge. bf16
// inputs and views without 16-byte rows take the same
// pipeline with synchronous loads (converted to fp32 on the way).
//
// Two instances of the tilings (template flag LSE). Serving's writes out
// alone. Training's (fp32, DP <= 128: what K4b takes) also writes each
// row's log-sum-exp m + log(l), fp32 (B, H, S), the one residual that the
// backward (K4b, flash_attention_bwd.cu) needs beside q, k, v and out;
// every other instruction is the same, so both give the same bits of out.
//
// The dots are chains of explicit fmaf in d (and in c for p . v), and the
// row sums are butterfly shuffles, so the kernel sums in another order than
// PyTorch: it agrees with the plain version to rounding, not bitwise.
// (The build's -fmad=false keeps K1 and K3 bitwise; the intrinsics here are
// not affected by it.)
//
// Bound on an H100: operations. At the long-prompt prefill's shape (B=2,
// H=14, Hk=2, S=8192, D=64, fp32) the causal pairs B*H*S*(S+1)/2 = 939.6 M
// cost 4 * D = 256 flops each (the two dots), 240.5 GFLOP, >= 3.59 ms at the
// 67 TFLOP/s of fp32 outside the tensor cores; q, k, v and out are 134 MB,
// 0.04 ms at 3.35 TB/s. At gemma3-4b's prefill (B=2, H=8, Hk=4, S=4096,
// D=256) a global layer's 137.5 GFLOP take >= 2.05 ms, a layer with the
// 1024 window's 60.1 GFLOP >= 0.90 ms. This kernel runs on the CUDA cores in fp32 (the
// port keeps TF32 off); 3xTF32 on the tensor cores (mma/wgmma), which
// changes both the bound and the tolerance argument, is its next step.
#include <atomic>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "smem_once.cuh"

namespace {

constexpr int LPASS = 4;         // 16-byte loads in flight per thread
constexpr float NEG = -1e30f;

// The tiling of the DP instance (see the header).
template <int DP>
struct Tile {
  static constexpr bool WIDE = DP > 128;
  static constexpr int BQ = 64;                // query rows per block
  static constexpr int BK = WIDE ? 32 : 64;    // keys per tile
  static constexpr int RPT = 4;                // query rows per thread
  static constexpr int RSTEP = BQ / RPT;       // distance between its rows
  static constexpr int CG = WIDE ? 16 : 8;     // threads sharing a row
  static constexpr int THREADS = BQ / RPT * CG;
  static constexpr int CPT = BK / CG;          // score columns per thread
  static constexpr int OPT = DP / CG;          // output columns per thread
  static constexpr int PT = BQ + 4;            // pitch of the weights^T
  static constexpr int MINB = DP <= 64 ? 3 : 1;  // blocks an SM
  static_assert(THREADS / CG * RPT == BQ, "thread layout must cover BQ");
  static_assert(RPT == 4, "a thread's rows are one float4 of the weights");
  static_assert(OPT % 4 == 0 && CPT >= 1, "float4 output groups");
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f(float* o, float x) { *o = x; }
__device__ __forceinline__ void from_f(__nv_bfloat16* o, float x) {
  *o = __float2bfloat16_rn(x);
}

template <int CG>
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = 1; o < CG; o <<= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <int CG>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = 1; o < CG; o <<= 1)
    x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Copy rows [row0, row0 + ROWS) of one head to dst[r * pitch + d] as fp32
// (times qscale when SCALE), zeros past S and for d in [D, DP). vec: unit
// d stride, 16-byte aligned rows and D a multiple of the 16-byte width, so
// one load moves W values; LPASS loads per thread are issued before the
// first is stored.
template <typename T, int DP, int ROWS, bool SCALE>
__device__ __forceinline__ void load_rows(float* dst, int pitch,
                                          const T* __restrict__ src,
                                          int64_t rs, int64_t ds, int64_t row0,
                                          int64_t S, int D, float qscale,
                                          bool vec) {
  constexpr int THREADS = Tile<DP>::THREADS;
  constexpr int W = 16 / sizeof(T);
  constexpr int CH = DP / W;             // chunks per row
  constexpr int TOT = ROWS * CH;
  if (vec) {
#pragma unroll 1
    for (int base = 0; base < TOT; base += LPASS * THREADS) {
      uint4 raw[LPASS];
#pragma unroll
      for (int j = 0; j < LPASS; ++j) {
        const int i = base + threadIdx.x + j * THREADS;
        const int r = i / CH, c = (i % CH) * W;
        raw[j] = make_uint4(0u, 0u, 0u, 0u);
        if (i < TOT && row0 + r < S && c < D)
          raw[j] = __ldg(reinterpret_cast<const uint4*>(src + (row0 + r) * rs +
                                                        c));
      }
#pragma unroll
      for (int j = 0; j < LPASS; ++j) {
        const int i = base + threadIdx.x + j * THREADS;
        if (i >= TOT) continue;
        const int r = i / CH, c = (i % CH) * W;
        const T* e = reinterpret_cast<const T*>(&raw[j]);
#pragma unroll
        for (int w = 0; w < W; ++w) {
          const float x = to_f(e[w]);
          dst[r * pitch + c + w] = SCALE ? __fmul_rn(x, qscale) : x;
        }
      }
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * DP; i += THREADS) {
      const int r = i / DP, d = i % DP;
      float x = 0.0f;
      if (row0 + r < S && d < D) {
        x = to_f(src[(row0 + r) * rs + d * ds]);
        if (SCALE) x = __fmul_rn(x, qscale);
      }
      dst[r * pitch + d] = x;
    }
  }
}

// The same rows of an fp32 head with 16-byte rows (vec), by cp.async: the
// copies complete at the next cp.async.wait_group that covers them.
template <int DP>
__device__ __forceinline__ void copy_rows_async(float* dst, int pitch,
                                                const float* __restrict__ src,
                                                int64_t rs, int64_t row0,
                                                int64_t S, int D) {
  constexpr int BK = Tile<DP>::BK, THREADS = Tile<DP>::THREADS;
  constexpr int CH = DP / 4;
  static_assert(BK * CH % THREADS == 0, "whole passes of the block");
#pragma unroll
  for (int j = 0; j < BK * CH / THREADS; ++j) {
    const int i = threadIdx.x + j * THREADS;
    const int r = i / CH, c = (i % CH) * 4;
    const bool ok = row0 + r < S && c < D;
    cp_async16(dst + r * pitch + c, ok ? src + (row0 + r) * rs + c : src, ok);
  }
}

// Output column of a thread's j-th accumulator: groups of 4 consecutive
// columns, the CG threads of a row side by side, so that one float4 load
// of v per group covers 16 CG contiguous bytes across them.
template <int CG>
__device__ __forceinline__ int out_col(int cg, int j) {
  return (j / 4) * (CG * 4) + cg * 4 + j % 4;
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int64_t qs[4], ks[4], vs[4];  // element strides of b, s, head, d
  int64_t S;
  int H, Hk, D;
  float qscale, softcap;
  int window;                   // 0 = no window
  int vec;
  float* lse;                   // (B, H, S) fp32, written where LSE
};

// floats of one K buffer: a key tile, or the transposed weights after it
template <int DP>
__host__ __device__ constexpr int kbuf_floats() {
  return Tile<DP>::BK *
         ((DP + 4) > Tile<DP>::PT ? (DP + 4) : Tile<DP>::PT);
}

template <typename T, int DP, bool LSE>
__global__ void __launch_bounds__(Tile<DP>::THREADS, Tile<DP>::MINB)
    flash_attention_kernel(const Args a) {
  using TL = Tile<DP>;
  constexpr int BQ = TL::BQ, BK = TL::BK, RPT = TL::RPT, RSTEP = TL::RSTEP;
  constexpr int CG = TL::CG, CPT = TL::CPT, OPT = TL::OPT, PT = TL::PT;
  constexpr int P = DP + 4;      // q/k tile pitch: 16-byte rows, odd banks
  constexpr int KB = kbuf_floats<DP>();
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* qs = smem;              // BQ x P, pre-scaled
  float* kbuf = qs + BQ * P;     // 2 x KB: key tiles / weights transposed
  float* vs = kbuf + 2 * KB;     // BK x DP

  const int t = threadIdx.x, cg = t % CG, rg = t / CG;
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int g = h / (a.H / a.Hk);
  const int64_t q0 = (int64_t)(gridDim.y - 1 - blockIdx.y) * BQ;
  const T* qb = static_cast<const T*>(a.q) + b * a.qs[0] + h * a.qs[2];
  const T* kb = static_cast<const T*>(a.k) + b * a.ks[0] + g * a.ks[2];
  const T* vb = static_cast<const T*>(a.v) + b * a.vs[0] + g * a.vs[2];
  const bool vec = a.vec != 0;
  const bool async = sizeof(T) == 4 && vec;

  auto stage_k = [&](int64_t k0, float* dst) {
    if (async)
      copy_rows_async<DP>(dst, P, reinterpret_cast<const float*>(kb),
                          a.ks[1], k0, a.S, a.D);
    else
      load_rows<T, DP, BK, false>(dst, P, kb, a.ks[1], a.ks[3], k0, a.S,
                                  a.D, 1.0f, vec);
  };
  auto stage_v = [&](int64_t k0) {
    if (async)
      copy_rows_async<DP>(vs, DP, reinterpret_cast<const float*>(vb),
                          a.vs[1], k0, a.S, a.D);
    else
      load_rows<T, DP, BK, false>(vs, DP, vb, a.vs[1], a.vs[3], k0, a.S,
                                  a.D, 1.0f, vec);
  };

  // the key tiles that hold an unmasked pair: from the first not wholly
  // beyond the window (q0 - (k0 + BK - 1) < window) to the one holding the
  // last row's diagonal (q0's own tile where BQ == BK); with BK < BQ that
  // tile may start past S (a short last query tile), so none past S
  int64_t kt_begin = 0;
  if (a.window > 0) {
    const int64_t lo = q0 - a.window - BK + 2;
    if (lo > 0) kt_begin = (lo + BK - 1) / BK;
  }
  int64_t kt_end = q0 / BK + 1;
  if (BK < BQ) {
    const int64_t kt_s = (a.S + BK - 1) / BK;
    kt_end = (q0 + BQ - 1) / BK + 1;
    if (kt_s < kt_end) kt_end = kt_s;
  }

  // cp.async groups, in order: K[kt_begin], V[kt_begin], then per tile
  // K[kt + 1] after the tile's first barrier and V[kt + 1] at its end (an
  // empty group where there is none), so "wait_group 1" always means "all
  // but the newest group": the tile's K at the first wait, its V at the
  // second
  stage_k(kt_begin * BK, kbuf);
  cp_commit();
  stage_v(kt_begin * BK);
  cp_commit();
  load_rows<T, DP, BQ, true>(qs, P, qb, a.qs[1], a.qs[3], q0, a.S, a.D,
                             a.qscale, vec);

  float m[RPT], l[RPT], acc[RPT][OPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < OPT; ++j) acc[i][j] = 0.0f;
  }

#pragma unroll 1
  for (int64_t kt = kt_begin; kt < kt_end; ++kt) {
    const int64_t k0 = kt * BK;
    float* ks = kbuf + ((kt - kt_begin) & 1) * KB;
    float* kn = kbuf + ((kt - kt_begin + 1) & 1) * KB;
    cp_wait1();
    __syncthreads();  // K[kt] (and q) landed; the last p . v is done
    if (kt + 1 < kt_end) stage_k(k0 + BK, kn);
    cp_commit();

    // scores: s[i][j] = q'[row i] . k[col j], one fmaf chain over d
    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.0f;
#pragma unroll 1
    for (int d = 0; d < DP; d += 4) {
      float4 qv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        qv[i] =
            *reinterpret_cast<const float4*>(qs + (rg + RSTEP * i) * P + d);
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float4 kv =
            *reinterpret_cast<const float4*>(ks + (cg + CG * j) * P + d);
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          s[i][j] = __fmaf_rn(qv[i].x, kv.x, s[i][j]);
          s[i][j] = __fmaf_rn(qv[i].y, kv.y, s[i][j]);
          s[i][j] = __fmaf_rn(qv[i].z, kv.z, s[i][j]);
          s[i][j] = __fmaf_rn(qv[i].w, kv.w, s[i][j]);
        }
      }
    }

    // softcap, mask, online softmax; the accumulator is rescaled now. A
    // tile wholly below the diagonal and inside the window needs no mask.
    const bool whole = k0 + BK - 1 <= q0 &&
                       (a.window <= 0 || q0 + BQ - 1 - k0 < (int64_t)a.window);
    const int rel = (int)(q0 - k0);   // row - col = rel + (row, col) offsets
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int ri = rel + rg + RSTEP * i;
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int dd = ri - (cg + CG * j);   // row - col
        float x = s[i][j];
        if (a.softcap > 0.0f)
          x = __fmul_rn(a.softcap, tanhf(__fdiv_rn(x, a.softcap)));
        const bool ok = whole || (dd >= 0 && (a.window <= 0 || dd < a.window));
        s[i][j] = ok ? x : NEG;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max<CG>(mx));
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        s[i][j] = expf(__fsub_rn(s[i][j], m_new));
        sum = __fadd_rn(sum, s[i][j]);
      }
      const float corr = expf(__fsub_rn(m[i], m_new));
      l[i] = __fadd_rn(__fmul_rn(l[i], corr), group_sum<CG>(sum));
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < OPT; ++j) acc[i][j] = __fmul_rn(acc[i][j], corr);
    }
    __syncthreads();  // every thread is done reading K[kt]
    // the weights, transposed, into K[kt]'s buffer: pt[col][4 * rg + i]
    float* pt = ks;
#pragma unroll
    for (int j = 0; j < CPT; ++j)
      *reinterpret_cast<float4*>(pt + (cg + CG * j) * PT + rg * RPT) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    cp_wait1();
    __syncthreads();  // V[kt] landed; the weights are visible

    // acc += sum_c p[row][c] * v[c][col], one chain over c
    const int n = (int)(a.S - k0 < BK ? a.S - k0 : BK);
#pragma unroll 4
    for (int c = 0; c < n; ++c) {
      const float4 p =
          *reinterpret_cast<const float4*>(pt + c * PT + rg * RPT);
      const float pr[RPT] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int j = 0; j < OPT; j += 4) {
        const float4 vv = *reinterpret_cast<const float4*>(
            vs + c * DP + out_col<CG>(cg, j));
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          acc[i][j] = __fmaf_rn(pr[i], vv.x, acc[i][j]);
          acc[i][j + 1] = __fmaf_rn(pr[i], vv.y, acc[i][j + 1]);
          acc[i][j + 2] = __fmaf_rn(pr[i], vv.z, acc[i][j + 2]);
          acc[i][j + 3] = __fmaf_rn(pr[i], vv.w, acc[i][j + 3]);
        }
      }
    }
    __syncthreads();  // every thread is done with V[kt] and the weights
    if (kt + 1 < kt_end) stage_v(k0 + BK);
    cp_commit();
  }

  T* ob = static_cast<T*>(a.o);
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int64_t row = q0 + rg + RSTEP * i;
    if (row >= a.S) continue;
    const float den = fmaxf(l[i], 1e-30f);
    if constexpr (LSE)   // the training instance: the row's log-sum-exp
      if (cg == 0)
        a.lse[(int64_t)(b * a.H + h) * a.S + row] =
            __fadd_rn(m[i], logf(l[i]));
    T* orow = ob + ((b * a.S + row) * a.H + h) * (int64_t)a.D;
#pragma unroll
    for (int j = 0; j < OPT; ++j) {
      const int d = out_col<CG>(cg, j);
      if (d < a.D) from_f(orow + d, __fdiv_rn(acc[i][j], den));
    }
  }
}

template <int DP>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)Tile<DP>::BQ * (DP + 4) +
                          2 * (size_t)kbuf_floats<DP>() +
                          (size_t)Tile<DP>::BK * DP);
}
static_assert(smem_bytes<256>() <= 232448, "a block's shared memory");

template <typename T, int DP, bool LSE>
int launch(const Args& a, int64_t B, cudaStream_t stream) {
  static std::atomic<int> done[SMEM_MAX_DEVICES];
  const size_t smem = smem_bytes<DP>();
  cudaError_t err =
      allow_smem(flash_attention_kernel<T, DP, LSE>, done, (int)smem);
  if (err != cudaSuccess) return (int)err;
  constexpr int BQ = Tile<DP>::BQ;
  dim3 grid((unsigned)(B * a.H), (unsigned)((a.S + BQ - 1) / BQ));
  flash_attention_kernel<T, DP, LSE>
      <<<grid, Tile<DP>::THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, bool LSE>
int dispatch(const Args& a, int64_t B, cudaStream_t stream) {
  if (a.D <= 32) return launch<T, 32, LSE>(a, B, stream);
  if (a.D <= 64) return launch<T, 64, LSE>(a, B, stream);
  if (a.D <= 128) return launch<T, 128, LSE>(a, B, stream);
  if constexpr (LSE)   // the training instance takes what K4b takes
    return (int)cudaErrorInvalidValue;
  else
    return launch<T, 256, LSE>(a, B, stream);
}

}  // namespace

// q, k, v, o: device pointers; *_st: the four element strides (b, s, head,
// d) of q, k and v; o is (B, S, H, D) contiguous in the inputs' type.
// bf16 != 0: __nv_bfloat16 inputs and output, else fp32. D <= 256. lse:
// null (the serving instance), or a contiguous fp32 (B, H, S) buffer that
// the training instance fills with each row's log-sum-exp m + log(l); that
// instance takes fp32 with D <= 128 (K4b's inputs) and refuses the rest.
// Returns the CUDA error of the launch (0 = none).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, long long B, long long S, int H,
                                   int Hk, int D, const long long* q_st,
                                   const long long* k_st,
                                   const long long* v_st, float qscale,
                                   float softcap, int window, int bf16,
                                   int vec, void* lse, void* stream) {
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  for (int i = 0; i < 4; ++i) {
    a.qs[i] = q_st[i];
    a.ks[i] = k_st[i];
    a.vs[i] = v_st[i];
  }
  a.S = S;
  a.H = H;
  a.Hk = Hk;
  a.D = D;
  a.qscale = qscale;
  a.softcap = softcap;
  a.window = window;
  a.vec = vec;
  a.lse = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (lse)
    return bf16 ? (int)cudaErrorInvalidValue : dispatch<float, true>(a, B, st);
  return bf16 ? dispatch<__nv_bfloat16, false>(a, B, st)
              : dispatch<float, false>(a, B, st);
}
