// Fused unembed + argmax sampling over the vocabulary (kernel K6).
//
// Replaces the TPU kernel repro/kernels/decode_step.py::decode_sample
// (pallas_call at decode_step.py:133, body _sample_kernel ->
// repro/kernels/ref.py::decode_sample_math). Its plain PyTorch version is
// repro_torch/kernels/ref.py::decode_sample_ref. For each row b of y:
//
//   id[b] = argmax_{v < v_real} (sum_d y[b,d] * table[v,d]) * scale
//                               + noise[b,v]
//
// with the first index winning ties. y is (B, d) fp32, table (V, d) fp32,
// noise (B, V) fp32 (zeros = greedy, Gumbel draws = sampling). The (B, V)
// logits are never written to device memory.
//
// Bound on an H100: bytes. The table dominates: at the serve path's shape
// (B=8, V=153,600, v_real=151,936, d=896) its 151,936 real rows are 544.5 MB,
// >= 0.163 ms at 3.35 TB/s per launch (one launch per decode step). The
// multiply-adds (B * v_real * d = 1.09 G) take ~33 us at the fp32 rate, so
// the kernel must read each table row once for all B rows of y.
//
// Design. Pass 1: blocks of 8 warps own contiguous vocabulary ranges, and
// each warp a contiguous part of its block's range. y is staged in shared
// memory once per block (B * d * 4 bytes, 28 KB at B=8). A warp reads one
// table row with 16-byte loads into registers (lane i holds float4s i,
// i+32, ...) and, for each b, sums y[b] . row with fmaf in a fixed order and
// a butterfly warp reduction. Every row's logit therefore comes out of the
// same reduction order wherever the row falls in the grid, so two identical
// rows give identical logits. The logit is then (acc * scale) + noise, two
// roundings as in the plain version (the file is built with -fmad=false).
// Rows >= v_real are not read: the id v_real stands for all of them with the
// logit -1e30 the plain version gives them. Lane b % 32 keeps row b's
// running best of its warp (strict >, rows in increasing order); the warps'
// bests meet in shared memory and each block writes one (best, id) pair per
// b to a scratch buffer. Pass 2: one block per b reduces the pairs. Both
// reductions order candidates by (value descending, id ascending), which
// gives the plain version's blockwise strict-> walk result whatever order
// the blocks ran in: the first index of the largest logit.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BMAX = 64;           // rows of y
constexpr int BSLOT = BMAX / 32;   // running bests per lane

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

template <int NV>  // float4s per lane: d <= 128 * NV
__global__ void __launch_bounds__(THREADS)
    decode_sample_blocks(const float* __restrict__ y,
                         const float* __restrict__ table,
                         const float* __restrict__ noise,
                         float* __restrict__ part_val,
                         int* __restrict__ part_arg, int B, int d, int64_t V,
                         int64_t v_real, int64_t rows_per_block, float scale) {
  extern __shared__ float4 smem4[];
  float* ys = reinterpret_cast<float*>(smem4);       // B x d
  float* wval = ys + (size_t)B * d;                  // WARPS x B
  int* warg = reinterpret_cast<int*>(wval + WARPS * B);
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  for (int i = t; i < B * d; i += THREADS) ys[i] = y[i];
  __syncthreads();

  const int d4 = d / 4;
  const int64_t lo = (int64_t)blockIdx.x * rows_per_block;
  const int64_t hi = lo + rows_per_block < v_real ? lo + rows_per_block
                                                  : v_real;
  const int64_t per_warp = (rows_per_block + WARPS - 1) / WARPS;
  const int64_t wlo = lo + warp * per_warp;
  const int64_t whi = wlo + per_warp < hi ? wlo + per_warp : hi;

  float best[BSLOT];
  int arg[BSLOT];
#pragma unroll
  for (int s = 0; s < BSLOT; ++s) {
    best[s] = -INFINITY;
    arg[s] = INT_MAX;
  }
  const float4* ys4 = reinterpret_cast<const float4*>(ys);
  for (int64_t v = wlo; v < whi; ++v) {
    const float4* row = reinterpret_cast<const float4*>(table + v * d);
    float4 tv[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int idx = lane + 32 * i;
      tv[i] = idx < d4 ? __ldg(row + idx) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    for (int bb = 0; bb < B; ++bb) {
      const float4* yb = ys4 + (size_t)bb * d4;
      float acc = 0.0f;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int idx = lane + 32 * i;
        if (idx < d4) {
          const float4 a = yb[idx];
          acc = __fmaf_rn(a.x, tv[i].x, acc);
          acc = __fmaf_rn(a.y, tv[i].y, acc);
          acc = __fmaf_rn(a.z, tv[i].z, acc);
          acc = __fmaf_rn(a.w, tv[i].w, acc);
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, o));
      if (lane == (bb & 31)) {
        const float logit =
            __fadd_rn(__fmul_rn(acc, scale), noise[(int64_t)bb * V + v]);
#pragma unroll
        for (int s = 0; s < BSLOT; ++s) {
          if (s == (bb >> 5) && logit > best[s]) {
            best[s] = logit;
            arg[s] = (int)v;
          }
        }
      }
    }
  }
  for (int bb = lane; bb < B; bb += 32) {
#pragma unroll
    for (int s = 0; s < BSLOT; ++s) {
      if (s == (bb >> 5)) {
        wval[warp * B + bb] = best[s];
        warg[warp * B + bb] = arg[s];
      }
    }
  }
  __syncthreads();
  for (int bb = t; bb < B; bb += THREADS) {
    float bv = -INFINITY;
    int bi = INT_MAX;
    for (int w = 0; w < WARPS; ++w) {
      const float v2 = wval[w * B + bb];
      const int i2 = warg[w * B + bb];
      if (better(v2, i2, bv, bi)) {
        bv = v2;
        bi = i2;
      }
    }
    part_val[(int64_t)blockIdx.x * B + bb] = bv;
    part_arg[(int64_t)blockIdx.x * B + bb] = bi;
  }
}

__global__ void __launch_bounds__(THREADS)
    decode_sample_reduce(const float* __restrict__ part_val,
                         const int* __restrict__ part_arg, int nblocks, int B,
                         int64_t V, int64_t v_real, int* __restrict__ ids,
                         float* __restrict__ best_out) {
  __shared__ float sv[THREADS];
  __shared__ int si[THREADS];
  const int b = blockIdx.x, t = threadIdx.x;
  float bv = -INFINITY;
  int bi = INT_MAX;
  if (t == 0 && v_real < V) {  // the padded ids, all at -1e30
    bv = -1e30f;
    bi = (int)v_real;
  }
  for (int j = t; j < nblocks; j += THREADS) {
    const float v2 = part_val[(int64_t)j * B + b];
    const int i2 = part_arg[(int64_t)j * B + b];
    if (better(v2, i2, bv, bi)) {
      bv = v2;
      bi = i2;
    }
  }
  sv[t] = bv;
  si[t] = bi;
  __syncthreads();
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    if (t < s && better(sv[t + s], si[t + s], sv[t], si[t])) {
      sv[t] = sv[t + s];
      si[t] = si[t + s];
    }
    __syncthreads();
  }
  if (t == 0) {
    ids[b] = si[0] == INT_MAX ? 0 : si[0];  // the plain walk starts at id 0
    best_out[b] = sv[0];
  }
}

template <int NV>
cudaError_t launch_blocks(const float* y, const float* table,
                          const float* noise, float* pv, int* pa, int B, int d,
                          int64_t V, int64_t v_real, int64_t rows_per_block,
                          int nblocks, float scale, cudaStream_t st) {
  const size_t smem = sizeof(float) * (size_t)B * d +
                      (sizeof(float) + sizeof(int)) * WARPS * (size_t)B;
  cudaError_t err = cudaFuncSetAttribute(
      decode_sample_blocks<NV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  decode_sample_blocks<NV><<<nblocks, THREADS, smem, st>>>(
      y, table, noise, pv, pa, B, d, V, v_real, rows_per_block, scale);
  return cudaGetLastError();
}

}  // namespace

// part_val / part_arg: scratch of nblocks * B entries each. d % 4 == 0,
// d <= 2048, table 16-byte aligned, 1 <= B <= 64, 1 <= v_real <= V < 2^31.
extern "C" int decode_sample_f32(const void* y, const void* table,
                                 const void* noise, void* part_val,
                                 void* part_arg, void* ids, void* best,
                                 int B, int d, long long V, long long v_real,
                                 long long rows_per_block, int nblocks,
                                 float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* yp = static_cast<const float*>(y);
  const float* tp = static_cast<const float*>(table);
  const float* np_ = static_cast<const float*>(noise);
  float* pv = static_cast<float*>(part_val);
  int* pa = static_cast<int*>(part_arg);
  const int d4 = d / 4;
  cudaError_t err;
  if (d4 <= 32)
    err = launch_blocks<1>(yp, tp, np_, pv, pa, B, d, V, v_real,
                           rows_per_block, nblocks, scale, st);
  else if (d4 <= 64)
    err = launch_blocks<2>(yp, tp, np_, pv, pa, B, d, V, v_real,
                           rows_per_block, nblocks, scale, st);
  else if (d4 <= 128)
    err = launch_blocks<4>(yp, tp, np_, pv, pa, B, d, V, v_real,
                           rows_per_block, nblocks, scale, st);
  else if (d4 <= 256)
    err = launch_blocks<8>(yp, tp, np_, pv, pa, B, d, V, v_real,
                           rows_per_block, nblocks, scale, st);
  else
    err = launch_blocks<16>(yp, tp, np_, pv, pa, B, d, V, v_real,
                            rows_per_block, nblocks, scale, st);
  if (err != cudaSuccess) return (int)err;
  decode_sample_reduce<<<B, THREADS, 0, st>>>(
      pv, pa, nblocks, B, (int64_t)V, (int64_t)v_real,
      static_cast<int*>(ids), static_cast<float*>(best));
  return (int)cudaGetLastError();
}
