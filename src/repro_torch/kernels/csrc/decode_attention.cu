// Single-query decode attention over a bf16 KV cache (kernel K5).
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
// q is fp32 (B, H, D); k and v are the bf16 cache (B, C, Hk, D|Dv), read
// through __bfloat162float; bias is (B, C) fp32. Head h = g * rep + r.
//
// Design: one block of 128 threads per (g, b). The block walks C in tiles of
// 128 positions with an online softmax: a running max m and sum l per query
// head and a rep x Dv accumulator in registers (each thread owns up to 8
// outputs). Per tile: k and v are copied to shared memory as fp32 (16-byte
// loads when aligned, all of a thread's loads in flight at once), thread t
// scores position t against all rep heads,
// each head's tile max and sum are warp reductions, and the accumulator is
// rescaled by exp(m_old - m_new) before the tile's sum_c p * v is added. The
// TPU kernel holds all of C in VMEM; a block here holds one tile, so any
// C >= 1 works (the ragged tail is masked with -inf scores and zero k/v).
// Masked positions get weight exactly 0: exp(-1e30 - m) underflows to +0 in
// fp32, and a tile seen before the first valid score is rescaled by
// exp(-1e30 - m_new) = 0. At least one position per row is valid.
//
// The mask, softcap and scaling repeat the plain version's fp32 operations
// in its order (q * D^-1/2 first, then softcap, then + bias); the dot
// products use explicit fmaf and sum in another order than PyTorch, so the
// kernel agrees with the plain version to rounding, not bitwise.
//
// Bound on an H100: bytes. The work reads q, k, v and bias once and writes
// out: at the serve path's shape (B=8, C=576, Hk=2, rep=7, D=Dv=64) that is
// 2,435,072 B, >= 0.73 us at 3.35 TB/s, far below a launch's latency. With
// only B * Hk blocks (16 there) the card is mostly idle; splitting C over
// blocks (flash-decoding) is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;  // one score per thread per tile
constexpr int TILE = 128;     // cache positions per tile
constexpr int RMAX = 16;      // query heads per kv head
constexpr int OMAX = 8;       // outputs per thread: rep * Dv <= 1024

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ void store8(float* o, const uint4& raw) {
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int e = 0; e < 8; ++e) o[e] = __bfloat162float(h[e]);
}

// Copy rows [0, n) of one head of the (TILE, Hk, D|Dv) bf16 k and v slabs
// to ks[c * kpitch + d] and vs[c * Dv + d] as fp32; rows n..TILE-1 are
// zeroed. vec: D % 8 == 0, Dv % 8 == 0 and 16-byte aligned rows, so each
// load moves 8 values; LPASS loads of k and of v per thread are issued
// before the first is used, so a tile costs about one memory latency.
constexpr int LPASS = 8;

__device__ __forceinline__ void load_tiles(float* ks, int kpitch,
                                           const __nv_bfloat16* ksrc,
                                           int64_t krow, int D, float* vs,
                                           const __nv_bfloat16* vsrc,
                                           int64_t vrow, int Dv, int n,
                                           bool vec) {
  if (vec) {
    const int kch = D / 8, vch = Dv / 8;
    const int ktot = TILE * kch, vtot = TILE * vch;
    const int tot = ktot > vtot ? ktot : vtot;
    for (int base = 0; base < tot; base += LPASS * THREADS) {
      uint4 kr[LPASS], vr[LPASS];
#pragma unroll
      for (int j = 0; j < LPASS; ++j) {
        const int i = base + threadIdx.x + j * THREADS;
        kr[j] = make_uint4(0u, 0u, 0u, 0u);
        vr[j] = make_uint4(0u, 0u, 0u, 0u);
        if (i < ktot && i / kch < n)
          kr[j] = __ldg(reinterpret_cast<const uint4*>(
              ksrc + (i / kch) * krow + (i % kch) * 8));
        if (i < vtot && i / vch < n)
          vr[j] = __ldg(reinterpret_cast<const uint4*>(
              vsrc + (i / vch) * vrow + (i % vch) * 8));
      }
#pragma unroll
      for (int j = 0; j < LPASS; ++j) {
        const int i = base + threadIdx.x + j * THREADS;
        if (i < ktot) store8(ks + (i / kch) * kpitch + (i % kch) * 8, kr[j]);
        if (i < vtot) store8(vs + (i / vch) * Dv + (i % vch) * 8, vr[j]);
      }
    }
  } else {
    for (int i = threadIdx.x; i < TILE * D; i += THREADS) {
      const int c = i / D, j = i % D;
      ks[c * kpitch + j] = c < n ? __bfloat162float(ksrc[c * krow + j]) : 0.0f;
    }
    for (int i = threadIdx.x; i < TILE * Dv; i += THREADS) {
      const int c = i / Dv, j = i % Dv;
      vs[c * Dv + j] = c < n ? __bfloat162float(vsrc[c * vrow + j]) : 0.0f;
    }
  }
}

__global__ void __launch_bounds__(THREADS)
    decode_attention_kernel(const float* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            const float* __restrict__ bias,
                            float* __restrict__ out, int64_t C, int H, int Hk,
                            int D, int Dv, float qscale, float softcap,
                            int vec) {
  extern __shared__ float smem[];
  const int g = blockIdx.x;
  const int64_t b = blockIdx.y;
  const int rep = H / Hk;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int kpitch = D + 1;  // odd pitch: thread t reads row t conflict-free
  float* qs = smem;                   // rep x D, pre-scaled
  float* ks = qs + rep * D;           // TILE x (D + 1)
  float* vs = ks + TILE * kpitch;     // TILE x Dv
  float* ps = vs + TILE * Dv;         // rep x TILE scores, then weights
  float* ms = ps + rep * TILE;        // running max per head
  float* ls = ms + RMAX;              // running sum per head
  float* cs = ls + RMAX;              // this tile's rescale per head

  const float* qb = q + (b * H + (int64_t)g * rep) * D;
  for (int i = t; i < rep * D; i += THREADS) qs[i] = __fmul_rn(qb[i], qscale);
  if (t < rep) {
    ms[t] = -INFINITY;
    ls[t] = 0.0f;
  }
  // the outputs this thread owns: (head orow[j], column ocol[j])
  float acc[OMAX];
  int orow[OMAX], ocol[OMAX];
#pragma unroll
  for (int j = 0; j < OMAX; ++j) {
    const int o = t + j * THREADS;
    acc[j] = 0.0f;
    orow[j] = o < rep * Dv ? o / Dv : -1;
    ocol[j] = o % Dv;
  }

  const int64_t krow = (int64_t)Hk * D, vrow = (int64_t)Hk * Dv;
  const __nv_bfloat16* kb = k + b * C * krow + (int64_t)g * D;
  const __nv_bfloat16* vb = v + b * C * vrow + (int64_t)g * Dv;
  const float* biasb = bias + b * C;

  for (int64_t c0 = 0; c0 < C; c0 += TILE) {
    const int n = (int)(C - c0 < TILE ? C - c0 : TILE);
    __syncthreads();  // the previous tile's readers are done
    load_tiles(ks, kpitch, kb + c0 * krow, krow, D, vs, vb + c0 * vrow,
               vrow, Dv, n, vec);
    __syncthreads();

    // scores of position c0 + t against every query head
    {
      float s[RMAX];
#pragma unroll
      for (int r = 0; r < RMAX; ++r) s[r] = 0.0f;
      const float* kr = ks + t * kpitch;
      for (int d = 0; d < D; ++d) {
        const float kv = kr[d];
#pragma unroll
        for (int r = 0; r < RMAX; ++r)
          if (r < rep) s[r] = __fmaf_rn(qs[r * D + d], kv, s[r]);
      }
      const float bb = t < n ? biasb[c0 + t] : 0.0f;
#pragma unroll
      for (int r = 0; r < RMAX; ++r) {
        if (r < rep) {
          float x = s[r];
          if (softcap > 0.0f)
            x = __fmul_rn(softcap, tanhf(__fdiv_rn(x, softcap)));
          ps[r * TILE + t] = t < n ? __fadd_rn(x, bb) : -INFINITY;
        }
      }
    }
    __syncthreads();

    // online softmax: warp w owns heads w, w + 4, ...
    for (int r = warp; r < rep; r += THREADS / 32) {
      float x[TILE / 32];
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < TILE / 32; ++i) {
        x[i] = ps[r * TILE + lane + 32 * i];
        mx = fmaxf(mx, x[i]);
      }
      mx = warp_max(mx);
      const float m_old = ms[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.0f;
#pragma unroll
      for (int i = 0; i < TILE / 32; ++i) {
        const float p = expf(__fsub_rn(x[i], m_new));
        ps[r * TILE + lane + 32 * i] = p;
        sum = __fadd_rn(sum, p);
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(__fsub_rn(m_old, m_new));
        cs[r] = corr;
        ls[r] = __fadd_rn(__fmul_rn(ls[r], corr), sum);
        ms[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + sum_c p * v for each owned (head, dv); the
    // owned outputs' sums are independent chains, interleaved per c
    {
      float part[OMAX];
#pragma unroll
      for (int j = 0; j < OMAX; ++j) part[j] = 0.0f;
      for (int c = 0; c < n; ++c) {
#pragma unroll
        for (int j = 0; j < OMAX; ++j)
          if (orow[j] >= 0)
            part[j] = __fmaf_rn(ps[orow[j] * TILE + c], vs[c * Dv + ocol[j]],
                                part[j]);
      }
#pragma unroll
      for (int j = 0; j < OMAX; ++j)
        if (orow[j] >= 0)
          acc[j] = __fadd_rn(__fmul_rn(acc[j], cs[orow[j]]), part[j]);
    }
  }

  float* ob = out + (b * H + (int64_t)g * rep) * Dv;
#pragma unroll
  for (int j = 0; j < OMAX; ++j)
    if (orow[j] >= 0)
      ob[t + j * THREADS] = __fdiv_rn(acc[j], ls[orow[j]]);
}

}  // namespace

extern "C" size_t decode_attention_smem_bytes(int rep, int D, int Dv) {
  return sizeof(float) * ((size_t)rep * D + (size_t)TILE * (D + 1) +
                          (size_t)TILE * Dv + (size_t)rep * TILE + 3 * RMAX);
}

extern "C" int decode_attention_f32(const void* q, const void* k,
                                    const void* v, const void* bias,
                                    void* out, long long B, long long C, int H,
                                    int Hk, int D, int Dv, float qscale,
                                    float softcap, int vec, void* stream) {
  const size_t smem = decode_attention_smem_bytes(H / Hk, D, Dv);
  cudaError_t err = cudaFuncSetAttribute(
      decode_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)Hk, (unsigned)B);
  decode_attention_kernel<<<grid, THREADS, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(bias),
      static_cast<float*>(out), (int64_t)C, H, Hk, D, Dv, qscale, softcap,
      vec);
  return (int)cudaGetLastError();
}
