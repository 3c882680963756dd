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
// Design: one block of 128 threads per (b, h, 64-row query tile); the
// heaviest tiles (last rows, the most keys) are launched first. The block
// keeps its query tile (pre-scaled) in shared memory and walks the key tiles
// of 64 rows that hold an unmasked pair, with the online softmax of the TPU
// kernel: running max m (from -1e30) and sum l per row, corr = exp(m_old -
// m_new), l = l * corr + sum p, acc = acc * corr + p . v, out = acc /
// max(l, 1e-30). Key tiles above the diagonal or wholly beyond the window
// are skipped, not computed and masked. Thread t owns rows 4 * (t / 8) + i
// (i < 4); the 8 threads of a row hold its score columns t % 8 + 8 j
// (j < 8) and an eighth of its output columns, and reduce the row's max
// and sum with shuffles. The 64 x 64 score tile stays in registers; the
// weights go through shared memory (transposed) for the p . v product. The
// head dim is padded to DP in {32, 64, 128} with zeros (which add nothing
// to a dot), so any D <= 128 works, and rows past S are loaded as zeros: a
// key past S is also past every real row, so the causal mask hides it.
// Masked scores are -1e30, not -inf, as in the TPU kernel: a row whose
// first tile is all masked is rescaled by exp(-1e30 - m) = +0 once it meets
// a real score, and every real row meets one (its own key) in its diagonal
// tile.
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
// 0.04 ms at 3.35 TB/s. This kernel runs on the CUDA cores in fp32 (the
// port keeps TF32 off); wgmma with 3xTF32 or bf16 operands, TMA staging and
// warp specialisation are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int BQ = 64;           // query rows per block
constexpr int BK = 64;           // keys per tile
constexpr int RPT = 4;           // query rows per thread
constexpr int CG = 8;            // threads sharing a query row
constexpr int CPT = BK / CG;     // score columns per thread
constexpr int PT = BQ + 4;       // pitch of the transposed weight tile
constexpr int LPASS = 8;         // 16-byte loads in flight per thread
constexpr float NEG = -1e30f;

static_assert(THREADS / CG * RPT == BQ, "thread layout must cover BQ rows");

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f(float* o, float x) { *o = x; }
__device__ __forceinline__ void from_f(__nv_bfloat16* o, float x) {
  *o = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = 1; o < CG; o <<= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = 1; o < CG; o <<= 1)
    x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Copy rows [row0, row0 + 64) of one head to dst[r * pitch + d] as fp32
// (times qscale when SCALE), zeros past S and for d in [D, DP). vec: unit
// d stride, 16-byte aligned rows and D a multiple of the 16-byte width, so
// one load moves W values; LPASS loads per thread are issued before the
// first is stored.
template <typename T, int DP, bool SCALE>
__device__ __forceinline__ void load_rows(float* dst, int pitch,
                                          const T* __restrict__ src,
                                          int64_t rs, int64_t ds, int64_t row0,
                                          int64_t S, int D, float qscale,
                                          bool vec) {
  constexpr int W = 16 / sizeof(T);
  constexpr int CH = DP / W;             // chunks per row
  constexpr int TOT = BQ * CH;
  if (vec) {
#pragma unroll
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
    for (int i = threadIdx.x; i < BQ * DP; i += THREADS) {
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

// Output column of a thread's j-th accumulator: groups of 4 consecutive
// columns, the 8 threads of a row side by side, so that one float4 load of
// v per group covers 128 contiguous bytes across them.
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
};

template <typename T, int DP>
__global__ void __launch_bounds__(THREADS)
    flash_attention_kernel(const Args a) {
  constexpr int P = DP + 4;      // q/k tile pitch: 16-byte rows, odd banks
  constexpr int OPT = DP / CG;   // output columns per thread
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* qs = smem;              // BQ x P, pre-scaled
  float* ks = qs + BQ * P;       // BK x P
  float* vs = ks + BK * P;       // BK x DP
  float* pt = vs + BK * DP;      // BK x PT, weights transposed

  const int t = threadIdx.x, cg = t % CG, rg = t / CG;
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int g = h / (a.H / a.Hk);
  const int64_t q0 = (int64_t)(gridDim.y - 1 - blockIdx.y) * BQ;
  const T* qb = static_cast<const T*>(a.q) + b * a.qs[0] + h * a.qs[2];
  const T* kb = static_cast<const T*>(a.k) + b * a.ks[0] + g * a.ks[2];
  const T* vb = static_cast<const T*>(a.v) + b * a.vs[0] + g * a.vs[2];
  const bool vec = a.vec != 0;

  load_rows<T, DP, true>(qs, P, qb, a.qs[1], a.qs[3], q0, a.S, a.D,
                         a.qscale, vec);

  float m[RPT], l[RPT], acc[RPT][OPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < OPT; ++j) acc[i][j] = 0.0f;
  }

  const int64_t last = q0 + BQ - 1;          // the tile's last row
  for (int64_t k0 = 0; k0 <= last && k0 < a.S; k0 += BK) {
    // wholly beyond the window: even (q0, k0 + BK - 1) is too far apart
    if (a.window > 0 && q0 - (k0 + BK - 1) >= a.window) continue;
    __syncthreads();  // the previous tile's readers are done
    load_rows<T, DP, false>(ks, P, kb, a.ks[1], a.ks[3], k0, a.S, a.D, 1.0f,
                            vec);
    load_rows<T, DP, false>(vs, DP, vb, a.vs[1], a.vs[3], k0, a.S, a.D, 1.0f,
                            vec);
    __syncthreads();

    // scores: s[i][j] = q'[row i] . k[col j], one fmaf chain over d
    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < DP; d += 4) {
      float4 qv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (rg * RPT + i) * P + d);
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

    // softcap, mask, online softmax; the weights go to pt[col][row]
    float corr[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int64_t row = q0 + rg * RPT + i;
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int64_t col = k0 + cg + CG * j;
        float x = s[i][j];
        if (a.softcap > 0.0f)
          x = __fmul_rn(a.softcap, tanhf(__fdiv_rn(x, a.softcap)));
        const bool ok =
            col <= row && (a.window <= 0 || row - col < (int64_t)a.window);
        s[i][j] = ok ? x : NEG;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(mx));
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        s[i][j] = expf(__fsub_rn(s[i][j], m_new));
        sum = __fadd_rn(sum, s[i][j]);
      }
      corr[i] = expf(__fsub_rn(m[i], m_new));
      l[i] = __fadd_rn(__fmul_rn(l[i], corr[i]), group_sum(sum));
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < CPT; ++j)
      *reinterpret_cast<float4*>(pt + (cg + CG * j) * PT + rg * RPT) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    // acc = acc * corr + sum_c p[row][c] * v[c][col], one chain over c
    const int n = (int)(a.S - k0 < BK ? a.S - k0 : BK);
    float part[RPT][OPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < OPT; ++j) part[i][j] = 0.0f;
#pragma unroll 4
    for (int c = 0; c < n; ++c) {
      const float4 p =
          *reinterpret_cast<const float4*>(pt + c * PT + rg * RPT);
      const float pr[RPT] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int j = 0; j < OPT; j += 4) {
        const float4 vv =
            *reinterpret_cast<const float4*>(vs + c * DP + out_col(cg, j));
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          part[i][j] = __fmaf_rn(pr[i], vv.x, part[i][j]);
          part[i][j + 1] = __fmaf_rn(pr[i], vv.y, part[i][j + 1]);
          part[i][j + 2] = __fmaf_rn(pr[i], vv.z, part[i][j + 2]);
          part[i][j + 3] = __fmaf_rn(pr[i], vv.w, part[i][j + 3]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < OPT; ++j)
        acc[i][j] = __fadd_rn(__fmul_rn(acc[i][j], corr[i]), part[i][j]);
  }

  T* ob = static_cast<T*>(a.o);
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int64_t row = q0 + rg * RPT + i;
    if (row >= a.S) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* orow = ob + ((b * a.S + row) * a.H + h) * (int64_t)a.D;
#pragma unroll
    for (int j = 0; j < OPT; ++j) {
      const int d = out_col(cg, j);
      if (d < a.D) from_f(orow + d, __fdiv_rn(acc[i][j], den));
    }
  }
}

template <int DP>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         ((size_t)BQ * (DP + 4) + (size_t)BK * (DP + 4) + (size_t)BK * DP +
          (size_t)BK * PT);
}

template <typename T, int DP>
int launch(const Args& a, int64_t B, cudaStream_t stream) {
  const size_t smem = smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)(B * a.H), (unsigned)((a.S + BQ - 1) / BQ));
  flash_attention_kernel<T, DP><<<grid, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Args& a, int64_t B, cudaStream_t stream) {
  if (a.D <= 32) return launch<T, 32>(a, B, stream);
  if (a.D <= 64) return launch<T, 64>(a, B, stream);
  return launch<T, 128>(a, B, stream);
}

}  // namespace

// q, k, v, o: device pointers; *_st: the four element strides (b, s, head,
// d) of q, k and v; o is (B, S, H, D) contiguous in the inputs' type.
// bf16 != 0: __nv_bfloat16 inputs and output, else fp32. D <= 128.
// Returns the CUDA error of the launch (0 = none).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, long long B, long long S, int H,
                                   int Hk, int D, const long long* q_st,
                                   const long long* k_st,
                                   const long long* v_st, float qscale,
                                   float softcap, int window, int bf16,
                                   int vec, void* stream) {
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(a, B, st) : dispatch<float>(a, B, st);
}
