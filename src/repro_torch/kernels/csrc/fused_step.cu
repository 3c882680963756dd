// Fused generic-scaling local step on per-client flat fp32 buffers (M, n).
//
// Replaces the TPU kernel repro/kernels/scaled_update.py::fused_step_flat
// (pallas_call at scaled_update.py:201, body _fused_kernel ->
// ref.fused_step_math). Its plain PyTorch version is
// repro_torch/kernels/ref.py::fused_step_math; this kernel repeats that
// sequence of fp32 operations one by one, each rounded to nearest
// (__f*_rn, and the file is built with -fmad=false), so the two agree
// bitwise:
//
//   g  = g * s[row]                                      (if s)
//   d' = d + stat  |  beta[row]*d + (1 - beta[row])*stat (if update_d;
//        stat = g*g or h)
//   g  = g + wd * p                                      (if wd != 0)
//   m' = beta1 * m + g
//   p' = p - gamma * m'                                  (identity)
//   p' = p - gamma * (m' / Dhat(d'))                     (other kinds)
//   Dhat = max(alpha, sqrt(d) or |d|)  or  sqrt(d) or |d| + alpha
//
// beta[row] is the per-client beta_t, computed by the wrapper with the plain
// version's own torch ops; it stands in for the TPU kernel's scalar-prefetched
// counter t and keeps powf out of the kernel.
//
// Bound on an H100: bandwidth. Each element reads p, m, g (+ d, + h) and
// writes p', m' (+ d'); nothing is reused, so the least time is the bytes over
// 3.35 TB/s. Design: one thread per element, or per 4 elements with 16-byte
// float4 loads and stores when n % 4 == 0 and every pointer is 16-byte
// aligned; the client row is blockIdx.y, offsets are 64-bit (M*n exceeds 2^31
// at full width for M >= 5). The ragged tail is masked, never padded. A
// global (client-shared) D is (n,) and indexed by column only. Outputs are
// written in place over p, m and d.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Kind { IDENTITY = 0, SQUARED = 1, ADAGRAD = 2, LINEAR = 3 };

struct Args {
  float* p;
  float* m;
  const float* g;
  float* d;            // (M, n) local, (n,) global, or null (identity)
  const float* h;      // (M, n) external stat or null
  const float* beta;   // (M,) beta_t or null
  const float* s;      // (M,) clip scale or null
  int64_t n;
  float gamma, beta1, wd, alpha;
  int kind, clip_add, update_d, global_d;
};

__device__ __forceinline__ float dhat(float d, const Args& a) {
  float mag = (a.kind == LINEAR) ? fabsf(d) : __fsqrt_rn(d);
  if (a.clip_add) return __fadd_rn(mag, a.alpha);
  return isnan(mag) ? mag : fmaxf(mag, a.alpha);   // NaN propagates, as in torch
}

__device__ __forceinline__ void step(float& p, float& m, float g, float& d,
                                     float h, float b, float s,
                                     const Args& a) {
  if (a.s) g = __fmul_rn(g, s);
  if (a.update_d) {
    float stat = a.h ? h : __fmul_rn(g, g);
    if (a.kind == ADAGRAD)
      d = __fadd_rn(d, stat);
    else
      d = __fadd_rn(__fmul_rn(b, d), __fmul_rn(__fsub_rn(1.0f, b), stat));
  }
  if (a.wd != 0.0f) g = __fadd_rn(g, __fmul_rn(a.wd, p));
  m = __fadd_rn(__fmul_rn(a.beta1, m), g);
  if (a.kind == IDENTITY)
    p = __fsub_rn(p, __fmul_rn(a.gamma, m));
  else
    p = __fsub_rn(p, __fmul_rn(a.gamma, __fdiv_rn(m, dhat(d, a))));
}

__global__ void fused_step_scalar(Args a) {
  const int64_t row = blockIdx.y;
  const int64_t col = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= a.n) return;
  const int64_t i = row * a.n + col;
  const int64_t di = a.global_d ? col : i;
  const float b = a.beta ? a.beta[row] : 0.0f;
  const float s = a.s ? a.s[row] : 1.0f;
  float p = a.p[i], m = a.m[i];
  float d = a.d ? a.d[di] : 0.0f;
  const float h = a.h ? a.h[i] : 0.0f;
  step(p, m, a.g[i], d, h, b, s, a);
  a.p[i] = p;
  a.m[i] = m;
  if (a.update_d) a.d[di] = d;
}

// n % 4 == 0 and 16-byte aligned pointers: each thread moves one float4.
__global__ void fused_step_vec4(Args a) {
  const int64_t row = blockIdx.y;
  const int64_t col = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (col >= a.n) return;
  const int64_t i = row * a.n + col;
  const int64_t di = a.global_d ? col : i;
  const float b = a.beta ? a.beta[row] : 0.0f;
  const float s = a.s ? a.s[row] : 1.0f;
  float4 p = *reinterpret_cast<const float4*>(a.p + i);
  float4 m = *reinterpret_cast<const float4*>(a.m + i);
  const float4 g = *reinterpret_cast<const float4*>(a.g + i);
  float4 d = a.d ? *reinterpret_cast<const float4*>(a.d + di)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  const float4 h = a.h ? *reinterpret_cast<const float4*>(a.h + i)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
  step(p.x, m.x, g.x, d.x, h.x, b, s, a);
  step(p.y, m.y, g.y, d.y, h.y, b, s, a);
  step(p.z, m.z, g.z, d.z, h.z, b, s, a);
  step(p.w, m.w, g.w, d.w, h.w, b, s, a);
  *reinterpret_cast<float4*>(a.p + i) = p;
  *reinterpret_cast<float4*>(a.m + i) = m;
  if (a.update_d) *reinterpret_cast<float4*>(a.d + di) = d;
}

}  // namespace

extern "C" int fused_step_f32(void* p, void* m, const void* g, void* d,
                              const void* h, const void* beta, const void* s,
                              long long M, long long n, float gamma,
                              float beta1, float weight_decay, float alpha,
                              int kind, int clip_add, int update_d,
                              int global_d, int vec4, void* stream) {
  Args a;
  a.p = static_cast<float*>(p);
  a.m = static_cast<float*>(m);
  a.g = static_cast<const float*>(g);
  a.d = static_cast<float*>(d);
  a.h = static_cast<const float*>(h);
  a.beta = static_cast<const float*>(beta);
  a.s = static_cast<const float*>(s);
  a.n = n;
  a.gamma = gamma;
  a.beta1 = beta1;
  a.wd = weight_decay;
  a.alpha = alpha;
  a.kind = kind;
  a.clip_add = clip_add;
  a.update_d = update_d;
  a.global_d = global_d;
  const int threads = 256;
  const int64_t per_thread = vec4 ? 4 : 1;
  const int64_t cols = (n + per_thread - 1) / per_thread;
  dim3 grid((unsigned)((cols + threads - 1) / threads), (unsigned)M);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec4)
    fused_step_vec4<<<grid, threads, 0, st>>>(a);
  else
    fused_step_scalar<<<grid, threads, 0, st>>>(a);
  return (int)cudaGetLastError();
}
