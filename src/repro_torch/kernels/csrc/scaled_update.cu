// Legacy per-leaf scaled step on one flat fp32 array (kernel K2).
//
// Replaces the TPU kernel repro/kernels/scaled_update.py::scaled_update_flat
// (pallas_call at scaled_update.py:103, body _kernel at :76). Its plain
// PyTorch version is repro_torch/kernels/ref.py::scaled_update_ref; this
// kernel repeats that sequence of fp32 operations one by one, each rounded
// to nearest (__f*_rn, and the file is built with -fmad=false), so the two
// agree bitwise:
//
//   m'   = beta1 * m + g                       (two roundings, no FMA)
//   Dhat = max(alpha, sqrt(d))  or  max(alpha, |d|)   (NaN passes through)
//   p'   = p - (gamma * m') / Dhat
//
// Bound on an H100: bandwidth. Each element reads p, m, g, d and writes p',
// m' (24 bytes) and nothing is reused, so the least time is the bytes over
// 3.35 TB/s. Design: one thread per 4 elements with 16-byte float4 loads and
// stores when all six pointers are 16-byte aligned, one thread per element
// otherwise. The ragged tail is masked, never padded (the TPU kernel padded
// p, m, g with 0 and d with 1.0 up to its block). Offsets are 64-bit: one
// launch is right past 2^31 elements.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Args {
  const float* p;
  const float* m;
  const float* g;
  const float* d;
  float* p_out;
  float* m_out;
  int64_t n;
  float gamma, beta1, alpha;
  int squared;
};

__device__ __forceinline__ void step(float p, float m, float g, float d,
                                     float& p_out, float& m_out,
                                     const Args& a) {
  const float m2 = __fadd_rn(__fmul_rn(a.beta1, m), g);
  const float mag = a.squared ? __fsqrt_rn(d) : fabsf(d);
  const float dhat = mag < a.alpha ? a.alpha : mag;   // NaN stays NaN
  p_out = __fsub_rn(p, __fdiv_rn(__fmul_rn(a.gamma, m2), dhat));
  m_out = m2;
}

__device__ __forceinline__ void step_at(int64_t i, const Args& a) {
  step(a.p[i], a.m[i], a.g[i], a.d[i], a.p_out[i], a.m_out[i], a);
}

__global__ void scaled_update_scalar(Args a) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < a.n) step_at(i, a);
}

// Every pointer 16-byte aligned: each thread moves one float4; the thread
// of a partial last group steps its elements one by one.
__global__ void scaled_update_vec4(Args a) {
  const int64_t i = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i >= a.n) return;
  if (i + 4 > a.n) {
    for (int64_t j = i; j < a.n; ++j) step_at(j, a);
    return;
  }
  const float4 p = *reinterpret_cast<const float4*>(a.p + i);
  const float4 m = *reinterpret_cast<const float4*>(a.m + i);
  const float4 g = *reinterpret_cast<const float4*>(a.g + i);
  const float4 d = *reinterpret_cast<const float4*>(a.d + i);
  float4 po, mo;
  step(p.x, m.x, g.x, d.x, po.x, mo.x, a);
  step(p.y, m.y, g.y, d.y, po.y, mo.y, a);
  step(p.z, m.z, g.z, d.z, po.z, mo.z, a);
  step(p.w, m.w, g.w, d.w, po.w, mo.w, a);
  *reinterpret_cast<float4*>(a.p_out + i) = po;
  *reinterpret_cast<float4*>(a.m_out + i) = mo;
}

}  // namespace

// p, m, g, d: n floats each; p_out, m_out: n floats, not overlapping the
// inputs at another offset. n >= 1.
extern "C" int scaled_update_f32(const void* p, const void* m, const void* g,
                                 const void* d, void* p_out, void* m_out,
                                 long long n, float gamma, float beta1,
                                 float alpha, int squared, int vec4,
                                 void* stream) {
  Args a;
  a.p = static_cast<const float*>(p);
  a.m = static_cast<const float*>(m);
  a.g = static_cast<const float*>(g);
  a.d = static_cast<const float*>(d);
  a.p_out = static_cast<float*>(p_out);
  a.m_out = static_cast<float*>(m_out);
  a.n = n;
  a.gamma = gamma;
  a.beta1 = beta1;
  a.alpha = alpha;
  a.squared = squared;
  const int threads = 256;
  const int64_t per_thread = vec4 ? 4 : 1;
  const int64_t work = (n + per_thread - 1) / per_thread;
  const unsigned blocks = (unsigned)((work + threads - 1) / threads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec4)
    scaled_update_vec4<<<blocks, threads, 0, st>>>(a);
  else
    scaled_update_scalar<<<blocks, threads, 0, st>>>(a);
  return (int)cudaGetLastError();
}
