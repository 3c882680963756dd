// Stochastic int8 quantize-dequantize on per-client flat fp32 rows (M, n).
//
// Replaces the TPU kernel repro/kernels/quantize_update.py::quantize_update_flat
// (pallas_call at quantize_update.py:56, body _kernel). Its plain PyTorch
// version is repro_torch/kernels/ref.py::quantize_update_ref; this kernel
// repeats that sequence of fp32 operations, each rounded to nearest (__f*_rn,
// and the file is built with -fmad=false), so q is equal and dec is bitwise
// equal:
//
//   s   = scale[row]
//   v   = x / s                      (0 where s is not > 0)
//   qf  = clip(floor(v + u), -127, 127)
//   q   = (int8) qf                  the wire payload
//   dec = qf * s                     the server-side fp32 view
//
// A zero scale gives v = 0, qf = floor(u) = 0 and dec = 0 * 0 = +0, as the
// plain version does. The scale is one fp32 per row (the engine's per-client
// absmax / 127), read once per thread, where the TPU kernel took an
// (n,)-broadcast s.
//
// Bound on an H100: bandwidth. Each element reads x and u and writes q and
// dec, 13 bytes, with no reuse, so the least time is the bytes over
// 3.35 TB/s. Design: one thread per element, or per 4 elements with 16-byte
// float4 loads of x and u, a float4 store of dec and a 4-byte char4 store of
// q when n % 4 == 0 and the pointers are aligned for those widths; the client
// row is blockIdx.y and offsets are 64-bit (M * n exceeds 2^31 past 537M
// elements per row at M = 4). The ragged tail is masked, never padded.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float qdq(float x, float u, float s,
                                     signed char* q) {
  const float v = (s > 0.0f) ? __fdiv_rn(x, s) : 0.0f;
  float qf = floorf(__fadd_rn(v, u));
  if (!isnan(qf)) qf = fminf(fmaxf(qf, -127.0f), 127.0f);  // NaN propagates
  *q = static_cast<signed char>(qf);
  return __fmul_rn(qf, s);
}

__global__ void quantize_update_scalar(const float* __restrict__ x,
                                       const float* __restrict__ u,
                                       const float* __restrict__ scale,
                                       signed char* __restrict__ q,
                                       float* __restrict__ dec, int64_t n) {
  const int64_t row = blockIdx.y;
  const int64_t col = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= n) return;
  const int64_t i = row * n + col;
  const float s = scale[row];
  dec[i] = qdq(x[i], u[i], s, q + i);
}

// n % 4 == 0, x/u/dec 16-byte and q 4-byte aligned: each thread moves 4
// elements.
__global__ void quantize_update_vec4(const float* __restrict__ x,
                                     const float* __restrict__ u,
                                     const float* __restrict__ scale,
                                     signed char* __restrict__ q,
                                     float* __restrict__ dec, int64_t n) {
  const int64_t row = blockIdx.y;
  const int64_t col = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (col >= n) return;
  const int64_t i = row * n + col;
  const float s = scale[row];
  const float4 xv = *reinterpret_cast<const float4*>(x + i);
  const float4 uv = *reinterpret_cast<const float4*>(u + i);
  char4 qv;
  float4 dv;
  signed char qs[4];
  dv.x = qdq(xv.x, uv.x, s, qs + 0);
  dv.y = qdq(xv.y, uv.y, s, qs + 1);
  dv.z = qdq(xv.z, uv.z, s, qs + 2);
  dv.w = qdq(xv.w, uv.w, s, qs + 3);
  qv.x = qs[0];
  qv.y = qs[1];
  qv.z = qs[2];
  qv.w = qs[3];
  *reinterpret_cast<char4*>(q + i) = qv;
  *reinterpret_cast<float4*>(dec + i) = dv;
}

}  // namespace

extern "C" int quantize_update_f32(const void* x, const void* u,
                                   const void* scale, void* q, void* dec,
                                   long long M, long long n, int vec4,
                                   void* stream) {
  const int threads = 256;
  const int64_t per_thread = vec4 ? 4 : 1;
  const int64_t cols = (n + per_thread - 1) / per_thread;
  dim3 grid((unsigned)((cols + threads - 1) / threads), (unsigned)M);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  const float* up = static_cast<const float*>(u);
  const float* sp = static_cast<const float*>(scale);
  signed char* qp = static_cast<signed char*>(q);
  float* dp = static_cast<float*>(dec);
  if (vec4)
    quantize_update_vec4<<<grid, threads, 0, st>>>(xp, up, sp, qp, dp, n);
  else
    quantize_update_scalar<<<grid, threads, 0, st>>>(xp, up, sp, qp, dp, n);
  return (int)cudaGetLastError();
}
