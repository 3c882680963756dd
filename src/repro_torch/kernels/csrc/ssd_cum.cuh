// The chunk's cumulative decay of one SSD cell, scanned by one warp: shared
// by K7 (ssd_intra_chunk.cu) and its VJP K7b (ssd_intra_chunk_bwd.cu), so
// that both see the same cum to the bit. build.py hashes this header into
// their libraries' names.
#pragma once
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

constexpr int SSD_QMAX = 256;   // the longest chunk

// For dt rows d[q * stride], q < Q <= SSD_QMAX, and the head's A: cum_q =
// sum_{k <= q} dt_k * A. Each lane adds its run of rows in order in fp64, a
// shuffle scan adds the lanes' sums, and each prefix is rounded once to fp32
// (within half an ulp of the exact sum, whatever the order of the fp64
// adds: ref.ssd_cumsum). Writes out[q] = cum_q, out[Q + q] = dt_q and
// out[2 Q + q] = exp(cum_{Q-1} - cum_q); returns cum_{Q-1} to every lane.
// The whole warp calls it.
__device__ __forceinline__ float ssd_cum_cell(const float* d, int64_t stride,
                                              float A, int Q, float* out) {
  constexpr unsigned FULL = 0xffffffffu;
  constexpr int U = SSD_QMAX / 32;
  const int lane = threadIdx.x % 32;
  const int L = (Q + 31) / 32;      // rows of a lane: lane * L .. + L - 1
  double part[U];
  float dv[U];
  double run = 0.0;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int q = lane * L + u;
    dv[u] = u < L && q < Q ? d[q * stride] : 0.0f;
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    run = __dadd_rn(run, (double)__fmul_rn(dv[u], A));
    part[u] = run;
  }
  double incl = run;                // inclusive scan of the lanes' sums
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double v = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl = __dadd_rn(incl, v);
  }
  double excl = __shfl_up_sync(FULL, incl, 1);
  if (lane == 0) excl = 0.0;
  float cq[U];
#pragma unroll
  for (int u = 0; u < U; ++u)
    cq[u] = __double2float_rn(__dadd_rn(excl, part[u]));
  float mine = 0.0f;                // cum_{Q-1}, from the lane that has it
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (lane * L + u == Q - 1) mine = cq[u];
  const float last = __shfl_sync(FULL, mine, (Q - 1) / L);
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int q = lane * L + u;
    if (u < L && q < Q) {
      out[q] = cq[u];
      out[Q + q] = dv[u];
      out[2 * Q + q] = expf(__fsub_rn(last, cq[u]));
    }
  }
  return last;
}
