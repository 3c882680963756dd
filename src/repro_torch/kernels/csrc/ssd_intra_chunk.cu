// Mamba2 SSD intra-chunk term, forward (kernel K7).
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py::ssd_intra_chunk
// (pallas_call at ssd_scan.py:71, body _kernel at :26). Its plain PyTorch
// version is repro_torch/kernels/ref.py::ssd_intra_chunk_ref. For one cell
// (batch b, chunk c, head h) with x (Q, P), dt (Q,), A, B and C (Q, N):
//
//   cum     = cumsum(dt * A)                       fp64 sum, rounded once
//   L[i][j] = exp(cum_i - cum_j) for j <= i, else 0
//   Y[i]    = sum_{j <= i} (C_i . B_j) * L[i][j] * (x_j * dt_j)   (Q, P)
//   S_chunk = sum_j B_j^T ((x_j * dt_j) * exp(cum_{Q-1} - cum_j))  (N, P)
//   total   = exp(cum_{Q-1})
//
// x, dt, B and C are read through their strides (B and C may repeat one
// group over the heads with a head stride of 0); A is (H,). All fp32. Y is
// written (B, S, H, P), S_chunk (B, nc, H, N, P) and total (B, nc, H), all
// contiguous.
//
// Design. The TPU kernel holds a whole cell (about 0.9 MiB at Q = 256,
// N = 128, P = 64) in VMEM; a Hopper block has 227 KB, so a cell is split
// over blocks that run in parallel. A block of 256 threads is either
//  * a Y block for one 64-row tile i of the chunk: it walks the column
//    tiles j <= i, builds the 64 x 64 tile G = C_i B_j^T from 32-wide
//    N-slices staged (transposed) in shared memory, multiplies it by L in
//    registers (zero above the diagonal and past Q), stores W = G * L
//    transposed in shared memory, and accumulates Y_i += W (x_j * dt_j)
//    over all j in one fmaf chain per output; or
//  * a state block for one 64-row tile of N: it walks the chunk in 64-row
//    tiles and accumulates S_chunk = B^T (x * dt * decay).
// The Y blocks of the last (heaviest) row tile launch first. Every block
// computes its cell's cum itself: all threads load dt * A (fp32), then one
// thread adds them up in order in fp64 and rounds each partial sum once to
// fp32. That is within half an ulp of the exact sum in any order, so cum is
// the plain version's (ref.py's ssd_cumsum, an fp64 cumsum) bit for bit
// but for the rare fp64 sum within ~2^-29 of an fp32 rounding boundary; a
// cum in fp32 would differ from any other order by several ulps, and at
// |cum| ~ 3000 one ulp is 2.4e-4 of every L near the diagonal. The rest
// sums in another order than cuBLAS, so the kernel agrees with the plain
// version to rounding, not bitwise.
// Thread (ty, tx) of the 16 x 16 layout owns rows 4 ty + r (r < 4) and the
// G columns 4 tx + k (k < 4), and the output columns tx + 16 k (k < DP/16)
// of P padded to DP in {32, 64, 128}. Masked pairs are skipped (W = 0),
// never exp'd: an upper-triangle exp(cum_i - cum_j) can overflow. Offsets
// are 64-bit.
//
// Bound on an H100: operations. At the serve prefill's shape (B = 4,
// S = 2048, H = 64, P = 64, N = 128, Q = 256; 2048 cells) the causal half
// of the three products is 34.4 GFLOP, >= 0.51 ms at the 67 TFLOP/s of fp32
// outside the tensor cores; the bytes (x, Y, S_chunk, dt and B/C read once
// at (B, S, 1, N)) are about 0.35 GB, 0.10 ms at 3.35 TB/s. This kernel
// computes whole 64 x 64 diagonal tiles, runs on the CUDA cores and keeps
// TF32 off; wgmma, TMA staging and one block per cell are later work.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int T = 64;            // rows of a tile (chunk rows, N rows)
constexpr int NS = 32;           // N-slice of the G product
constexpr int PT = T + 4;        // pitch of the transposed / B tiles
constexpr int QMAX = 256;

struct Args {
  const float* x;
  const float* dt;
  const float* A;
  const float* Bm;
  const float* Cm;
  float* y;
  float* s;
  float* tot;
  int64_t xs[4], ds[3], bs[4], cs[4];  // element strides (b, s, head, ·)
  int64_t as;
  int64_t nc;
  int H, P, N, Q;
  int nrt;                             // row tiles of the chunk
};

// cum of the block's cell into s_cum, dt into s_dt (all Q rows)
__device__ __forceinline__ void cell_cum(const Args& a, int64_t b, int64_t c,
                                         int h, float* s_dt, float* s_cum) {
  const float Ah = a.A[h * a.as];
  for (int q = threadIdx.x; q < a.Q; q += THREADS) {
    const float d = a.dt[b * a.ds[0] + (c * a.Q + q) * a.ds[1] + h * a.ds[2]];
    s_dt[q] = d;
    s_cum[q] = __fmul_rn(d, Ah);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double acc = 0.0;
#pragma unroll 8
    for (int q = 0; q < a.Q; ++q) {
      acc = __dadd_rn(acc, (double)s_cum[q]);
      s_cum[q] = __double2float_rn(acc);
    }
  }
  __syncthreads();
}

template <int DP>
__global__ void __launch_bounds__(THREADS)
    ssd_intra_chunk_kernel(const Args a) {
  constexpr int OC = DP / 16;    // output columns per thread
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* s_dt = smem;            // QMAX
  float* s_cum = s_dt + QMAX;    // QMAX
  float* xs = s_cum + QMAX;      // T x DP: x * dt (Y) or x * dt * decay (S)
  float* t1 = xs + T * DP;       // T x PT: W^T (Y) or B tile (S)
  float* cs = t1 + T * PT;       // NS x PT: C slice, transposed (Y)
  float* bsl = cs + NS * PT;     // NS x PT: B slice, transposed (Y)

  const int t = threadIdx.x, tx = t % 16, ty = t / 16;
  const int64_t cell = blockIdx.x;
  const int h = (int)(cell % a.H);
  const int64_t c = (cell / a.H) % a.nc;
  const int64_t b = cell / (a.H * a.nc);
  const int64_t row0 = c * a.Q;  // first sequence row of the chunk

  cell_cum(a, b, c, h, s_dt, s_cum);
  const float* xb = a.x + b * a.xs[0] + h * a.xs[2];
  const float* Bb = a.Bm + b * a.bs[0] + h * a.bs[2];

  float acc[4][OC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int k = 0; k < OC; ++k) acc[r][k] = 0.0f;

  if ((int)blockIdx.y < a.nrt) {
    // ---------------------------- Y block --------------------------------
    const int i0 = (a.nrt - 1 - (int)blockIdx.y) * T;  // heaviest first
    const float* Cb = a.Cm + b * a.cs[0] + h * a.cs[2];
    for (int j0 = 0; j0 <= i0; j0 += T) {
      float g[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int k = 0; k < 4; ++k) g[r][k] = 0.0f;
      for (int n0 = 0; n0 < a.N; n0 += NS) {
        __syncthreads();  // the previous slice's readers are done
        for (int e = t; e < T * NS; e += THREADS) {
          const int r = e / NS, n = e % NS;
          float cv = 0.0f, bv = 0.0f;
          if (n0 + n < a.N) {
            if (i0 + r < a.Q)
              cv = Cb[(row0 + i0 + r) * a.cs[1] + (n0 + n) * a.cs[3]];
            if (j0 + r < a.Q)
              bv = Bb[(row0 + j0 + r) * a.bs[1] + (n0 + n) * a.bs[3]];
          }
          cs[n * PT + r] = cv;
          bsl[n * PT + r] = bv;
        }
        __syncthreads();
#pragma unroll 8
        for (int n = 0; n < NS; ++n) {
          const float4 cv = *reinterpret_cast<const float4*>(cs + n * PT +
                                                             4 * ty);
          const float4 bv = *reinterpret_cast<const float4*>(bsl + n * PT +
                                                             4 * tx);
          const float cr[4] = {cv.x, cv.y, cv.z, cv.w};
          const float bk[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int k = 0; k < 4; ++k)
              g[r][k] = __fmaf_rn(cr[r], bk[k], g[r][k]);
        }
      }
      // W = G * L (0 above the diagonal and past Q), stored W^T; x * dt
      __syncthreads();  // the previous tile's W^T and xs readers are done
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int col = j0 + 4 * tx + k;
        float w[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = i0 + 4 * ty + r;
          w[r] = 0.0f;
          if (row < a.Q && col <= row)
            w[r] = __fmul_rn(g[r][k],
                             expf(__fsub_rn(s_cum[row], s_cum[col])));
        }
        *reinterpret_cast<float4*>(t1 + (4 * tx + k) * PT + 4 * ty) =
            make_float4(w[0], w[1], w[2], w[3]);
      }
      for (int e = t; e < T * DP; e += THREADS) {
        const int r = e / DP, p = e % DP;
        float v = 0.0f;
        if (j0 + r < a.Q && p < a.P)
          v = __fmul_rn(xb[(row0 + j0 + r) * a.xs[1] + p * a.xs[3]],
                        s_dt[j0 + r]);
        xs[r * DP + p] = v;
      }
      __syncthreads();
      const int ncol = min(T, a.Q - j0);
#pragma unroll 4
      for (int col = 0; col < ncol; ++col) {
        const float4 wv = *reinterpret_cast<const float4*>(t1 + col * PT +
                                                           4 * ty);
        const float wr[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
        for (int k = 0; k < OC; ++k) {
          const float xv = xs[col * DP + tx + 16 * k];
#pragma unroll
          for (int r = 0; r < 4; ++r)
            acc[r][k] = __fmaf_rn(wr[r], xv, acc[r][k]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = i0 + 4 * ty + r;
      if (row >= a.Q) continue;
      float* yrow = a.y + ((b * a.nc * a.Q + row0 + row) * a.H + h) *
                              (int64_t)a.P;
#pragma unroll
      for (int k = 0; k < OC; ++k) {
        const int p = tx + 16 * k;
        if (p < a.P) yrow[p] = acc[r][k];
      }
    }
  } else {
    // --------------------------- state block -----------------------------
    const int m0 = ((int)blockIdx.y - a.nrt) * T;  // first N row
    const float last = s_cum[a.Q - 1];
    for (int q0 = 0; q0 < a.Q; q0 += T) {
      __syncthreads();  // the previous tile's readers are done
      for (int e = t; e < T * T; e += THREADS) {
        const int q = e / T, n = e % T;
        float v = 0.0f;
        if (q0 + q < a.Q && m0 + n < a.N)
          v = Bb[(row0 + q0 + q) * a.bs[1] + (m0 + n) * a.bs[3]];
        t1[q * PT + n] = v;
      }
      for (int e = t; e < T * DP; e += THREADS) {
        const int q = e / DP, p = e % DP;
        float v = 0.0f;
        if (q0 + q < a.Q && p < a.P) {
          const float xdt = __fmul_rn(
              xb[(row0 + q0 + q) * a.xs[1] + p * a.xs[3]], s_dt[q0 + q]);
          v = __fmul_rn(xdt, expf(__fsub_rn(last, s_cum[q0 + q])));
        }
        xs[q * DP + p] = v;
      }
      __syncthreads();
      const int nq = min(T, a.Q - q0);
#pragma unroll 4
      for (int q = 0; q < nq; ++q) {
        const float4 bv = *reinterpret_cast<const float4*>(t1 + q * PT +
                                                           4 * ty);
        const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int k = 0; k < OC; ++k) {
          const float xv = xs[q * DP + tx + 16 * k];
#pragma unroll
          for (int r = 0; r < 4; ++r)
            acc[r][k] = __fmaf_rn(br[r], xv, acc[r][k]);
        }
      }
    }
    float* sb = a.s + (cell * (int64_t)a.N) * a.P;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int n = m0 + 4 * ty + r;
      if (n >= a.N) continue;
#pragma unroll
      for (int k = 0; k < OC; ++k) {
        const int p = tx + 16 * k;
        if (p < a.P) sb[(int64_t)n * a.P + p] = acc[r][k];
      }
    }
    if (m0 == 0 && t == 0) a.tot[cell] = expf(last);
  }
}

template <int DP>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)2 * QMAX + (size_t)T * DP +
                          (size_t)T * PT + (size_t)2 * NS * PT);
}

template <int DP>
int launch(const Args& a, int64_t cells, cudaStream_t stream) {
  const size_t smem = smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      ssd_intra_chunk_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nst = (a.N + T - 1) / T;
  dim3 grid((unsigned)cells, (unsigned)(a.nrt + nst));
  ssd_intra_chunk_kernel<DP><<<grid, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// x, dt, A, Bm, Cm: device pointers to fp32 inputs; *_st: their element
// strides (x, B, C: b, s, head, last; dt: b, s, head; A: head). y
// (B, S, H, P), s (B, nc, H, N, P), tot (B, nc, H): contiguous fp32
// outputs. Q <= 256 divides S; N <= 128; P <= 128. Returns the CUDA error
// of the launch (0 = none).
extern "C" int ssd_intra_chunk_f32(const float* x, const float* dt,
                                   const float* A, const float* Bm,
                                   const float* Cm, float* y, float* s,
                                   float* tot, long long B, long long S,
                                   int H, int P, int N, int Q,
                                   const long long* x_st,
                                   const long long* dt_st, long long a_st,
                                   const long long* b_st,
                                   const long long* c_st, void* stream) {
  Args a;
  a.x = x;
  a.dt = dt;
  a.A = A;
  a.Bm = Bm;
  a.Cm = Cm;
  a.y = y;
  a.s = s;
  a.tot = tot;
  for (int i = 0; i < 4; ++i) {
    a.xs[i] = x_st[i];
    a.bs[i] = b_st[i];
    a.cs[i] = c_st[i];
  }
  for (int i = 0; i < 3; ++i) a.ds[i] = dt_st[i];
  a.as = a_st;
  a.nc = S / Q;
  a.H = H;
  a.P = P;
  a.N = N;
  a.Q = Q;
  a.nrt = (Q + T - 1) / T;
  const int64_t cells = B * a.nc * H;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (P <= 32) return launch<32>(a, cells, st);
  if (P <= 64) return launch<64>(a, cells, st);
  return launch<128>(a, cells, st);
}
