// Mamba-2 SSD intra-chunk for Hopper (sm_90a): for every (chunk i, head h)
//   y[i,h]     = ((C_i B_i^T) o L) x[i,h]          in x's dtype,
//   state[i,h] = (x[i,h] o exp(cum_last - cum))^T B_i  in f32,
// with L[q, j] = exp(cum[q] - cum[j]) for q >= j and 0 above the diagonal.
// x [BNC, H, Q, HD], b and c [BNC, Q, N] (shared by the heads), cum
// [BNC, H, Q], all f32 but x (f32 or bf16).
//
// Replaces: src/repro/kernels/ssd_scan.py::ssd_intra_chunk (Pallas body _ssd_kernel).
//
// Bound: operations.  Per (chunk, head) the work is ~Q^2 N (C B^T, causal
// half) + Q^2 HD / 2 + Q HD N multiply-adds, all on f32 operands (the
// contract keeps B, C, the decay and the scores in f32), against ~4 Q
// (N + HD) bytes of x, y and the state plus B and C once per chunk.  At
// mamba2-130m's serving shapes (Q = 128..256, N = 128, HD = 64) that is
// ~90 operations per byte counted once, above the ~20 at which the CUDA
// cores' 67 TFLOP/s of f32 meet the 3.35 TB/s of device memory.  This
// kernel runs f32 FMAs on the CUDA cores, so that is its bound.  It
// recomputes C B^T for every head (B and C are shared across heads):
// reusing them across heads is later work.
//
// Design: the TPU kernel keeps a whole [Q, Q] f32 mask per (chunk, head) in
// VMEM (256 KB at Q = 256, more than a Hopper block's 227 KB of shared
// memory).  Here it is tiled: a block owns 64 rows q of one (chunk, head)
// and walks the 64-column tiles j <= its last row (causal), with C's rows,
// one tile of B's rows (all N columns), x's rows and the masked 64 x 64
// scores in shared memory (~100 KB at N = 128, HD = 64).  The decay is
// evaluated only where q >= j: above the diagonal its exponent is positive,
// and inf * 0 would be NaN.  y accumulates in f32 registers.  The chunk
// state is a reduction over all Q rows, so it has blocks of its own (one
// per 64 columns of N) beside the row blocks.  Ragged Q (128 and 160 on the
// serving path) is masked: rows and columns at or past Q are zero.
// 256 threads = 16 x 16; each owns a 4 x 4 (scores) or 4 x HD/16 (y) or
// HD/16 x 4 (state) piece, spread 16 apart so a warp reads distinct banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;   // rows q per y block; columns j per tile; rows j per state tile
constexpr int BNS = 64;  // columns n per state block
constexpr int kThreads = 256;
constexpr int kS = BQ + 1;  // row stride of the score tile

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even
}

// Row stride of the [BQ, N] tiles of B and C: odd, so the 16 rows that a
// warp's threads read at one column fall on distinct banks.
__host__ __device__ __forceinline__ int n_stride(int N) { return N | 1; }

template <int HD>
__host__ __device__ __forceinline__ size_t smem_bytes(int N) {
  const size_t y_role = 2 * BQ * n_stride(N) + BQ * HD + BQ * kS + 2 * BQ;
  const size_t state_role = BQ * HD + BQ * BNS;
  return sizeof(float) * (y_role > state_role ? y_role : state_role);
}

// y rows [q0, q0 + BQ) of one (chunk, head).
template <typename T, int HD>
__device__ __forceinline__ void y_block(const T* __restrict__ xh, const float* __restrict__ bi,
                                        const float* __restrict__ ci,
                                        const float* __restrict__ cumh, T* __restrict__ yh,
                                        int Q, int N, int q0, float* smem) {
  constexpr int KD = HD / 16;
  const int kN = n_stride(N);
  float* Cs = smem;            // [BQ][kN]  C rows q0..
  float* Bs = Cs + BQ * kN;    // [BQ][kN]  B rows j0..
  float* Xs = Bs + BQ * kN;    // [BQ][HD]  x rows j0.., f32
  float* Ss = Xs + BQ * HD;    // [BQ][kS]  masked scores
  float* cq = Ss + BQ * kS;    // [BQ]
  float* cj = cq + BQ;         // [BQ]
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  for (int idx = threadIdx.x; idx < BQ * N; idx += kThreads) {
    const int r = idx / N, n = idx - r * N;
    Cs[r * kN + n] = q0 + r < Q ? ci[static_cast<int64_t>(q0 + r) * N + n] : 0.f;
  }
  if (threadIdx.x < BQ) cq[threadIdx.x] = q0 + threadIdx.x < Q ? cumh[q0 + threadIdx.x] : 0.f;

  float acc[4][KD];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int k = 0; k < KD; ++k) acc[a][k] = 0.f;

  const int j_end = min(Q, q0 + BQ);  // causal: columns past the block's last row add nothing
  for (int j0 = 0; j0 < j_end; j0 += BQ) {
    __syncthreads();  // the previous tile is consumed (and Cs, cq are visible)
    for (int idx = threadIdx.x; idx < BQ * N; idx += kThreads) {
      const int r = idx / N, n = idx - r * N;
      Bs[r * kN + n] = j0 + r < Q ? bi[static_cast<int64_t>(j0 + r) * N + n] : 0.f;
    }
    for (int idx = threadIdx.x; idx < BQ * HD; idx += kThreads) {
      const int r = idx / HD, d = idx - r * HD;
      Xs[idx] = j0 + r < Q ? to_float(xh[static_cast<int64_t>(j0 + r) * HD + d]) : 0.f;
    }
    if (threadIdx.x < BQ) cj[threadIdx.x] = j0 + threadIdx.x < Q ? cumh[j0 + threadIdx.x] : 0.f;
    __syncthreads();

    // scores s[q][j] = C_q . B_j for q = ty + 16 a, j = tx + 16 b
    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) s[a][b] = 0.f;
    for (int n = 0; n < N; ++n) {
      float cv[4], bv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) cv[a] = Cs[(ty + 16 * a) * kN + n];
#pragma unroll
      for (int b = 0; b < 4; ++b) bv[b] = Bs[(tx + 16 * b) * kN + n];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) s[a][b] = fmaf(cv[a], bv[b], s[a][b]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int r = ty + 16 * a, c = tx + 16 * b;
        const int q = q0 + r, j = j0 + c;
        // exp only where q >= j (both inside the chunk): above the diagonal
        // the exponent is positive and could overflow to inf
        const float l = (q >= j && q < Q) ? expf(cq[r] - cj[c]) : 0.f;
        Ss[r * kS + c] = s[a][b] * l;
      }
    __syncthreads();

    // y[q][d] += sum_j S[q][j] x[j][d] for q = ty + 16 a, d = tx + 16 k
#pragma unroll 4
    for (int c = 0; c < BQ; ++c) {
      float sv[4], xv[KD];
#pragma unroll
      for (int a = 0; a < 4; ++a) sv[a] = Ss[(ty + 16 * a) * kS + c];
#pragma unroll
      for (int k = 0; k < KD; ++k) xv[k] = Xs[c * HD + tx + 16 * k];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int k = 0; k < KD; ++k) acc[a][k] = fmaf(sv[a], xv[k], acc[a][k]);
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int q = q0 + ty + 16 * a;
    if (q < Q) {
#pragma unroll
      for (int k = 0; k < KD; ++k)
        yh[static_cast<int64_t>(q) * HD + tx + 16 * k] = from_float<T>(acc[a][k]);
    }
  }
}

// state columns [n0, n0 + BNS) of one (chunk, head): sum over all rows j.
template <typename T, int HD>
__device__ __forceinline__ void state_block(const T* __restrict__ xh,
                                            const float* __restrict__ bi,
                                            const float* __restrict__ cumh,
                                            float* __restrict__ sth, int Q, int N, int n0,
                                            float* smem) {
  constexpr int KD = HD / 16;
  float* Xs = smem;           // [BQ][HD]   x rows j0.. times exp(cum_last - cum_j)
  float* Bs = Xs + BQ * HD;   // [BQ][BNS]  B rows j0.., columns n0..
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float c_last = cumh[Q - 1];

  float acc[KD][4];
#pragma unroll
  for (int k = 0; k < KD; ++k)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[k][b] = 0.f;

  for (int j0 = 0; j0 < Q; j0 += BQ) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < BQ * HD; idx += kThreads) {
      const int r = idx / HD, d = idx - r * HD;
      const int j = j0 + r;
      Xs[idx] = j < Q ? to_float(xh[static_cast<int64_t>(j) * HD + d]) * expf(c_last - cumh[j])
                      : 0.f;
    }
    for (int idx = threadIdx.x; idx < BQ * BNS; idx += kThreads) {
      const int r = idx / BNS, n = n0 + idx - r * BNS;
      Bs[idx] = (j0 + r < Q && n < N) ? bi[static_cast<int64_t>(j0 + r) * N + n] : 0.f;
    }
    __syncthreads();
    // state[d][n] += sum_j xw[j][d] B[j][n] for d = ty + 16 k, n = tx + 16 b
#pragma unroll 4
    for (int r = 0; r < BQ; ++r) {
      float xv[KD], bv[4];
#pragma unroll
      for (int k = 0; k < KD; ++k) xv[k] = Xs[r * HD + ty + 16 * k];
#pragma unroll
      for (int b = 0; b < 4; ++b) bv[b] = Bs[r * BNS + tx + 16 * b];
#pragma unroll
      for (int k = 0; k < KD; ++k)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[k][b] = fmaf(xv[k], bv[b], acc[k][b]);
    }
  }

#pragma unroll
  for (int k = 0; k < KD; ++k)
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int n = n0 + tx + 16 * b;
      if (n < N) sth[static_cast<int64_t>(ty + 16 * k) * N + n] = acc[k][b];
    }
}

// grid (row tiles + state tiles, H, BNC)
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
ssd_intra_chunk_kernel(const T* __restrict__ x, const float* __restrict__ b,
                       const float* __restrict__ c, const float* __restrict__ cum,
                       T* __restrict__ y, float* __restrict__ state, int H, int Q, int N,
                       int row_tiles) {
  extern __shared__ __align__(16) float smem[];
  const int64_t ih = static_cast<int64_t>(blockIdx.z) * H + blockIdx.y;
  const T* xh = x + ih * Q * HD;
  const float* bi = b + static_cast<int64_t>(blockIdx.z) * Q * N;
  const float* ci = c + static_cast<int64_t>(blockIdx.z) * Q * N;
  const float* cumh = cum + ih * Q;
  if (static_cast<int>(blockIdx.x) < row_tiles) {
    y_block<T, HD>(xh, bi, ci, cumh, y + ih * Q * HD, Q, N, blockIdx.x * BQ, smem);
  } else {
    state_block<T, HD>(xh, bi, cumh, state + ih * HD * N, Q, N,
                       (blockIdx.x - row_tiles) * BNS, smem);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* x, const float* b, const float* c, const float* cum, void* y,
                   float* state, int BNC, int H, int Q, int N, cudaStream_t stream) {
  auto kernel = ssd_intra_chunk_kernel<T, HD>;
  const size_t bytes = smem_bytes<HD>(N);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const int row_tiles = (Q + BQ - 1) / BQ;
  const dim3 grid(row_tiles + (N + BNS - 1) / BNS, H, BNC);
  kernel<<<grid, kThreads, bytes, stream>>>(static_cast<const T*>(x), b, c, cum,
                                            static_cast<T*>(y), state, H, Q, N, row_tiles);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int HD, const void* x, const float* b, const float* c, const float* cum,
                        void* y, float* state, int BNC, int H, int Q, int N, cudaStream_t s) {
  switch (HD) {
    case 32: return launch<T, 32>(x, b, c, cum, y, state, BNC, H, Q, N, s);
    case 64: return launch<T, 64>(x, b, c, cum, y, state, BNC, H, Q, N, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Dynamic shared memory one block needs, in bytes (0 for an unsupported head dim).
extern "C" int64_t ssd_intra_chunk_smem_bytes(int HD, int N) {
  switch (HD) {
    case 32: return static_cast<int64_t>(smem_bytes<32>(N));
    case 64: return static_cast<int64_t>(smem_bytes<64>(N));
    default: return 0;
  }
}

// dtype of x and y: 0 = float32, 1 = bfloat16.  x, y [BNC, H, Q, HD];
// b, c [BNC, Q, N], cum [BNC, H, Q] and state [BNC, H, HD, N] are f32; all
// contiguous.  Returns cudaGetLastError() after the launch.
extern "C" int ssd_intra_chunk_fwd(int dtype, int HD, const void* x, const float* b,
                                   const float* c, const float* cum, void* y, float* state,
                                   int BNC, int H, int Q, int N, void* stream) {
  if (BNC <= 0 || H <= 0 || Q <= 0 || N <= 0 || BNC > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(dispatch_hd<float>(HD, x, b, c, cum, y, state, BNC, H, Q, N, s));
    case 1:
      return static_cast<int>(
          dispatch_hd<__nv_bfloat16>(HD, x, b, c, cum, y, state, BNC, H, Q, N, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
