// RMSNorm over the rows of x [T, D] for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/rmsnorm.py::rmsnorm (Pallas body _rmsnorm_kernel).
//
// Bound: memory.  The kernel reads T*D elements of x and D of the weight and
// writes T*D elements, with ~4 operations per element: far below the card's
// ~295 operations per byte, so its least time is bytes / 3.35 TB/s.
//
// Design: one block of 128 threads per row (rows may be strided).  Each thread takes 16-byte
// vectors (8 bf16 or 4 f32) where D is a multiple of the vector width and
// the pointers are 16-byte aligned, and single elements otherwise (so
// D = 960 takes the vector path, any D works).  The sum of squares is f32,
// reduced with warp shuffles and then across the 4 warps in shared memory.
// The second pass re-reads the row, which the first pass left in L1, so x
// crosses device memory once.  Any T: the grid has one block per row (no
// T % block_rows restriction as on the TPU).
//
// Rounding is the reference's order: out = bf16(float(bf16(x * r)) * float(w))
// with r = 1/sqrt(mean(x^2) + eps) in f32, i.e. the normalized row is rounded
// to the working type BEFORE the weight multiply.  The product of two bf16
// values is exact in f32, so the final rounding matches XLA's bf16 multiply.
//
// Backward (no TPU counterpart: the JAX package differentiates the plain
// norm).  With n = dy * w rounded to the working type (the reference's bf16
// multiply) and r as above, dx = r n - x r^3 sum(n x) / D, and dweight =
// sum over rows of dy * round(x r).  Bound: memory again (x, dy read, dx
// written, ~10 operations per element).  rmsnorm_bwd gives each block of
// 128 threads rows_per_block consecutive rows: one pass for the two row
// sums (sum x^2 and sum n x, reduced together), one for dx, which also adds
// dy * round(x r) into the block's f32 column sums in shared memory (each
// thread owns the same columns in every row, so no two threads touch one
// sum).  The block writes its column sums as one row of an f32 partials
// buffer; rmsnorm_bwd_dweight then sums the partials of each column in a
// fixed order (8 slices of rows per 32 columns, then the 8 slices) and
// rounds once.  No atomics: the result does not depend on block order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even
}

// 16 bytes of T as a register array.
template <typename T>
struct alignas(16) Pack {
  static constexpr int N = 16 / sizeof(T);
  T v[N];
};

__device__ __forceinline__ float block_sum(float s, float* scratch) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) scratch[warp] = s;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) total += scratch[w];
  return total;
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
               int64_t dim, int64_t x_stride, float eps) {
  __shared__ float scratch[kThreads / 32];
  const int64_t row = blockIdx.x;
  const T* xr = x + row * x_stride;
  T* orow = out + row * dim;
  constexpr int N = Pack<T>::N;

  float ss = 0.f;
  if (kVec) {
    const Pack<T>* xp = reinterpret_cast<const Pack<T>*>(xr);
    for (int64_t i = threadIdx.x; i < dim / N; i += kThreads) {
      Pack<T> p = xp[i];
#pragma unroll
      for (int j = 0; j < N; ++j) {
        float f = to_float(p.v[j]);
        ss = fmaf(f, f, ss);
      }
    }
  } else {
    for (int64_t i = threadIdx.x; i < dim; i += kThreads) {
      float f = to_float(xr[i]);
      ss = fmaf(f, f, ss);
    }
  }
  const float var = block_sum(ss, scratch) / static_cast<float>(dim);
  const float r = 1.0f / sqrtf(var + eps);

  if (kVec) {
    const Pack<T>* xp = reinterpret_cast<const Pack<T>*>(xr);
    const Pack<T>* wp = reinterpret_cast<const Pack<T>*>(w);
    Pack<T>* op = reinterpret_cast<Pack<T>*>(orow);
    for (int64_t i = threadIdx.x; i < dim / N; i += kThreads) {
      Pack<T> p = xp[i], q = wp[i], o;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float y = to_float(from_float<T>(to_float(p.v[j]) * r));
        o.v[j] = from_float<T>(y * to_float(q.v[j]));
      }
      op[i] = o;
    }
  } else {
    for (int64_t i = threadIdx.x; i < dim; i += kThreads) {
      const float y = to_float(from_float<T>(to_float(xr[i]) * r));
      orow[i] = from_float<T>(y * to_float(w[i]));
    }
  }
}

struct Sum2 {
  float a, b;
};

// Two block sums at once; ends with a barrier so scratch can be reused.
__device__ __forceinline__ Sum2 block_sum2(float a, float b, float* scratch) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    b += __shfl_xor_sync(0xffffffffu, b, off);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    scratch[2 * warp] = a;
    scratch[2 * warp + 1] = b;
  }
  __syncthreads();
  Sum2 total{0.f, 0.f};
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) {
    total.a += scratch[2 * w];
    total.b += scratch[2 * w + 1];
  }
  __syncthreads();
  return total;
}

// One element of the backward: returns dx and adds dy * round(x r) to dw.
template <typename T>
__device__ __forceinline__ float bwd_elem(float x, float dy, float w, float r, float k, float& dw) {
  const float n = to_float(from_float<T>(dy * w));
  dw = fmaf(dy, to_float(from_float<T>(x * r)), dw);
  return r * n - x * k;
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ dy,
                   T* __restrict__ dx, float* __restrict__ dw_part, int64_t rows, int64_t dim,
                   int64_t x_stride, int rows_per_block, float eps) {
  extern __shared__ __align__(16) float colsum[];  // [dim] if dw_part, else unused
  __shared__ float scratch[2 * (kThreads / 32)];
  constexpr int N = Pack<T>::N;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * rows_per_block;
  const int64_t row_end = row0 + rows_per_block < rows ? row0 + rows_per_block : rows;
  const bool want_dw = dw_part != nullptr;
  if (want_dw)  // each thread zeroes, and later owns, the columns it visits below
    for (int64_t i = threadIdx.x; i < (kVec ? dim / N : dim); i += kThreads)
      for (int j = 0; j < (kVec ? N : 1); ++j) colsum[(kVec ? i * N : i) + j] = 0.f;

  for (int64_t row = row0; row < row_end; ++row) {
    const T* xr = x + row * x_stride;
    const T* gr = dy + row * dim;
    T* dr = dx + row * dim;
    float ss = 0.f, dot = 0.f;
    if (kVec) {
      const Pack<T>* xp = reinterpret_cast<const Pack<T>*>(xr);
      const Pack<T>* gp = reinterpret_cast<const Pack<T>*>(gr);
      const Pack<T>* wp = reinterpret_cast<const Pack<T>*>(w);
      for (int64_t i = threadIdx.x; i < dim / N; i += kThreads) {
        const Pack<T> a = xp[i], g = gp[i], c = wp[i];
#pragma unroll
        for (int j = 0; j < N; ++j) {
          const float f = to_float(a.v[j]);
          ss = fmaf(f, f, ss);
          dot = fmaf(to_float(from_float<T>(to_float(g.v[j]) * to_float(c.v[j]))), f, dot);
        }
      }
    } else {
      for (int64_t i = threadIdx.x; i < dim; i += kThreads) {
        const float f = to_float(xr[i]);
        ss = fmaf(f, f, ss);
        dot = fmaf(to_float(from_float<T>(to_float(gr[i]) * to_float(w[i]))), f, dot);
      }
    }
    const Sum2 tot = block_sum2(ss, dot, scratch);
    const float r = 1.0f / sqrtf(tot.a / static_cast<float>(dim) + eps);
    const float k = r * r * r * tot.b / static_cast<float>(dim);
    float unused = 0.f;
    if (kVec) {
      const Pack<T>* xp = reinterpret_cast<const Pack<T>*>(xr);
      const Pack<T>* gp = reinterpret_cast<const Pack<T>*>(gr);
      const Pack<T>* wp = reinterpret_cast<const Pack<T>*>(w);
      Pack<T>* op = reinterpret_cast<Pack<T>*>(dr);
      for (int64_t i = threadIdx.x; i < dim / N; i += kThreads) {
        const Pack<T> a = xp[i], g = gp[i], c = wp[i];
        Pack<T> o;
#pragma unroll
        for (int j = 0; j < N; ++j)
          o.v[j] = from_float<T>(bwd_elem<T>(to_float(a.v[j]), to_float(g.v[j]),
                                             to_float(c.v[j]), r, k,
                                             want_dw ? colsum[i * N + j] : unused));
        op[i] = o;
      }
    } else {
      for (int64_t i = threadIdx.x; i < dim; i += kThreads)
        dr[i] = from_float<T>(bwd_elem<T>(to_float(xr[i]), to_float(gr[i]), to_float(w[i]), r, k,
                                          want_dw ? colsum[i] : unused));
    }
  }
  if (want_dw) {
    float* out = dw_part + static_cast<int64_t>(blockIdx.x) * dim;
    for (int64_t i = threadIdx.x; i < (kVec ? dim / N : dim); i += kThreads)
      for (int j = 0; j < (kVec ? N : 1); ++j) {
        const int64_t c = kVec ? i * N + j : i;
        out[c] = colsum[c];
      }
  }
}

constexpr int kReduceCols = 32, kReduceSlices = 8;  // 256 threads per block

// dw[c] = sum over the nparts rows of part[:, c], in a fixed order, rounded once.
template <typename T>
__global__ void __launch_bounds__(kReduceCols * kReduceSlices)
rmsnorm_dweight_kernel(const float* __restrict__ part, T* __restrict__ dw, int nparts,
                       int64_t dim) {
  __shared__ float red[kReduceSlices][kReduceCols + 1];
  const int lane = threadIdx.x % kReduceCols, slice = threadIdx.x / kReduceCols;
  const int64_t col = static_cast<int64_t>(blockIdx.x) * kReduceCols + lane;
  float s = 0.f;
  if (col < dim)
    for (int p = slice; p < nparts; p += kReduceSlices) s += part[p * dim + col];
  red[slice][lane] = s;
  __syncthreads();
  if (slice == 0 && col < dim) {
    float total = 0.f;
#pragma unroll
    for (int i = 0; i < kReduceSlices; ++i) total += red[i][lane];
    dw[col] = from_float<T>(total);
  }
}

template <typename T>
bool vec_ok(int64_t dim, int64_t x_stride, std::initializer_list<const void*> ptrs) {
  uintptr_t bits = 0;
  for (const void* p : ptrs) bits |= reinterpret_cast<uintptr_t>(p);
  return dim % Pack<T>::N == 0 && x_stride % Pack<T>::N == 0 && bits % 16 == 0;
}

template <typename T>
cudaError_t launch_bwd(const void* x, const void* w, const void* dy, void* dx, void* dw_part,
                       int64_t rows, int64_t dim, int64_t x_stride, int rows_per_block,
                       int blocks, int64_t smem, float eps, cudaStream_t stream) {
  const int64_t want_blocks = (rows + rows_per_block - 1) / rows_per_block;
  const int64_t want_smem = dw_part != nullptr ? dim * static_cast<int64_t>(sizeof(float)) : 0;
  if (rows_per_block <= 0 || blocks != want_blocks || smem != want_smem)
    return cudaErrorInvalidConfiguration;
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  const T* gp = static_cast<const T*>(dy);
  T* dp = static_cast<T*>(dx);
  float* part = static_cast<float*>(dw_part);
  auto kernel = vec_ok<T>(dim, x_stride, {x, w, dy, dx}) ? rmsnorm_bwd_kernel<T, true>
                                                         : rmsnorm_bwd_kernel<T, false>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kThreads, smem, stream>>>(xp, wp, gp, dp, part, rows, dim, x_stride,
                                             rows_per_block, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* out, int64_t rows, int64_t dim,
                   int64_t x_stride, float eps, cudaStream_t stream) {
  const bool vec = dim % Pack<T>::N == 0 && x_stride % Pack<T>::N == 0 &&
                   (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
                    reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  const dim3 grid(static_cast<unsigned>(rows));
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  T* op = static_cast<T*>(out);
  if (vec)
    rmsnorm_kernel<T, true><<<grid, kThreads, 0, stream>>>(xp, wp, op, dim, x_stride, eps);
  else
    rmsnorm_kernel<T, false><<<grid, kThreads, 0, stream>>>(xp, wp, op, dim, x_stride, eps);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  x is [rows, dim] with rows x_stride
// elements apart and contiguous within a row; out is contiguous [rows, dim];
// w is [dim]; all of one dtype.  Returns cudaGetLastError() after the launch.
extern "C" int rmsnorm_fwd(int dtype, const void* x, const void* w, void* out, int64_t rows,
                           int64_t dim, int64_t x_stride, float eps, void* stream) {
  if (rows <= 0 || rows > 0x7fffffff || dim <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(launch<float>(x, w, out, rows, dim, x_stride, eps, s));
    case 1: return static_cast<int>(launch<__nv_bfloat16>(x, w, out, rows, dim, x_stride, eps, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Backward, first kernel: dx [rows, dim] (contiguous, like dy) and, if
// dw_part is not null, one row of f32 column sums of dy * round(x r) per
// block into dw_part [blocks, dim].  rows_per_block, blocks and smem are
// rmsnorm.py::bwd_plan's (smem = dim * 4 with dw_part, else 0); another
// plan returns cudaErrorInvalidConfiguration.
extern "C" int rmsnorm_bwd(int dtype, const void* x, const void* w, const void* dy, void* dx,
                           void* dw_part, int64_t rows, int64_t dim, int64_t x_stride,
                           int rows_per_block, int blocks, int64_t smem, float eps,
                           void* stream) {
  if (rows <= 0 || dim <= 0 || smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(launch_bwd<float>(x, w, dy, dx, dw_part, rows, dim, x_stride,
                                                rows_per_block, blocks, smem, eps, s));
    case 1:
      return static_cast<int>(launch_bwd<__nv_bfloat16>(x, w, dy, dx, dw_part, rows, dim,
                                                        x_stride, rows_per_block, blocks, smem,
                                                        eps, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Backward, second kernel: dw [dim] in the working type from the
// [nparts, dim] f32 partials of rmsnorm_bwd.
extern "C" int rmsnorm_bwd_dweight(int dtype, const void* dw_part, void* dw, int nparts,
                                   int64_t dim, void* stream) {
  if (nparts <= 0 || dim <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((dim + kReduceCols - 1) / kReduceCols));
  const float* part = static_cast<const float*>(dw_part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      rmsnorm_dweight_kernel<float><<<grid, kReduceCols * kReduceSlices, 0, s>>>(
          part, static_cast<float*>(dw), nparts, dim);
      break;
    case 1:
      rmsnorm_dweight_kernel<__nv_bfloat16><<<grid, kReduceCols * kReduceSlices, 0, s>>>(
          part, static_cast<__nv_bfloat16*>(dw), nparts, dim);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rmsnorm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
