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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

extern "C" const char* rmsnorm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
