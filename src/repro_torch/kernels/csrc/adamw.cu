// AdamW for Hopper (sm_90a): the global gradient norm and the update of every
// parameter leaf, with the moments updated in place.
//
// Replaces no TPU kernel.  It computes src/repro/training/optimizer.py::adamw_update
// (the per-leaf `upd` at :87-94 and `global_norm` at :65-68), which the JAX package
// runs as XLA's fused loops under jax.jit with the state donated.  Port-only kernel
// B9.
//
// Bound: memory.  The update reads p, g, m, v and writes p, m, v once (22 bytes a
// bf16 parameter with f32 moments), and the norm reads g once more (2 bytes); ~16
// f32 operations an element are far below the card's ~20 operations a byte at
// 67 TFLOP/s f32 over 3.35 TB/s.
//
// Design: three launches a step over a table of up to kMaxLeaves leaves, passed by
// value in the kernel's parameters (more leaves take one more norm and update launch
// each).  A leaf is cut into chunks of kChunk elements, 8 a thread, numbered across
// the table; block b takes the chunks b, b + grid, b + 2 grid, ... of every leaf in
// turn, so small leaves spread over the blocks and no block searches for its leaf.
// Where a leaf's pointers are 16-byte aligned a thread moves its 8 elements as 16-byte
// vectors (one for bf16, two for f32); otherwise, and in a leaf's last chunk, one
// element at a time.  Offsets are 64-bit: granite's stacked expert leaf holds
// 32 x 40 x 1536 x 512 = 1.007 B elements.
// - adamw_norm_kernel: a fixed grid, one block a partial (adamw.py NORM_BLOCKS, passed
//   in as `nparts`); each thread sums the f32 squares of its 8 elements and adds the
//   chunk's sum to an f64 accumulator, and the block reduces its threads' sums in a
//   fixed tree into one f64 partial (the next launch of a longer table adds to it).
//   On a mesh each rank sums the leaves whose block it holds first (coordinate 0 on
//   every replicated mesh dim) and the partials are summed over the ranks elementwise
//   between the two kernels.  The grid, 8 blocks of 256 threads an SM, is one wave.
// - adamw_finish_kernel: one block sums the partials in a fixed order and writes
//   gnorm = sqrt(sum) and scale = min(1, clip / (gnorm + 1e-9)) to device memory,
//   rounded as torch rounds its ops (clip * (1 / (gnorm + 1e-9f))).  No atomics
//   anywhere: two calls are bit-identical, and nothing waits for the host.
// - adamw_update_kernel: per element, in the plain version's order of torch ops and
//   with its roundings (the _rn intrinsics, which nvcc never contracts into an FMA):
//   g = f32(g) * scale; m = b1 m + (1 - b1) g; v = b2 v + (1 - b2) g g;
//   delta = (m / bc1) / (sqrt(v / bc2) + eps) + wd f32(p); p = round(f32(p) - lr delta).
//   m and v are written in place; scale, lr, bc1 and bc2 are read from device memory.
//   (p, g) may be bf16 or f32 each: gradient accumulation hands f32 grads to bf16
//   parameters.  The grid is one wave: as many blocks as the SMs hold at once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxLeaves = 32;  // adamw.py MAX_LEAVES
constexpr int kThreads = 256;
constexpr int kVec = 8;  // elements a thread takes of a chunk
constexpr int64_t kChunk = kThreads * kVec;

struct NormTable {
  const void* g[kMaxLeaves];
  int64_t n[kMaxLeaves];
  int64_t first[kMaxLeaves];  // the leaf's first chunk number, modulo the grid
  int8_t g_bf16[kMaxLeaves];
  int8_t aligned[kMaxLeaves];
  int leaves;
  int accumulate;  // add to the partials (a later launch of a longer table)
};

struct UpdateTable {
  void* p[kMaxLeaves];
  const void* g[kMaxLeaves];
  float* m[kMaxLeaves];
  float* v[kMaxLeaves];
  int64_t n[kMaxLeaves];
  int64_t first[kMaxLeaves];
  int8_t kind[kMaxLeaves];  // 2 * (p is bf16) + (g is bf16)
  int8_t aligned[kMaxLeaves];
  int leaves;
};

struct Consts {
  float b1, omb1, b2, omb2, eps, wd;  // omb = 1 - b, formed in double and rounded once
};

struct Scalars {
  float scale, lr, bc1, bc2;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// 8 consecutive elements, 16-byte aligned, as f32.
__device__ __forceinline__ void load8(const float* src, float (&o)[kVec]) {
  const float4 a = reinterpret_cast<const float4*>(src)[0];
  const float4 b = reinterpret_cast<const float4*>(src)[1];
  o[0] = a.x, o[1] = a.y, o[2] = a.z, o[3] = a.w, o[4] = b.x, o[5] = b.y, o[6] = b.z, o[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* src, float (&o)[kVec]) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    o[2 * k] = f.x;
    o[2 * k + 1] = f.y;
  }
}
__device__ __forceinline__ void store8(float* dst, const float (&o)[kVec]) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(o[0], o[1], o[2], o[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(o[4], o[5], o[6], o[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* dst, const float (&o)[kVec]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(o[2 * k], o[2 * k + 1]);
  *reinterpret_cast<uint4*>(dst) = u;
}

// The first chunk of a leaf that this block takes.
__device__ __forceinline__ int64_t first_chunk(int64_t leaf_first) {
  const int64_t grid = gridDim.x;
  return (static_cast<int64_t>(blockIdx.x) - leaf_first + grid) % grid;
}

// A block's threads' f64 sums, reduced in a fixed tree; the total in thread 0.
__device__ __forceinline__ double block_sum(double s, double* red) {
  red[threadIdx.x] = s;
  __syncthreads();
#pragma unroll
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  return red[0];
}

template <typename G>
__device__ __forceinline__ double leaf_sumsq(const G* g, int64_t n, int64_t first, bool aligned) {
  const int64_t chunks = (n + kChunk - 1) / kChunk;
  double acc = 0.0;
  for (int64_t c = first_chunk(first); c < chunks; c += gridDim.x) {
    const int64_t i = c * kChunk + threadIdx.x * kVec;
    float x[kVec];
    if (aligned && i + kVec <= n) {
      load8(g + i, x);
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) x[j] = i + j < n ? to_f32(g[i + j]) : 0.f;
    }
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < kVec; ++j) s = fmaf(x[j], x[j], s);
    acc += static_cast<double>(s);
  }
  return acc;
}

__global__ void __launch_bounds__(kThreads) adamw_norm_kernel(const NormTable t, double* partials) {
  __shared__ double red[kThreads];
  double acc = 0.0;
  for (int l = 0; l < t.leaves; ++l) {
    acc += t.g_bf16[l]
               ? leaf_sumsq(static_cast<const __nv_bfloat16*>(t.g[l]), t.n[l], t.first[l], t.aligned[l])
               : leaf_sumsq(static_cast<const float*>(t.g[l]), t.n[l], t.first[l], t.aligned[l]);
  }
  const double total = block_sum(acc, red);
  if (threadIdx.x == 0) partials[blockIdx.x] = t.accumulate ? partials[blockIdx.x] + total : total;
}

__global__ void __launch_bounds__(kThreads)
adamw_finish_kernel(const double* partials, int nparts, float clip, float* out) {
  __shared__ double red[kThreads];
  double s = 0.0;
  for (int i = threadIdx.x; i < nparts; i += kThreads) s += partials[i];
  const double total = block_sum(s, red);
  if (threadIdx.x == 0) {
    const float gnorm = static_cast<float>(sqrt(total));
    // torch: clamp(clip / (gnorm + 1e-9), max=1): Tensor.__rtruediv__ is reciprocal() * clip
    const float r = __fmul_rn(__fdiv_rn(1.0f, __fadd_rn(gnorm, 1e-9f)), clip);
    out[0] = gnorm;
    out[1] = isnan(r) ? r : fminf(r, 1.0f);
  }
}

__device__ __forceinline__ float adamw_elem(float p, float g, float& m, float& v, const Scalars& s,
                                            const Consts& c) {
  const float gs = __fmul_rn(g, s.scale);
  m = __fadd_rn(__fmul_rn(m, c.b1), __fmul_rn(gs, c.omb1));
  v = __fadd_rn(__fmul_rn(v, c.b2), __fmul_rn(__fmul_rn(gs, gs), c.omb2));
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, s.bc2)), c.eps);
  const float delta = __fadd_rn(__fdiv_rn(__fdiv_rn(m, s.bc1), den), __fmul_rn(p, c.wd));
  return __fsub_rn(p, __fmul_rn(s.lr, delta));
}

template <typename P, typename G>
__device__ __forceinline__ void update_leaf(const UpdateTable& t, int l, const Scalars& s,
                                            const Consts& c) {
  P* p = static_cast<P*>(t.p[l]);
  const G* g = static_cast<const G*>(t.g[l]);
  float* m = t.m[l];
  float* v = t.v[l];
  const int64_t n = t.n[l];
  const int64_t chunks = (n + kChunk - 1) / kChunk;
  for (int64_t ch = first_chunk(t.first[l]); ch < chunks; ch += gridDim.x) {
    const int64_t i = ch * kChunk + threadIdx.x * kVec;
    if (t.aligned[l] && i + kVec <= n) {
      float pv[kVec], gv[kVec], mv[kVec], vv[kVec];
      load8(p + i, pv);
      load8(g + i, gv);
      load8(m + i, mv);
      load8(v + i, vv);
#pragma unroll
      for (int j = 0; j < kVec; ++j) pv[j] = adamw_elem(pv[j], gv[j], mv[j], vv[j], s, c);
      store8(m + i, mv);
      store8(v + i, vv);
      store8(p + i, pv);
    } else {
      for (int64_t k = i; k < i + kVec && k < n; ++k) {
        float mk = m[k], vk = v[k];
        const float pk = adamw_elem(to_f32(p[k]), to_f32(g[k]), mk, vk, s, c);
        m[k] = mk;
        v[k] = vk;
        p[k] = from_f32<P>(pk);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
adamw_update_kernel(const UpdateTable t, const Consts c, const float* scale, const float* lr,
                    const float* bc1, const float* bc2) {
  const Scalars s{*scale, *lr, *bc1, *bc2};
  for (int l = 0; l < t.leaves; ++l) {
    switch (t.kind[l]) {
      case 0: update_leaf<float, float>(t, l, s, c); break;
      case 1: update_leaf<float, __nv_bfloat16>(t, l, s, c); break;
      case 2: update_leaf<__nv_bfloat16, float>(t, l, s, c); break;
      default: update_leaf<__nv_bfloat16, __nv_bfloat16>(t, l, s, c); break;
    }
  }
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

}  // namespace

// The f64 partials [nparts], one a block, of the sum of squares of `leaves` gradients
// (dtype codes: 0 f32, 1 bf16), written, or added to where `accumulate` is not 0.
extern "C" int adamw_norm(int leaves, const void* const* g, const int64_t* n, const int* dtype,
                          int accumulate, int nparts, double* partials, void* stream) {
  if (leaves < 0 || leaves > kMaxLeaves || nparts <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  NormTable t{};
  int64_t first = 0;
  for (int l = 0; l < leaves; ++l) {
    if (n[l] < 0 || (dtype[l] != 0 && dtype[l] != 1)) return static_cast<int>(cudaErrorInvalidValue);
    t.g[l] = g[l];
    t.n[l] = n[l];
    t.first[l] = first % nparts;
    t.g_bf16[l] = static_cast<int8_t>(dtype[l]);
    t.aligned[l] = aligned16(g[l]);
    first += (n[l] + kChunk - 1) / kChunk;
  }
  t.leaves = leaves;
  t.accumulate = accumulate;
  adamw_norm_kernel<<<nparts, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(t, partials);
  return static_cast<int>(cudaGetLastError());
}

// gnorm and the clip scale into out[0], out[1] from `nparts` f64 partials.
extern "C" int adamw_norm_finish(const double* partials, int nparts, float clip, float* out,
                                 void* stream) {
  if (nparts <= 0) return static_cast<int>(cudaErrorInvalidValue);
  adamw_finish_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(partials, nparts, clip,
                                                                           out);
  return static_cast<int>(cudaGetLastError());
}

// The update of `leaves` leaves in place: p (dtype code p_dtype), g (g_dtype), f32 m
// and v, n elements each, contiguous.  scale, lr, bc1 and bc2 point to f32 device
// scalars; the constants come as the f32 values torch forms from the Python floats.
extern "C" int adamw_update(int leaves, void* const* p, const void* const* g, void* const* m,
                            void* const* v, const int64_t* n, const int* p_dtype,
                            const int* g_dtype, const float* scale, const float* lr,
                            const float* bc1, const float* bc2, float b1, float omb1, float b2,
                            float omb2, float eps, float wd, void* stream) {
  if (leaves < 0 || leaves > kMaxLeaves) return static_cast<int>(cudaErrorInvalidValue);
  int64_t chunks = 0;
  for (int l = 0; l < leaves; ++l) {
    if (n[l] < 0 || (p_dtype[l] != 0 && p_dtype[l] != 1) || (g_dtype[l] != 0 && g_dtype[l] != 1))
      return static_cast<int>(cudaErrorInvalidValue);
    chunks += (n[l] + kChunk - 1) / kChunk;
  }
  // one wave: as many blocks as the SMs hold at once (the kernel's registers set it)
  static int resident = 0;
  if (resident == 0) {
    int per_sm = 0, sms = 0, dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, adamw_update_kernel, kThreads, 0);
    resident = per_sm * sms > 0 ? per_sm * sms : 132;
  }
  const int grid = static_cast<int>(chunks < resident ? (chunks > 0 ? chunks : 1) : resident);
  UpdateTable t{};
  int64_t first = 0;
  for (int l = 0; l < leaves; ++l) {
    t.p[l] = p[l];
    t.g[l] = g[l];
    t.m[l] = static_cast<float*>(m[l]);
    t.v[l] = static_cast<float*>(v[l]);
    t.n[l] = n[l];
    t.first[l] = first % grid;
    t.kind[l] = static_cast<int8_t>(2 * p_dtype[l] + g_dtype[l]);
    t.aligned[l] = aligned16(p[l]) && aligned16(g[l]) && aligned16(m[l]) && aligned16(v[l]);
    first += (n[l] + kChunk - 1) / kChunk;
  }
  t.leaves = leaves;
  const Consts c{b1, omb1, b2, omb2, eps, wd};
  adamw_update_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(t, c, scale, lr,
                                                                              bc1, bc2);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* adamw_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
