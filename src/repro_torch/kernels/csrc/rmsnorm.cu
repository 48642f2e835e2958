// RMSNorm over the rows of x [T, D] for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/rmsnorm.py::rmsnorm (Pallas body _rmsnorm_kernel).
//
// Bound: memory.  The kernel reads T*D elements of x and D of the weight and
// writes T*D elements, with ~4 operations per element: far below the card's
// ~295 operations per byte, so its least time is bytes / 3.35 TB/s.
//
// Design: a warp per row for rows up to 2048 elements ("warp" route,
// rmsnorm_warp_kernel), the layout of the backward's warp route below.  The
// row lives in the warp's registers: lane l holds the row's 16-byte chunks l,
// l + 32, ... (at most 8 a lane in bf16, 16 in f32), and the weight's same
// chunks, loaded once per warp and kept for every row the warp takes.  The
// loads of x and w are issued together, before either is used; the sum of
// squares is an f32 xor-shuffle in a fixed lane order, with no shared memory
// and no block barrier, and the output is rounded and stored from the same
// registers, so x crosses memory once and is read once.  The lane keeps four
// partial sums in the block route's order (sum k: the chunks that route's
// thread l + 32 k takes), so both routes give the same bits at every D.
// bf16 pairs are normalised in packed form (two products rounded to a bf16x2
// at once, then one bf16x2 multiply by w): the row's instructions, not its
// bytes, are a warp's share of the chain, and the weight kept as loaded, not
// as f32, leaves every bf16 row at <= 128 registers, so 16 warps an SM.  D
// that is not a multiple of the vector width, unaligned pointers and row
// strides take the same route an element at a time (lane l: elements l,
// l + 32, ...).
// The launch plan is rmsnorm.py::fwd_plan, which the entry recomputes and
// holds the call to: a grid of at most one block per SM, as many warps a
// block as spread the rows over every SM (T = 1024: 128 blocks of 8 warps),
// at most 16 (8 where the row takes more than 32 registers a lane); past 16
// rows an SM a warp walks several consecutive rows of its block, and issues
// the next row's loads before this row's stores.  The route is a
// programmatic dependent launch: its grid starts while the kernel before it
// on the stream ends, and waits for it before the first read, so the output
// is the same bit for bit and the launch's latency overlaps its predecessor.
// Why so: the block-per-row kernel it replaces at these widths
// waited on a block barrier between two passes over the row and re-read w
// from L2 for every row, so at T <= ~1500, where every row is resident at
// once, its time was the launch plus that chain of dependent waits.
// Rows wider than 2048 keep that kernel ("block" route, rmsnorm_kernel):
// one block of 128 threads per row, 16-byte vectors where D and the
// pointers allow, the sum of squares reduced over the block's 4 warps in
// shared memory, and a second pass that re-reads the row from L1.
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
// written, ~10 operations per element).  rmsnorm_bwd runs a warp per row
// with the row in registers (up to 2048 elements: 64 a lane): the two row
// sums (sum x^2 and sum n x) are warp shuffles, dx comes from the same
// registers, and no block barrier sits in the row loop.  A persistent grid
// of at most one block per SM walks the rows, 16 warps (rows in flight) a
// block where D <= 1024 in bf16 (512 in f32), else 8; on the card 16 rows
// in flight beat 8 with each warp's next row prefetched into registers.
// Each lane keeps its columns' dweight sums in f32 registers; at the end
// the warps store them to shared memory and each column is summed over the
// warps in warp order into one row of an f32 partials buffer.
// rmsnorm_bwd_dweight then sums the partials of each column in a fixed
// order (8 slices of rows per 32 columns, then the 8 slices) and rounds
// once.  No atomics: the result does not depend on block order.  The
// column reduce stays a second launch (one block that summed every block's
// partials at the end of the first launch would read them at one SM's
// rate), made a programmatic dependent launch: it is resident and waiting
// when the first kernel's grid ends.
//
// Rows wider than 2048 (hymba-1.5b's SSM out_norm, 3200; d 4096) do not fit
// one warp's registers: a block takes a row, and the persistent grid (one
// block per SM) walks consecutive rows, one at a time per block.
// - "ring" (rmsnorm_bwd_ring_kernel), where every row is 16-byte aligned:
//   a ring of stages in shared memory is filled with the block's next rows
//   of x and dy by cp.async behind mbarriers (as many rows as 192 KB hold,
//   at most the block's rows: all 8 rows of 12.8 KB at [1024, 3200] bf16),
//   so the memory streams while rows reduce.  Two teams of threads take
//   alternate rows, so two rows reduce at once; within a team a thread
//   takes one 16-byte chunk of the row (two past 512 chunks, four past
//   1024, with one team), so D 3200 bf16 runs 2 x 416 threads.  The weight
//   is read once per block and held as f32, and dy w, rounded, is kept from
//   the first pass for dx.  The two row sums go through warp shuffles and
//   then across the team's warps (each warp reads the warps' sums from
//   shared memory, a lane each, and shuffles them); the team barrier that
//   publishes them also frees the row's stage, which the team refills at
//   once with the row `stages` ahead.  At the end team 1 hands its dweight
//   sums to team 0 through shared memory, which adds them to its own in
//   that order.  Why so: at [1024, 3200] bf16 on an H100 SXM at 700 W,
//   every extra row a block cost ~1.3 us whether the rows were bf16 or f32,
//   so the instructions and the reduction chain of each row, not the bytes,
//   set the time; one team a block with two chunks a thread ran 0.0137 ms
//   and one thread issuing bulk copies of each row ran no faster.
// On both, each thread owns fixed columns, so it keeps their dweight sums in
// f32 registers across its block's rows and writes the block's row of
// partials directly, for the same column reduce as the warp route.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

#include "hopper.cuh"

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

// VEC elements of T loaded at once: 16 bytes on the vector path, 1 otherwise.
template <typename T, int VEC>
struct alignas(VEC * sizeof(T)) Vec {
  T v[VEC];
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

// Rows up to 2048 elements ("warp" route): a warp per row, the row in
// registers.  Lane l holds the row's VEC-element chunks l, l + 32, ... (CPL of
// them) and the weight's same chunks, as loaded.  A block of `warps` warps
// takes warps * rows_per_warp consecutive rows, walked by its warps in turn
// (warp i: rows i, i + warps, ...).  kMaxWarps (launch bound): 16 where the
// row takes at most 32 registers a lane (16-byte chunks: 8; an element a
// register on the element-at-a-time form: 32), else 8; so every bf16 row up
// to 2048 keeps 16 warps an SM at <= 128 registers a thread.
constexpr int kFwdMaxPerLane = 64;  // row elements a lane keeps in registers
constexpr int kWarpMaxDim = 32 * kFwdMaxPerLane;  // rmsnorm.py FWD_WARP_MAX_DIM

template <typename T, int VEC>
constexpr int row_regs(int chunks) {  // 32-bit registers a lane's `chunks` chunks take
  return chunks * (VEC * sizeof(T) < 4 ? 1 : static_cast<int>(VEC * sizeof(T)) / 4);
}

// The sum of squares of a chunk, added in element order.
template <typename T, int VEC>
__device__ __forceinline__ float add_squares(const Vec<T, VEC>& x, float ss) {
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const float f = to_float(x.v[j]);
    ss = fmaf(f, f, ss);
  }
  return ss;
}

// round(round(x r) w) of a chunk, the reference's order.  bf16 pairs take
// the packed forms: two f32 products rounded to a bf16x2 at once, and the
// bf16x2 multiply by w, whose exact product is rounded once to nearest even,
// as bf16(float(y) * float(w)) is.
template <typename T, int VEC>
__device__ __forceinline__ Vec<T, VEC> normed(const Vec<T, VEC>& x, const Vec<T, VEC>& w, float r) {
  Vec<T, VEC> o;
  if constexpr (std::is_same_v<T, __nv_bfloat16> && VEC % 2 == 0) {
    const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(x.v);
    const __nv_bfloat162* w2 = reinterpret_cast<const __nv_bfloat162*>(w.v);
    __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(o.v);
#pragma unroll
    for (int k = 0; k < VEC / 2; ++k) {
      const float2 f = __bfloat1622float2(x2[k]);
      o2[k] = __hmul2_rn(__floats2bfloat162_rn(f.x * r, f.y * r), w2[k]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      o.v[j] = from_float<T>(to_float(from_float<T>(to_float(x.v[j]) * r)) * to_float(w.v[j]));
  }
  return o;
}

// A dependent launch (launch_dependent_fn): the grid may start while the
// kernel before it on the stream ends, and waits for it before reading.
template <typename T, int VEC, int CPL, int kMaxWarps = (row_regs<T, VEC>(CPL) <= 32 ? 16 : 8)>
__global__ void __launch_bounds__(kMaxWarps * 32)
rmsnorm_warp_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
                    int64_t rows, int dim, int64_t x_stride, int64_t rows_per_warp, float eps) {
  hopper::grid_dependency_wait();  // x and w may be the previous kernel's outputs
  hopper::launch_dependents();  // the next dependent grid may start, up to its own wait
  using V = Vec<T, VEC>;
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nchunks = dim / VEC;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * warps * rows_per_warp;
  const int64_t row_end = row0 + warps * rows_per_warp < rows ? row0 + warps * rows_per_warp : rows;
  int64_t row = row0 + warp;
  if (row >= row_end) return;
  auto zero = [](V& v) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) v.v[j] = from_float<T>(0.f);
  };
  V xa[CPL];
  auto load = [&](int64_t r) {
    const V* xp = reinterpret_cast<const V*>(x + r * x_stride);
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      if (lane + 32 * i < nchunks) xa[i] = xp[lane + 32 * i];
      else zero(xa[i]);
    }
  };
  // the first row and the weight: both loads in flight before either is used
  load(row);
  V wa[CPL];
  const V* wp = reinterpret_cast<const V*>(w);
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    if (lane + 32 * i < nchunks) wa[i] = wp[lane + 32 * i];
    else zero(wa[i]);
  }
  constexpr int K = CPL < kThreads / 32 ? CPL : kThreads / 32;
  for (;;) {
    // the block route's order of sums, so that both routes give the same bits: its thread
    // l + 32 k takes this lane's chunks k, k + 4, ... (sum k), its warp k sums them by
    // shuffles, and the 4 warps' sums are added in warp order
    float part[K];
#pragma unroll
    for (int k = 0; k < K; ++k) part[k] = 0.f;
#pragma unroll
    for (int i = 0; i < CPL; ++i) part[i % K] = add_squares(xa[i], part[i % K]);
    float ss = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) part[k] += __shfl_xor_sync(0xffffffffu, part[k], off);
      ss += part[k];
    }
    const float r = 1.0f / sqrtf(ss / static_cast<float>(dim) + eps);
    V o[CPL];
#pragma unroll
    for (int i = 0; i < CPL; ++i) o[i] = normed(xa[i], wa[i], r);
    V* op = reinterpret_cast<V*>(out + row * dim);
    const int64_t next = row + warps;
    if (next < row_end) load(next);  // the next row's loads go out before this row's stores
#pragma unroll
    for (int i = 0; i < CPL; ++i)
      if (lane + 32 * i < nchunks) op[lane + 32 * i] = o[i];
    if (next >= row_end) break;
    row = next;
  }
}

// One element of the backward: returns dx and adds dy * round(x r) to dw.
template <typename T>
__device__ __forceinline__ float bwd_elem(float x, float dy, float w, float r, float k, float& dw) {
  const float n = to_float(from_float<T>(dy * w));
  dw = fmaf(dy, to_float(from_float<T>(x * r)), dw);
  return r * n - x * k;
}

constexpr int kBwdMaxPerLane = 64;  // row elements a lane keeps in registers
constexpr int kMaxBwdDim = 32 * kBwdMaxPerLane;

// Warps (rows in flight) per block: 16 where a lane's share of a row is at
// most 64 bytes, else 8 (the row's registers would not fit 16 warps).
constexpr int bwd_warps(int64_t dim, int elem) { return dim * elem <= 2048 ? 16 : 8; }

// A warp per row, the row in registers: lane l holds the row's VEC-element
// chunks l, l + 32, ... (CPL of them) of x and dy, sums x^2 and n x with
// shuffles, and computes dx from the same registers.  Rows are walked by
// the block's warps in turn (rows_per_block consecutive rows a block), so a
// block keeps kWarps rows in flight: 16 where a lane's row share is at most
// 64 bytes (then 128 registers a thread suffice), else 8.  Each lane keeps
// its columns' dy * round(x r) sums in f32 registers across its rows; at
// the end each warp stores them to its slice of shared memory, and each
// column's slices are summed in warp order into the block's row of f32
// partials.
template <typename T, int VEC, int CPL, int kWarps = (CPL * VEC * sizeof(T) <= 64 ? 16 : 8)>
__global__ void __launch_bounds__(kWarps * 32)
rmsnorm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ dy,
                   T* __restrict__ dx, float* __restrict__ dw_part, int64_t rows, int dim,
                   int64_t x_stride, int64_t rows_per_block, float eps) {
  constexpr int E = CPL * VEC;
  using V = Vec<T, VEC>;
  extern __shared__ __align__(16) float colsum[];  // [kWarps][dim] if dw_part, else unused
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nchunks = dim / VEC;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * rows_per_block;
  const int64_t row_end = row0 + rows_per_block < rows ? row0 + rows_per_block : rows;
  const V* wp = reinterpret_cast<const V*>(w);

  auto load = [&](V (&xs)[CPL], V (&gs)[CPL], int64_t row) {
    const V* xp = reinterpret_cast<const V*>(x + row * x_stride);
    const V* gp = reinterpret_cast<const V*>(dy + row * dim);
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const int c = lane + 32 * i;
      if (c < nchunks) {
        xs[i] = xp[c];
        gs[i] = gp[c];
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) xs[i].v[j] = gs[i].v[j] = from_float<T>(0.f);
      }
    }
  };

  V xa[CPL], ga[CPL];
  float acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;
  int64_t row = row0 + warp;
  if (row < row_end) load(xa, ga, row);
  for (; row < row_end; row += kWarps) {
    // w is read per chunk from L1 in both passes, not held: its registers
    // would cost the row-in-flight ones
    auto weight = [&](int i) {
      V wv;
      const int c = lane + 32 * i;
      if (c < nchunks) wv = wp[c];
      else
#pragma unroll
        for (int j = 0; j < VEC; ++j) wv.v[j] = from_float<T>(0.f);
      return wv;
    };
    float ss = 0.f, dot = 0.f;
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const V wv = weight(i);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float f = to_float(xa[i].v[j]);
        ss = fmaf(f, f, ss);
        dot = fmaf(to_float(from_float<T>(to_float(ga[i].v[j]) * to_float(wv.v[j]))), f, dot);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
      dot += __shfl_xor_sync(0xffffffffu, dot, off);
    }
    const float r = 1.0f / sqrtf(ss / static_cast<float>(dim) + eps);
    const float k = r * r * r * dot / static_cast<float>(dim);
    V* op = reinterpret_cast<V*>(dx + row * dim);
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const V wv = weight(i);
      V o;
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        o.v[j] = from_float<T>(bwd_elem<T>(to_float(xa[i].v[j]), to_float(ga[i].v[j]),
                                           to_float(wv.v[j]), r, k, acc[i * VEC + j]));
      if (lane + 32 * i < nchunks) op[lane + 32 * i] = o;
    }
    if (row + kWarps < row_end) load(xa, ga, row + kWarps);
  }
  hopper::launch_dependents();  // the column reduce may start; it waits for this grid
  if (dw_part == nullptr) return;
  // the block's column sums: each warp's into its own slice, then every
  // thread sums its columns over the slices in warp order
  float* mine = colsum + warp * dim;
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    const int c = lane + 32 * i;
    if (c < nchunks) {
      if constexpr (VEC % 4 == 0) {  // 16-byte stores: dim is a multiple of VEC here
#pragma unroll
        for (int j = 0; j < VEC; j += 4)
          *reinterpret_cast<float4*>(mine + c * VEC + j) =
              make_float4(acc[i * VEC + j], acc[i * VEC + j + 1], acc[i * VEC + j + 2],
                          acc[i * VEC + j + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) mine[c * VEC + j] = acc[i * VEC + j];
      }
    }
  }
  __syncthreads();
  for (int col = threadIdx.x; col < dim; col += kWarps * 32) {
    float v = colsum[col];
#pragma unroll
    for (int wi = 1; wi < kWarps; ++wi) v += colsum[wi * dim + col];
    dw_part[static_cast<int64_t>(blockIdx.x) * dim + col] = v;
  }
}

// Wide rows: a block of kWideThreads per row, up to kWidePerThread elements a thread.
constexpr int kWideThreads = 256, kWidePerThread = 32;
constexpr int kMaxWideDim = kWideThreads * kWidePerThread;

template <typename T, int VEC, int CPT>
__global__ void __launch_bounds__(kWideThreads)
rmsnorm_bwd_wide_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ dy,
                        T* __restrict__ dx, float* __restrict__ dw_part, int64_t rows, int dim,
                        int64_t x_stride, int64_t rows_per_block, float eps) {
  using V = Vec<T, VEC>;
  constexpr int kWarps = kWideThreads / 32;
  __shared__ float red[2][2][kWarps];  // [row parity][sum x^2, sum n x][warp]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nchunks = dim / VEC;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * rows_per_block;
  const int64_t row_end = row0 + rows_per_block < rows ? row0 + rows_per_block : rows;
  const V* wp = reinterpret_cast<const V*>(w);
  auto chunk = [&](int i) { return static_cast<int>(threadIdx.x) + kWideThreads * i; };
  auto zero = [](V& v) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) v.v[j] = from_float<T>(0.f);
  };

  float acc[CPT * VEC];
#pragma unroll
  for (int e = 0; e < CPT * VEC; ++e) acc[e] = 0.f;
  for (int64_t row = row0; row < row_end; ++row) {
    const V* xp = reinterpret_cast<const V*>(x + row * x_stride);
    const V* gp = reinterpret_cast<const V*>(dy + row * dim);
    V xa[CPT], ga[CPT], wa[CPT];
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      if (chunk(i) < nchunks) {
        xa[i] = xp[chunk(i)];
        ga[i] = gp[chunk(i)];
        wa[i] = wp[chunk(i)];
      } else {
        zero(xa[i]);
        zero(ga[i]);
        zero(wa[i]);
      }
    }
    float ss = 0.f, dot = 0.f;
#pragma unroll
    for (int i = 0; i < CPT; ++i)
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float f = to_float(xa[i].v[j]);
        ss = fmaf(f, f, ss);
        dot = fmaf(to_float(from_float<T>(to_float(ga[i].v[j]) * to_float(wa[i].v[j]))), f, dot);
      }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
      dot += __shfl_xor_sync(0xffffffffu, dot, off);
    }
    // parity buffers: a warp reaches row + 2's writes only after every warp
    // has passed row + 1's barrier, so after row's reads
    float (&rb)[2][kWarps] = red[row & 1];
    if (lane == 0) {
      rb[0][warp] = ss;
      rb[1][warp] = dot;
    }
    __syncthreads();
    ss = dot = 0.f;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) {
      ss += rb[0][wi];
      dot += rb[1][wi];
    }
    const float r = 1.0f / sqrtf(ss / static_cast<float>(dim) + eps);
    const float k = r * r * r * dot / static_cast<float>(dim);
    V* op = reinterpret_cast<V*>(dx + row * dim);
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      V o;
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        o.v[j] = from_float<T>(bwd_elem<T>(to_float(xa[i].v[j]), to_float(ga[i].v[j]),
                                           to_float(wa[i].v[j]), r, k, acc[i * VEC + j]));
      if (chunk(i) < nchunks) op[chunk(i)] = o;
    }
  }
  hopper::launch_dependents();  // the column reduce may start; it waits for this grid
  if (dw_part == nullptr) return;
  float* part = dw_part + static_cast<int64_t>(blockIdx.x) * dim;
#pragma unroll
  for (int i = 0; i < CPT; ++i)
    if (chunk(i) < nchunks)
#pragma unroll
      for (int j = 0; j < VEC; ++j) part[chunk(i) * VEC + j] = acc[i * VEC + j];
}

// Wide rows through a ring of shared-memory stages ("ring" route): the block's
// rows row0 .. row_end - 1, row i's x and dy in stage i % stages.  The block's
// threads form `teams` teams (two where the block has two rows or more), team
// t taking rows t, t + teams, ...; stages is a multiple of teams, so a stage
// always serves one team, in order, and that team fills it: each of its
// threads copies its 16-byte chunks by cp.async and arrives on the stage's
// barrier once they have landed.  A team's thread tt takes chunks tt +
// team_threads j (j < CPT) of the row, 16 bytes each.
constexpr int kRingMaxThreads = 1024, kRingMaxTeams = 2, kRingMaxWarps = 16;  // warps a team

template <typename T, int CPT>
__global__ void __launch_bounds__(CPT == 4 ? 512 : kRingMaxThreads)
rmsnorm_bwd_ring_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ dy,
                        T* __restrict__ dx, float* __restrict__ dw_part, int64_t rows, int dim,
                        int64_t x_stride, int64_t rows_per_block, int stages, int teams, float eps) {
  constexpr int VEC = 16 / sizeof(T);
  using V = Vec<T, VEC>;
  extern __shared__ __align__(16) unsigned char ring[];  // [stages][x row, dy row], full[stages]
  __shared__ float red[kRingMaxTeams][2][2][kRingMaxWarps];  // [team][row parity][x^2, n x][warp]
  const int team_threads = blockDim.x / teams;
  const int team = threadIdx.x / team_threads, tt = threadIdx.x % team_threads;
  const int warp = tt >> 5, lane = tt & 31, nwarps = team_threads >> 5;
  const int nchunks = dim / VEC;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * rows_per_block;
  const int nrows = static_cast<int>((row0 + rows_per_block < rows ? row0 + rows_per_block : rows) - row0);
  const uint32_t row_bytes = static_cast<uint32_t>(dim) * sizeof(T);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + static_cast<size_t>(stages) * 2 * row_bytes);
  auto stage = [&](int s) { return ring + static_cast<size_t>(s) * 2 * row_bytes; };
  auto fill = [&](int i, int s) {  // this thread's 16-byte chunks of row row0 + i into stage s
    unsigned char* dst = stage(s);
    const unsigned char* xs = reinterpret_cast<const unsigned char*>(x + (row0 + i) * x_stride);
    const unsigned char* gs = reinterpret_cast<const unsigned char*>(dy + (row0 + i) * dim);
    for (int c = tt; c < nchunks; c += team_threads) {
      hopper::cp_async16(dst + 16 * c, xs + 16 * c);
      hopper::cp_async16(dst + row_bytes + 16 * c, gs + 16 * c);
    }
    hopper::cp_async_arrive(full + s);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) hopper::mbar_init(full + s, team_threads);  // a team's arrivals
    hopper::mbar_init_fence();
  }
  __syncthreads();  // the barriers are initialised
  for (int i = team; i < stages && i < nrows; i += teams) fill(i, i);  // each team fills its stages
  auto chunk = [&](int j) { return tt + team_threads * j; };
  auto zero = [](V& v) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) v.v[j] = from_float<T>(0.f);
  };
  float wf[CPT * VEC];  // the weight as f32, once per block
  const V* wp = reinterpret_cast<const V*>(w);
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    V wv;
    if (chunk(j) < nchunks) wv = wp[chunk(j)];
    else zero(wv);
#pragma unroll
    for (int e = 0; e < VEC; ++e) wf[j * VEC + e] = to_float(wv.v[e]);
  }
  float acc[CPT * VEC];
#pragma unroll
  for (int e = 0; e < CPT * VEC; ++e) acc[e] = 0.f;

  // row i's stage s = i % stages and its phase, and the row's parity, kept by increments
  int s = team, phase = 0, parity = 0;
  for (int i = team; i < nrows; i += teams) {
    hopper::mbar_wait(full + s, phase);
    const V* xs = reinterpret_cast<const V*>(stage(s));
    const V* gs = reinterpret_cast<const V*>(stage(s) + row_bytes);
    // the row as f32, and n = dy w rounded to the working type, kept for dx
    float xf[CPT * VEC], gf[CPT * VEC], nf[CPT * VEC];
    float ss = 0.f, dot = 0.f;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      V xv, gv;
      if (chunk(j) < nchunks) {
        xv = xs[chunk(j)];
        gv = gs[chunk(j)];
      } else {
        zero(xv);
        zero(gv);
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const int c = j * VEC + e;
        xf[c] = to_float(xv.v[e]);
        gf[c] = to_float(gv.v[e]);
        nf[c] = to_float(from_float<T>(gf[c] * wf[c]));
        ss = fmaf(xf[c], xf[c], ss);
        dot = fmaf(nf[c], xf[c], dot);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
      dot += __shfl_xor_sync(0xffffffffu, dot, off);
    }
    // parity buffers per team, as in rmsnorm_bwd_wide_kernel
    float (&rb)[2][kRingMaxWarps] = red[team][parity];
    if (lane == 0) {
      rb[0][warp] = ss;
      rb[1][warp] = dot;
    }
    hopper::named_sync(1 + team, team_threads);  // the team has its row in registers: the stage is free
    if (i + stages < nrows) fill(i + stages, s);
    // the warps' sums, lane l holding warp l's, summed by shuffles in one fixed order
    ss = lane < nwarps ? rb[0][lane] : 0.f;
    dot = lane < nwarps ? rb[1][lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
      dot += __shfl_xor_sync(0xffffffffu, dot, off);
    }
    const float r = 1.0f / sqrtf(ss / static_cast<float>(dim) + eps);
    const float k = r * r * r * dot / static_cast<float>(dim);
    V* op = reinterpret_cast<V*>(dx + (row0 + i) * dim);
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      V o;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const int c = j * VEC + e;
        acc[c] = fmaf(gf[c], to_float(from_float<T>(xf[c] * r)), acc[c]);
        o.v[e] = from_float<T>(r * nf[c] - xf[c] * k);
      }
      if (chunk(j) < nchunks) op[chunk(j)] = o;
    }
    s += teams;
    if (s >= stages) s -= stages, phase ^= 1;
    parity ^= 1;
  }
  hopper::launch_dependents();  // the column reduce may start; it waits for this grid
  if (dw_part == nullptr) return;
  // the block's row of partials: team 0's sums plus team 1's, in that order, through the
  // ring, which every row has left
  float* other = reinterpret_cast<float*>(ring);
  if (teams == 2) {
    __syncthreads();
    if (team == 1)
#pragma unroll
      for (int j = 0; j < CPT; ++j)
        if (chunk(j) < nchunks)
#pragma unroll
          for (int e = 0; e < VEC; ++e) other[chunk(j) * VEC + e] = acc[j * VEC + e];
    __syncthreads();
    if (team == 1) return;
#pragma unroll
    for (int j = 0; j < CPT; ++j)
      if (chunk(j) < nchunks)
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[j * VEC + e] += other[chunk(j) * VEC + e];
  }
  float4* part = reinterpret_cast<float4*>(dw_part + static_cast<int64_t>(blockIdx.x) * dim);
#pragma unroll
  for (int j = 0; j < CPT; ++j)
    if (chunk(j) < nchunks)
#pragma unroll
      for (int e = 0; e < VEC; e += 4)
        part[(chunk(j) * VEC + e) / 4] =
            make_float4(acc[j * VEC + e], acc[j * VEC + e + 1], acc[j * VEC + e + 2], acc[j * VEC + e + 3]);
}

constexpr int kRingBytes = 192 * 1024;  // rmsnorm.py RING_BYTES

constexpr int kReduceCols = 32, kReduceSlices = 8;  // 256 threads per block

// dw[c] = sum over the nparts rows of part[:, c], in a fixed order, rounded once.
template <typename T>
__global__ void __launch_bounds__(kReduceCols * kReduceSlices)
rmsnorm_dweight_kernel(const float* __restrict__ part, T* __restrict__ dw, int nparts,
                       int64_t dim) {
  __shared__ float red[kReduceSlices][kReduceCols + 1];
  hopper::grid_dependency_wait();  // the partials come from rmsnorm_bwd_kernel, launched just before
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

// The instantiation whose CPL chunks of VEC elements a lane cover the row.
template <typename T, int VEC, int CPL = 1>
void* pick_bwd(int per_lane) {
  if constexpr (CPL * VEC > kBwdMaxPerLane) {
    return nullptr;
  } else {
    if (per_lane <= CPL) return reinterpret_cast<void*>(rmsnorm_bwd_kernel<T, VEC, CPL>);
    return pick_bwd<T, VEC, 2 * CPL>(per_lane);
  }
}

// The wide instantiation whose CPT chunks of VEC elements a thread cover the row.
template <typename T, int VEC, int CPT = 1>
void* pick_wide(int per_thread) {
  if constexpr (CPT * VEC > kWidePerThread) {
    return nullptr;
  } else {
    if (per_thread <= CPT) return reinterpret_cast<void*>(rmsnorm_bwd_wide_kernel<T, VEC, CPT>);
    return pick_wide<T, VEC, 2 * CPT>(per_thread);
  }
}

template <typename T>
cudaError_t launch_bwd(const void* x, const void* w, const void* dy, void* dx, void* dw_part,
                       int64_t rows, int64_t dim, int64_t x_stride, int rows_per_block,
                       int blocks, int64_t smem, int threads, int stages, int ring_chunks, int teams,
                       float eps, cudaStream_t stream) {
  // the plan this call should have (rmsnorm.py::bwd_plan)
  const int64_t want_blocks = rows_per_block > 0 ? (rows + rows_per_block - 1) / rows_per_block : -1;
  constexpr int N = Pack<T>::N;
  const bool vec = vec_ok<T>(dim, x_stride, {x, w, dy, dx});
  const bool wide = dim > kMaxBwdDim;
  const bool ring = wide && vec;
  int want_threads, want_stages = 1, want_chunks = 1, want_teams = 1;
  int64_t want_smem = 0;
  if (ring) {
    const int64_t chunks = dim / N, pair = 2 * dim * static_cast<int64_t>(sizeof(T));
    want_chunks = chunks <= 512 ? 1 : chunks <= 1024 ? 2 : 4;
    want_teams = want_chunks < 4 && rows_per_block >= 2 ? 2 : 1;
    want_threads = want_teams * static_cast<int>(32 * (((chunks + want_chunks - 1) / want_chunks + 31) / 32));
    const int64_t fit = kRingBytes / pair;
    const int64_t most = rows_per_block < fit ? rows_per_block : fit;
    want_stages = static_cast<int>(most / want_teams * want_teams);
    if (want_stages < want_teams) want_stages = want_teams;
    want_smem = want_stages * (pair + 8);
  } else if (wide) {
    want_threads = kWideThreads;
  } else {
    want_threads = 32 * bwd_warps(dim, sizeof(T));
    if (dw_part != nullptr) want_smem = want_threads / 32 * dim * static_cast<int64_t>(sizeof(float));
  }
  if (rows_per_block <= 0 || blocks != want_blocks || smem != want_smem || threads != want_threads ||
      stages != want_stages || ring_chunks != want_chunks || teams != want_teams)
    return cudaErrorInvalidConfiguration;
  if (dim > kMaxWideDim) return cudaErrorInvalidValue;
  const int lanes = wide ? kWideThreads : 32;
  const int per_lane = static_cast<int>(vec ? (dim / N + lanes - 1) / lanes : (dim + lanes - 1) / lanes);
  void* fn = ring ? (ring_chunks == 1   ? reinterpret_cast<void*>(rmsnorm_bwd_ring_kernel<T, 1>)
                     : ring_chunks == 2 ? reinterpret_cast<void*>(rmsnorm_bwd_ring_kernel<T, 2>)
                                        : reinterpret_cast<void*>(rmsnorm_bwd_ring_kernel<T, 4>))
             : wide ? pick_wide<T, 1>(per_lane)  // the block route: rows that are not aligned
                    : (vec ? pick_bwd<T, N>(per_lane) : pick_bwd<T, 1>(per_lane));
  if (fn == nullptr) return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const T* xp = static_cast<const T*>(x);
  const T* wq = static_cast<const T*>(w);
  const T* gp = static_cast<const T*>(dy);
  T* dp = static_cast<T*>(dx);
  float* part = static_cast<float*>(dw_part);
  int d = static_cast<int>(dim);
  int64_t rpb = rows_per_block;
  if (ring) {
    void* args[] = {&xp, &wq, &gp, &dp, &part, &rows, &d, &x_stride, &rpb, &stages, &teams, &eps};
    return cudaLaunchKernel(fn, dim3(blocks), dim3(threads), args, smem, stream);
  }
  void* args[] = {&xp, &wq, &gp, &dp, &part, &rows, &d, &x_stride, &rpb, &eps};
  return cudaLaunchKernel(fn, dim3(blocks), dim3(threads), args, smem, stream);
}

constexpr int kNumSms = 132;  // _build.NUM_SMS

// Warps a block may have on the warp route (rmsnorm_warp_kernel's kMaxWarps):
// 16 where the row takes at most 32 registers a lane, i.e. dim * elem <= 4096
// bytes on 16-byte loads and dim <= 1024 an element at a time, else 8.
constexpr int fwd_max_warps(int64_t dim, int elem, bool vector) {
  return (vector ? dim * elem : 4 * dim) <= 4096 ? 16 : 8;
}

// The warp-route instantiation whose CPL chunks of VEC elements a lane cover
// the row: every count up to 64 elements a lane on the vector form, powers of
// two on the element form.
template <typename T, int VEC, int CPL = 1>
void* pick_fwd(int per_lane) {
  if constexpr (CPL * VEC > kFwdMaxPerLane) {
    return nullptr;
  } else {
    if (per_lane <= CPL) return reinterpret_cast<void*>(rmsnorm_warp_kernel<T, VEC, CPL>);
    return pick_fwd<T, VEC, VEC == 1 ? 2 * CPL : CPL + 1>(per_lane);
  }
}

// Launch fn with `args` as a dependent launch: programmatic stream
// serialization, so that its grid may start while the kernel before it on
// the stream ends; the kernel waits for that kernel before it reads.
cudaError_t launch_dependent_fn(const void* fn, dim3 grid, dim3 block, void** args,
                                cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelExC(&cfg, fn, args);
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* out, int64_t rows, int64_t dim,
                   int64_t x_stride, int warps, int64_t rows_per_warp, int64_t blocks, int vec,
                   float eps, cudaStream_t stream) {
  // the plan this call should have (rmsnorm.py::fwd_plan)
  constexpr int N = Pack<T>::N;
  const bool vector = vec_ok<T>(dim, x_stride, {x, w, out});
  int64_t want_warps = kThreads / 32, want_rpw = 1, want_blocks = rows;
  if (dim <= kWarpMaxDim) {
    const int64_t per_sm = (rows + kNumSms - 1) / kNumSms;
    const int most = fwd_max_warps(dim, sizeof(T), vector);
    want_rpw = (per_sm + most - 1) / most;
    want_warps = (per_sm + want_rpw - 1) / want_rpw;
    want_blocks = (rows + want_warps * want_rpw - 1) / (want_warps * want_rpw);
  }
  if (warps != want_warps || rows_per_warp != want_rpw || blocks != want_blocks ||
      vec != (vector ? N : 1))
    return cudaErrorInvalidConfiguration;
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  T* op = static_cast<T*>(out);
  if (dim > kWarpMaxDim) {  // the block route: a block of kThreads per row
    const dim3 grid(static_cast<unsigned>(rows));
    if (vector)
      rmsnorm_kernel<T, true><<<grid, kThreads, 0, stream>>>(xp, wp, op, dim, x_stride, eps);
    else
      rmsnorm_kernel<T, false><<<grid, kThreads, 0, stream>>>(xp, wp, op, dim, x_stride, eps);
    return cudaGetLastError();
  }
  const int per_lane = static_cast<int>((dim / vec + 31) / 32);
  void* fn = vector ? pick_fwd<T, N>(per_lane) : pick_fwd<T, 1>(per_lane);
  if (fn == nullptr) return cudaErrorInvalidValue;
  int d = static_cast<int>(dim);
  void* args[] = {&xp, &wp, &op, &rows, &d, &x_stride, &rows_per_warp, &eps};
  return launch_dependent_fn(fn, dim3(static_cast<unsigned>(blocks)), dim3(32 * warps), args, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  x is [rows, dim] with rows x_stride
// elements apart and contiguous within a row; out is contiguous [rows, dim];
// w is [dim]; all of one dtype.  warps, rows_per_warp, blocks and vec (the
// elements a load: 16 bytes where dim, x_stride and the pointers allow, else
// 1) are rmsnorm.py::fwd_plan's (the warp route up to dim 2048, past it the
// block route: 4 warps, a row a block); another plan returns
// cudaErrorInvalidConfiguration.  Returns cudaGetLastError() after the launch.
extern "C" int rmsnorm_fwd(int dtype, const void* x, const void* w, void* out, int64_t rows,
                           int64_t dim, int64_t x_stride, int warps, int64_t rows_per_warp,
                           int64_t blocks, int vec, float eps, void* stream) {
  if (rows <= 0 || rows > 0x7fffffff || dim <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(launch<float>(x, w, out, rows, dim, x_stride, warps, rows_per_warp,
                                            blocks, vec, eps, s));
    case 1:
      return static_cast<int>(launch<__nv_bfloat16>(x, w, out, rows, dim, x_stride, warps,
                                                    rows_per_warp, blocks, vec, eps, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Backward, first kernel: dx [rows, dim] (contiguous, like dy) and, if
// dw_part is not null, one row of f32 column sums of dy * round(x r) per
// block into dw_part [blocks, dim].  rows_per_block, blocks, smem, threads,
// stages, ring_chunks and teams are rmsnorm.py::bwd_plan's (the warp route up to
// dim 2048, smem dim f32 per warp with dw_part; past it up to 8192 the ring
// route where every row is 16-byte aligned, else the block route); another
// plan returns cudaErrorInvalidConfiguration.
extern "C" int rmsnorm_bwd(int dtype, const void* x, const void* w, const void* dy, void* dx,
                           void* dw_part, int64_t rows, int64_t dim, int64_t x_stride,
                           int rows_per_block, int blocks, int64_t smem, int threads, int stages,
                           int ring_chunks, int teams, float eps, void* stream) {
  if (rows <= 0 || dim <= 0 || smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(launch_bwd<float>(x, w, dy, dx, dw_part, rows, dim, x_stride,
                                                rows_per_block, blocks, smem, threads, stages,
                                                ring_chunks, teams, eps, s));
    case 1:
      return static_cast<int>(launch_bwd<__nv_bfloat16>(x, w, dy, dx, dw_part, rows, dim,
                                                        x_stride, rows_per_block, blocks, smem,
                                                        threads, stages, ring_chunks, teams, eps,
                                                        s));
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
      return static_cast<int>(hopper::launch_dependent(rmsnorm_dweight_kernel<float>, grid,
                                                       dim3(kReduceCols * kReduceSlices), 0, s,
                                                       part, static_cast<float*>(dw), nparts,
                                                       dim));
    case 1:
      return static_cast<int>(hopper::launch_dependent(
          rmsnorm_dweight_kernel<__nv_bfloat16>, grid, dim3(kReduceCols * kReduceSlices), 0, s,
          part, static_cast<__nv_bfloat16*>(dw), nparts, dim));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* rmsnorm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
