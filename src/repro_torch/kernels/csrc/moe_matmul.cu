// Grouped (per-expert) matrix product for Hopper (sm_90a):
// out[e] = buf[e] @ w[e], buf [E, C, D], w [E, D, F] -> out [E, C, F].
//
// Replaces: src/repro/kernels/moe_matmul.py::moe_matmul (Pallas body _moe_kernel).
//
// Bound: bytes at every shape the MoE path gives it.  A call reads all E
// expert matrices (granite: 40 x 1536 x 512 bf16 = 63 MB) whatever C is,
// and does 2*C operations per weight element it reads, so below C ~ 295
// (the H100's bf16 operations per byte) the weights' bytes set the least
// time: decode (C = 8) ~19 us, prefill (C = 128) ~25 us with buf and out.
// At C = 384 (scoring) the bytes' time (~38 us) is ~1.5x the operations'.
//
// Design: the TPU kernel's grid (expert, C-block, F-block) with a
// sequential D-block axis becomes one block per (F-tile, C-tile, expert)
// that loops over D in 32-deep tiles; the f32 accumulator lives in
// registers (the TPU kernel keeps it in VMEM scratch).  128 threads = 4
// warps in a 2 x 2 layout, each owning 32 x 32 of the block's 64 x 64 tile.
// bf16 runs on the tensor cores with mma.sync m16n8k16 (bf16 products,
// f32 accumulation, exactly the TPU kernel's contract): fragments come out
// of shared memory with ldmatrix (.trans for w, which is stored [k][n] as
// it lies in device memory).  f32 runs the same tiles with f32 FMAs on the
// CUDA cores, each thread owning the same accumulator elements as an mma
// fragment, so one epilogue serves both.  Since the weights' bytes set the
// bound, the loads are what the design is about: where every row is
// 16-byte aligned (D and F multiples of 8 bf16 or 4 f32 values, as at all
// the model's shapes) tiles are copied with cp.async into a ring of
// shared-memory stages (4 for bf16, 2 for f32), so several tiles of
// weights are in flight while the tensor cores work on an earlier one;
// edges are zero-filled by the copy itself.  Other shapes (any C, D, F)
// take a path that stages one tile at a time through registers with
// masked element loads.  No expert is skipped: like the TPU kernel it
// multiplies every expert's whole capacity buffer.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;  // rows of C per block
constexpr int BN = 64;  // columns of F per block
constexpr int BK = 32;  // depth of one shared-memory tile
constexpr int kThreads = 128;

// Shared-memory layout per element type: row strides in elements and the
// number of pipeline stages.  bf16: rows of 80 (A) and 144 (W) bytes, so
// the eight 16-byte rows of one ldmatrix phase fall on distinct bank
// groups; 4 stages = 39 KB.  f32: 16-byte aligned rows of 36 and 68
// floats (in the FMA loop the eight rows a warp reads from A land on
// banks 4g + k); 2 stages = 36 KB.  Both stay under the 48 KB of static
// shared memory a block may have.
template <typename T> struct Layout;
template <> struct Layout<__nv_bfloat16> {
  static constexpr int A = BK + 8, W = BN + 8, kStages = 4;
};
template <> struct Layout<float> {
  static constexpr int A = BK + 4, W = BN + 4, kStages = 2;
};

template <typename T>
struct alignas(16) Vec {
  static constexpr int N = 16 / sizeof(T);
  T v[N];
};

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even
}

// The 16 bytes at (row, col) of a [nrows, ncols] matrix with rows ld
// elements apart; zero outside it.  vec_ok: every row start is 16-byte
// aligned and ncols is a multiple of the vector width.
template <typename T>
__device__ __forceinline__ Vec<T> load_vec(const T* __restrict__ base, int64_t ld, int row,
                                           int col, int nrows, int ncols, bool vec_ok) {
  constexpr int N = Vec<T>::N;
  Vec<T> out;
  if (vec_ok && row < nrows && col < ncols) {
    out = *reinterpret_cast<const Vec<T>*>(base + row * ld + col);
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j)
      out.v[j] = (row < nrows && col + j < ncols) ? base[row * ld + col + j] : from_float<T>(0.f);
  }
  return out;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; bytes = 0 writes
// 16 zero bytes and reads nothing (src must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a b for one m16n8k16 tile: bf16 inputs, f32 accumulator.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Accumulator element r of tile (mi, ni) of a warp sits, as in an m16n8
// fragment, at row mi*16 + g + 8*(r/2) and column ni*8 + 2*t + r%2 of the
// warp's 32 x 32, where g = lane / 4 and t = lane % 4.
using Acc = float[2][4][4];

__device__ __forceinline__ void mma_tile(Acc& acc, const __nv_bfloat16* As,
                                         const __nv_bfloat16* Ws, int wm, int wn, int lane) {
  constexpr int kA = Layout<__nv_bfloat16>::A, kW = Layout<__nv_bfloat16>::W;
  // ldmatrix x4: lanes 8i..8i+7 address the rows of 8x8 matrix i
  const int r8 = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int c8 = (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    uint32_t a[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
      ldmatrix_x4(a[mi], As + (wm * 32 + mi * 16 + r8) * kA + kk + c8);
#pragma unroll
    for (int nj = 0; nj < 2; ++nj) {
      uint32_t b[4];  // k rows kk..kk+15 of n columns [16 nj, 16 nj + 16): two n8 tiles
      ldmatrix_x4_trans(b, Ws + (kk + r8) * kW + wn * 32 + nj * 16 + c8);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        mma_bf16(acc[mi][2 * nj], a[mi], b[0], b[1]);
        mma_bf16(acc[mi][2 * nj + 1], a[mi], b[2], b[3]);
      }
    }
  }
}

__device__ __forceinline__ void mma_tile(Acc& acc, const float* As, const float* Ws, int wm,
                                         int wn, int lane) {
  constexpr int kA = Layout<float>::A, kW = Layout<float>::W;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 4
  for (int k = 0; k < BK; ++k) {
    float a[2][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) a[mi][h] = As[(wm * 32 + mi * 16 + g + 8 * h) * kA + k];
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const float2 b = *reinterpret_cast<const float2*>(Ws + k * kW + wn * 32 + ni * 8 + 2 * t);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        acc[mi][ni][0] = fmaf(a[mi][0], b.x, acc[mi][ni][0]);
        acc[mi][ni][1] = fmaf(a[mi][0], b.y, acc[mi][ni][1]);
        acc[mi][ni][2] = fmaf(a[mi][1], b.x, acc[mi][ni][2]);
        acc[mi][ni][3] = fmaf(a[mi][1], b.y, acc[mi][ni][3]);
      }
    }
  }
}

// kAsync: every row of buf and w starts 16-byte aligned and D, F are
// multiples of the 16-byte vector, so tiles go through the cp.async ring.
// Otherwise one tile at a time is staged through registers with masked
// element loads (vec_a / vec_w still allow 16-byte loads where they hold).
template <typename T, bool kAsync>
__global__ void __launch_bounds__(kThreads)
moe_matmul_kernel(const T* __restrict__ buf, const T* __restrict__ w, T* __restrict__ out, int C,
                  int D, int F, bool vec_a, bool vec_w) {
  constexpr int kA = Layout<T>::A, kW = Layout<T>::W;
  constexpr int kStages = kAsync ? Layout<T>::kStages : 1;
  constexpr int N = Vec<T>::N;
  constexpr int kVa = BM * BK / N / kThreads;  // 16-byte vectors per thread of the buf tile
  constexpr int kVw = BK * BN / N / kThreads;  // ... and of the w tile
  __shared__ __align__(16) T As[kStages][BM * kA];
  __shared__ __align__(16) T Ws[kStages][BK * kW];

  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM, e = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 1, wn = warp & 1;
  const T* a = buf + static_cast<int64_t>(e) * C * D;
  const T* b = w + static_cast<int64_t>(e) * D * F;
  const int nk = (D + BK - 1) / BK;

  Acc acc;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0.f;

  // (row, column) of this thread's i-th 16-byte vector in a tile of `cols` columns
  auto a_pos = [](int i, int& r, int& c) {
    const int v = threadIdx.x + i * kThreads;
    r = v / (BK / N);
    c = (v % (BK / N)) * N;
  };
  auto w_pos = [](int i, int& r, int& c) {
    const int v = threadIdx.x + i * kThreads;
    r = v / (BN / N);
    c = (v % (BN / N)) * N;
  };

  if constexpr (kAsync) {
    auto issue = [&](int stage, int kt) {
      const int k0 = kt * BK;
#pragma unroll
      for (int i = 0; i < kVa; ++i) {
        int r, c;
        a_pos(i, r, c);
        const bool in = m0 + r < C && k0 + c < D;
        cp_async16(&As[stage][r * kA + c], in ? a + static_cast<int64_t>(m0 + r) * D + k0 + c : a,
                   in ? 16 : 0);
      }
#pragma unroll
      for (int i = 0; i < kVw; ++i) {
        int r, c;
        w_pos(i, r, c);
        const bool in = k0 + r < D && n0 + c < F;
        cp_async16(&Ws[stage][r * kW + c], in ? b + static_cast<int64_t>(k0 + r) * F + n0 + c : b,
                   in ? 16 : 0);
      }
    };
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < nk) issue(s, s);
      cp_async_commit();  // empty groups keep the count uniform
    }
    for (int kt = 0; kt < nk; ++kt) {
      cp_async_wait<kStages - 2>();  // tile kt has landed (this thread's copies) ...
      __syncthreads();  // ... everyone's, and every warp is done with tile kt - 1
      const int next = kt + kStages - 1;
      if (next < nk) issue(next % kStages, next);  // into the stage tile kt - 1 used
      cp_async_commit();
      mma_tile(acc, As[kt % kStages], Ws[kt % kStages], wm, wn, lane);
    }
  } else {
    Vec<T> ra[kVa], rw[kVw];
    auto fetch = [&](int k0) {
#pragma unroll
      for (int i = 0; i < kVa; ++i) {
        int r, c;
        a_pos(i, r, c);
        ra[i] = load_vec(a, D, m0 + r, k0 + c, C, D, vec_a);
      }
#pragma unroll
      for (int i = 0; i < kVw; ++i) {
        int r, c;
        w_pos(i, r, c);
        rw[i] = load_vec(b, F, k0 + r, n0 + c, D, F, vec_w);
      }
    };
    if (nk > 0) fetch(0);
    for (int kt = 0; kt < nk; ++kt) {
#pragma unroll
      for (int i = 0; i < kVa; ++i) {
        int r, c;
        a_pos(i, r, c);
        *reinterpret_cast<Vec<T>*>(&As[0][r * kA + c]) = ra[i];
      }
#pragma unroll
      for (int i = 0; i < kVw; ++i) {
        int r, c;
        w_pos(i, r, c);
        *reinterpret_cast<Vec<T>*>(&Ws[0][r * kW + c]) = rw[i];
      }
      __syncthreads();
      if (kt + 1 < nk) fetch((kt + 1) * BK);  // in flight while this tile is multiplied
      mma_tile(acc, As[0], Ws[0], wm, wn, lane);
      __syncthreads();  // every warp is done with the tile before it is overwritten
    }
  }

  T* o = out + static_cast<int64_t>(e) * C * F;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = m0 + wm * 32 + mi * 16 + g + (r >> 1) * 8;
        const int col = n0 + wn * 32 + ni * 8 + 2 * t + (r & 1);
        if (row < C && col < F) o[static_cast<int64_t>(row) * F + col] = from_float<T>(acc[mi][ni][r]);
      }
}

template <typename T>
cudaError_t launch(const void* buf, const void* w, void* out, int E, int C, int D, int F,
                   cudaStream_t stream) {
  constexpr int N = Vec<T>::N;
  const bool vec_a = D % N == 0 && reinterpret_cast<uintptr_t>(buf) % 16 == 0;
  const bool vec_w = F % N == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const dim3 grid((F + BN - 1) / BN, (C + BM - 1) / BM, E);
  const T* bp = static_cast<const T*>(buf);
  const T* wp = static_cast<const T*>(w);
  T* op = static_cast<T*>(out);
  if (vec_a && vec_w)
    moe_matmul_kernel<T, true><<<grid, kThreads, 0, stream>>>(bp, wp, op, C, D, F, true, true);
  else
    moe_matmul_kernel<T, false><<<grid, kThreads, 0, stream>>>(bp, wp, op, C, D, F, vec_a, vec_w);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  buf [E, C, D], w [E, D, F] and out
// [E, C, F] are contiguous, of one dtype.  Returns cudaGetLastError()
// after the launch.
extern "C" int moe_matmul_fwd(int dtype, const void* buf, const void* w, void* out, int64_t E,
                              int64_t C, int64_t D, int64_t F, void* stream) {
  if (E <= 0 || C <= 0 || F <= 0 || D < 0 || E > 65535 || (C + BM - 1) / BM > 65535 ||
      C > 0x7fffffff || D > 0x7fffffff || F > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int e = static_cast<int>(E), c = static_cast<int>(C), d = static_cast<int>(D),
            f = static_cast<int>(F);
  switch (dtype) {
    case 0: return static_cast<int>(launch<float>(buf, w, out, e, c, d, f, s));
    case 1: return static_cast<int>(launch<__nv_bfloat16>(buf, w, out, e, c, d, f, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* moe_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
