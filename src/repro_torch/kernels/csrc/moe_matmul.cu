// Grouped (per-expert) matrix product for Hopper (sm_90a):
// out[e] = buf[e] @ w[e], buf [E, C, D], w [E, D, F] -> out [E, C, F], with
// f32 accumulation, one rounding to the working dtype, and no expert skipped.
//
// Replaces: src/repro/kernels/moe_matmul.py::moe_matmul (Pallas body _moe_kernel).
//
// Bound: bytes at every shape the MoE path gives it.  A call reads all E
// expert matrices (granite: 40 x 1536 x 512 bf16 = 63 MB) whatever C is,
// and does 2 C operations per weight element, so below C ~ 295 (the H100's
// bf16 operations per byte) the weights' bytes set the least time: decode
// (C = 8) 19.2 us, prefill (C = 128) 25.0 us with buf and out.  At C = 384
// (scoring) the bytes' 37.6 us are 1.5x the operations' 24.4 us: the tensor
// cores must run at two thirds of their peak while the weights stream at
// the memory's rate.
//
// Routes (kernels/moe_matmul.py launch_plan picks one; the entry point
// refuses a route, tile, grid or shared-memory size that is not its own):
//
// - "wgmma": bf16, D and F multiples of 8, 16-byte aligned bases, C > 32.
//   128 x BN output tiles on two consumer warpgroups of 64 rows, running
//   wgmma with both operands in shared memory; a producer warpgroup (one
//   thread issuing, its registers given to the consumers by setmaxnreg)
//   feeds a ring of 64-deep stages by TMA with 128-byte swizzle: buf's
//   [128 rows][64 of D], read K-major, and w's [64 of D][BN], read MN-major
//   in 64-column chunks, as w is stored.  A consumer frees each stage as
//   soon as its products finish, so ST - 1 stages stay in flight.  BN = 256
//   (4 stages) where D > F (gate, up), 128 (6 stages) otherwise (down).  The
//   tensor maps are 3-D (inner, rows, E), so a partial C tile reads zeros,
//   never the next expert's rows.  The grid is persistent: one block per SM
//   walks the tiles in (expert, F tile, C tile) order, C fastest, so the
//   blocks that need one expert's weight tile run side by side and all but
//   the first find it in L2.  Epilogue: the accumulators are rounded to bf16
//   once, written to a swizzled 64 x 64 staging tile per warpgroup (two,
//   alternating) and stored by TMA, which clips at C and F; the producer
//   meanwhile fills the ring with the next tile.
// - "wgmma_t": the same inputs with C <= 32 (decode: C = 8), where the call
//   is a stream over the weights.  The product is transposed, out^T =
//   w^T buf^T: a 64-column chunk of the weights is wgmma's M side (read
//   MN-major) and 8 rows of buf its N.  Up to three 160-thread blocks per SM
//   (one consumer warpgroup, one producer warp, a ring of seven 9 KB stages)
//   walk (expert, 64-column F tile, 8-row C tile) units persistently, so an
//   SM keeps some 160 KB of weights in flight and a producer never drains
//   its ring between units.  Each out^T tile is transposed on its way through
//   shared memory and stored by TMA.
//   Both TMA routes are programmatic dependent launches: a block sets up
//   while the kernel before it finishes and waits for it before touching
//   device memory.
// - "tf32x3": f32 with 16-byte aligned rows, D and F multiples of 4 (namespace
//   tf).  The tensor cores in split TF32: each f32 operand goes in as hi =
//   tf32(v) and lo = v - hi, each product as three TF32 products, lo hi + hi
//   lo first, then hi hi, summed in the f32 accumulator (~21 bits of each
//   operand; the dropped lo lo term is ~2^-22 of the product), which holds
//   f32's 1e-4 as flash_attention.cu's f32 route holds 2e-5.  The products
//   run on wgmma m64nNk8 TF32, a consumer warpgroup per 64 rows: 128 x 128
//   tiles, 64 x 64 for C <= 64 (decode).  Each thread loads its share of a
//   32-deep stage into registers two stages ahead, and the block splits each
//   stage once into hi and lo planes laid out as wgmma reads TF32 (K-major,
//   128-byte swizzle; w's transposed as it is split), into one set while the
//   warpgroups' wgmma read the other: no warp splits what another has split,
//   and no fragment passes through registers.  (A 3-stage cp.async ring in
//   shared memory ran no faster than the registers.)  mma.sync m16n8k8 TF32
//   was tried first: it peaks at 65% of the TF32 rate on an H100, and with
//   its fragment loads the kernel ran no faster than bmm (PERF.md).
//   Bound: 3 x 2 C D F operations a call on the 494.7 TFLOP/s TF32 tensor
//   cores, beside which the block issues the split (3 instructions an
//   element of a stage) and the planes' stores.
// - "masked": rows that are not 16-byte aligned, either dtype (TMA needs
//   16-byte strides).  64 x 64 tiles staged one at a time through registers
//   with masked element loads; bf16 on mma.sync m16n8k16, f32 on CUDA-core
//   FMAs.
//
// No route uses atomics: every output element is summed in one fixed order,
// so two calls give bit-identical results.
//
// Backward (no TPU counterpart: the JAX package differentiates the plain
// product).  For the gradient dout [E, C, F]: dbuf = dout w^T ([E, C, F] x
// [E, F, D]) and dw = buf^T dout ([E, D, C] x [E, C, F]), two launches
// (moe_matmul_bwd, which = 0 and 1), each laid out by moe_matmul.py's
// bwd_plan and refusing any other.  Bound: bytes at the training shape, as
// the forward (granite at C = 256: ~105 MB for 16 GFLOP per product pair).
// - "wgmma": bf16 with the forward's TMA conditions.  The forward's kernel
//   shape (persistent blocks, a producer warpgroup, 128-row tiles on two
//   consumer warpgroups, a ring as deep as 192 KB hold, TMA-stored epilogue
//   while the producer already fills the ring for the next tile) with the
//   operands' major-ness changed: dbuf reads dout K-major (as buf) and w
//   K-major too (boxes of 64 rows of D by 64 of F: w^T's rows are w's
//   columns), dw reads buf MN-major as A (transposed: each consumer
//   warpgroup's 64 columns of D, a box of 64 rows of C each) and dout
//   MN-major as B.  TMA zero-fills past C, so the dw reduction over a
//   ragged capacity adds zeros.  The tile width is chosen per launch
//   (bwd_tile_n, from stage times read on the card): 256 columns for
//   granite's gate/up dbuf (four rounds of 480 tiles for eight of 960),
//   128 for its down dbuf and both dw.  At these shapes the products stream
//   their operands from L2 at 4.4-6 TB/s, so narrower tiles, which read
//   more bytes per product, lose what their finer rounds win (granite's
//   down dbuf on an H100 SXM at 700 W: 0.0611 ms at 64 columns against
//   0.0476 at 128, whose 320 tiles take three rounds of the 132 blocks).
// - "tf32x3": f32 with the forward's tf32x3 conditions (16-byte aligned bases, D
//   and F multiples of 4), both launches: the forward's split-TF32 arithmetic
//   (namespace tf: each 32-deep stage split once by the block into swizzled
//   K-major hi / lo planes, lo hi + hi lo + hi hi on wgmma m64nNk8 TF32, each
//   stage's products summed from zero, then added to the running f32 sum) in
//   one kernel templated on the launch, tf::moe_matmul_bwd_tf32x3<S, kDw>.
//   dbuf reads dout and w K-major as stored (the forward's buf path); dw reads
//   buf and dout MN-major (the forward's w path, each 4 x 4 piece transposed as
//   it is split), and its K = C is short (8 stages a tile at granite's LM step,
//   1920 tiles), so the grid is persistent: a block's stage loop runs on from
//   one tile into the next, loading and splitting the next tile's first stages
//   while TMA stores the last one's accumulators from a staging tile (a block a
//   tile ran 8-10% slower at dw, 1-8% at dbuf).  128 x 128 tiles, 64 x 64 where
//   the launch's M <= 64 or 128 x 128 tiles would not fill the SMs once (the
//   reduced configs: 1.7x faster there than 128 x 128).  Bound: 3 x 2 C D F
//   operations a launch on the 494.7 TFLOP/s TF32 tensor cores (0.0977 ms a
//   launch at granite's LM products, where the kernel reaches 40-48% of it).
// - "fma": rows that are not 16-byte aligned, either dtype: CUDA-core FMAs on
//   register-blocked 128 x 128
//   tiles (64 x 64 where 128 would not fill the SMs), 8 x 8 outputs a thread,
//   over 16-deep slices double-buffered in shared memory (moe_matmul_bwd_fma
//   below): 4 LDS.128 for 64 FMAs a k step.
// Tried on the card and not kept (PERF.md): clusters of two blocks
// sharing the buf tile by TMA multicast (2-3x slower), 32-deep stages,
// asking the next stages into L2 ahead of the ring, 128-column decode units
// and one 4-D weight box per stage (none faster).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <initializer_list>
#include <type_traits>

#include "hopper.cuh"

namespace {

// The masked route: one block per 64 x 64 tile.
constexpr int BM = 64;  // rows of C per block
constexpr int BN = 64;  // columns of F per block
constexpr int BK = 32;  // depth of one shared-memory tile
constexpr int kThreads = 128;

// Shared-memory row strides in elements per element type.  bf16: rows of 80
// (A) and 144 (W) bytes, so the eight 16-byte rows of one ldmatrix phase
// fall on distinct bank groups.  f32: 16-byte aligned rows of 36 and 68
// floats (in the FMA loop the eight rows a warp reads from A land on banks
// 4g + k).  Both stay under the 48 KB of static shared memory a block may
// have.
template <typename T> struct Layout;
template <> struct Layout<__nv_bfloat16> {
  static constexpr int A = BK + 8, W = BN + 8;
};
template <> struct Layout<float> {
  static constexpr int A = BK + 4, W = BN + 4;
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

// One tile at a time is staged through registers with masked element loads
// (vec_a / vec_w still allow 16-byte loads where they hold).
template <typename T>
__global__ void __launch_bounds__(kThreads)
moe_matmul_kernel(const T* __restrict__ buf, const T* __restrict__ w, T* __restrict__ out, int C,
                  int D, int F, bool vec_a, bool vec_w) {
  constexpr int kA = Layout<T>::A, kW = Layout<T>::W;
  constexpr int N = Vec<T>::N;
  constexpr int kVa = BM * BK / N / kThreads;  // 16-byte vectors per thread of the buf tile
  constexpr int kVw = BK * BN / N / kThreads;  // ... and of the w tile
  __shared__ __align__(16) T As[BM * kA];
  __shared__ __align__(16) T Ws[BK * kW];

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
      *reinterpret_cast<Vec<T>*>(&As[r * kA + c]) = ra[i];
    }
#pragma unroll
    for (int i = 0; i < kVw; ++i) {
      int r, c;
      w_pos(i, r, c);
      *reinterpret_cast<Vec<T>*>(&Ws[r * kW + c]) = rw[i];
    }
    __syncthreads();
    if (kt + 1 < nk) fetch((kt + 1) * BK);  // in flight while this tile is multiplied
    mma_tile(acc, As, Ws, wm, wn, lane);
    __syncthreads();  // every warp is done with the tile before it is overwritten
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

// Static shared memory of moe_matmul_kernel<T>, as its plan states it.
template <typename T>
constexpr int static_smem() {
  return (BM * Layout<T>::A + BK * Layout<T>::W) * static_cast<int>(sizeof(T));
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// Backward on CUDA cores ("fma" route of bwd_plan: rows that are not 16-byte
// aligned, f32, or bf16 where TMA cannot read them): out[e] (M x N) = sum over
// k of A(m, k) B(k, n) in f32, each output's k in one fixed order.  Both
// operands of a launch are contiguous along the same dimension: along k for
// dbuf (A(m, k) = dout[e][m][k], B(k, n) = w[e][n][k]: kKC), along m and n
// for dw (A(m, k) = buf[e][k][m], B(k, n) = dout[e][k][n]).  Operand X(p, k),
// p = m or n, sits at x[e se + p ld + k] (kKC) or x[e se + k ld + p].
//
// A register-blocked tile: BM x BM outputs a block (128, or 64 where 128-wide
// tiles would not fill the SMs once), 256 threads with (BM / 16)^2 outputs
// each (8 x 8 at 128: two 4-wide pieces of m and of n, 64 apart), so a k step
// is 4 LDS.128 (4 distinct A and 8 distinct B addresses a warp: one
// wavefront each) for 64 FMAs.  Both operands sit in shared memory k-major,
// [16 k][BM + 4] f32 (rows 16-byte aligned), two stages: the next 16-deep
// slice is fetched into registers while this one is multiplied and stored
// (converted to f32; transposed where it runs along k) after the slice's
// products, each warp on 16 rows by 2 k-groups so that the transposed stores
// hit 32 distinct banks, and one barrier a slice frees the stage.  kVec (bf16
// only: aligned f32 rows take tf32x3): every 4-element group along a
// contiguous dimension is aligned (bases 16-byte aligned, D and F multiples
// of 4), loaded 8 bytes at once; otherwise masked element loads.
constexpr int kFmaThreads = 256, kFmaK = 16;

template <int BM>
struct FmaTile {
  static constexpr int LD = BM + 4;  // shared row stride in floats
  static constexpr int CH = BM / 64;  // 4-wide pieces of m (and of n) a thread, 64 apart
  static constexpr int stage = kFmaK * LD;  // floats of one operand's stage
  static constexpr int bytes = 2 * 2 * stage * static_cast<int>(sizeof(float));  // 2 stages, A and B
};

// The q-th 4-element group (q < BM / 64) this thread moves of a [BM p][16 k]
// slice: (p, k) of its first element; the group runs along k (kKC) or p.
template <int BM, bool kKC>
__device__ __forceinline__ void quad_pos(int q, int& p, int& k) {
  const int v = threadIdx.x + kFmaThreads * q;
  if constexpr (kKC) {  // a warp takes 16 rows by 2 k-groups
    const int lane = v & 31, wv = v >> 5;
    p = (wv % (BM / 16)) * 16 + (lane >> 1);
    k = ((wv / (BM / 16)) * 2 + (lane & 1)) * 4;
  } else {  // a warp takes consecutive groups along p
    k = v / (BM / 4);
    p = (v % (BM / 4)) * 4;
  }
}

// The group at (p, k) of X, P x K (p < P, k < K), into r as f32; zeros outside.
template <typename T, bool kKC, bool kVec>
__device__ __forceinline__ void load_quad(float (&r)[4], const T* __restrict__ x, int64_t ld, int p,
                                          int k, int P, int K) {
  static_assert(!kVec || sizeof(T) == 2, "aligned f32 rows take tf32x3");
  if constexpr (kVec) {  // the group is all inside or all outside
    if (p < P && k < K) {
      const T* src = kKC ? x + static_cast<int64_t>(p) * ld + k : x + static_cast<int64_t>(k) * ld + p;
      const uint2 v = *reinterpret_cast<const uint2*>(src);
      const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
      const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
      r[0] = lo.x, r[1] = lo.y, r[2] = hi.x, r[3] = hi.y;
    } else {
      r[0] = r[1] = r[2] = r[3] = 0.f;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int pj = kKC ? p : p + j, kj = kKC ? k + j : k;
      r[j] = pj < P && kj < K ? to_float(x[kKC ? static_cast<int64_t>(pj) * ld + kj
                                               : static_cast<int64_t>(kj) * ld + pj])
                              : 0.f;
    }
  }
}

template <int BM, bool kKC>
__device__ __forceinline__ void store_quad(float* s, const float (&r)[4], int p, int k) {
  constexpr int LD = FmaTile<BM>::LD;
  if constexpr (kKC) {  // transposed: 4 k rows
#pragma unroll
    for (int j = 0; j < 4; ++j) s[(k + j) * LD + p] = r[j];
  } else {
    *reinterpret_cast<float4*>(s + k * LD + p) = make_float4(r[0], r[1], r[2], r[3]);
  }
}

template <typename T, int BM, bool kKC, bool kVec>
__global__ void __launch_bounds__(kFmaThreads)
moe_matmul_bwd_fma(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ out, int M,
                   int N, int K, int64_t sae, int64_t lda, int64_t sbe, int64_t ldb) {
  using L = FmaTile<BM>;
  constexpr int CH = L::CH, LD = L::LD;
  __shared__ __align__(16) float As[2][L::stage];  // [stage][k][m]
  __shared__ __align__(16) float Bs[2][L::stage];  // [stage][k][n]
  const int n0 = blockIdx.x * BM, m0 = blockIdx.y * BM;
  const int64_t e = blockIdx.z;
  const T* ae = a + e * sae;
  const T* be = b + e * sbe;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // a warp covers 4 values of ty by 8 of tx
  const int tx = (warp & 1) * 8 + (lane & 7), ty = (warp >> 1) * 4 + (lane >> 3);
  const int nk = (K + kFmaK - 1) / kFmaK;

  float acc[4 * CH][4 * CH];
#pragma unroll
  for (int i = 0; i < 4 * CH; ++i)
#pragma unroll
    for (int j = 0; j < 4 * CH; ++j) acc[i][j] = 0.f;
  float ra[CH][4], rb[CH][4];  // the next slice

  auto fetch = [&](int k0) {
#pragma unroll
    for (int q = 0; q < CH; ++q) {
      int p, k;
      quad_pos<BM, kKC>(q, p, k);
      load_quad<T, kKC, kVec>(ra[q], ae, lda, m0 + p, k0 + k, M, K);
      load_quad<T, kKC, kVec>(rb[q], be, ldb, n0 + p, k0 + k, N, K);
    }
  };
  auto stash = [&](int st) {
#pragma unroll
    for (int q = 0; q < CH; ++q) {
      int p, k;
      quad_pos<BM, kKC>(q, p, k);
      store_quad<BM, kKC>(As[st], ra[q], p, k);
      store_quad<BM, kKC>(Bs[st], rb[q], p, k);
    }
  };

  fetch(0);
  stash(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) fetch((kt + 1) * kFmaK);  // for the other stage, freed by the last barrier
    const float* A = As[cur];
    const float* B = Bs[cur];
#pragma unroll
    for (int k = 0; k < kFmaK; ++k) {
      float av[4 * CH], bv[4 * CH];
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const float4 x4 = *reinterpret_cast<const float4*>(A + k * LD + c * 64 + ty * 4);
        const float4 y4 = *reinterpret_cast<const float4*>(B + k * LD + c * 64 + tx * 4);
        av[4 * c] = x4.x, av[4 * c + 1] = x4.y, av[4 * c + 2] = x4.z, av[4 * c + 3] = x4.w;
        bv[4 * c] = y4.x, bv[4 * c + 1] = y4.y, bv[4 * c + 2] = y4.z, bv[4 * c + 3] = y4.w;
      }
#pragma unroll
      for (int i = 0; i < 4 * CH; ++i)
#pragma unroll
        for (int j = 0; j < 4 * CH; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (kt + 1 < nk) stash(cur ^ 1);
    __syncthreads();
  }

  T* oe = out + e * M * N;
#pragma unroll
  for (int ci = 0; ci < CH; ++ci)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + ci * 64 + ty * 4 + i;
      if (m >= M) continue;
#pragma unroll
      for (int cj = 0; cj < CH; ++cj) {
        const int n = n0 + cj * 64 + tx * 4;
        T* o = oe + static_cast<int64_t>(m) * N + n;
        const float v0 = acc[4 * ci + i][4 * cj], v1 = acc[4 * ci + i][4 * cj + 1];
        const float v2 = acc[4 * ci + i][4 * cj + 2], v3 = acc[4 * ci + i][4 * cj + 3];
        if (kVec && n < N) {  // N is a multiple of 4: the group is inside
          const __nv_bfloat162 lo = __floats2bfloat162_rn(v0, v1), hi = __floats2bfloat162_rn(v2, v3);
          uint2 pk;
          pk.x = *reinterpret_cast<const uint32_t*>(&lo);
          pk.y = *reinterpret_cast<const uint32_t*>(&hi);
          *reinterpret_cast<uint2*>(o) = pk;
        } else if (!kVec) {
          const float v[4] = {v0, v1, v2, v3};
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (n + j < N) o[j] = from_float<T>(v[j]);
        }
      }
    }
}

}  // namespace

namespace tf {  // f32 on the tensor cores in split TF32 ("tf32x3")

constexpr int BK = 32;  // depth of a stage: one 128-byte row of f32, 8 16-byte chunks

// A tile shape: BM x BN outputs a block, a consumer warpgroup per 64 rows, each running wgmma
// m64nBNk8.  Shared memory (from a 1024-byte aligned base): two sets of split planes, each buf
// hi, buf lo, w hi, w lo of BM x BK and BN x BK words.
template <int BM_, int BN_>
struct Shape {
  static constexpr int BM = BM_, BN = BN_, kThreads = 2 * BM;  // BM / 64 warpgroups
  static constexpr int plane_a = BM * BK, plane_b = BK * BN;
  static constexpr int planes = 2 * (plane_a + plane_b);  // words of one set
  static constexpr int bytes = 1024 + 4 * 2 * planes;
  static constexpr int bwd_bytes = bytes + 4 * BM * BN;  // and the backward's staging tile
};
// C > 64 (the backward: M > 64).  128 x 64 tiles ran slower at granite's f32 products on an
// H100 (torch_kernel_probe.py f32-gemm, PERF.md).
using Wide = Shape<128, 128>;
using Small = Shape<64, 64>;  // C <= 64 (decode; the backward: tf_bwd_small)
// The backward's persistent grid: blocks an SM of each shape (Wide: its 193 KB of planes and
// staging and 256 threads' registers hold one; Small two).  moe_matmul.py's TF_BWD_BLOCKS.
constexpr int kBwdWideBlocks = 1, kBwdSmallBlocks = 2;

// x as hi + lo: hi rounded to nearest TF32, ties away (cvt.rna's rounding: half an ulp added,
// the low 13 bits cleared), lo = x - hi exactly in f32, which the tensor cores read as TF32 by
// dropping its low 13 bits (flash_attention.cu's split, kRoundLo false).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}
__device__ __forceinline__ void split4(const float4& v, uint4& hi, uint4& lo) {
  split(v.x, hi.x, lo.x);
  split(v.y, hi.y, lo.y);
  split(v.z, hi.z, lo.z);
  split(v.w, hi.w, lo.w);
}

// d = a b + (add ? d : 0) for a warpgroup's m64 x N x k8: a and b K-major TF32 in shared memory
// (the only form wgmma takes TF32 in), f32 accumulators in the m64nNk8 layout.
__device__ __forceinline__ void wgmma_tf32_n64(float (&d)[32], uint64_t da, uint64_t db, int add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(add));
}
__device__ __forceinline__ void wgmma_tf32_n128(float (&d)[64], uint64_t da, uint64_t db, int add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(add));
}
template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2], uint64_t da, uint64_t db, int add) {
  if constexpr (N == 128) wgmma_tf32_n128(d, da, db, add);
  else wgmma_tf32_n64(d, da, db, add);
}

// The planes lie as wgmma reads K-major operands with 128-byte swizzle: row r (a row of buf's
// tile, or a column of w's, transposed as it is split) is 128 bytes, its 16-byte chunk c (k =
// 4c .. 4c + 3 of the stage) at chunk c ^ (r % 8), 8-row groups 1024 bytes apart; k-step kk
// starts 32 kk bytes into the rows.  A quarter warp's eight 16-byte stores of the split land on
// distinct banks.
__device__ __forceinline__ uint64_t desc(const uint32_t* plane, int row0, int kk) {
  return hopper::desc_sw128(hopper::smem_u32(plane) + row0 * 128 + kk * 32, 16, 1024);
}

// One operand's share of a stage: P rows of a plane (rows of the product's M or N side) by the
// stage's BK of K, loaded into registers by the tile's NTH threads and split into its hi and lo
// planes (hi at `plane`, lo P BK words further on).  Each 16-byte chunk is wholly inside or
// outside the matrix (rows 16-byte aligned, the sides multiples of 4), and those outside read as
// zeros, so a ragged edge adds zeros.  Two layouts:
// - KMajor, X(p, k) at x[p ld + k] (buf in the forward; dout and w in dbuf): chunk (row r0 + it
//   NTH / 8, k 4 ca); a quarter warp reads one row's 128 bytes and stores them to 8 distinct
//   chunks of its plane row.
// - MNMajor, X(p, k) at x[k ld + p] (w in the forward; buf and dout in dw): one 4 x 4 piece a
//   thread, at k chunk kq = 4 kh + t4 (rows 4 kq ..) and p chunk pq = 2 ph + q (a quarter warp
//   takes t4 and q), transposed as it is split, to the chunks sb[ii] of plane rows 4 pq + ii.
template <int P, int NTH>
struct KMajor {
  static constexpr int kRegs = P * BK / 4 / NTH;  // float4 a thread a stage
  static_assert(kRegs * NTH * 4 == P * BK, "tile shape");
  const float* src[kRegs];
  bool in[kRegs];
  int k4, chunk;  // this thread's k offset in a stage; its first plane chunk (+ it (NTH / 8) 8)
  // the tile's rows p0 .. p0 + P - 1 of x, `rows` rows ld floats apart
  __device__ __forceinline__ void at(const float* x, int64_t ld, int p0, int rows) {
    const int r0 = threadIdx.x >> 3, ca = threadIdx.x & 7;
    k4 = 4 * ca;
    chunk = r0 * 8 + (ca ^ (r0 & 7));  // rows r0 + it (NTH / 8) keep r0's swizzle
#pragma unroll
    for (int it = 0; it < kRegs; ++it) {
      const int r = r0 + it * (NTH / 8);
      in[it] = p0 + r < rows;
      src[it] = x + (in[it] ? p0 + r : 0) * ld + k4;
    }
  }
  __device__ __forceinline__ void load(int k0, int K, float4 (&v)[kRegs]) const {
    const bool kin = k0 + k4 < K;
#pragma unroll
    for (int it = 0; it < kRegs; ++it)
      v[it] = in[it] && kin ? *reinterpret_cast<const float4*>(src[it] + k0)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __device__ __forceinline__ void split(uint32_t* plane, const float4 (&v)[kRegs]) const {
    uint4* ph = reinterpret_cast<uint4*>(plane);
#pragma unroll
    for (int it = 0; it < kRegs; ++it) {
      uint4 hi, lo;
      split4(v[it], hi, lo);
      const int c = chunk + it * (NTH / 8) * 8;
      ph[c] = hi;
      ph[P * BK / 4 + c] = lo;
    }
  }
};

template <int P, int NTH>
struct MNMajor {
  static constexpr int kRegs = 4;
  static_assert(BK * P / 16 == NTH, "one 4 x 4 piece a thread");
  const float* src;
  int ld, k4;  // rows ld floats apart; this thread's first row of a stage, 4 kq
  bool in;
  int chunk[4];  // the plane chunks of its piece's columns
  // the tile's columns p0 .. p0 + P - 1 of x, `cols` columns, rows ld floats apart
  __device__ __forceinline__ void at(const float* x, int ld_, int p0, int cols) {
    const int t4 = threadIdx.x & 3, q = (threadIdx.x >> 2) & 1, kq = 4 * ((threadIdx.x >> 3) & 1) + t4;
    const int pq = 2 * ((threadIdx.x >> 4) % (P / 8)) + q;
    in = p0 + 4 * pq < cols;
    src = x + (in ? p0 + 4 * pq : 0);
    ld = ld_;
    k4 = 4 * kq;
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) chunk[ii] = (4 * pq + ii) * 8 + (kq ^ ((4 * q + ii) & 7));
  }
  __device__ __forceinline__ void load(int k0, int K, float4 (&v)[kRegs]) const {
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      const int k = k0 + k4 + rr;
      v[rr] = in && k < K ? *reinterpret_cast<const float4*>(src + static_cast<int64_t>(k) * ld)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  __device__ __forceinline__ void split(uint32_t* plane, const float4 (&v)[kRegs]) const {
    uint4* ph = reinterpret_cast<uint4*>(plane);
    const float col[4][4] = {{v[0].x, v[1].x, v[2].x, v[3].x}, {v[0].y, v[1].y, v[2].y, v[3].y},
                             {v[0].z, v[1].z, v[2].z, v[3].z}, {v[0].w, v[1].w, v[2].w, v[3].w}};
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      uint4 hi, lo;
      split4(make_float4(col[ii][0], col[ii][1], col[ii][2], col[ii][3]), hi, lo);
      ph[chunk[ii]] = hi;
      ph[P * BK / 4 + chunk[ii]] = lo;
    }
  }
};

// One stage's twelve wgmma from a plane set (buf or A hi, lo; w or B hi, lo), issued and
// committed: four k-steps, lo hi + hi lo first, then hi hi, summed from zero in part.  The
// tensor cores add a product into an f32 accumulator with truncation, so over granite's
// 1536-deep products one accumulator strays ~1e-4 from f32's sum (an H100, PERF.md): each
// stage's products start from zero in `part`, which joins the running sum by an f32 add.
template <class S>
__device__ __forceinline__ void stage_products(float (&part)[S::BN / 2], const uint32_t* set, int wg) {
  const uint32_t* ah = set;
  const uint32_t* al = ah + S::plane_a;
  const uint32_t* bh = al + S::plane_a;
  const uint32_t* bl = bh + S::plane_b;
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk) {
    wgmma_tf32<S::BN>(part, desc(al, 64 * wg, kk), desc(bh, 0, kk), kk);  // the small terms first
    wgmma_tf32<S::BN>(part, desc(ah, 64 * wg, kk), desc(bl, 0, kk), 1);
    wgmma_tf32<S::BN>(part, desc(ah, 64 * wg, kk), desc(bh, 0, kk), 1);
  }
  hopper::wgmma_commit();
}

// The accumulators of rows m0 .. and columns n0 .. of out (M x N, rows N floats apart, N a
// multiple of 4): acc[4 j + i] is row 16 (warp % 4) + g + 8 (i / 2) of the warpgroup's 64, column
// 8 j + 2 t + i % 2.
template <int BN>
__device__ __forceinline__ void store_tile(float* out, const float (&acc)[BN / 2], int m0, int n0, int M,
                                           int N) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row = m0 + 64 * (threadIdx.x >> 7) + 16 * ((threadIdx.x >> 5) & 3) + g;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (row + 8 * half >= M) continue;
    float* orow = out + static_cast<int64_t>(row + 8 * half) * N;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * t;  // even; N a multiple of 4
      if (col < N)
        *reinterpret_cast<float2*>(orow + col) = make_float2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
    }
  }
}

// The backward's epilogue: the accumulators of rows m0 .. (this warpgroup's 64) and columns n0 ..
// of out[e] (M x N), written into the warpgroup's staging tile (BN / 32 boxes of 64 rows by 32
// columns, 128-byte swizzled as TMA reads them: 2 wavefronts a warp's store) and stored by TMA,
// which skips rows past M and columns past N, while the threads go on to the next tile; one
// thread a warpgroup issues the stores and, before its staging tile is written again, waits
// until they have read it.  (The accumulators stored straight as 8-byte pairs, 8 rows a warp's
// store, ran dw 3.5-5% slower at granite's LM products on an H100 SXM at 700 W, dbuf the
// same; PERF.md.)
template <int BN>
__device__ __forceinline__ void store_tile_tma(const CUtensorMap* map, unsigned char* staging,
                                               const float (&acc)[BN / 2], int m0, int n0, int e, int M,
                                               int N) {
  const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bool issuer = (threadIdx.x & 127) == 0;
  const int r0 = 16 * ((threadIdx.x >> 5) & 3) + g;  // rows r0, r0 + 8 of the warpgroup's 64
  unsigned char* st = staging + wg * 64 * BN * 4;
  if (issuer) hopper::bulk_wait_read<0>();
  hopper::named_sync(1 + wg, 128);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {  // acc[4 j + i]: column 8 j + 2 t + i % 2, in box j / 4
    const int c = 2 * (j & 3) + (t >> 1);  // its 16-byte chunk of the box's 128-byte row
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + 8 * half;
      *reinterpret_cast<float2*>(st + (j >> 2) * 8192 + r * 128 + ((c ^ (r & 7)) << 4) + (t & 1) * 8) =
          make_float2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
    }
  }
  hopper::fence_async_shared();  // the staging stores, before TMA (the async proxy) reads them
  hopper::named_sync(1 + wg, 128);
  if (issuer && m0 + 64 * wg < M) {
#pragma unroll
    for (int b = 0; b < BN / 32; ++b)
      if (n0 + 32 * b < N) hopper::tma_store_3d(map, st + b * 8192, n0 + 32 * b, m0 + 64 * wg, e);
    hopper::bulk_commit();
  }
}

// The planes: [2][S::planes] words past the first 1024-byte boundary of dynamic shared memory.
// An offset from smem_raw, not a pointer rebuilt from an integer: accesses stay shared ones.
__device__ __forceinline__ uint32_t* plane_sets(unsigned char* smem_raw) {
  return reinterpret_cast<uint32_t*>(smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023));
}

// out[e] = buf[e] w[e] for the BM x BN tile (blockIdx.x: F tile, y: C tile, z: expert); buf
// K-major, w MN-major.  Per 32-deep stage kt: each warpgroup issues stage kt - 1's twelve wgmma
// on one set of planes; meanwhile the block splits stage kt, which its threads loaded into
// registers two stages ahead, into the other set, loads stage kt + 2 into the registers it frees,
// and waits for the wgmma before the barrier that opens the next stage.  The f32 tiles go from
// device memory to registers to the planes: shared memory carries only the planes' stores and
// wgmma's reads.  Each output element sums its products in one fixed order (no atomics): two
// calls give the same bits.
template <class S>
__global__ void __launch_bounds__(S::kThreads)
moe_matmul_tf32x3(const float* __restrict__ buf, const float* __restrict__ w,
                  float* __restrict__ out, int C, int D, int F) {
  constexpr int BN = S::BN, NTH = S::kThreads;
  using OpA = KMajor<S::BM, NTH>;
  using OpB = MNMajor<BN, NTH>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint32_t* planes = plane_sets(smem_raw);
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * S::BM;
  const int64_t e = blockIdx.z;
  const int wg = threadIdx.x >> 7, nk = (D + BK - 1) / BK;
  OpA A;
  OpB B;
  A.at(buf + e * C * D, D, m0, C);
  B.at(w + e * D * F, F, n0, F);

  float acc[BN / 2], part[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  float4 va[2][OpA::kRegs], vb[2][OpB::kRegs];  // stages kt and kt + 1, in buffers kt % 2, (kt + 1) % 2
  if (nk > 0) A.load(0, D, va[0]), B.load(0, D, vb[0]);
  if (nk > 1) A.load(BK, D, va[1]), B.load(BK, D, vb[1]);
  for (int k2 = 0; k2 <= nk; k2 += 2) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {  // unrolled: each stage's buffer is a fixed register set
      const int kt = k2 + u;
      if (kt > nk) break;
      // stage kt - 1 is split, and stage kt - 2's wgmma, which read the set stage kt takes, are done
      __syncthreads();
      if (kt > 0) stage_products<S>(part, planes + (u ^ 1) * S::planes, wg);
      if (kt < nk) {
        A.split(planes + u * S::planes, va[u]);
        B.split(planes + u * S::planes + 2 * S::plane_a, vb[u]);
        hopper::fence_async_shared();  // the planes' stores, before wgmma (the async proxy) reads them
      }
      if (kt + 2 < nk) A.load((kt + 2) * BK, D, va[u]), B.load((kt + 2) * BK, D, vb[u]);  // two stages ahead
      hopper::wgmma_wait<0>();
      hopper::fence_regs(part);
      if (kt > 0) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
      }
    }
  }
  store_tile<BN>(out + e * C * F, acc, m0, n0, C, F);
}

// The backward's two launches on the same arithmetic, out[e] (M x N) = sum over k < K of
// A(m, k) B(k, n), BM x BN tiles over 32-deep stages:
// - kDw false, dbuf = dout w^T: M = C, N = D, K = F; A = dout [C][F] and B(k, n) = w[n][k],
//   both K-major as stored (the forward's buf path);
// - kDw true, dw = buf^T dout: M = D, N = F, K = C; A(m, k) = buf[k][m] and B = dout [C][F],
//   both MN-major (the forward's w path, each 4 x 4 piece transposed as it is split); stages past
//   a ragged C read zeros.
// The grid is persistent: block b walks tiles t = b, b + G, ... in (expert, N tile, M tile)
// order, M fastest, and its stage loop runs on across them, so the loads of a tile's first two
// stages and the split of its first are made while the tile before finishes its products and
// hands its accumulators to TMA (store_tile_tma; out is the tensor map ``to``).  dw's K = C is
// 256 at granite's LM step: 8 stages a tile.  Each output element sums its products in one
// fixed order (no atomics): two calls give the same bits.
template <class S, bool kDw>
__global__ void __launch_bounds__(S::kThreads)
moe_matmul_bwd_tf32x3(const float* __restrict__ a, const float* __restrict__ b,
                      const __grid_constant__ CUtensorMap to, int E, int M, int N, int K) {
  constexpr int BM = S::BM, BN = S::BN, NTH = S::kThreads;
  using OpA = typename std::conditional<kDw, MNMajor<BM, NTH>, KMajor<BM, NTH>>::type;
  using OpB = typename std::conditional<kDw, MNMajor<BN, NTH>, KMajor<BN, NTH>>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint32_t* planes = plane_sets(smem_raw);
  unsigned char* staging = reinterpret_cast<unsigned char*>(planes + 2 * S::planes);  // [BM][BN] f32
  const int m_tiles = (M + BM - 1) / BM, n_tiles = (N + BN - 1) / BN, tiles = E * m_tiles * n_tiles;
  const int nk = (K + BK - 1) / BK, wg = threadIdx.x >> 7;
  const int mine = blockIdx.x < tiles ? (tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int total = mine * nk;  // this block's stages, over all its tiles

  OpA A;
  OpB B;
  int lt = blockIdx.x, lk = 0;  // the tile and stage the loads have reached
  auto seek = [&](int t) {  // point the loads at tile t
    const int64_t e = t / (m_tiles * n_tiles);
    const int m0 = t % m_tiles * BM, n0 = t / m_tiles % n_tiles * BN;
    if constexpr (kDw) {
      A.at(a + e * K * M, M, m0, M);
      B.at(b + e * K * N, N, n0, N);
    } else {
      A.at(a + e * M * K, K, m0, M);
      B.at(b + e * N * K, K, n0, N);
    }
  };
  float4 va[2][OpA::kRegs], vb[2][OpB::kRegs];  // stages s and s + 1, in buffers s % 2 and (s + 1) % 2
  auto load_next = [&](float4 (&la)[OpA::kRegs], float4 (&lb)[OpB::kRegs]) {
    A.load(lk * BK, K, la);
    B.load(lk * BK, K, lb);
    if (++lk == nk) {
      lk = 0;
      lt += gridDim.x;
      if (lt < tiles) seek(lt);
    }
  };

  float acc[BN / 2], part[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  if (total > 0) seek(lt);
  if (total > 0) load_next(va[0], vb[0]);
  if (total > 1) load_next(va[1], vb[1]);
  int ot = blockIdx.x, ok = 0;  // the tile and stage the products have reached
  for (int s2 = 0; s2 <= total; s2 += 2) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {  // unrolled: each stage's buffer is a fixed register set
      const int st = s2 + u;
      if (st > total) break;
      // stage st - 1 is split, and stage st - 2's wgmma, which read the set stage st takes, are done
      __syncthreads();
      if (st > 0) stage_products<S>(part, planes + (u ^ 1) * S::planes, wg);
      if (st < total) {
        A.split(planes + u * S::planes, va[u]);
        B.split(planes + u * S::planes + 2 * S::plane_a, vb[u]);
        hopper::fence_async_shared();  // the planes' stores, before wgmma (the async proxy) reads them
      }
      if (st + 2 < total) load_next(va[u], vb[u]);  // two stages ahead, into the next tile at its end
      hopper::wgmma_wait<0>();
      hopper::fence_regs(part);
      if (st > 0) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
        if (++ok == nk) {  // stage st - 1 was tile ot's last: store it while the next one loads
          store_tile_tma<BN>(&to, staging, acc, ot % m_tiles * BM, ot / m_tiles % n_tiles * BN,
                             ot / (m_tiles * n_tiles), M, N);
#pragma unroll
          for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
          ok = 0;
          ot += gridDim.x;
        }
      }
    }
  }
  if ((threadIdx.x & 127) == 0) hopper::bulk_wait<0>();  // the stores have read the staging
}

}  // namespace tf

namespace tc {  // bf16 on wgmma fed by TMA

using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr int kDepth = 64;  // D per stage: one 128-byte swizzled row of bf16
constexpr int kRows = 128;  // wgmma: rows of C per tile, 64 per consumer warpgroup
constexpr int kThreads = 3 * 128;  // two consumer warpgroups, one producer
constexpr int kTRows = 8;  // wgmma_t: rows of C per unit (wgmma's N)
constexpr int kTCols = 64;  // wgmma_t: columns of F per unit (wgmma's M)
constexpr int kTThreads = 128 + 32;
constexpr int kTBlocksPerSM = 3;

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// Byte offset of the 16-bit element (r, c) of a [rows][64] tile that
// starts 1024-byte aligned, laid out as TMA's 128-byte swizzle lays it out.
__device__ __forceinline__ int sw128(int r, int c) {
  return r * 128 + ((((c >> 3) ^ r) & 7) << 4) + (c & 7) * 2;
}

// Shared-memory layouts (byte offsets past a 1024-byte aligned base; the
// 1024 bytes of slack in `bytes` pay for the alignment).  wgmma: the ring's
// buf tiles [128][64], its w tiles (BN / 64 chunks of [64][64] each), in as
// many stages as 192 KB hold, two 64 x 64 staging tiles per consumer
// warpgroup, then full[ST] and empty[ST].
template <int BN>
struct WgSmem {
  static constexpr int ST = 192 * 1024 / ((kRows + BN) * kDepth * 2);
  static constexpr int a_tile = kRows * kDepth * 2, b_tile = kDepth * BN * 2;
  static constexpr int a = 0, b = ST * a_tile, out = b + ST * b_tile;
  static constexpr int bars = out + 2 * 2 * 64 * 64 * 2;
  static constexpr int bytes = 1024 + bars + 8 * 2 * ST;
};
// wgmma_t: the ring's w tiles [64 of D][64 of F] and buf tiles [8][64 of D],
// two [8][64] staging tiles, then full[ST] and empty[ST].
struct TSmem {
  static constexpr int ST = 7;
  static constexpr int w_tile = kDepth * kTCols * 2, x_tile = kTRows * kDepth * 2;
  static constexpr int w = 0, x = ST * w_tile, out = x + ST * x_tile;
  static constexpr int bars = out + 2 * kTRows * kTCols * 2;
  static constexpr int bytes = 1024 + bars + 8 * 2 * ST;
};

// A block's walk through its output tiles, for the producer: stage `it` is
// depth step it % nk of the block's (it / nk)-th tile, tile t = blockIdx.x
// + (it / nk) gridDim.x: expert t / (c_tiles f_tiles), F tile (t / c_tiles)
// % f_tiles, C tile t % c_tiles.  A stage is one buf box of `rows` rows of C
// and cols / 64 weight boxes, each 64 deep in D.
struct Walk {
  int c_tiles, f_tiles, tiles, nk, rows, cols;
  __device__ bool at(int it, int& e, int& c0, int& f0, int& k0) const {
    const int t = blockIdx.x + it / nk * gridDim.x;
    if (t >= tiles) return false;
    e = t / (c_tiles * f_tiles);
    f0 = t / c_tiles % f_tiles * cols;
    c0 = t % c_tiles * rows;
    k0 = it % nk * kDepth;
    return true;
  }
};

// The producer thread: fill the ring (buf boxes into a_ring, [ST][rows][64];
// weight boxes into w_ring, [ST][cols / 64][64][64]) stage by stage as the
// consumers free it.
template <int ST>
__device__ __forceinline__ void produce(const Walk& w, const CUtensorMap* ta, const CUtensorMap* tw,
                                        bf16* a_ring, bf16* w_ring, uint64_t* full, uint64_t* empty) {
  const uint32_t bytes = (w.rows + w.cols) * kDepth * 2;
  int e, c0, f0, k0;
  for (int it = 0; w.at(it, e, c0, f0, k0); ++it) {
    const int s = it % ST;
    if (it >= ST) mbar_wait(empty + s, (it / ST - 1) & 1);
    mbar_expect_tx(full + s, bytes);
    tma_load_3d(a_ring + s * w.rows * 64, ta, full + s, k0, c0, e);
    for (int j = 0; j < w.cols / 64; ++j)
      tma_load_3d(w_ring + (s * (w.cols / 64) + j) * 64 * 64, tw, full + s, f0 + 64 * j, k0, e);
  }
}

// A TMA route is a programmatic dependent launch: its blocks may start
// while the kernel before it on the stream finishes, and wait for it here,
// after setting up, before any read or write of device memory.  Each block
// then lets the next such launch start.
__device__ __forceinline__ void wait_for_previous_kernel() {
  grid_dependency_wait();
  launch_dependents();
}

// "wgmma" route.  Tile t: expert t / (c_tiles f_tiles), F tile
// (t / c_tiles) % f_tiles, C tile t % c_tiles; block b takes t = b, b + G,
// ...  Warps 0-7 are two consumer warpgroups (rows 0-63 and 64-127 of the
// tile), warps 8-11 the producer warpgroup, of which one thread issues the
// loads; the producer gives its registers to the consumers' accumulators.
template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
moe_matmul_wgmma(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tw,
                 const __grid_constant__ CUtensorMap to, int E, int C, int D, int F) {
  using L = WgSmem<BN>;
  constexpr int ST = L::ST, NC = BN / 64;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  bf16* As = reinterpret_cast<bf16*>(sm + L::a);  // [ST][128][64]
  bf16* Bs = reinterpret_cast<bf16*>(sm + L::b);  // [ST][NC][64][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::bars);
  uint64_t* empty = full + ST;
  const int c_tiles = (C + kRows - 1) / kRows, f_tiles = (F + BN - 1) / BN;
  const int tiles = E * f_tiles * c_tiles, nk = (D + kDepth - 1) / kDepth;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 8);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();
  wait_for_previous_kernel();

  if (warp >= 8) {  // producer warpgroup
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256)
      produce<ST>(Walk{c_tiles, f_tiles, tiles, nk, kRows, BN}, &ta, &tw, As, Bs, full, empty);
    return;
  }

  setmaxnreg_inc<232>();
  const int wg = warp >> 2, tid = threadIdx.x & 127, g = lane >> 2, tq = lane & 3;
  const int r0 = (warp & 3) * 16 + g;  // this thread's rows of the warpgroup's 64: r0, r0 + 8
  unsigned char* staging = sm + L::out + wg * 2 * 8192;
  auto release = [&](int s) {  // this warp is done with stage s
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);
  };
  int it = 0, stores = 0;
  float acc[BN / 2];
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int e = t / (c_tiles * f_tiles), f0 = (t / c_tiles) % f_tiles * BN;
    const int c0 = t % c_tiles * kRows;
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int s = it % ST;
      mbar_wait(full + s, (it / ST) & 1);
      __syncwarp();
      const bf16* At = As + s * kRows * 64;
      const bf16* Bt = Bs + s * NC * 64 * 64;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t da = desc_k(At, kRows, wg * 64, kk), db = desc_mn(Bt, 64, 0, kk);
        if constexpr (BN == 256)
          wgmma_ss_n256<1>(acc, da, db, kt | kk);
        else
          wgmma_ss_n128<1>(acc, da, db, kt | kk);
      }
      wgmma_commit();
      // Wait for this stage's products and free the stage at once, so that
      // ST - 1 stages stay in flight; the other warpgroup's products keep
      // the tensor cores busy meanwhile.
      wgmma_wait<0>();
      release(s);
    }
    fence_regs(acc);
    if (c0 + wg * 64 >= C) continue;  // the warpgroup's rows are all past C
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      if (f0 + 64 * j >= F) break;
      unsigned char* st = staging + (stores++ & 1) * 8192;
      if (tid == 0) bulk_wait_read<1>();  // the store that last used st has read it
      named_sync(1 + wg, 128);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int i = 4 * (8 * j + jj);
        *reinterpret_cast<uint32_t*>(st + sw128(r0, 8 * jj + 2 * tq)) = pack_bf16(acc[i], acc[i + 1]);
        *reinterpret_cast<uint32_t*>(st + sw128(r0 + 8, 8 * jj + 2 * tq)) =
            pack_bf16(acc[i + 2], acc[i + 3]);
      }
      fence_async_shared();
      named_sync(1 + wg, 128);
      if (tid == 0) {
        tma_store_3d(&to, st, f0 + 64 * j, c0 + wg * 64, e);
        bulk_commit();
      }
    }
  }
  if (tid == 0) bulk_wait<0>();
}

// "wgmma_t" route.  Unit u: expert u / (c_tiles f_tiles), F tile
// (u / c_tiles) % f_tiles, C tile u % c_tiles (8 rows); block b takes
// u = b, b + G, ...  Warps 0-3 are the consumer warpgroup, warp 4 the
// producer.  Accumulator rows are columns f of F, its columns rows c of C.
__global__ void __launch_bounds__(kTThreads, kTBlocksPerSM)
moe_matmul_wgmma_t(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                   const __grid_constant__ CUtensorMap to, int E, int C, int D, int F) {
  using L = TSmem;
  constexpr int ST = L::ST;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  bf16* Ws = reinterpret_cast<bf16*>(sm + L::w);  // [ST][64 of D][64 of F]
  bf16* Xs = reinterpret_cast<bf16*>(sm + L::x);  // [ST][8 of C][64 of D]
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::bars);
  uint64_t* empty = full + ST;
  const int c_tiles = (C + kTRows - 1) / kTRows, f_tiles = (F + kTCols - 1) / kTCols;
  const int units = E * f_tiles * c_tiles, nk = (D + kDepth - 1) / kDepth;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 4);
    }
    mbar_init_fence();
  }
  __syncthreads();
  wait_for_previous_kernel();

  if (warp == 4) {  // producer
    if (lane == 0)
      produce<ST>(Walk{c_tiles, f_tiles, units, nk, kTRows, kTCols}, &tx, &tw, Xs, Ws, full, empty);
    return;
  }

  const int tid = threadIdx.x, g = lane >> 2, tq = lane & 3;
  const int f_lo = warp * 16 + g;  // this thread's columns of F: f_lo, f_lo + 8
  auto release = [&](int s) {  // this warp is done with stage s
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);
  };
  int it = 0, stores = 0;
  float acc[4];
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int e = u / (c_tiles * f_tiles), f0 = (u / c_tiles) % f_tiles * kTCols;
    const int c0 = u % c_tiles * kTRows;
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int s = it % ST;
      mbar_wait(full + s, (it / ST) & 1);
      __syncwarp();
      const bf16* Wt = Ws + s * kDepth * kTCols;
      const bf16* Xt = Xs + s * kTRows * kDepth;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_n8_ta(acc, desc_mn(Wt, 64, 0, kk), desc_k(Xt, kTRows, 0, kk), kt | kk);
      wgmma_commit();
      wgmma_wait<0>();  // free the stage at once: ST - 1 stages stay in flight
      release(s);
    }
    fence_regs(acc);
    unsigned char* st = sm + L::out + (stores++ & 1) * kTRows * kTCols * 2;
    if (tid == 0) bulk_wait_read<1>();  // the store that last used st has read it
    named_sync(1, 128);
#pragma unroll
    for (int i = 0; i < 4; ++i)  // element i: column f_lo + 8 (i / 2) of F, row 2 tq + i % 2 of C
      *reinterpret_cast<bf16*>(st + sw128(2 * tq + (i & 1), f_lo + 8 * (i >> 1))) =
          __float2bfloat16(acc[i]);
    fence_async_shared();
    named_sync(1, 128);
    if (tid == 0) {
      tma_store_3d(&to, st, f0, c0, e);
      bulk_commit();
    }
  }
  if (tid == 0) bulk_wait<0>();
}

// d (+)= A B on one m64nBNk16 wgmma, BN = 64, 128 or 256.
template <int BN, int kTransB, int kTransA = 0>
__device__ __forceinline__ void wgmma_ss(float (&d)[BN / 2], uint64_t da, uint64_t db, int accumulate) {
  if constexpr (BN == 64)
    wgmma_ss_n64<kTransB, kTransA>(d, da, db, accumulate);
  else if constexpr (BN == 128)
    wgmma_ss_n128<kTransB, kTransA>(d, da, db, accumulate);
  else
    wgmma_ss_n256<kTransB, kTransA>(d, da, db, accumulate);
}

// Backward on wgmma ("wgmma" route of bwd_plan), 128 x BN tiles of out[e]
// (M x N) over K in 64-deep stages; the walk, the ring and the epilogue are
// moe_matmul_wgmma<BN>'s.  Tried at granite's products on an H100 SXM at
// 700 W and not kept: keeping one stage's products in flight while a
// consumer issues the next stage's, freeing each stage a step later (1-5%
// slower); storing the accumulators straight to device memory instead of
// through the staging tiles and TMA (dw 1.9x slower: 4-byte stores
// scattered over eight rows a warp); and clusters of two blocks on the two
// 128-row tiles of a 256-row pair, sharing the B tile by TMA multicast, so
// that a quarter fewer bytes cross from L2 (1.4-2x slower, with all 66
// clusters resident: each stage then waits for both blocks' consumers).  bwd_plan picks BN per launch (64, 128 or 256)
// for the fewest rounds of tiles over the SMs weighed by a tile's time.
// kDw = false, dbuf: M = C, N = D, K = F; A = dout boxes [128 of C][64 of F]
//   (K-major), B = w boxes [64 of D][64 of F], BN / 64 per stage (K-major).
// kDw = true, dw: M = D, N = F, K = C; A = buf boxes [64 of C][64 of D], one
//   per consumer warpgroup (MN-major, wgmma's transposed A), B = dout boxes
//   [64 of C][64 of F], BN / 64 per stage (MN-major).
template <bool kDw, int BN>
__device__ __forceinline__ void produce_bwd(const Walk& w, const CUtensorMap* ta,
                                            const CUtensorMap* tb, bf16* a_ring, bf16* b_ring,
                                            uint64_t* full, uint64_t* empty) {
  constexpr int ST = WgSmem<BN>::ST, NB = BN / 64;
  int e, m0, n0, k0;
  for (int it = 0; w.at(it, e, m0, n0, k0); ++it) {
    const int s = it % ST;
    if (it >= ST) mbar_wait(empty + s, (it / ST - 1) & 1);
    mbar_expect_tx(full + s, (kRows + BN) * kDepth * 2);
    bf16* a = a_ring + s * kRows * 64;
    bf16* b = b_ring + s * NB * 64 * 64;
    if constexpr (kDw) {
      for (int h = 0; h < 2; ++h) tma_load_3d(a + h * 64 * 64, ta, full + s, m0 + 64 * h, k0, e);
      for (int j = 0; j < NB; ++j) tma_load_3d(b + j * 64 * 64, tb, full + s, n0 + 64 * j, k0, e);
    } else {
      tma_load_3d(a, ta, full + s, k0, m0, e);
      for (int j = 0; j < NB; ++j) tma_load_3d(b + j * 64 * 64, tb, full + s, k0, n0 + 64 * j, e);
    }
  }
}

template <bool kDw, int BN>
__global__ void __launch_bounds__(kThreads, 1)
moe_matmul_bwd_wgmma(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                     const __grid_constant__ CUtensorMap to, int E, int M, int N, int K) {
  using L = WgSmem<BN>;
  constexpr int ST = L::ST, NB = BN / 64;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  bf16* As = reinterpret_cast<bf16*>(sm + L::a);  // [ST][128 * 64]
  bf16* Bs = reinterpret_cast<bf16*>(sm + L::b);  // [ST][NB][64][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::bars);
  uint64_t* empty = full + ST;
  const int m_tiles = (M + kRows - 1) / kRows, n_tiles = (N + BN - 1) / BN;
  const int tiles = E * n_tiles * m_tiles, nk = (K + kDepth - 1) / kDepth;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 8);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();
  wait_for_previous_kernel();

  if (warp >= 8) {  // producer warpgroup
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256)
      produce_bwd<kDw, BN>(Walk{m_tiles, n_tiles, tiles, nk, kRows, BN}, &ta, &tb, As, Bs, full, empty);
    return;
  }

  setmaxnreg_inc<232>();
  const int wg = warp >> 2, tid = threadIdx.x & 127, g = lane >> 2, tq = lane & 3;
  const int r0 = (warp & 3) * 16 + g;
  unsigned char* staging = sm + L::out + wg * 2 * 8192;
  int it = 0, stores = 0;
  float acc[BN / 2];
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int e = t / (m_tiles * n_tiles), n0 = (t / m_tiles) % n_tiles * BN;
    const int m0 = t % m_tiles * kRows;
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int s = it % ST;
      mbar_wait(full + s, (it / ST) & 1);
      __syncwarp();
      const bf16* At = As + s * kRows * 64;
      const bf16* Bt = Bs + s * NB * 64 * 64;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if constexpr (kDw)
          wgmma_ss<BN, 1, 1>(acc, desc_mn(At + wg * 64 * 64, 64, 0, kk), desc_mn(Bt, 64, 0, kk), kt | kk);
        else
          wgmma_ss<BN, 0>(acc, desc_k(At, kRows, wg * 64, kk), desc_k(Bt, BN, 0, kk), kt | kk);
      }
      wgmma_commit();
      wgmma_wait<0>();
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + s);
    }
    fence_regs(acc);
    if (m0 + wg * 64 >= M) continue;  // the warpgroup's rows are all past M
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      if (n0 + 64 * j >= N) break;
      unsigned char* st = staging + (stores++ & 1) * 8192;
      if (tid == 0) bulk_wait_read<1>();
      named_sync(1 + wg, 128);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int i = 4 * (8 * j + jj);
        *reinterpret_cast<uint32_t*>(st + sw128(r0, 8 * jj + 2 * tq)) = pack_bf16(acc[i], acc[i + 1]);
        *reinterpret_cast<uint32_t*>(st + sw128(r0 + 8, 8 * jj + 2 * tq)) =
            pack_bf16(acc[i + 2], acc[i + 3]);
      }
      fence_async_shared();
      named_sync(1 + wg, 128);
      if (tid == 0) {
        tma_store_3d(&to, st, n0 + 64 * j, m0 + wg * 64, e);
        bulk_commit();
      }
    }
  }
  if (tid == 0) bulk_wait<0>();
}

}  // namespace tc

namespace {

// Route ids; kFma is the backward's only.
enum Route { kWgmma = 0, kWgmmaT = 1, kFma = 2, kMasked = 3, kTf32x3 = 4 };

// What a launch plan states; the entry point compares it with its own.
struct Plan {
  int route, block_n, block_k, stages, threads, grid_x, grid_y, grid_z;
  int64_t smem;
  bool operator==(const Plan& o) const {
    return route == o.route && block_n == o.block_n && block_k == o.block_k && stages == o.stages &&
           threads == o.threads && grid_x == o.grid_x && grid_y == o.grid_y && grid_z == o.grid_z &&
           smem == o.smem;
  }
};

int persistent(int64_t work, int per_sm) {
  const int64_t most = static_cast<int64_t>(hopper::kSMs) * per_sm;
  return static_cast<int>(work < most ? work : most);
}

template <int BN>
Plan wgmma_plan(int64_t tiles) {
  using L = tc::WgSmem<BN>;
  return {kWgmma, BN, tc::kDepth, L::ST, tc::kThreads, persistent(tiles, 1), 1, 1, L::bytes};
}

template <class S>
Plan tf_plan(int E, int C, int F) {
  return {kTf32x3, S::BN, tf::BK, 2, S::kThreads, (F + S::BN - 1) / S::BN,
          (C + S::BM - 1) / S::BM, E, S::bytes};
}

// The plan of a route for these sizes; block_n is the wgmma tile width.
Plan own_plan(int route, int dtype, int E, int C, int D, int F, int block_n) {
  const int64_t e = E;
  switch (route) {
    case kWgmma: {
      const int64_t tiles = e * ((F + block_n - 1) / block_n) * ((C + tc::kRows - 1) / tc::kRows);
      return block_n == 256 ? wgmma_plan<256>(tiles) : wgmma_plan<128>(tiles);
    }
    case kWgmmaT: {
      const int64_t units = e * ((F + tc::kTCols - 1) / tc::kTCols) * ((C + tc::kTRows - 1) / tc::kTRows);
      return {route, tc::kTCols, tc::kDepth, tc::TSmem::ST, tc::kTThreads,
              persistent(units, tc::kTBlocksPerSM), 1, 1, tc::TSmem::bytes};
    }
    case kTf32x3:
      return C <= tf::Small::BM ? tf_plan<tf::Small>(E, C, F) : tf_plan<tf::Wide>(E, C, F);
    default: {
      const int64_t smem = dtype == 1 ? static_smem<__nv_bfloat16>() : static_smem<float>();
      return {route, BN, BK, 1, kThreads, static_cast<int>((F + BN - 1) / BN),
              static_cast<int>((C + BM - 1) / BM), E, smem};
    }
  }
}

template <typename T>
cudaError_t launch_cuda_cores(const void* buf, const void* w, void* out, int C, int D, int F,
                              const Plan& p, cudaStream_t stream) {
  constexpr int N = Vec<T>::N;
  const bool vec_a = D % N == 0 && reinterpret_cast<uintptr_t>(buf) % 16 == 0;
  const bool vec_w = F % N == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const dim3 grid(p.grid_x, p.grid_y, p.grid_z);
  const T* bp = static_cast<const T*>(buf);
  const T* wp = static_cast<const T*>(w);
  T* op = static_cast<T*>(out);
  moe_matmul_kernel<T><<<grid, kThreads, 0, stream>>>(bp, wp, op, C, D, F, vec_a, vec_w);
  return cudaGetLastError();
}

// A TMA route: encode the 3-D tensor maps (buf: boxes of a_rows rows of C
// by 64 of D; w: 64 of D by 64 of F; out: o_rows of C by 64 of F), then
// launch it as a dependent launch.  The kernel's shared-memory attributes
// are set on its first launch on each device (they stay with the
// function; the plan check has fixed p.smem to the kernel's own size).
template <auto kKernel>
cudaError_t configure_once(int64_t smem) {
  static std::atomic<uint64_t> configured{0};  // one bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (!(configured.load(std::memory_order_acquire) & bit)) {
    err = cudaFuncSetAttribute(kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kKernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    configured.fetch_or(bit, std::memory_order_release);
  }
  return cudaSuccess;
}

template <class S>
cudaError_t launch_tf32x3(const void* buf, const void* w, void* out, int C, int D, int F,
                          const Plan& p, cudaStream_t stream) {
  constexpr auto kernel = tf::moe_matmul_tf32x3<S>;
  cudaError_t err = configure_once<kernel>(p.smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(p.grid_x, p.grid_y, p.grid_z), S::kThreads, p.smem, stream>>>(
      static_cast<const float*>(buf), static_cast<const float*>(w), static_cast<float*>(out), C, D, F);
  return cudaGetLastError();
}

template <auto kKernel>
cudaError_t launch_tma(int a_rows, int o_rows, const void* buf, const void* w, void* out, int E,
                       int C, int D, int F, const Plan& p, cudaStream_t stream) {
  cudaError_t err = configure_once<kKernel>(p.smem);
  if (err != cudaSuccess) return err;
  CUtensorMap ta, tw, to;
  if (!hopper::map_bf16_3d(&ta, buf, D, C, E, a_rows) || !hopper::map_bf16_3d(&tw, w, F, D, E, 64) ||
      !hopper::map_bf16_3d(&to, out, F, C, E, o_rows))
    return cudaErrorInvalidValue;
  err = hopper::launch_dependent(kKernel, dim3(p.grid_x), dim3(p.threads), p.smem, stream, ta, tw, to,
                                 E, C, D, F);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  buf [E, C, D], w [E, D, F] and out
// [E, C, F] are contiguous, of one dtype.  plan holds the launch plan of
// kernels/moe_matmul.py as nine integers: route (0 wgmma, 1 wgmma_t, 3
// masked, 4 tf32x3), block_n, block_k, stages, threads, grid x, y, z and shared
// memory bytes; a plan whose route is not the one these sizes and
// alignments call for, or whose other fields are not that route's, is
// refused with cudaErrorInvalidConfiguration.  Returns cudaGetLastError()
// after the launch.
extern "C" int moe_matmul_fwd(int dtype, const int64_t* plan_in, const void* buf, const void* w,
                              void* out, int64_t E, int64_t C, int64_t D, int64_t F, void* stream) {
  if (E <= 0 || C <= 0 || F <= 0 || D < 0 || E > 65535 || (C + BM - 1) / BM > 65535 ||
      C > 0x7fffffff || D > 0x7fffffff || F > 0x7fffffff || (dtype != 0 && dtype != 1) ||
      E * ((C + 7) / 8) * ((F + 63) / 64) > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const int e = static_cast<int>(E), c = static_cast<int>(C), d = static_cast<int>(D),
            f = static_cast<int>(F);
  const bool aligned = (reinterpret_cast<uintptr_t>(buf) | reinterpret_cast<uintptr_t>(w) |
                        reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  int want;
  if (dtype == 1)
    want = aligned && d > 0 && d % 8 == 0 && f % 8 == 0 ? (c <= 32 ? kWgmmaT : kWgmma) : kMasked;
  else
    want = aligned && d % 4 == 0 && f % 4 == 0 ? kTf32x3 : kMasked;
  const int bn = d > f ? 256 : 128;  // the wgmma tile width: 256 for gate/up (D > F), 128 for down
  const Plan given{static_cast<int>(plan_in[0]), static_cast<int>(plan_in[1]),
                   static_cast<int>(plan_in[2]), static_cast<int>(plan_in[3]),
                   static_cast<int>(plan_in[4]), static_cast<int>(plan_in[5]),
                   static_cast<int>(plan_in[6]), static_cast<int>(plan_in[7]), plan_in[8]};
  const Plan plan = own_plan(want, dtype, e, c, d, f, bn);
  if (!(given == plan)) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (want) {
    case kWgmma:
      err = bn == 256
                ? launch_tma<tc::moe_matmul_wgmma<256>>(tc::kRows, 64, buf, w, out, e, c, d, f, plan, s)
                : launch_tma<tc::moe_matmul_wgmma<128>>(tc::kRows, 64, buf, w, out, e, c, d, f, plan, s);
      break;
    case kWgmmaT:
      err = launch_tma<tc::moe_matmul_wgmma_t>(tc::kTRows, tc::kTRows, buf, w, out, e, c, d, f, plan, s);
      break;
    case kTf32x3:
      err = c <= tf::Small::BM ? launch_tf32x3<tf::Small>(buf, w, out, c, d, f, plan, s)
                               : launch_tf32x3<tf::Wide>(buf, w, out, c, d, f, plan, s);
      break;
    default:
      err = dtype == 1 ? launch_cuda_cores<__nv_bfloat16>(buf, w, out, c, d, f, plan, s)
                       : launch_cuda_cores<float>(buf, w, out, c, d, f, plan, s);
  }
  return static_cast<int>(err);
}

namespace {

// The backward's tile width on wgmma for one launch (out M x N over K): of
// 64, 128 and 256 columns, the one whose rounds of tiles over the persistent
// blocks, each weighed by a tile's time, are least; ties go to the wider.  A
// tile's time is its K / 64 stages times a stage's time at that width, read
// on the card at granite's four products (1/100 us: 52, 70 and 135 for 64,
// 128 and 256 columns).  A stage does not get cheaper in proportion to its
// width: every width streams its operands from L2 at 4.4-6 TB/s over the
// SMs, and the 256-wide ring holds only four stages.  moe_matmul.py's
// _bwd_tile_n is the same arithmetic.
int bwd_tile_n(int64_t E, int64_t M, int64_t N, int64_t K) {
  const int64_t nk = (K + tc::kDepth - 1) / tc::kDepth;
  int best = 0;
  int64_t best_cost = 0;
  for (int bn : {256, 128, 64}) {
    const int64_t tiles = E * ((M + tc::kRows - 1) / tc::kRows) * ((N + bn - 1) / bn);
    const int64_t rounds = (tiles + hopper::kSMs - 1) / hopper::kSMs;
    const int64_t cost = rounds * nk * (bn == 256 ? 135 : bn == 128 ? 70 : 52);
    if (best == 0 || cost < best_cost) best = bn, best_cost = cost;
  }
  return best;
}

template <class S>
int64_t tf_tiles(int64_t E, int64_t M, int64_t N) {
  return E * ((M + S::BM - 1) / S::BM) * ((N + S::BN - 1) / S::BN);
}

template <class S>
Plan tf_bwd_plan(int64_t E, int64_t M, int64_t N, int per_sm) {
  return {kTf32x3, S::BN, tf::BK, 2, S::kThreads, persistent(tf_tiles<S>(E, M, N), per_sm), 1, 1,
          S::bwd_bytes};
}

// The backward's tf32x3 tiles: 64 x 64 where M <= 64 or 128 x 128 tiles would not fill the SMs
// once (the reduced configs), else 128 x 128.  moe_matmul.py's _tf_bwd_small.
bool tf_bwd_small(int64_t E, int64_t M, int64_t N) {
  return M <= tf::Small::BM || tf_tiles<tf::Wide>(E, M, N) < hopper::kSMs;
}

// The backward's own plan for one of its two launches (which: 0 dbuf, 1 dw);
// a launch's product is out M x N over K: (C, D, F) for dbuf, (D, F, C) for dw.
Plan bwd_plan(int route, int which, int E, int C, int D, int F) {
  const int64_t M = which == 0 ? C : D, N = which == 0 ? D : F, K = which == 0 ? F : C;
  if (route == kTf32x3)
    return tf_bwd_small(E, M, N) ? tf_bwd_plan<tf::Small>(E, M, N, tf::kBwdSmallBlocks)
                                 : tf_bwd_plan<tf::Wide>(E, M, N, tf::kBwdWideBlocks);
  if (route == kWgmma) {
    const int bn = bwd_tile_n(E, M, N, K);
    const int64_t tiles = static_cast<int64_t>(E) * ((M + 127) / 128) * ((N + bn - 1) / bn);
    return bn == 64 ? wgmma_plan<64>(tiles) : bn == 128 ? wgmma_plan<128>(tiles) : wgmma_plan<256>(tiles);
  }
  const int bm = static_cast<int64_t>(E) * ((M + 127) / 128) * ((N + 127) / 128) >= hopper::kSMs ? 128 : 64;
  return {kFma, bm, kFmaK, 2, kFmaThreads, static_cast<int>((N + bm - 1) / bm),
          static_cast<int>((M + bm - 1) / bm), E,
          bm == 128 ? FmaTile<128>::bytes : FmaTile<64>::bytes};
}

// The tensor maps of one wgmma launch, then the launch: dbuf reads dout [E][C][F]
// in boxes of 128 rows and w [E][D][F], writes dbuf [E][C][D]; dw reads buf [E][C][D]
// and dout, writes dw [E][D][F]; every box 64 values wide.
template <bool kDw, int BN>
cudaError_t launch_bwd_wgmma_n(const void* a, const void* b, void* out, int E, int C, int D, int F,
                             const Plan& p, cudaStream_t s) {
  constexpr auto kernel = tc::moe_matmul_bwd_wgmma<kDw, BN>;
  cudaError_t err = configure_once<kernel>(p.smem);
  if (err != cudaSuccess) return err;
  CUtensorMap ta, tb, to;
  const bool ok = kDw
      ? hopper::map_bf16_3d(&ta, a, D, C, E, 64) && hopper::map_bf16_3d(&tb, b, F, C, E, 64) &&
            hopper::map_bf16_3d(&to, out, F, D, E, 64)
      : hopper::map_bf16_3d(&ta, a, F, C, E, tc::kRows) && hopper::map_bf16_3d(&tb, b, F, D, E, 64) &&
            hopper::map_bf16_3d(&to, out, D, C, E, 64);
  if (!ok) return cudaErrorInvalidValue;
  const int M = kDw ? D : C, N = kDw ? F : D, K = kDw ? C : F;
  err = hopper::launch_dependent(kernel, dim3(p.grid_x), dim3(p.threads), p.smem, s, ta, tb, to, E, M,
                                 N, K);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <bool kDw>
cudaError_t launch_bwd_wgmma(const void* a, const void* b, void* out, int E, int C, int D, int F,
                             const Plan& p, cudaStream_t s) {
  switch (p.block_n) {
    case 64: return launch_bwd_wgmma_n<kDw, 64>(a, b, out, E, C, D, F, p, s);
    case 128: return launch_bwd_wgmma_n<kDw, 128>(a, b, out, E, C, D, F, p, s);
    default: return launch_bwd_wgmma_n<kDw, 256>(a, b, out, E, C, D, F, p, s);
  }
}

// One tf32x3 launch: a and b as moe_matmul_bwd takes them, out M x N over K.
template <class S, bool kDw>
cudaError_t launch_bwd_tf32x3_s(const void* a, const void* b, void* out, int E, int M, int N, int K,
                                const Plan& p, cudaStream_t s) {
  constexpr auto kernel = tf::moe_matmul_bwd_tf32x3<S, kDw>;
  cudaError_t err = configure_once<kernel>(p.smem);
  if (err != cudaSuccess) return err;
  CUtensorMap to;  // out [E][M][N] in boxes of 64 rows by 32 columns
  if (!hopper::map_f32_3d(&to, out, N, M, E, 64)) return cudaErrorInvalidValue;
  kernel<<<p.grid_x, S::kThreads, p.smem, s>>>(static_cast<const float*>(a), static_cast<const float*>(b), to,
                                                E, M, N, K);
  return cudaGetLastError();
}

template <bool kDw>
cudaError_t launch_bwd_tf32x3(const void* a, const void* b, void* out, int E, int C, int D, int F,
                              const Plan& p, cudaStream_t s) {
  const int M = kDw ? D : C, N = kDw ? F : D, K = kDw ? C : F;
  return tf_bwd_small(E, M, N) ? launch_bwd_tf32x3_s<tf::Small, kDw>(a, b, out, E, M, N, K, p, s)
                               : launch_bwd_tf32x3_s<tf::Wide, kDw>(a, b, out, E, M, N, K, p, s);
}

// One fma launch: (M, N, K) and each operand's expert stride and leading dimension.
template <typename T, int BM, bool kVec>
cudaError_t launch_bwd_fma(int which, const void* a, const void* b, void* out, int64_t E, int64_t C,
                           int64_t D, int64_t F, const Plan& p, cudaStream_t s) {
  const dim3 grid(p.grid_x, p.grid_y, p.grid_z);
  const T* ap = static_cast<const T*>(a);
  const T* bp = static_cast<const T*>(b);
  T* op = static_cast<T*>(out);
  if (which == 0)  // dbuf = dout w^T: A = dout [C][F], B(k, n) = w[n][k], both along k
    moe_matmul_bwd_fma<T, BM, true, kVec><<<grid, kFmaThreads, 0, s>>>(
        ap, bp, op, static_cast<int>(C), static_cast<int>(D), static_cast<int>(F), C * F, F, D * F, F);
  else  // dw = buf^T dout: A(m, k) = buf[k][m], B = dout [C][F], both along m, n
    moe_matmul_bwd_fma<T, BM, false, kVec><<<grid, kFmaThreads, 0, s>>>(
        ap, bp, op, static_cast<int>(D), static_cast<int>(F), static_cast<int>(C), C * D, D, C * F, F);
  return cudaGetLastError();
}

// vec: every 4-element group aligned, which only bf16 brings here (aligned f32 takes tf32x3)
template <typename T>
cudaError_t launch_bwd_fma(int which, bool vec, const void* a, const void* b, void* out, int64_t E,
                           int64_t C, int64_t D, int64_t F, const Plan& p, cudaStream_t s) {
  if constexpr (sizeof(T) == 2) {
    if (vec)
      return p.block_n == 128 ? launch_bwd_fma<T, 128, true>(which, a, b, out, E, C, D, F, p, s)
                              : launch_bwd_fma<T, 64, true>(which, a, b, out, E, C, D, F, p, s);
  }
  return p.block_n == 128 ? launch_bwd_fma<T, 128, false>(which, a, b, out, E, C, D, F, p, s)
                          : launch_bwd_fma<T, 64, false>(which, a, b, out, E, C, D, F, p, s);
}

}  // namespace

// Backward of moe_matmul_fwd, one launch per gradient.  which = 0: out =
// dbuf [E, C, D] = a w^T with a = dout [E, C, F], b = w [E, D, F]; which =
// 1: out = dw [E, D, F] = a^T b with a = buf [E, C, D], b = dout [E, C, F].
// All contiguous, of one dtype (0 f32, 1 bf16).  plan: moe_matmul.py's
// bwd_plan for this launch as nine integers (route 0 wgmma, 2 fma or 4
// tf32x3, block_n, block_k, stages, threads, grid x, y, z, shared-memory
// bytes); any other returns cudaErrorInvalidConfiguration.
extern "C" int moe_matmul_bwd(int which, int dtype, const int64_t* plan_in, const void* a,
                              const void* b, void* out, int64_t E, int64_t C, int64_t D, int64_t F,
                              void* stream) {
  if (E <= 0 || C <= 0 || D <= 0 || F <= 0 || E > 65535 || C > 0x7fffffff || D > 0x7fffffff ||
      F > 0x7fffffff || (D + BM - 1) / BM > 65535 || (C + BM - 1) / BM > 65535 ||
      (which != 0 && which != 1) || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int e = static_cast<int>(E), c = static_cast<int>(C), d = static_cast<int>(D),
            f = static_cast<int>(F);
  const bool aligned = (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
                        reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  // rows TMA or the split's 16-byte loads cannot read go to fma, in either dtype
  const int route = !aligned ? kFma
                    : dtype == 1 ? (d % 8 == 0 && f % 8 == 0 ? kWgmma : kFma)
                                 : (d % 4 == 0 && f % 4 == 0 ? kTf32x3 : kFma);
  const Plan given{static_cast<int>(plan_in[0]), static_cast<int>(plan_in[1]),
                   static_cast<int>(plan_in[2]), static_cast<int>(plan_in[3]),
                   static_cast<int>(plan_in[4]), static_cast<int>(plan_in[5]),
                   static_cast<int>(plan_in[6]), static_cast<int>(plan_in[7]), plan_in[8]};
  const Plan plan = bwd_plan(route, which, e, c, d, f);
  if (!(given == plan)) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == kWgmma)
    return static_cast<int>(which == 0 ? launch_bwd_wgmma<false>(a, b, out, e, c, d, f, plan, s)
                                       : launch_bwd_wgmma<true>(a, b, out, e, c, d, f, plan, s));
  if (route == kTf32x3)
    return static_cast<int>(which == 0 ? launch_bwd_tf32x3<false>(a, b, out, e, c, d, f, plan, s)
                                       : launch_bwd_tf32x3<true>(a, b, out, e, c, d, f, plan, s));
  const bool vec = aligned && d % 4 == 0 && f % 4 == 0;  // every 4-element group aligned: bf16 only
  return static_cast<int>(dtype == 1 ? launch_bwd_fma<__nv_bfloat16>(which, vec, a, b, out, E, C, D, F, plan, s)
                                     : launch_bwd_fma<float>(which, vec, a, b, out, E, C, D, F, plan, s));
}

extern "C" const char* moe_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
