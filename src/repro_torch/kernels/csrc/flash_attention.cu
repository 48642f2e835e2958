// Flash-attention forward (GQA, causal or not) for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention
// (Pallas body _flash_kernel).
//
// Two templates behind one entry point, one per element type.  The launch
// plan (tile sizes, grid, shared-memory bytes) is computed in Python
// (flash_attention.py::launch_plan) and checked here against the template
// it selects.
//
// bf16: tensor cores.  At the main path's shapes (head dim 64, 128-160
// tokens) the card's least time is set by the bytes of q, k, v and out; at
// long S by the 4*d*S^2/2 operations on the bf16 tensor cores (989 TFLOP/s).
// Reaching either needs the products on the tensor cores, so both Q K^T
// and P V run on mma.sync m16n8k16 (bf16 inputs, f32 accumulator), in the
// FlashAttention-2 layout: a block of 4 warps owns 64 query rows of one
// (batch, head), each warp 16 of them.  The warp's Q fragments are loaded
// once with ldmatrix and stay in registers; 64-key tiles of K and V are
// double-buffered in shared memory by 16-byte cp.async, so the next tile
// is in flight while the tensor cores work on this one.  Rows are padded
// by 16 bytes, which puts the eight rows of an ldmatrix phase on distinct
// bank groups.  K fragments come with ldmatrix, V fragments with
// ldmatrix.trans.  The online softmax works on the score accumulators in
// registers: each thread holds two rows' values, and a row's max and sum
// are reduced over the quad of lanes that share it (__shfl_xor 1, 2);
// scale*log2(e) is folded into one multiply and exp2f does the rest.  P
// goes from the score accumulators straight into bf16 A fragments for
// P V and never touches shared memory.  Rounding P to bf16 is what the JAX
// model does before P V (repro/models/layers.py:208); the TPU kernel keeps
// P in f32, and the bf16 tolerance (2e-2) covers the difference.
// Causal: key tiles past the block's last row are neither loaded nor
// computed, tiles wholly below the diagonal run unmasked, and only the
// diagonal tile (and a ragged last tile) is masked.  The grid is (H,
// row tiles, B) with the head fastest, so the g query heads that read one
// KV head are adjacent blocks of one wave and find its K/V tiles in L2;
// the alternative, one block over g*64 rows, would tie the block's shape
// to g (3, 4 and 5 on the served models).  Row tiles run last-first, so
// the longest causal rows start first.
//
// f32: the tensor cores in split TF32 (namespace tf, below): its limit of
// 2e-5 cannot be met with bf16 or a single TF32 product, but it is with
// three (hi hi + hi lo + lo hi).  The same block of 4 warps and 64 query
// rows, grid (H, row tiles, B), the same online softmax in exp2; K/V tiles
// of 64 keys (32 at d = 128) double-buffered by cp.async.  P stays f32, as
// in the TPU kernel, and enters P V split as every operand does.
//
// Both: strides are arguments, so the model's q [B,S,H,d] and k/v
// [B,S,KV,d] are read in place, with only the last dimension required to
// be contiguous and rows 16-byte aligned.  Ragged S is masked (keys >= S
// get no weight, rows >= S are not stored), so it is unrestricted.  With a
// non-null lse pointer the forward also writes each row's log-sum-exp of
// the scaled scores (natural log, f32, [B,H,S]) for the backward; serving
// passes null, which selects the instantiation without it (kLse = false),
// so serving runs the code it ran before.  The bf16 template takes keys of
// q's own length only; the f32 one also serves B11's f32 route below.
//
// Port-only B11, attention over keys of a length of their own (Sk != S),
// has an entry of its own, flash_attention_cross_fwd.  It computes
// repro/models/layers.py's cross-attention (multihead_attention with
// kv_override, non-causal): whisper's decoder, a few hundred queries, over
// its encoder's 1500 frames.  No TPU kernel has a counterpart (the TPU
// kernel's (S, d) K/V blocks cannot take another length; JAX runs the
// einsums in XLA).  Its bound on this card: at whisper's prefill (B4 H16
// S128 Sk1500) the 24.6 MB of K and V read once (7.3 us at 3.35 TB/s); at
// its LM shape (B2 S448) the 4 d S Sk operations on the bf16 tensor cores
// (5.5 GFLOP, 5.6 us), and as many exp2 on the SFUs (21.5 M at 16 a clock
// an SM: 5.6 us more where the two do not overlap).  B2's template fits
// that shape badly: a block of 4 warps walks all 1500 keys alone with
// mma.sync.  So bf16 runs xa::flash_cross_fwd_wgmma: a consumer warpgroup
// of 64 query rows on wgmma, fed by a producer warp's TMA ring of 128-key
// K and V tiles (64 at d = 128), in FlashAttention-3's order (each tile's
// scores issued, then the previous tile's P V, whose product runs while the
// tile's softmax does), with no register a product in flight touches
// written meanwhile: ptxas otherwise serialises every wgmma of the kernel.
// Where the (batch, head, row tile) groups would leave SMs without their
// two blocks, the keys of each group are split over the blocks of a
// thread-block cluster (up to 8, whole key tiles, none empty; the decode's
// pattern); block 0 combines every split's (max, sum, P V) in a fixed order
// through distributed shared memory and writes out and lse: no combine
// launch, no atomics, no scratch, so two calls give the same bits.  What
// holds it back (PERF.md, torch_kernel_probe.py cross-parts): a block's
// fixed cost, launch to stores (6.7 us of the LM shape's 19.3 with one key
// tile a block), then the products and the SFU's exp2, which overlap only
// in part (2.6 us less without the P V products, 1.6 without the exp2).
// The f32 route is B2's split-TF32 kernel (tf::flash_fwd_tf32) with its key
// loop over Sk.
//
// Backward (no TPU counterpart: the JAX package differentiates plain XLA
// attention).  With P = exp(scale q k^T - lse) recomputed from the saved
// lse and D = rowsum(dO o): dV = P^T dO, dS = P (dO V^T - D),
// dQ = scale dS K, dK = scale dS^T Q.  Two kernels, no atomics, so the
// results do not depend on the order blocks run in:
//   dq:   one block per (query head, row tile); it first writes D for its
//         rows (16-byte loads of o and dO), then walks the key tiles up to
//         the diagonal, as the forward does;
//   dkdv: one block per (KV head, key tile); it walks every 64-row query
//         tile at or after the diagonal of each of the KV head's g query
//         heads, reading the D and lse log2(e) rows the dq kernel wrote
//         (bf16: a programmatic dependent launch, whose producer loads K
//         and V while the dq grid finishes and waits for it before the
//         first stats).
// At Sk != S in f32 (B11's f32 route) dq walks Sk keys per query tile and
// dkdv's grid is the key tiles of Sk, each walking S queries.  Each kernel
// recomputes Q K^T and dO V^T (7 tile products for the pair where one fused
// kernel does 5): that keeps every output element written by one block, in
// a fixed order.  B11's bf16 backward is a kernel of its own (xa::, after
// the forward): one pass of the 5 products.
//
// bf16: warp specialisation on wgmma, fed by TMA (hopper.cuh).  A block is
// one or two consumer warpgroups of 64 rows (dq) or keys (dkdv) and one
// producer warp.  The producer loads the block's resident operands once
// (dq: Q and dO; dkdv: K and V) and keeps a ring of 2-3 stages of streamed
// tiles in flight (dq: 64-key K and V tiles; dkdv: 64-row Q and dO tiles
// with their lse and D rows), each completing on an mbarrier and released
// by the consumer warps' arrivals.  Tiles are 128-byte swizzled boxes of a
// 4-D tensor map over the model's strided [B,S,H,d] layout, so positions
// past S arrive as zeros and the masks drop them.  The consumers compute
// S = Q K^T and dP = dO V^T (dkdv: their transposes, K and V as the
// A operand) with wgmma from shared memory, turn P and dS into bf16
// register A operands in place, and accumulate dQ += dS K (or dV += P^T dO
// and dK += dS^T Q) with the streamed tile as an MN-major B operand.  The
// lse and D of a query tile are read once per thread's 16 columns.  Two
// consumer warpgroups (128 rows or keys) halve the streamed bytes per row
// at long S; below S = 256 one warpgroup keeps the grid large enough to
// fill the card; at d = 128 dkdv keeps one (its dK and dV accumulators
// alone are 128 f32 registers a thread).  f32 runs two kernels of its own
// in split TF32 on mma.sync (namespace tf): a dq block of 64 query rows
// streaming K/V tiles, a dkdv block of 64 keys streaming query tiles, each
// warp 16 rows of its side.  Bound: at the training shapes (S 160-256, d 64) the bytes
// of q, k, v, o, dO and the three gradients; at long S the ~2.5x forward
// operations.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

struct Strides {
  int64_t b, h, s;  // in elements; the head dim is contiguous
};

constexpr int kThreads = 128;  // both templates: 4 warps
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// The backward's per-row statistics: [2][B][H][stats_row(S)] f32, D =
// rowsum(dO o) then lse log2(e); rows padded to 16 bytes for TMA.
__host__ __device__ constexpr int stats_row(int S) { return (S + 3) / 4 * 4; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// ---------------------------------------------------------------- bf16 --

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int BQ = 64;  // query rows per block, 16 per warp
constexpr int BK = 64;  // keys per K/V tile

template <int D>
struct Layout {
  static constexpr int kRow = D + 8;      // row stride in elements: 16 bytes of pad
  static constexpr int kTile = BQ * kRow;  // one 64-row tile (BQ == BK)
  // Q, then K and V twice each (double buffer)
  static constexpr size_t bytes = sizeof(bf16) * 5 * kTile;
};

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
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Rows [row0, row0 + 64) of one head into a padded tile, 16 bytes per
// cp.async; rows at or past S are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* __restrict__ src,
                                          int64_t s_stride, int row0, int S) {
  constexpr int kChunks = D / 8;
#pragma unroll
  for (int i = threadIdx.x; i < BQ * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const bool ok = row0 + r < S;
    const bf16* g = src + (ok ? static_cast<int64_t>(row0 + r) * s_stride : 0) + c;
    cp_async16(dst + r * Layout<D>::kRow + c, g, ok ? 16 : 0);
  }
}

// grid (H, row tiles, B); kLse: write the rows' log-sum-exp (training).  At d = 64
// four blocks share an SM (their 46 KB of tiles fit four times) when a thread keeps
// to 128 registers, which the bounds hold it to.  The bound stays with the key loop
// over S alone: against no stated bound it ties at d = 64 and is 10% faster at
// d = 128 (PERF.md, torch_kernel_probe.py fwd-bounds).
template <int D, bool kLse>
__global__ void __launch_bounds__(kThreads, D == 64 ? 4 : 1)
flash_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
               bf16* __restrict__ o, float* __restrict__ lse, int S, int H, int KV, Strides qs,
               Strides ks, Strides vs, Strides os, float scale_log2, int causal) {
  using L = Layout<D>;
  constexpr int KD = D / 16;  // k-steps of Q K^T; n16 column pairs of P V
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + L::kTile;      // [2][64][kRow]
  bf16* Vs = Ks + 2 * L::kTile;  // [2][64][kRow]

  const int h = blockIdx.x, b = blockIdx.z;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest causal rows first
  const int kvh = h / (H / KV);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // ldmatrix x4 addresses: A operands (Q, and V through .trans) take rows
  // lane%8 + 8*(lane/8 %2) at column 8*(lane/16); K's B operand takes rows
  // lane%8 + 8*(lane/16) at column 8*(lane/8 % 2).
  const int ar = (lane & 7) + ((lane >> 3) & 1) * 8, ac = (lane >> 4) * 8;
  const int kr = (lane & 7) + (lane >> 4) * 8, kc = ((lane >> 3) & 1) * 8;

  const bf16* kh = k + b * ks.b + kvh * ks.h;
  const bf16* vh = v + b * vs.b + kvh * vs.h;
  const int k_end = causal ? min(S, q0 + BQ) : S;  // causal: later tiles add nothing
  const int n_tiles = (k_end + BK - 1) / BK;

  load_tile<D>(Qs, q + b * qs.b + h * qs.h, qs.s, q0, S);
  load_tile<D>(Ks, kh, ks.s, 0, S);
  load_tile<D>(Vs, vh, vs.s, 0, S);
  cp_async_commit();

  uint32_t qf[KD][4];
  float acc[2 * KD][4];
#pragma unroll
  for (int n = 0; n < 2 * KD; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // rows g and g + 8; l per thread
  const int row_lo = q0 + warp * 16 + g;                   // this thread's first row

  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_tiles) {  // the next tile flies while this one is computed
      load_tile<D>(Ks + (buf ^ 1) * L::kTile, kh, ks.s, (it + 1) * BK, S);
      load_tile<D>(Vs + (buf ^ 1) * L::kTile, vh, vs.s, (it + 1) * BK, S);
    }
    cp_async_commit();
    cp_async_wait<1>();  // everything but the newest group has landed
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        ldmatrix_x4(qf[kk], Qs + (warp * 16 + ar) * L::kRow + kk * 16 + ac);
    }
    const bf16* Kt = Ks + buf * L::kTile;
    const bf16* Vt = Vs + buf * L::kTile;
    const int k0 = it * BK;

    // scores of the warp's 16 rows against the tile's 64 keys, 8 n8 tiles
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        uint32_t kb[4];
        ldmatrix_x4(kb, Kt + (nj * 16 + kr) * L::kRow + kk * 16 + kc);
        mma_bf16(s[2 * nj], qf[kk], kb[0], kb[1]);
        mma_bf16(s[2 * nj + 1], qf[kk], kb[2], kb[3]);
      }

    // element e of tile n: row row_lo + 8*(e/2), key k0 + 8n + 2t + e%2
    const bool masked = k0 + BK > S || (causal && k0 + BK - 1 > q0);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale_log2;
        if (masked) {
          const int key = k0 + 8 * n + 2 * t + (e & 1);
          if (key >= S || (causal && key > row_lo + 8 * (e >> 1))) x = -INFINITY;
        }
        s[n][e] = x;
      }

    // online softmax over the thread's two rows, reduced across the quad
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float mx = m[half];
#pragma unroll
      for (int n = 0; n < 8; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * half], s[n][2 * half + 1]));
      mx = quad_max(mx);
      // key 0 is valid for every row, so mx is finite from the first tile
      // on; the guard keeps a fully masked row at p = 0 instead of NaN
      const float base = mx == -INFINITY ? 0.f : mx;
      const float alpha = exp2f(m[half] - base);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 2 * half; e < 2 * half + 2; ++e) {
          s[n][e] = exp2f(s[n][e] - base);
          sum += s[n][e];
        }
      l[half] = l[half] * alpha + sum;
      m[half] = mx;
#pragma unroll
      for (int n = 0; n < 2 * KD; ++n) {
        acc[n][2 * half] *= alpha;
        acc[n][2 * half + 1] *= alpha;
      }
    }

    // acc += P V: P's accumulators become bf16 A fragments in place
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dn = 0; dn < KD; ++dn) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, Vt + (kk * 16 + ar) * L::kRow + dn * 16 + ac);
        mma_bf16(acc[2 * dn], pa, vb[0], vb[1]);
        mma_bf16(acc[2 * dn + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

  // out = acc / l, staged through the (now idle) Q tile for 16-byte stores
  bf16* Os = Qs + warp * 16 * L::kRow;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const float sum = quad_sum(l[half]);
    const float inv = 1.f / fmaxf(sum, 1e-30f);
#pragma unroll
    for (int n = 0; n < 2 * KD; ++n)
      *reinterpret_cast<uint32_t*>(Os + (g + 8 * half) * L::kRow + 8 * n + 2 * t) =
          pack_bf16(acc[n][2 * half] * inv, acc[n][2 * half + 1] * inv);
    const int row = row_lo + 8 * half;
    if (kLse && t == 0 && row < S)  // m is in log2 units of the scaled scores
      lse[(static_cast<int64_t>(b) * H + h) * S + row] = (m[half] + log2f(sum)) * kLn2;
  }
  __syncwarp();
  bf16* oh = o + b * os.b + h * os.h;
  constexpr int kChunks = D / 8;
#pragma unroll
  for (int i = lane; i < 16 * kChunks; i += 32) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const int qpos = q0 + warp * 16 + r;
    if (qpos < S)
      *reinterpret_cast<uint4*>(oh + qpos * os.s + c) =
          *reinterpret_cast<const uint4*>(Os + r * L::kRow + c);
  }
}

}  // namespace tc

// ------------------------------------------------------- bf16 backward --

namespace wg {

using bf16 = __nv_bfloat16;
using namespace hopper;

template <int D>
constexpr int stages() { return D == 64 ? 3 : 2; }  // tiles in flight per ring

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// Shared-memory layout (byte offsets past a 1024-byte aligned base; the
// 1024 bytes of slack in `bytes` pay for the alignment).  dq: Q and dO of
// the block's BQ rows, then the K and V ring, the barriers (Q/dO, full[ST],
// empty[ST]) and each consumer warp's 16 D = rowsum(dO o) values.
template <int D, int NWG>
struct DqSmem {
  static constexpr int BQ = 64 * NWG, ST = stages<D>();
  static constexpr int q = 0, dout = BQ * D * 2, k = 2 * BQ * D * 2, v = k + ST * 64 * D * 2;
  static constexpr int bars = v + ST * 64 * D * 2, dsum = bars + 8 * (1 + 2 * ST);
  static constexpr int bytes = 1024 + dsum + 4 * 64 * NWG;
};
// dkdv: K and V of the block's BK keys, then the Q and dO ring, the ring's
// lse and D rows, and the barriers (K/V, full[ST], empty[ST]).
template <int D, int NWG>
struct DkdvSmem {
  static constexpr int BK = 64 * NWG, ST = stages<D>();
  static constexpr int k = 0, v = BK * D * 2, q = 2 * BK * D * 2, dout = q + ST * 64 * D * 2;
  static constexpr int lse = dout + ST * 64 * D * 2, delta = lse + ST * 64 * 4;
  static constexpr int bars = delta + ST * 64 * 4;
  static constexpr int bytes = 1024 + bars + 8 * (1 + 2 * ST);
};

// dQ and D.  grid (H, row tiles of 64 NWG, B), row tiles last-first.
// Warps 0 .. 4 NWG - 1 are NWG consumer warpgroups of 64 rows each; the
// last warp is the producer.
template <int D, int NWG>
__global__ void __launch_bounds__(NWG * 128 + 32, NWG == 1 ? 2 : 1)
flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                   const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                   const bf16* __restrict__ o, const bf16* __restrict__ dout,
                   const float* __restrict__ lse, float* __restrict__ stats, bf16* __restrict__ dq,
                   int S, int Sk, int H, int KV, Strides os, Strides dos, Strides dqs,
                   float scale_log2, float scale, int causal) {
  using L = DqSmem<D, NWG>;
  constexpr int BQ = L::BQ, ST = L::ST, CH = D / 64;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  bf16* Qs = reinterpret_cast<bf16*>(sm + L::q);
  bf16* dOs = reinterpret_cast<bf16*>(sm + L::dout);
  bf16* Ks = reinterpret_cast<bf16*>(sm + L::k);  // [ST][64 keys][D], swizzled chunks
  bf16* Vs = reinterpret_cast<bf16*>(sm + L::v);
  uint64_t* qfull = reinterpret_cast<uint64_t*>(sm + L::bars);
  uint64_t* full = qfull + 1;
  uint64_t* empty = full + ST;
  float* Dsum = reinterpret_cast<float*>(sm + L::dsum);

  const int h = blockIdx.x, b = blockIdx.z;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest causal rows first
  const int kvh = h / (H / KV);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_tiles = ((causal ? min(S, q0 + BQ) : Sk) + 63) / 64;  // causal only at Sk == S
  if (threadIdx.x == 0) {
    mbar_init(qfull, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 4 * NWG);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 4 * NWG) {  // producer: Q and dO once, then K and V tiles through the ring
    if (lane == 0) {
      mbar_expect_tx(qfull, 2 * BQ * D * 2);
      for (int c = 0; c < CH; ++c) {
        tma_load_4d(Qs + c * BQ * 64, &tq, qfull, 64 * c, q0, h, b);
        tma_load_4d(dOs + c * BQ * 64, &tdo, qfull, 64 * c, q0, h, b);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % ST;
        if (it >= ST) mbar_wait(empty + s, (it / ST - 1) & 1);
        mbar_expect_tx(full + s, 2 * 64 * D * 2);
        for (int c = 0; c < CH; ++c) {
          tma_load_4d(Ks + (s * CH + c) * 4096, &tk, full + s, 64 * c, it * 64, kvh, b);
          tma_load_4d(Vs + (s * CH + c) * 4096, &tv, full + s, 64 * c, it * 64, kvh, b);
        }
      }
    }
    launch_dependents();
    return;
  }

  const int wgi = warp >> 2, w4 = warp & 3, g = lane >> 2, t = lane & 3;
  const int wq0 = q0 + wgi * 64;            // the warpgroup's first row
  const int row_lo = wq0 + w4 * 16 + g;     // this thread's rows: row_lo, row_lo + 8
  const int64_t stat = (static_cast<int64_t>(b) * H + h) * S;
  const int64_t pad = (static_cast<int64_t>(b) * H + h) * stats_row(S);  // this head's stats row
  const int64_t lse_half = static_cast<int64_t>(gridDim.z) * H * stats_row(S);
  {  // D = rowsum(dO o) of the warp's 16 rows, 16-byte loads, while Q and dO land
    constexpr int LPR = D / 8, RP = 32 / LPR;  // lanes per row, rows per pass
    const bf16* oh = o + b * os.b + h * os.h;
    const bf16* doh = dout + b * dos.b + h * dos.h;
#pragma unroll
    for (int p = 0; p < 16 / RP; ++p) {
      const int r = p * RP + lane / LPR, row = wq0 + w4 * 16 + r, c = (lane % LPR) * 8;
      float sum = 0.f;
      if (row < S) {
        const uint4 a = *reinterpret_cast<const uint4*>(oh + static_cast<int64_t>(row) * os.s + c);
        const uint4 e = *reinterpret_cast<const uint4*>(doh + static_cast<int64_t>(row) * dos.s + c);
        const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
        const __nv_bfloat162* e2 = reinterpret_cast<const __nv_bfloat162*>(&e);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 x = __bfloat1622float2(a2[i]), y = __bfloat1622float2(e2[i]);
          sum = fmaf(x.x, y.x, fmaf(x.y, y.y, sum));
        }
      }
#pragma unroll
      for (int off = LPR / 2; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane % LPR == 0) {
        Dsum[warp * 16 + r] = sum;
        if (row < S) {  // D and lse log2(e) for the dkdv kernel's TMA loads
          stats[pad + row] = sum;
          stats[lse_half + pad + row] = lse[stat + row] * kLog2e;
        }
      }
    }
    __syncwarp();
  }
  float lse2[2], dd[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row_lo + 8 * half;
    lse2[half] = row < S ? lse[stat + row] * kLog2e : 0.f;
    dd[half] = Dsum[warp * 16 + g + 8 * half];
  }

  float acc[CH][32];
#pragma unroll
  for (int c = 0; c < CH; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
  mbar_wait(qfull, 0);
  __syncwarp();
  // The dQ product of a tile is left in flight while the next tile's S and
  // dP run; its stage is released once a later wait has seen it finish.
  int held = -1;
  auto release = [&](int stage) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + stage);  // this warp is done with the stage
  };
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % ST, k0 = it * 64;
    mbar_wait(full + s, (it / ST) & 1);
    __syncwarp();
    const bf16* Kt = Ks + s * 64 * D;
    const bf16* Vt = Vs + s * 64 * D;
    if (causal && k0 > wq0 + 63) {  // every key of the tile is after the warpgroup's rows
      wgmma_wait<0>();
      if (held >= 0) release(held);
      held = -1;
      release(s);
      continue;
    }
    float sc[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)  // S = Q K^T
      wgmma_ss_n64<0>(sc, desc_k(Qs, BQ, wgi * 64, kk), desc_k(Kt, 64, 0, kk), kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)  // dP = dO V^T
      wgmma_ss_n64<0>(dp, desc_k(dOs, BQ, wgi * 64, kk), desc_k(Vt, 64, 0, kk), kk);
    wgmma_commit();
    wgmma_wait<2>();  // the previous tile's dQ product is done
    if (held >= 0) release(held);
    wgmma_wait<1>();
    fence_regs(sc);
    // P; element i: row row_lo + 8 (i%4 / 2), key k0 + 8 (i/4) + 2t + i%2.  Only
    // a diagonal or ragged tile is masked, with one warp-uniform branch.
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = exp2_ftz(fmaf(sc[i], scale_log2, -lse2[(i >> 1) & 1]));
    if (k0 + 64 > Sk || (causal && k0 + 63 > wq0)) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int key = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
        const bool drop = key >= Sk || (causal && key > row_lo + 8 * ((i >> 1) & 1));
        sc[i] = drop ? 0.f : sc[i];
      }
    }
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] *= dp[i] - dd[(i >> 1) & 1];  // dS
    uint32_t a[4][4];  // every k-step's fragment first: no product waits on a register
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) a_frag(a[kk], sc, kk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)  // dQ += dS K, K read MN-major
#pragma unroll
      for (int c = 0; c < CH; ++c) wgmma_rs_n64<1>(acc[c], a[kk], desc_mn(Kt, 64, c, kk));
    wgmma_commit();
    held = s;
  }
  wgmma_wait<0>();
  if (held >= 0) release(held);
#pragma unroll
  for (int c = 0; c < CH; ++c) fence_regs(acc[c]);
  launch_dependents();  // the dkdv kernel may start; it waits for this grid before reading stats
  bf16* qh = dq + b * dqs.b + h * dqs.h;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row_lo + 8 * half;
    if (row < S)
#pragma unroll
      for (int c = 0; c < CH; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<uint32_t*>(qh + static_cast<int64_t>(row) * dqs.s + 64 * c + 8 * j + 2 * t) =
              pack_bf16(acc[c][4 * j + 2 * half] * scale, acc[c][4 * j + 2 * half + 1] * scale);
  }
}

// dK, dV.  grid (key tiles of 64 NWG over Sk, KV, B).  The NWG consumer warpgroups
// own 64 keys each; the producer streams, for each of the KV head's g query
// heads, the 64-row query tiles at or after the diagonal.  kMinBlocks = 2
// caps the registers so that two blocks share an SM, and ptxas then
// serializes the products for lack of registers; with 1 they run
// unserialized, which wins where the grid fits one block per SM.
template <int D, int NWG, int kMinBlocks>
__global__ void __launch_bounds__(NWG * 128 + 32, kMinBlocks)
flash_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                     const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tstats, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int S, int Sk, int H, int KV, Strides dks,
                     Strides dvs, float scale_log2, float scale, int causal) {
  using L = DkdvSmem<D, NWG>;
  constexpr int BK = L::BK, ST = L::ST, CH = D / 64;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  bf16* Ks = reinterpret_cast<bf16*>(sm + L::k);
  bf16* Vs = reinterpret_cast<bf16*>(sm + L::v);
  bf16* Qs = reinterpret_cast<bf16*>(sm + L::q);  // [ST][64 rows][D]
  bf16* dOs = reinterpret_cast<bf16*>(sm + L::dout);
  float* Ls = reinterpret_cast<float*>(sm + L::lse);  // [ST][64]
  float* Dl = reinterpret_cast<float*>(sm + L::delta);
  uint64_t* kvfull = reinterpret_cast<uint64_t*>(sm + L::bars);
  uint64_t* full = kvfull + 1;
  uint64_t* empty = full + ST;

  const int k0 = blockIdx.x * BK, kvh = blockIdx.y, b = blockIdx.z;
  const int g_heads = H / KV;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int qt0 = causal ? k0 / 64 : 0;  // causal: earlier query tiles see none of the keys
  const int per_head = (S + 63) / 64 - qt0;
  const int n_it = g_heads * per_head;
  if (threadIdx.x == 0) {
    mbar_init(kvfull, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 4 * NWG);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 4 * NWG) {  // producer
    if (lane == 0) {
      mbar_expect_tx(kvfull, 2 * BK * D * 2);
      for (int c = 0; c < CH; ++c) {
        tma_load_4d(Ks + c * BK * 64, &tk, kvfull, 64 * c, k0, kvh, b);
        tma_load_4d(Vs + c * BK * 64, &tv, kvfull, 64 * c, k0, kvh, b);
      }
      grid_dependency_wait();  // the stats come from the dq kernel, launched just before
      for (int it = 0; it < n_it; ++it) {
        const int s = it % ST;
        if (it >= ST) mbar_wait(empty + s, (it / ST - 1) & 1);
        const int h = kvh * g_heads + it / per_head, q0 = (qt0 + it % per_head) * 64;
        mbar_expect_tx(full + s, 2 * 64 * D * 2 + 2 * 64 * 4);
        for (int c = 0; c < CH; ++c) {
          tma_load_4d(Qs + (s * CH + c) * 4096, &tq, full + s, 64 * c, q0, h, b);
          tma_load_4d(dOs + (s * CH + c) * 4096, &tdo, full + s, 64 * c, q0, h, b);
        }
        const int bh = b * H + h;  // stats rows: D of each head, then its lse log2(e)
        tma_load_2d(Ls + s * 64, &tstats, full + s, q0, gridDim.z * H + bh);
        tma_load_2d(Dl + s * 64, &tstats, full + s, q0, bh);
      }
    }
    return;
  }

  const int wgi = warp >> 2, w4 = warp & 3, g = lane >> 2, t = lane & 3;
  const int wk0 = k0 + wgi * 64;         // the warpgroup's first key
  const int key_lo = wk0 + w4 * 16 + g;  // this thread's keys: key_lo, key_lo + 8
  float dka[CH][32], dva[CH][32];
#pragma unroll
  for (int c = 0; c < CH; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) dka[c][i] = dva[c][i] = 0.f;
  mbar_wait(kvfull, 0);
  __syncwarp();
  auto release = [&](int stage) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + stage);  // this warp is done with the stage
  };
  for (int it = 0; it < n_it; ++it) {
    const int s = it % ST, q0 = (qt0 + it % per_head) * 64;
    mbar_wait(full + s, (it / ST) & 1);
    __syncwarp();
    const bf16* Qt = Qs + s * 64 * D;
    const bf16* dOt = dOs + s * 64 * D;
    if (causal && q0 + 63 < wk0) {  // no query of the tile sees these keys
      release(s);
      continue;
    }
    // S^T and dP^T: element i is key key_lo + 8 (i%4 / 2), query q0 + 8 (i/4) + 2t + i%2
    float st[32], dpt[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)  // S^T = K Q^T
      wgmma_ss_n64<0>(st, desc_k(Ks, BK, wgi * 64, kk), desc_k(Qt, 64, 0, kk), kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)  // dP^T = V dO^T
      wgmma_ss_n64<0>(dpt, desc_k(Vs, BK, wgi * 64, kk), desc_k(dOt, 64, 0, kk), kk);
    wgmma_commit();
    float2 lq[8];  // lse log2(e) of the thread's 16 queries, once per tile
#pragma unroll
    for (int j = 0; j < 8; ++j) lq[j] = *reinterpret_cast<const float2*>(Ls + s * 64 + 8 * j + 2 * t);
    wgmma_wait<1>();
    fence_regs(st);
#pragma unroll
    for (int i = 0; i < 32; ++i)  // P^T; only a diagonal or ragged tile is masked
      st[i] = exp2_ftz(fmaf(st[i], scale_log2, -((i & 1) ? lq[i >> 2].y : lq[i >> 2].x)));
    if (q0 + 64 > S || (causal && q0 < wk0 + 63)) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int query = q0 + 8 * (i >> 2) + 2 * t + (i & 1);
        const bool drop = query >= S || (causal && query < key_lo + 8 * ((i >> 1) & 1));
        st[i] = drop ? 0.f : st[i];
      }
    }
    uint32_t pa[4][4];  // every k-step's fragment first: no product waits on a register
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) a_frag(pa[kk], st, kk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)  // dV += P^T dO, dO read MN-major
#pragma unroll
      for (int c = 0; c < CH; ++c) wgmma_rs_n64<1>(dva[c], pa[kk], desc_mn(dOt, 64, c, kk));
    wgmma_commit();
    wgmma_wait<1>();  // dP^T is done; dV may still run
    fence_regs(dpt);
#pragma unroll
    for (int j = 0; j < 8; ++j) {  // dS^T = P^T (dP^T - D)
      const float2 dq2 = *reinterpret_cast<const float2*>(Dl + s * 64 + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) dpt[4 * j + e] = st[4 * j + e] * (dpt[4 * j + e] - ((e & 1) ? dq2.y : dq2.x));
    }
    uint32_t sa[4][4];  // dS^T's fragments in registers apart from P^T's, which dV may still read
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) a_frag(sa[kk], dpt, kk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)  // dK += dS^T Q, Q read MN-major
#pragma unroll
      for (int c = 0; c < CH; ++c) wgmma_rs_n64<1>(dka[c], sa[kk], desc_mn(Qt, 64, c, kk));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      fence_regs(dva[c]);
      fence_regs(dka[c]);
    }
    release(s);
  }
  bf16* kd = dk + b * dks.b + kvh * dks.h;
  bf16* vd = dv + b * dvs.b + kvh * dvs.h;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = key_lo + 8 * half;
    if (key < Sk)
#pragma unroll
      for (int c = 0; c < CH; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = 64 * c + 8 * j + 2 * t;
          const int i = 4 * j + 2 * half;
          *reinterpret_cast<uint32_t*>(kd + static_cast<int64_t>(key) * dks.s + col) =
              pack_bf16(dka[c][i] * scale, dka[c][i + 1] * scale);
          *reinterpret_cast<uint32_t*>(vd + static_cast<int64_t>(key) * dvs.s + col) =
              pack_bf16(dva[c][i], dva[c][i + 1]);
        }
  }
}

}  // namespace wg

// ------------------------------------------------------- B11 bf16 forward --

namespace xa {

using bf16 = __nv_bfloat16;
using namespace hopper;

// Keys a K/V tile holds: 128 at d = 64, which halves the per-tile work of
// the softmax (barriers, row max, rescale) against the products; 64 at
// d = 128, where a 128-key ring would not leave two blocks an SM.
constexpr int key_tile(int D) { return D == 64 ? 128 : 64; }
template <int D>
constexpr int stages() { return D == 64 ? 3 : 2; }  // K/V tiles in flight

// A block is one consumer warpgroup of 64 query rows and one producer warp.
// Two warpgroups a block (128 rows, half the K/V tiles a row) ran slower at
// every shape measured (PERF.md), one producer feeding both.
constexpr int BQ = 64, NT = 128, kBlockThreads = NT + 32;

// Shared memory (byte offsets past a 1024-byte aligned base; the 1024 bytes
// of slack in `bytes` pay for the alignment): Q of the block's 64 rows, the
// ring of BK-key K and V tiles, then the barriers (Q, full[ST], empty[ST]).
// Once the key loop is done the ring holds the block's partial for the
// cluster's combine: each consumer thread's PART floats (its P V
// accumulators, then its two rows' max and sum), value i of thread t at
// i * NT + t, so that block 0's threads read neighbouring words.
template <int D>
struct Smem {
  static constexpr int BK = key_tile(D), ST = stages<D>();
  static constexpr int PART = D / 2 + 4;
  static constexpr int q = 0, k = BQ * D * 2, v = k + ST * BK * D * 2, part = k;
  static constexpr int ring_end = v + ST * BK * D * 2, part_end = part + NT * PART * 4;
  static constexpr int bars = ring_end > part_end ? ring_end : part_end;
  static constexpr int bytes = 1024 + bars + 8 * (1 + 2 * ST);
};

// Blocks an SM, as the launch bound keeps room for them in registers and
// the shared memory admits them; flash_attention.py's cross_plan sizes the
// grid by them.  A tighter bound makes ptxas serialize the products.
constexpr int kBlocksPerSM = 2;

// grid (splits, row tiles x H, B) in clusters of (splits, 1, 1): block
// (s, tile H + h, b) takes query rows [tile BQ, tile BQ + BQ) of head h
// against keys [s chunk, min(Sk, s chunk + chunk)), chunk a multiple of BK.
// Warps 0-3 are the consumer warpgroup; warp 4 is the producer.  Every
// thread of every block reaches both cluster barriers.
template <int D, bool kLse>
__global__ void __launch_bounds__(kBlockThreads, kBlocksPerSM)
flash_cross_fwd_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
                      float* __restrict__ lse, int S, int Sk, int H, int KV, int chunk, Strides os,
                      float scale_log2) {
  using L = Smem<D>;
  constexpr int BK = L::BK, NB = BK / 64, ST = L::ST, CH = D / 64;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm = wg::align1024(smem_raw);
  bf16* Qs = reinterpret_cast<bf16*>(sm + L::q);
  bf16* Ks = reinterpret_cast<bf16*>(sm + L::k);  // [ST][BK keys][D], swizzled chunks
  bf16* Vs = reinterpret_cast<bf16*>(sm + L::v);
  float* part = reinterpret_cast<float*>(sm + L::part);
  uint64_t* qfull = reinterpret_cast<uint64_t*>(sm + L::bars);
  uint64_t* full = qfull + 1;
  uint64_t* empty = full + ST;

  cg::cluster_group cluster = cg::this_cluster();
  const int split = blockIdx.x, splits = gridDim.x;  // a cluster spans grid.x: rank = blockIdx.x
  const int h = blockIdx.y % H, q0 = blockIdx.y / H * BQ, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int k_lo = split * chunk, n_tiles = (min(Sk, k_lo + chunk) - k_lo + BK - 1) / BK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    mbar_init(qfull, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 4);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 4) {  // producer: Q once, then the split's K and V tiles through the ring
    if (lane == 0) {
      mbar_expect_tx(qfull, BQ * D * 2);
      for (int c = 0; c < CH; ++c) tma_load_4d(Qs + c * BQ * 64, &tq, qfull, 64 * c, q0, h, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % ST;
        if (it >= ST) mbar_wait(empty + s, (it / ST - 1) & 1);
        mbar_expect_tx(full + s, 2 * BK * D * 2);
        for (int c = 0; c < CH; ++c) {
          tma_load_4d(Ks + (s * CH + c) * BK * 64, &tk, full + s, 64 * c, k_lo + it * BK, kvh, b);
          tma_load_4d(Vs + (s * CH + c) * BK * 64, &tv, full + s, 64 * c, k_lo + it * BK, kvh, b);
        }
      }
    }
    cluster.sync();  // the splits' partials are in place
    cluster.sync();  // block 0 has read them
    return;
  }

  const int g = lane >> 2, t = lane & 3;
  float acc[CH][32], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // rows g and g + 8
#pragma unroll
  for (int c = 0; c < CH; ++c) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
    fence_regs(acc[c]);  // zeroed here, not inside the first product's pipeline stage
  }
  mbar_wait(qfull, 0);
  __syncwarp();
  auto release = [&](int stage) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + stage);  // this warp is done with the stage
  };
  // The loop runs FlashAttention-3's order: tile j's scores are issued, the
  // output is rescaled and tile j-1's P V issued behind them; tile j's
  // softmax then runs while that P V is on the tensor cores, and P becomes
  // the next A operand only once no product is in flight.  No register a
  // product in flight reads or writes is written meanwhile, so ptxas keeps
  // the products asynchronous.
  float sc[32 * NB], alpha[2];
  uint32_t pa[4 * NB][4];  // P of the previous tile, unnormalised, as bf16 A fragments
  auto issue_scores = [&](int j) {  // S = Q K^T of tile j into sc, left in flight
    const int s = j % ST;
    mbar_wait(full + s, (j / ST) & 1);
    __syncwarp();
    const bf16* Kt = Ks + s * BK * D;
    wgmma_fence();
    if constexpr (NB == 2) {
      wgmma_ss_n128_first<0>(sc, desc_k(Qs, BQ, 0, 0), desc_k(Kt, BK, 0, 0));
#pragma unroll
      for (int kk = 1; kk < D / 16; ++kk)
        wgmma_ss_n128<0>(sc, desc_k(Qs, BQ, 0, kk), desc_k(Kt, BK, 0, kk), 1);
    } else {
      wgmma_ss_n64_first<0>(sc, desc_k(Qs, BQ, 0, 0), desc_k(Kt, BK, 0, 0));
#pragma unroll
      for (int kk = 1; kk < D / 16; ++kk)
        wgmma_ss_n64<0>(sc, desc_k(Qs, BQ, 0, kk), desc_k(Kt, BK, 0, kk), 1);
    }
    wgmma_commit();
  };
  // Online softmax of tile j's scores, in log2 units of the scaled scores:
  // m and l move on, alpha = 2^(m_old - m_new) waits for the output, and sc
  // becomes P in place.  Element i: row g + 8 (i%4 / 2) of the warp's 16, key
  // k0 + 8 (i/4) + 2t + i%2; keys at or past Sk arrived as zeros and get no
  // weight (only a split's last tile).
  auto softmax = [&](int j) {
    const int k0 = k_lo + j * BK;
    if (k0 + BK > Sk) {
#pragma unroll
      for (int i = 0; i < 32 * NB; ++i)
        if (k0 + 8 * (i >> 2) + 2 * t + (i & 1) >= Sk) sc[i] = -INFINITY;
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float mx = -INFINITY;
#pragma unroll
      for (int j8 = 0; j8 < 8 * NB; ++j8) mx = fmaxf(mx, fmaxf(sc[4 * j8 + 2 * half], sc[4 * j8 + 2 * half + 1]));
      mx = fmaxf(m[half], tc::quad_max(mx) * scale_log2);
      // a split's first key is valid for every row, so mx is finite from its
      // first tile on; the guard keeps a fully masked row at p = 0, not NaN
      const float base = mx == -INFINITY ? 0.f : mx;
      alpha[half] = exp2_ftz(m[half] - base);
      float sum = 0.f;
#pragma unroll
      for (int j8 = 0; j8 < 8 * NB; ++j8)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j8 + 2 * half + e;
          const float x = fmaf(sc[i], scale_log2, -base);
          sc[i] = exp2_ftz(x);
          sum += sc[i];
        }
      l[half] = l[half] * alpha[half] + sum;
      m[half] = mx;
    }
  };
  // O = O alpha + P V of tile j (its P in pa), left in flight; V read MN-major.
  auto rescale_and_issue_pv = [&](int j) {
#pragma unroll
    for (int c = 0; c < CH; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[c][i] *= alpha[(i >> 1) & 1];
    const bf16* Vt = Vs + (j % ST) * BK * D;
#pragma unroll
    for (int c = 0; c < CH; ++c) fence_regs(acc[c]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * NB; ++kk)
#pragma unroll
      for (int c = 0; c < CH; ++c) wgmma_rs_n64<1>(acc[c], pa[kk], desc_mn(Vt, BK, c, kk));
    wgmma_commit();
  };
  issue_scores(0);
  wgmma_wait<0>();
  fence_regs(sc);
  softmax(0);
#pragma unroll
  for (int kk = 0; kk < 4 * NB; ++kk) a_frag(pa[kk], sc, kk);
  for (int j = 1; j < n_tiles; ++j) {
    issue_scores(j);
    rescale_and_issue_pv(j - 1);
    wgmma_wait<1>();  // tile j's scores are done
    fence_regs(sc);
    softmax(j);
    wgmma_wait<0>();  // tile j-1's P V is done: its K and V are read, its P is free
#pragma unroll
    for (int c = 0; c < CH; ++c) fence_regs(acc[c]);
    release((j - 1) % ST);
#pragma unroll
    for (int kk = 0; kk < 4 * NB; ++kk) a_frag(pa[kk], sc, kk);
  }
  rescale_and_issue_pv(n_tiles - 1);
  wgmma_wait<0>();
#pragma unroll
  for (int c = 0; c < CH; ++c) fence_regs(acc[c]);
  release((n_tiles - 1) % ST);
#pragma unroll
  for (int half = 0; half < 2; ++half) l[half] = tc::quad_sum(l[half]);
  if (split != 0) {  // the partial, over the ring once every consumer warp is done with it
    named_sync(1, NT);
    const int tid = threadIdx.x;
#pragma unroll
    for (int c = 0; c < CH; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) part[(32 * c + i) * NT + tid] = acc[c][i];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      part[(32 * CH + half) * NT + tid] = m[half];
      part[(32 * CH + 2 + half) * NT + tid] = l[half];
    }
  }
  cluster.sync();  // every split's partial is in its block's shared memory
  if (split == 0) {
    const int tid = threadIdx.x;
    float mx[2] = {m[0], m[1]};
    for (int r = 1; r < splits; ++r) {
      const float* p = cluster.map_shared_rank(part, r);
#pragma unroll
      for (int half = 0; half < 2; ++half) mx[half] = fmaxf(mx[half], p[(32 * CH + half) * NT + tid]);
    }
    // the splits in rank order, block 0's own first: w = 2^(m_r - max).  The
    // sums go to registers of their own: nothing but wgmma defines acc.
    float sum[2], w0[2], out[CH][32];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      w0[half] = exp2_ftz(m[half] - mx[half]);
      sum[half] = l[half] * w0[half];
    }
#pragma unroll
    for (int c = 0; c < CH; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) out[c][i] = acc[c][i] * w0[(i >> 1) & 1];
    for (int r = 1; r < splits; ++r) {
      const float* p = cluster.map_shared_rank(part, r);
      float w[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        w[half] = exp2_ftz(p[(32 * CH + half) * NT + tid] - mx[half]);
        sum[half] = fmaf(p[(32 * CH + 2 + half) * NT + tid], w[half], sum[half]);
      }
#pragma unroll
      for (int c = 0; c < CH; ++c)
#pragma unroll
        for (int i = 0; i < 32; ++i) out[c][i] = fmaf(p[(32 * c + i) * NT + tid], w[(i >> 1) & 1], out[c][i]);
    }
    bf16* oh = o + b * os.b + h * os.h;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = q0 + warp * 16 + g + 8 * half;
      if (row >= S) continue;
      const float inv = 1.f / fmaxf(sum[half], 1e-30f);
#pragma unroll
      for (int c = 0; c < CH; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<uint32_t*>(oh + static_cast<int64_t>(row) * os.s + 64 * c + 8 * j + 2 * t) =
              pack_bf16(out[c][4 * j + 2 * half] * inv, out[c][4 * j + 2 * half + 1] * inv);
      if (kLse && t == 0)  // mx is in log2 units of the scaled scores
        lse[(static_cast<int64_t>(b) * H + h) * S + row] = (mx[half] + log2f(sum[half])) * kLn2;
    }
  }
  cluster.sync();  // block 0 has read every split's partial before the blocks go
}

// ------------------------------------------------------ B11 bf16 backward --
//
// No TPU counterpart (the JAX package differentiates XLA's einsums).  One
// pass of five products a scored pair, after a small pass for the row
// statistics.  Bound at whisper's LM shape (B2 H16 S448 Sk1500 d64): the
// 13.8 GFLOP of the products on the bf16 tensor cores, 13.9 us.  Blocks
// hold keys: a block is NWG consumer warpgroups of 64 keys each (a key
// tile of BK = 64 NWG keys) and a producer (a warp, or at two consumer
// warpgroups a warpgroup that gives them its registers), and it
// walks every (query head of the KV head, 64-row query tile) of its batch
// row, a unit at a time.  Per unit each warpgroup computes S^T = K Q^T and
// dP^T = V dO^T once, P^T = 2^(scale log2(e) S^T - lse log2(e)) with one
// exp2 a score, dS^T = P^T (dP^T - D), and accumulates dV += P^T dO and
// dK += dS^T Q in registers; dS^T also goes to shared memory (bf16,
// 128-byte swizzled), from where the warpgroup multiplies it by its 64 K
// rows into its dQ partial of the unit.  At two warpgroups warpgroup 0
// hands its partial to warpgroup 1 through shared memory (two slots, each
// guarded by a full and an empty mbarrier), and warpgroup 1 adds it to its
// own and updates the rows: the two are coupled by no barrier of their
// own, so that one's exps run under the other's products.  No thread-
// dependent loop or branch runs while a product may be in flight, and no
// product is left in flight across a loop's back edge: ptxas serialises
// every wgmma of a kernel that does either (C7518, C7514).
// dK and dV of a key tile are whole in one block; dQ is summed across the
// `splits` <= 8 blocks that share a KV head's keys, block r taking key
// tiles r, r + splits, ....  Each keeps the f32 dQ partial of every query
// row of the KV head's g heads (in shared memory where it fits, else in
// the global scratch), adding its later key tiles in order.  At one split
// the block writes dQ from it; else each block puts its partial in the
// global scratch (splits f32 rows a query row, whatever Sk is) and counts
// itself in, and the block that comes last sums the splits' partials in
// split order and writes dQ (the rows in `splits` parts, each summed by the
// block that counts it last).  The count only elects that block: the sum
// runs in a fixed order, so two calls give the same bits.  (A thread-block
// cluster summing through distributed shared memory does not fit whisper's
// grid: the card holds 30 clusters of four of these blocks at once, so the
// 32 (batch, KV head) pairs would take two waves.)  The exps run under the
// dP^T product in flight, and each warpgroup's under the other's products.
// What holds it back (PERF.md, torch_kernel_probe.py cross-bwd-parts): not
// the products (cut to a quarter they save 2-7% each) but each unit's
// chain of waits, about 2 us a unit, and ~30 us a launch of fixed cost:
// the partials' final sum, the K/V loads at each key tile, the launches.
// Issuing the next unit's S^T and dP^T under this unit's dQ product
// (FlashAttention-3's order) measured 13% slower and is not done.

// D = rowsum(dO o) and lse log2(e) of every query row into
// [2][B][H][stats_row(S)] f32, as B5's dq kernel writes them; the pass
// streams both rows with each query tile.  A warp takes 32 / (D / 8) rows,
// a row's D / 8 lanes 16 bytes each of o and dO.  Block 0 also zeroes the
// pass's counters ([B][KV][splits]; none at one split).
constexpr int kStatsThreads = 256;
template <int D>
__global__ void __launch_bounds__(kStatsThreads)
cross_bwd_stats(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                const float* __restrict__ lse, float* __restrict__ stats, int* __restrict__ counters,
                int n_counters, int S, int H, int BH, Strides os, Strides dos) {
  launch_dependents();  // the pass may start; it waits for this grid before the stats and counters
  if (blockIdx.x == 0)
    for (int i = threadIdx.x; i < n_counters; i += kStatsThreads) counters[i] = 0;
  constexpr int LPR = D / 8, RP = 32 / LPR;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t row = (static_cast<int64_t>(blockIdx.x) * (kStatsThreads / 32) + warp) * RP + lane / LPR;
  const bool ok = row < static_cast<int64_t>(BH) * S;
  const int bh = ok ? static_cast<int>(row / S) : 0, s = ok ? static_cast<int>(row % S) : 0;
  const int b = bh / H, h = bh % H, c = (lane % LPR) * 8;
  float sum = 0.f;
  if (ok) {
    const uint4 a = *reinterpret_cast<const uint4*>(o + b * os.b + h * os.h + s * os.s + c);
    const uint4 e = *reinterpret_cast<const uint4*>(dout + b * dos.b + h * dos.h + s * dos.s + c);
    const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* e2 = reinterpret_cast<const __nv_bfloat162*>(&e);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(a2[i]), y = __bfloat1622float2(e2[i]);
      sum = fmaf(x.x, y.x, fmaf(x.y, y.y, sum));
    }
  }
#pragma unroll
  for (int off = LPR / 2; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (ok && lane % LPR == 0) {
    const int64_t at = static_cast<int64_t>(bh) * stats_row(S) + s;
    stats[at] = sum;
    stats[static_cast<int64_t>(BH) * stats_row(S) + at] = lse[row] * kLog2e;
  }
}

// Shared memory of the pass (byte offsets past a 1024-byte aligned base):
// K and V of the block's key tile, the ring of Q and dO tiles, the dS^T
// tile ([BK keys][64 queries], each warpgroup its 64 rows), at two
// warpgroups the two slots of the f32 dQ partial warpgroup 0 hands to
// warpgroup 1 ([2][64][D], swizzled as the partials are), the ring's lse
// and D rows, the barriers (K/V full and empty, full[ST], empty[ST], the
// slots' full[2] and empty[2]) and the last-block flag, then, where it fits,
// the f32 dQ partials.
template <int D, int NWG>
struct BwdSmem {
  static constexpr int BK = 64 * NWG, ST = 2;
  static constexpr int k = 0, v = BK * D * 2, q = 2 * BK * D * 2, dout = q + ST * 64 * D * 2;
  static constexpr int dst = dout + ST * 64 * D * 2, pass = dst + BK * 64 * 2;
  static constexpr int lse = pass + (NWG == 2 ? 2 * 64 * D * 4 : 0);
  static constexpr int delta = lse + ST * 64 * 4, bars = delta + ST * 64 * 4;
  static constexpr int flag = bars + 8 * (6 + 2 * ST), region = flag + 16;
  static constexpr int fixed = 1024 + region;  // bytes without the dQ partials
};

// The dQ partials: [rows][D] f32, rows = g S_pad (a head's query rows
// padded to whole tiles, the KV head's g heads one after another).  Each
// 8-column group of a row is XOR-ed with the row's last two bits, so that a
// warp's float2 updates (8 rows, 4 column pairs) hit 32 distinct banks.
__device__ __forceinline__ int region_col(int row, int col) { return col ^ ((row & 3) << 3); }

// grid (splits, KV, B): block (r, kvh, b) takes key tiles r, r + splits,
// ... of KV head kvh.  Warps 0 .. 4 NWG - 1 are the consumer warpgroups;
// the warps after them the producer.  `scratch` is [splits][B][KV][rows][D]
// f32 (null at one split with the partials in shared memory), `counters`
// [B][KV][splits] ints the statistics pass zeroed (null at one split); `in_smem`: the
// partials live in shared memory, else in the block's slice of scratch.
// Threads of a block: NWG consumer warpgroups and the producer, a whole
// warpgroup at two consumer warpgroups, so that it can give its registers
// to them (setmaxnreg: 40 a thread, the consumers 232).
template <int NWG>
constexpr int bwd_threads() { return NWG * 128 + (NWG == 2 ? 128 : 32); }

template <int D, int NWG>
__global__ void __launch_bounds__(bwd_threads<NWG>(), 1)
flash_cross_bwd_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                      const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tstats, bf16* __restrict__ dq,
                      bf16* __restrict__ dk, bf16* __restrict__ dv, float* __restrict__ scratch,
                      int* __restrict__ counters, int in_smem, int S, int Sk, int H, int KV, int rows,
                      Strides dqs, Strides dks, Strides dvs, float scale_log2, float scale) {
  using L = BwdSmem<D, NWG>;
  constexpr int BK = L::BK, ST = L::ST, CH = D / 64, NT = NWG * 128;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm = wg::align1024(smem_raw);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, wgi = warp >> 2;
  bf16* Ks = reinterpret_cast<bf16*>(sm + L::k);
  bf16* Vs = reinterpret_cast<bf16*>(sm + L::v);
  bf16* Qs = reinterpret_cast<bf16*>(sm + L::q);  // [ST][64 rows][D]
  bf16* dOs = reinterpret_cast<bf16*>(sm + L::dout);
  bf16* dS = reinterpret_cast<bf16*>(sm + L::dst) + wgi * 64 * 64;  // this warpgroup's dS^T rows
  float* pass = reinterpret_cast<float*>(sm + L::pass);  // [2 slots][64][D]
  float* Ls = reinterpret_cast<float*>(sm + L::lse);  // [ST][64]
  float* Dl = reinterpret_cast<float*>(sm + L::delta);
  uint64_t* kvfull = reinterpret_cast<uint64_t*>(sm + L::bars);
  uint64_t* kvempty = kvfull + 1;
  uint64_t* full = kvfull + 2;
  uint64_t* empty = full + ST;
  uint64_t* passfull = empty + ST;  // [2]
  uint64_t* passempty = passfull + 2;

  int* last = reinterpret_cast<int*>(sm + L::flag);
  uint64_t* sumbar = reinterpret_cast<uint64_t*>(sm + L::flag + 8);  // the final sum's bulk loads
  const int rank = blockIdx.x, C = gridDim.x, kvh = blockIdx.y, b = blockIdx.z;
  const int g_heads = H / KV, n_qt = (S + 63) / 64, S_pad = n_qt * 64, n_units = g_heads * n_qt;
  const int n_kt = (Sk + BK - 1) / BK, nsub = (n_kt - rank + C - 1) / C;
  const int64_t region_size = static_cast<int64_t>(rows) * D;
  auto slice = [&](int r) {  // split r's partials in the scratch
    return scratch + ((static_cast<int64_t>(r) * gridDim.z + b) * KV + kvh) * region_size;
  };
  float* region = in_smem ? reinterpret_cast<float*>(sm + L::region) : slice(rank);
  if (threadIdx.x == 0) {
    mbar_init(kvfull, 1);
    mbar_init(kvempty, 4 * NWG);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 4 * NWG);  // one arrival per consumer warp
    }
    for (int k = 0; k < 2; ++k) {
      mbar_init(passfull + k, 128);  // every thread of the warpgroup that writes or reads
      mbar_init(passempty + k, 128);
    }
    mbar_init(sumbar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 4 * NWG) {  // producer: each key tile's K and V, then every unit's tiles through the ring
    if (NWG == 2) setmaxnreg_dec<40>();
    if (warp == 4 * NWG && lane == 0) {
      // The first units of a key tile go out before its K and V, which wait for the last
      // tile's products: their Q and dO are in flight while the last tile finishes.
      auto load_kv = [&](int js) {
        const int k0 = (rank + js * C) * BK;
        mbar_expect_tx(kvfull, 2 * BK * D * 2);
        for (int c = 0; c < CH; ++c) {
          tma_load_4d(Ks + c * BK * 64, &tk, kvfull, 64 * c, k0, kvh, b);
          tma_load_4d(Vs + c * BK * 64, &tv, kvfull, 64 * c, k0, kvh, b);
        }
      };
      load_kv(0);
      grid_dependency_wait();  // the stats come from the launch just before
      for (int js = 0; js < nsub; ++js) {
        for (int u = 0; u < n_units; ++u) {
          if (js > 0 && u == min(ST, n_units)) {
            mbar_wait(kvempty, (js - 1) & 1);
            load_kv(js);
          }
          const int it = js * n_units + u, s = it % ST;
          if (it >= ST) mbar_wait(empty + s, (it / ST - 1) & 1);
          const int h = kvh * g_heads + u / n_qt, q0 = (u % n_qt) * 64;
          mbar_expect_tx(full + s, 2 * 64 * D * 2 + 2 * 64 * 4);
          for (int c = 0; c < CH; ++c) {
            tma_load_4d(Qs + (s * CH + c) * 4096, &tq, full + s, 64 * c, q0, h, b);
            tma_load_4d(dOs + (s * CH + c) * 4096, &tdo, full + s, 64 * c, q0, h, b);
          }
          const int bh = b * H + h;  // stats rows: D of each head, then its lse log2(e)
          tma_load_2d(Ls + s * 64, &tstats, full + s, q0, gridDim.z * H + bh);
          tma_load_2d(Dl + s * 64, &tstats, full + s, q0, bh);
        }
        if (js > 0 && n_units <= ST) {  // a tile of fewer units than the ring holds
          mbar_wait(kvempty, (js - 1) & 1);
          load_kv(js);
        }
      }
    }
    return;
  }

  if (NWG == 2) setmaxnreg_inc<232>();
  const int w4 = warp & 3, g = lane >> 2, t = lane & 3;
  float dka[CH][32], dva[CH][32], st[32], dpt[32], dqp[32];
  uint32_t pa[4][4], sa[4][4];
  auto release = [&](uint64_t* bar) {
    __syncwarp();
    mbar_arrive_if(bar, lane == 0);  // this warp is done with what the barrier guards
  };
  auto issue_sdp = [&](int it) {  // S^T = K Q^T and dP^T = V dO^T of flattened unit it, in flight
    const int s = it % ST;
    mbar_wait_in_asm(full + s, (it / ST) & 1);
    __syncwarp();
    const bf16* Qt = Qs + s * 64 * D;
    const bf16* dOt = dOs + s * 64 * D;
    wgmma_fence();
    wgmma_ss_n64_first<0>(st, desc_k(Ks, BK, wgi * 64, 0), desc_k(Qt, 64, 0, 0));
#pragma unroll
    for (int kk = 1; kk < D / 16; ++kk)
      wgmma_ss_n64<0>(st, desc_k(Ks, BK, wgi * 64, kk), desc_k(Qt, 64, 0, kk), 1);
    wgmma_commit();
    wgmma_ss_n64_first<0>(dpt, desc_k(Vs, BK, wgi * 64, 0), desc_k(dOt, 64, 0, 0));
#pragma unroll
    for (int kk = 1; kk < D / 16; ++kk)
      wgmma_ss_n64<0>(dpt, desc_k(Vs, BK, wgi * 64, kk), desc_k(dOt, 64, 0, kk), 1);
    wgmma_commit();
  };

  for (int js = 0; js < nsub; ++js) {
    const int wk0 = (rank + js * C) * BK + wgi * 64;  // the warpgroup's first key
    const int key_lo = wk0 + w4 * 16 + g;            // this thread's keys: key_lo, key_lo + 8
#pragma unroll
    for (int c = 0; c < CH; ++c) {
#pragma unroll
      for (int i = 0; i < 32; ++i) dka[c][i] = dva[c][i] = 0.f;
      fence_regs(dka[c]);  // zeroed here, not inside a product's pipeline stage
      fence_regs(dva[c]);
    }
    mbar_wait_in_asm(kvfull, js & 1);
    __syncwarp();
    for (int u = 0; u < n_units; ++u) {
      const int it = js * n_units + u, s = it % ST, q0 = (u % n_qt) * 64;
      issue_sdp(it);
      const bf16* Qt = Qs + s * 64 * D;
      const bf16* dOt = dOs + s * 64 * D;
      // element i of S^T and dP^T: key key_lo + 8 (i%4 / 2), query q0 + 8 (i/4) + 2t + i%2
      float2 lq[8];  // lse log2(e) of the thread's 16 queries
#pragma unroll
      for (int j = 0; j < 8; ++j) lq[j] = *reinterpret_cast<const float2*>(Ls + s * 64 + 8 * j + 2 * t);
      wgmma_wait<1>();  // S^T is done; dP^T still runs under the exps
      fence_regs(st);
#pragma unroll
      for (int i = 0; i < 32; ++i)  // P^T; only a ragged tile is masked
        st[i] = exp2_ftz(fmaf(st[i], scale_log2, -((i & 1) ? lq[i >> 2].y : lq[i >> 2].x)));
      if (q0 + 64 > S || (rank + js * C + 1) * BK > Sk) {  // the block's tile: uniform
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int query = q0 + 8 * (i >> 2) + 2 * t + (i & 1);
          const bool drop = query >= S || key_lo + 8 * ((i >> 1) & 1) >= Sk;
          st[i] = drop ? 0.f : st[i];
        }
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) a_frag(pa[kk], st, kk);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // dV += P^T dO, dO read MN-major
#pragma unroll
        for (int c = 0; c < CH; ++c) wgmma_rs_n64<1>(dva[c], pa[kk], desc_mn(dOt, 64, c, kk));
      wgmma_commit();
      wgmma_wait<1>();  // dP^T is done; dV may still run
      fence_regs(dpt);
#pragma unroll
      for (int j = 0; j < 8; ++j) {  // dS^T = P^T (dP^T - D)
        const float2 dq2 = *reinterpret_cast<const float2*>(Dl + s * 64 + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) dpt[4 * j + e] = st[4 * j + e] * (dpt[4 * j + e] - ((e & 1) ? dq2.y : dq2.x));
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) a_frag(sa[kk], dpt, kk);
      // dS^T into the warpgroup's swizzled rows: fragment kk holds query columns 16 kk ..
      // 16 kk + 15 (8-column groups 2 kk and 2 kk + 1) of rows r and r + 8
      {
        const int r = w4 * 16 + g;  // r & 7 == g
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = r + 8 * (e & 1), grp = 2 * kk + (e >> 1);
            *reinterpret_cast<uint32_t*>(reinterpret_cast<unsigned char*>(dS) + row * 128 +
                                         ((grp ^ g) << 4) + 4 * t) = sa[kk][e];
          }
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // dK += dS^T Q, Q read MN-major
#pragma unroll
        for (int c = 0; c < CH; ++c) wgmma_rs_n64<1>(dka[c], sa[kk], desc_mn(Qt, 64, c, kk));
      wgmma_commit();
      fence_async_shared();         // dS^T is read by the dQ product (the async proxy)
      named_sync(1 + wgi, 128);     // the warpgroup's dS^T rows are in place
      // dQ partial of the unit over the warpgroup's 64 keys: dS K, the K rows read MN-major.
      // At two warpgroups warpgroup 0 hands it over in slot it % 2 and warpgroup 1 adds
      // it to its own (one add: its order does not matter) and updates the tile's rows.
      const int row0 = (u / n_qt) * S_pad + q0 + w4 * 16 + g;  // this thread's rows row0, row0 + 8
      float* slot = pass + (it & 1) * 64 * D;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        wgmma_fence();
        wgmma_ss_n64_first<1, 1>(dqp, desc_mn(dS, 64, 0, 0), desc_mn(Ks + wgi * 64 * 64, BK, c, 0));
#pragma unroll
        for (int kk = 1; kk < 4; ++kk)
          wgmma_ss_n64<1, 1>(dqp, desc_mn(dS, 64, 0, kk), desc_mn(Ks + wgi * 64 * 64, BK, c, kk), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dqp);
        if (c == 0) release(empty + s);  // the unit's Q, dO, lse and D are read
        if (NWG == 2 && wgi == 0) {
          if (it >= 2) mbar_wait_in_asm(passempty + (it & 1), ((it >> 1) - 1) & 1);
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int row = w4 * 16 + g + 8 * half;  // row & 3 == row0 + 8 half & 3
#pragma unroll
            for (int j = 0; j < 8; ++j)
              *reinterpret_cast<float2*>(slot + row * D + region_col(row, 8 * j + 2 * t)) =
                  make_float2(dqp[4 * j + 2 * half], dqp[4 * j + 2 * half + 1]);
          }
          mbar_arrive(passfull + (it & 1));
          continue;
        }
        if (NWG == 2) mbar_wait_in_asm(passfull + (it & 1), (it >> 1) & 1);
        // at the last key tile the rows are final: past one split they go straight to the
        // block's slice of the scratch, their stores under the tile's other units
        float* final_rows = C > 1 && js == nsub - 1 ? slice(rank) : region;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = row0 + 8 * half, prow = w4 * 16 + g + 8 * half;
          float* rp = region + static_cast<int64_t>(row) * D;
          float* fp = final_rows + static_cast<int64_t>(row) * D;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            float2 x = make_float2(dqp[4 * j + 2 * half], dqp[4 * j + 2 * half + 1]);
            if (NWG == 2) {
              const float2 y = *reinterpret_cast<const float2*>(slot + prow * D + region_col(prow, 8 * j + 2 * t));
              x.x += y.x;
              x.y += y.y;
            }
            const int col = region_col(row, 64 * c + 8 * j + 2 * t);
            if (js > 0) {
              const float2 y = *reinterpret_cast<const float2*>(rp + col);
              x.x += y.x;
              x.y += y.y;
            }
            *reinterpret_cast<float2*>(fp + col) = x;
          }
        }
        if (NWG == 2) mbar_arrive(passempty + (it & 1));
      }
    }
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      fence_regs(dva[c]);
      fence_regs(dka[c]);
    }
    release(kvempty);  // every product of the key tile is done: K and V may be refilled
    // dK (scaled) and dV of the warpgroup's 64 keys, 64 columns at a time, through its dS^T
    // rows (free now; 16-byte groups XOR-ed with the row, as dS^T is) so that each row
    // goes out in 16-byte stores: 4-byte stores of the accumulators were 8 µs of the pass
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      bf16* out = m == 0 ? dk + b * dks.b + kvh * dks.h : dv + b * dvs.b + kvh * dvs.h;
      const int64_t row_stride = m == 0 ? dks.s : dvs.s;
      const float mul = m == 0 ? scale : 1.f;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const float* acc = m == 0 ? dka[c] : dva[c];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = w4 * 16 + g + 8 * half;  // row & 7 == g
#pragma unroll
          for (int j = 0; j < 8; ++j)
            *reinterpret_cast<uint32_t*>(reinterpret_cast<unsigned char*>(dS) + row * 128 + ((j ^ g) << 4) + 4 * t) =
                pack_bf16(acc[4 * j + 2 * half] * mul, acc[4 * j + 2 * half + 1] * mul);
        }
        named_sync(1 + wgi, 128);
#pragma unroll
        for (int k = 0; k < 4; ++k) {  // 64 rows of 8 16-byte groups, a warp 4 whole rows a step
          const int idx = k * 128 + (threadIdx.x & 127), row = idx >> 3, grp = idx & 7;
          const int key = wk0 + row;
          if (key < Sk)
            *reinterpret_cast<uint4*>(out + static_cast<int64_t>(key) * row_stride + 64 * c + 8 * grp) =
                *reinterpret_cast<const uint4*>(reinterpret_cast<const unsigned char*>(dS) + row * 128 +
                                                ((grp ^ (row & 7)) << 4));
        }
        named_sync(1 + wgi, 128);  // the rows are read before the next columns overwrite them
      }
    }
  }

  // dQ = scale (the splits' partials summed in split order).  The rows fall into C parts
  // (whole rows: the column swizzle stays inside a row), already in the block's slice of
  // the scratch; block r counts itself into their counters in the order r, r + 1, ...
  // (mod C), and the block that counts a part last sums it.  Blocks finish at nearly the
  // same time, so the sums spread over them (counting every part at once measured slower:
  // the last block then sums all of them), each in a fixed order.
  constexpr int V4 = D / 4;
  const int64_t total = region_size / 4;
  named_sync(4, NT);  // the block's partials are final
  auto write_dq = [&](int row, int col, float4 acc) {
    const int s = row % S_pad, h = kvh * g_heads + row / S_pad;
    if (s >= S) return;
    uint2 out;
    out.x = pack_bf16(acc.x * scale, acc.y * scale);
    out.y = pack_bf16(acc.z * scale, acc.w * scale);
    *reinterpret_cast<uint2*>(dq + b * dqs.b + h * dqs.h + static_cast<int64_t>(s) * dqs.s + col) = out;
  };
  if (C == 1) {  // the block's own partials are dQ
    for (int64_t i = threadIdx.x; i < total; i += NT) {
      const int row = static_cast<int>(i / V4), col = static_cast<int>(i % V4) * 4;
      write_dq(row, col, *reinterpret_cast<const float4*>(region + static_cast<int64_t>(row) * D +
                                                            region_col(row, col)));
    }
    return;
  }
  // The part's rows of every split come into shared memory by bulk copies (everything
  // before the lse rows is free now), as many rows at a time as it holds, and are summed
  // from there: loads of a few float4 a thread from L2 waited on its latency.
  float* stage = reinterpret_cast<float*>(sm);
  const int stage_rows = L::lse / (C * D * 4), per_rows = (rows + C - 1) / C;
  uint32_t phase = 0;
  for (int j = 0; j < C; ++j) {
    const int part = (rank + j) % C;
    __threadfence();  // the part (written to the scratch at the last key tile) is visible
    named_sync(4, NT);
    if (threadIdx.x == 0) {
      if (j == 0) grid_dependency_wait();  // the statistics pass zeroed the counters
      int* count = counters + (b * KV + kvh) * C + part;
      *last = atomicAdd(count, 1) == C - 1;
      if (*last) *count = 0;  // every block has counted: left as it was found
    }
    named_sync(4, NT);
    if (!*last) continue;
    __threadfence();
    const int r_hi = min(rows, (part + 1) * per_rows);
    for (int r0 = part * per_rows; r0 < r_hi; r0 += stage_rows) {
      const int nr = min(stage_rows, r_hi - r0);
      fence_async_shared();  // the stage's earlier reads and writes come before the copies
      named_sync(4, NT);
      if (threadIdx.x == 0) {
        mbar_expect_tx(sumbar, C * nr * D * 4);
        for (int r = 0; r < C; ++r)
          bulk_load(stage + r * nr * D, slice(r) + static_cast<int64_t>(r0) * D, nr * D * 4, sumbar);
      }
      mbar_wait_in_asm(sumbar, phase);
      phase ^= 1;
      for (int i = threadIdx.x; i < nr * V4; i += NT) {
        const int row = r0 + i / V4, col = (i % V4) * 4, at = (i / V4) * D + region_col(row, col);
        float4 acc = *reinterpret_cast<const float4*>(stage + at);
        for (int r = 1; r < C; ++r) {  // split order
          const float4 x = *reinterpret_cast<const float4*>(stage + r * nr * D + at);
          acc.x += x.x;
          acc.y += x.y;
          acc.z += x.z;
          acc.w += x.w;
        }
        write_dq(row, col, acc);
      }
    }
  }
}

}  // namespace xa

// ----------------------------------------------------------------- f32 --
//
// The f32 route: B2's forward (and B11's f32 forward, at keys of their own
// length) and B5's dq and dkdv (and B11's f32 backward), all on the tensor
// cores in split TF32 ("tf32x3").  Each f32 operand x goes in as two TF32
// values, hi = tf32(x), rounded to nearest with ties away (cvt.rna's
// rounding), and lo = tf32(x - hi), which the tensor cores take by dropping
// its low 13 bits, and each product as three mma.sync m16n8k8 TF32
// products, lo hi + hi lo first, then hi hi (CUTLASS's OpMultiplyAddFastF32
// order, what f32 sdpa runs on sm_80+): the two halves carry ~21 bits of
// each operand and the dropped lo lo term is ~2^-22 of the product.  The tensor cores round
// their sums more coarsely than an f32 add (measured: 4e-6 on whisper's
// 1500 keys when P V ran into one accumulator), so each product over one
// tile starts from zero and is added to the running f32 sum with an f32
// add, and the backward's dP, whose error reaches dS = P (dP - D) whole
// where the two cancel, sums each k-step's products so.  That holds the f32
// limits (2e-5 forward, 1e-4 of the largest gradient, 1e-5 where it is 0).  Bound: 3x the 4 d (forward) or 10 d (backward) operations a
// scored pair on the 494.7 TFLOP/s TF32 tensor cores; the splits (3
// instructions an operand element), the fragment loads and the softmax
// take issue slots beside the products (PERF.md).
//
// Layout.  A warp owns 16 rows of the m16 side (query rows; dkdv: keys).
// Tiles live in shared memory as padded f32 rows, filled by 16-byte cp.async
// with zeros past the sequence.  The contraction order of every product is
// permuted, which a sum allows: in a k-step over 8 columns, lane (g, t)'s
// k = t and k = t + 4 are columns 2t and 2t + 1.  Then
//  - an operand whose rows are the product's rows (Q, dO, K, V as A) or its
//    columns (K^T, V^T, Q^T, dO^T as B) is read 8 bytes a lane from rows of
//    D + 8 floats: a half warp's 16 lanes fall on 32 distinct banks;
//  - an operand whose rows are the contraction (V in P V, K in dS K, dO in
//    P^T dO, Q in dS^T Q) is read 4 bytes a lane from rows 2t and 2t + 1:
//    conflict-free in V's rows of D + 4 floats, two-way where the same tile
//    is also read by rows (D + 8);
//  - a score accumulator's (2t, 2t + 1) columns are the next product's
//    k = t and t + 4, so P and dS become A fragments in registers with no
//    shuffle and no trip through shared memory.
// Every address is a lane's base plus a constant, so the unrolled loops
// spend no instruction on it.  The online softmax (forward) keeps (m, l) in
// f32 on the accumulator rows, reduced over the quad of lanes that share a
// row, with exp2 of scores prescaled by scale log2(e), as the bf16 route
// does.  No atomics: every output element is summed by one warp (dkdv at 32
// keys a block: two, added in a fixed order), so two calls give the same bits.

namespace tf {

constexpr int BQ = 64;  // query rows a forward / dq block, keys a dkdv block: 16 a warp

// K/V tile keys (forward, dq) and streamed query rows (dkdv): 64 at d = 64, 32 at d = 128,
// where two forward blocks still share an SM
template <int D>
__host__ __device__ constexpr int tile_rows() { return D == 64 ? 64 : 32; }
// row strides in floats: tiles read by rows (8 bytes a lane), and V, read by columns only
template <int D>
__host__ __device__ constexpr int row_t() { return D + 8; }
template <int D>
__host__ __device__ constexpr int row_n() { return D + 4; }

template <int D>
struct FwdSmem {  // Q, then K and V twice each
  static constexpr size_t bytes =
      sizeof(float) * (BQ * row_t<D>() + 2 * tile_rows<D>() * (row_t<D>() + row_n<D>()));
};
template <int D>
struct DqSmem {  // Q and dO, then K and V twice each
  static constexpr size_t bytes = sizeof(float) * row_t<D>() * (2 * BQ + 4 * tile_rows<D>());
};
template <int D, int KB>
struct DkdvSmem {  // K and V of KB keys, then Q, dO and their lse log2(e) and D rows twice each
  static constexpr size_t bytes =
      sizeof(float) * (2 * KB * row_t<D>() + 4 * tile_rows<D>() * (row_t<D>() + 1));
};

// Keys a dkdv block owns: 64, or 32 where 64-key blocks would leave SMs without one.
inline int dkdv_keys(int Sk, int KV, int B) {
  return static_cast<int64_t>((Sk + 63) / 64) * KV * B >= hopper::kSMs ? 64 : 32;
}

// Rows [row0, row0 + N) of one head into a tile of row stride R; rows at or past `limit` are
// zero.
template <int D, int N, int R>
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src,
                                          int64_t s_stride, int row0, int limit) {
  constexpr int kChunks = D / 4;
#pragma unroll
  for (int i = threadIdx.x; i < N * kChunks; i += kThreads) {
    const int r = i / kChunks, c = 4 * (i % kChunks);
    const bool ok = row0 + r < limit;
    const float* g = src + (ok ? static_cast<int64_t>(row0 + r) * s_stride : 0) + c;
    tc::cp_async16(dst + r * R + c, g, ok ? 16 : 0);
  }
}

// n values of a row from `row0` (zero at or past `limit`), 4 bytes each.
__device__ __forceinline__ void load_vals(float* dst, const float* __restrict__ src, int row0,
                                          int limit, int n, int tid) {
  if (tid >= 0 && tid < n) {
    const bool ok = row0 + tid < limit;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(tc::smem_addr(dst + tid)),
                 "l"(src + (ok ? row0 + tid : 0)), "r"(ok ? 4 : 0));
  }
}

// Whether lo is rounded to nearest too.  Left to the tensor cores, which read a TF32 operand's
// top 19 bits, it is truncated: at most 2^-21 of x where rounding gives 2^-22, below the
// tensor cores' own rounding of the sums; the errors read the same either way and the kernels
// run 4-9% (forward) and 8-17% (backward) faster without the add (torch_kernel_probe.py
// f32-lo, PERF.md).
constexpr bool kRoundLo = false;

// x as hi + lo: hi rounded to nearest TF32, ties away (cvt.rna's rounding: half an ulp
// added, the low 13 bits cleared), lo = x - hi exactly in f32, read as TF32 by the tensor
// cores: 3 instructions.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) + (kRoundLo ? 0x1000u : 0u);
}

// d += a b for one m16n8k8 tile: TF32 inputs, f32 accumulator.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[n][e] = 0.f;
}

// Split operand fragments: hi and lo.
struct AFrag {
  uint32_t hi[4], lo[4];
};
struct BFrag {
  uint32_t hi[2], lo[2];
};

// d += a b in f32 by three TF32 products, the small terms first.
__device__ __forceinline__ void mma3(float (&d)[4], const AFrag& a, const BFrag& b) {
  mma_tf32(d, a.lo, b.hi[0], b.hi[1]);
  mma_tf32(d, a.hi, b.lo[0], b.lo[1]);
  mma_tf32(d, a.hi, b.hi[0], b.hi[1]);
}

// The A fragment of k-step kk (columns 8 kk + 2t and + 1 as k = t and t + 4) of rows g and
// g + 8 of a tile read by rows; p = tile + (r0 + g) row_t + 2t.
template <int D>
__device__ __forceinline__ AFrag load_a(const float* p, int kk) {
  const float2 x0 = *reinterpret_cast<const float2*>(p + 8 * kk);
  const float2 x1 = *reinterpret_cast<const float2*>(p + 8 * row_t<D>() + 8 * kk);
  AFrag a;
  split(x0.x, a.hi[0], a.lo[0]);
  split(x1.x, a.hi[1], a.lo[1]);
  split(x0.y, a.hi[2], a.lo[2]);
  split(x1.y, a.hi[3], a.lo[3]);
  return a;
}

// The B fragment of k-step kk, n-tile n where the tile's rows are the product's columns
// (B = Y^T): row 8n + g, the columns of load_a; p = tile + g row_t + 2t.
template <int D>
__device__ __forceinline__ BFrag load_bt(const float* p, int n, int kk) {
  const float2 y = *reinterpret_cast<const float2*>(p + 8 * n * row_t<D>() + 8 * kk);
  BFrag b;
  split(y.x, b.hi[0], b.lo[0]);
  split(y.y, b.hi[1], b.lo[1]);
  return b;
}

// The B fragment of k-step j, n-tile n where the tile's rows are the contraction (B = Y):
// rows 8j + 2t and + 1 (k = t and t + 4), column 8n + g; p = tile + 2t R + g.
template <int R>
__device__ __forceinline__ BFrag load_b(const float* p, int j, int n) {
  BFrag b;
  split(p[8 * j * R + 8 * n], b.hi[0], b.lo[0]);
  split(p[(8 * j + 1) * R + 8 * n], b.hi[1], b.lo[1]);
  return b;
}

// An accumulator tile (rows g, g + 8; columns 2t, 2t + 1) as the A fragment of the k-step
// over its 8 columns.
__device__ __forceinline__ AFrag acc_a(const float (&s)[4]) {
  AFrag a;
  split(s[0], a.hi[0], a.lo[0]);
  split(s[2], a.hi[1], a.lo[1]);
  split(s[1], a.hi[2], a.lo[2]);
  split(s[3], a.hi[3], a.lo[3]);
  return a;
}

// k-steps whose products the backward's dP sums on the tensor cores before an f32 add joins
// them to the rest: dS = P (dP - D) keeps dP's error whole where the two cancel (one key a
// row, where the reference gradient is 0), and the tensor cores round a long sum coarsely.
// At 4 that error is 3.6e-6 at d 128 against 1.2e-5 for one sum over all 16 k-steps, for 1-2%
// of the pair's time; at 1, 2.1e-6 for 10% (torch_kernel_probe.py f32-dp, PERF.md).
constexpr int kDpGroup = 4;

// acc[n] = X Y^T over D columns for the warp's 16 rows of X and the N rows of Y, both read
// by rows: pa = X + (r0 + g) row_t + 2t, pb = Y + g row_t + 2t.  G > 0: each G k-steps'
// products start from zero and join acc by an f32 add.
template <int D, int N, int G = 0>
__device__ __forceinline__ void product_t(float (&acc)[N / 8][4], const float* pa, const float* pb) {
  zero(acc);
  if (G == 0) {
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const AFrag a = load_a<D>(pa, kk);
#pragma unroll
      for (int n = 0; n < N / 8; ++n) mma3(acc[n], a, load_bt<D>(pb, n, kk));
    }
    return;
  }
  constexpr int kG = G > 0 ? G : 1;
#pragma unroll
  for (int k0 = 0; k0 < D / 8; k0 += kG) {
    AFrag a[kG];
#pragma unroll
    for (int i = 0; i < kG; ++i) a[i] = load_a<D>(pa, k0 + i);
#pragma unroll
    for (int n = 0; n < N / 8; ++n) {
      float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < kG; ++i) mma3(part, a[i], load_bt<D>(pb, n, k0 + i));
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] += part[e];
    }
  }
}

// part = P Y over the column tiles [c, c + N) of Y, for the warp's accumulator tiles p (16 rows
// x K columns) and the K rows of Y (row stride R): pb = Y + 2t R + g.  It starts from zero,
// so the tensor cores' coarser rounding of a sum runs over one tile's K / 8 k-steps; the
// caller adds it to its running sum in f32.
template <int R, int K, int N>
__device__ __forceinline__ void product_n(float (&part)[N][4], const float (&p)[K / 8][4],
                                          const float* pb, int c) {
  zero(part);
#pragma unroll
  for (int j = 0; j < K / 8; ++j) {
    const AFrag a = acc_a(p[j]);
#pragma unroll
    for (int n = 0; n < N; ++n) mma3(part[n], a, load_b<R>(pb, j, c + n));
  }
}

// acc = acc w + P Y over all D columns, in parts of at most 8 column tiles (32 registers);
// w[half] scales rows g + 8 half (1 where there is nothing to rescale).
template <int D, int R, int K>
__device__ __forceinline__ void add_product_n(float (&acc)[D / 8][4], const float (&p)[K / 8][4],
                                              const float* pb, const float (&w)[2]) {
  constexpr int N = D / 8 < 8 ? D / 8 : 8;
#pragma unroll
  for (int c = 0; c < D / 8; c += N) {
    float part[N][4];
    product_n<R, K, N>(part, p, pb, c);
#pragma unroll
    for (int n = 0; n < N; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c + n][e] = fmaf(acc[c + n][e], w[e >> 1], part[n][e]);
  }
}

// Forward.  grid (H, row tiles, B), row tiles last-first; kLse: write the rows' log-sum-exp
// (training).  A block of 4 warps owns 64 query rows, each warp 16, and streams K/V tiles of
// tile_rows<D>() keys through a double-buffered cp.async ring.
template <int D, bool kLse>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_tf32(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse, int S,
               int Sk, int H, int KV, Strides qs, Strides ks, Strides vs, Strides os,
               float scale_log2, int causal) {
  constexpr int BK = tile_rows<D>(), NT = BK / 8, DT = D / 8, RT = row_t<D>(), RN = row_n<D>();
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * RT;       // [2][BK][RT]
  float* Vs = Ks + 2 * BK * RT;   // [2][BK][RN]

  const int h = blockIdx.x, b = blockIdx.z;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest causal rows first
  const int kvh = h / (H / KV);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, r0 = warp * 16;
  const float* kh = k + b * ks.b + kvh * ks.h;
  const float* vh = v + b * vs.b + kvh * vs.h;
  const int k_end = causal ? min(Sk, q0 + BQ) : Sk;  // causal (Sk == S): later tiles add nothing
  const int n_tiles = (k_end + BK - 1) / BK;

  load_rows<D, BQ, RT>(Qs, q + b * qs.b + h * qs.h, qs.s, q0, S);
  load_rows<D, BK, RT>(Ks, kh, ks.s, 0, Sk);
  load_rows<D, BK, RN>(Vs, vh, vs.s, 0, Sk);
  tc::cp_async_commit();

  float acc[DT][4];
  zero(acc);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // rows g and g + 8; l per thread
  const int row_lo = q0 + r0 + g;
  const float* pq = Qs + (r0 + g) * RT + 2 * t;

  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_tiles) {  // the next tile flies while this one is computed
      load_rows<D, BK, RT>(Ks + (buf ^ 1) * BK * RT, kh, ks.s, (it + 1) * BK, Sk);
      load_rows<D, BK, RN>(Vs + (buf ^ 1) * BK * RN, vh, vs.s, (it + 1) * BK, Sk);
    }
    tc::cp_async_commit();
    tc::cp_async_wait<1>();  // everything but the newest group has landed
    __syncthreads();
    const int k0 = it * BK;
    float s[NT][4];
    product_t<D, BK>(s, pq, Ks + buf * BK * RT + g * RT + 2 * t);

    // element e of tile n: row row_lo + 8 (e / 2), key k0 + 8n + 2t + e % 2
    const bool masked = k0 + BK > Sk || (causal && k0 + BK - 1 > q0 + r0);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale_log2;
        if (masked) {
          const int key = k0 + 8 * n + 2 * t + (e & 1);
          if (key >= Sk || (causal && key > row_lo + 8 * (e >> 1))) x = -INFINITY;
        }
        s[n][e] = x;
      }

    // online softmax over the thread's two rows, reduced across the quad
    float alpha[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float mx = m[half];
#pragma unroll
      for (int n = 0; n < NT; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * half], s[n][2 * half + 1]));
      mx = tc::quad_max(mx);
      // a row with no key yet (a causal tile past it) keeps p = 0 instead of NaN
      const float base = mx == -INFINITY ? 0.f : mx;
      alpha[half] = exp2f(m[half] - base);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 2 * half; e < 2 * half + 2; ++e) {
          s[n][e] = exp2f(s[n][e] - base);
          sum += s[n][e];
        }
      l[half] = l[half] * alpha[half] + sum;
      m[half] = mx;
    }

    // acc = acc alpha + P V
    add_product_n<D, RN, BK>(acc, s, Vs + buf * BK * RN + 2 * t * RN + g, alpha);
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

  float* oh = o + b * os.b + h * os.h;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const float sum = tc::quad_sum(l[half]);
    const float inv = 1.f / fmaxf(sum, 1e-30f);
    const int row = row_lo + 8 * half;
    if (row < S) {
#pragma unroll
      for (int n = 0; n < DT; ++n)
        *reinterpret_cast<float2*>(oh + static_cast<int64_t>(row) * os.s + 8 * n + 2 * t) =
            make_float2(acc[n][2 * half] * inv, acc[n][2 * half + 1] * inv);
      if (kLse && t == 0)  // m is in log2 units of the scaled scores
        lse[(static_cast<int64_t>(b) * H + h) * S + row] = (m[half] + log2f(sum)) * kLn2;
    }
  }
}

// dQ, and the hand-off to dkdv: stats[0] = D = rowsum(dO o), stats[1] = lse log2(e), rows
// of stats_row(S).  grid (H, row tiles, B), row tiles last-first.  A block of 4 warps owns 64
// query rows (Q and dO resident) and streams K/V tiles as the forward does; per tile
// S = Q K^T, dP = dO V^T, dS = P (dP - D), dQ += dS K.
template <int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dq_tf32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ o,
                  const float* __restrict__ dout, const float* __restrict__ lse,
                  float* __restrict__ stats, float* __restrict__ dq, int S, int Sk, int H, int KV,
                  Strides qs, Strides ks, Strides vs, Strides os, Strides dos, Strides dqs,
                  float scale_log2, float scale, int causal) {
  constexpr int BK = tile_rows<D>(), NT = BK / 8, DT = D / 8, RT = row_t<D>();
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* dOs = Qs + BQ * RT;
  float* Ks = dOs + BQ * RT;     // [2][BK][RT]
  float* Vs = Ks + 2 * BK * RT;  // [2][BK][RT]

  const int h = blockIdx.x, b = blockIdx.z;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int kvh = h / (H / KV);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, r0 = warp * 16;
  const float* kh = k + b * ks.b + kvh * ks.h;
  const float* vh = v + b * vs.b + kvh * vs.h;
  const float* doh = dout + b * dos.b + h * dos.h;
  const int k_end = causal ? min(Sk, q0 + BQ) : Sk;
  const int n_tiles = (k_end + BK - 1) / BK;

  load_rows<D, BQ, RT>(Qs, q + b * qs.b + h * qs.h, qs.s, q0, S);
  load_rows<D, BQ, RT>(dOs, doh, dos.s, q0, S);
  load_rows<D, BK, RT>(Ks, kh, ks.s, 0, Sk);
  load_rows<D, BK, RT>(Vs, vh, vs.s, 0, Sk);
  tc::cp_async_commit();

  // D and lse log2(e) of rows g and g + 8: each lane of a quad sums a quarter of the row
  const float* oh = o + b * os.b + h * os.h;
  const int64_t stat = (static_cast<int64_t>(b) * H + h) * stats_row(S);
  float drow[2], lrow[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + r0 + g + 8 * half;
    float sum = 0.f;
    if (row < S) {
#pragma unroll
      for (int c = t * (D / 4); c < (t + 1) * (D / 4); c += 4) {
        const float4 x = *reinterpret_cast<const float4*>(oh + static_cast<int64_t>(row) * os.s + c);
        const float4 y = *reinterpret_cast<const float4*>(doh + static_cast<int64_t>(row) * dos.s + c);
        sum = fmaf(x.x, y.x, fmaf(x.y, y.y, fmaf(x.z, y.z, fmaf(x.w, y.w, sum))));
      }
    }
    drow[half] = tc::quad_sum(sum);
    lrow[half] = row < S ? lse[(static_cast<int64_t>(b) * H + h) * S + row] * kLog2e : 0.f;
    if (t == 0 && row < S) {
      stats[stat + row] = drow[half];
      stats[static_cast<int64_t>(gridDim.z) * H * stats_row(S) + stat + row] = lrow[half];
    }
  }

  float dqa[DT][4];
  zero(dqa);
  const float one[2] = {1.f, 1.f};
  const float* pq = Qs + (r0 + g) * RT + 2 * t;
  const float* pdo = dOs + (r0 + g) * RT + 2 * t;
  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_tiles) {
      load_rows<D, BK, RT>(Ks + (buf ^ 1) * BK * RT, kh, ks.s, (it + 1) * BK, Sk);
      load_rows<D, BK, RT>(Vs + (buf ^ 1) * BK * RT, vh, vs.s, (it + 1) * BK, Sk);
    }
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();
    const int k0 = it * BK;
    const float* Kt = Ks + buf * BK * RT;
    if (!(causal && k0 > q0 + r0 + 15)) {  // else no key of the tile is seen by the warp's rows
      float s[NT][4], dp[NT][4];
      product_t<D, BK>(s, pq, Kt + g * RT + 2 * t);
      product_t<D, BK, kDpGroup>(dp, pdo, Vs + buf * BK * RT + g * RT + 2 * t);
      const bool masked = k0 + BK > Sk || (causal && k0 + BK - 1 > q0 + r0);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int half = e >> 1;
          float p = exp2f(fmaf(s[n][e], scale_log2, -lrow[half]));
          if (masked) {
            const int key = k0 + 8 * n + 2 * t + (e & 1);
            if (key >= Sk || (causal && key > q0 + r0 + g + 8 * half)) p = 0.f;
          }
          s[n][e] = p * (dp[n][e] - drow[half]);  // dS
        }
      add_product_n<D, RT, BK>(dqa, s, Kt + 2 * t * RT + g, one);  // dQ += dS K
    }
    __syncthreads();
  }

  float* qh = dq + b * dqs.b + h * dqs.h;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + r0 + g + 8 * half;
    if (row < S)
#pragma unroll
      for (int n = 0; n < DT; ++n)
        *reinterpret_cast<float2*>(qh + static_cast<int64_t>(row) * dqs.s + 8 * n + 2 * t) =
            make_float2(dqa[n][2 * half] * scale, dqa[n][2 * half + 1] * scale);
  }
}

// dK, dV.  grid (KB-key tiles of Sk, KV, B).  A block of 4 warps owns KB keys (K and V
// resident) and walks the query tiles (tile_rows<D>() rows) at or after the diagonal of each
// of the KV head's g query heads, streamed with their lse log2(e) and D rows through a
// double-buffered cp.async ring; per tile S^T = K Q^T, dP^T = V dO^T, dV += P^T dO,
// dK += dS^T Q.  KB 64: each warp 16 keys against the whole tile.  KB 32, where 64-key blocks
// would leave SMs idle: warps w and w + 2 share 16 keys, each taking half of every tile's
// queries, and the second's dK and dV are added to the first's at the end, in that order.
template <int D, int KB>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dkdv_tf32(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ stats, float* __restrict__ dk,
                    float* __restrict__ dv, int S, int Sk, int H, int KV, Strides qs, Strides ks,
                    Strides vs, Strides dos, Strides dks, Strides dvs, float scale_log2,
                    float scale, int causal) {
  constexpr int BT = tile_rows<D>(), DT = D / 8, RT = row_t<D>();
  constexpr int QS = 64 / KB, NQ = BT / QS, NT = NQ / 8;  // query splits; a warp's queries a tile
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + KB * RT;
  float* Qs = Vs + KB * RT;        // [2][BT][RT]
  float* dOs = Qs + 2 * BT * RT;   // [2][BT][RT]
  float* Ls = dOs + 2 * BT * RT;   // [2][BT] lse log2(e)
  float* Ds = Ls + 2 * BT;         // [2][BT] D

  const int k0 = blockIdx.x * KB, kvh = blockIdx.y, b = blockIdx.z;
  const int g_heads = H / KV;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = (warp % (KB / 16)) * 16, qc0 = (warp / (KB / 16)) * NQ;  // keys; queries
  const int key_lo = k0 + r0 + g;  // this thread's first key
  const int64_t plane = static_cast<int64_t>(gridDim.z) * H * stats_row(S);

  load_rows<D, KB, RT>(Ks, k + b * ks.b + kvh * ks.h, ks.s, k0, Sk);
  load_rows<D, KB, RT>(Vs, v + b * vs.b + kvh * vs.h, vs.s, k0, Sk);
  // causal (Sk == S): query tiles wholly before the key tile see none of it
  const int qt0 = causal ? k0 / BT : 0;
  const int per_head = (S + BT - 1) / BT - qt0;
  const int n_tiles = g_heads * per_head;
  auto load_tile = [&](int it, int buf) {
    const int hh = kvh * g_heads + it / per_head, qq = (qt0 + it % per_head) * BT;
    load_rows<D, BT, RT>(Qs + buf * BT * RT, q + b * qs.b + hh * qs.h, qs.s, qq, S);
    load_rows<D, BT, RT>(dOs + buf * BT * RT, dout + b * dos.b + hh * dos.h, dos.s, qq, S);
    const float* st = stats + (static_cast<int64_t>(b) * H + hh) * stats_row(S);
    load_vals(Ls + buf * BT, st + plane, qq, S, BT, static_cast<int>(threadIdx.x));
    load_vals(Ds + buf * BT, st, qq, S, BT, static_cast<int>(threadIdx.x) - BT);
  };
  load_tile(0, 0);
  tc::cp_async_commit();

  float dka[DT][4], dva[DT][4];
  zero(dka);
  zero(dva);
  const float one[2] = {1.f, 1.f};
  const float* pk = Ks + (r0 + g) * RT + 2 * t;
  const float* pv = Vs + (r0 + g) * RT + 2 * t;
  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_tiles) load_tile(it + 1, buf ^ 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();
    const int q0 = (qt0 + it % per_head) * BT + qc0;  // the warp's first query
    if (!(causal && q0 + NQ - 1 < k0 + r0)) {  // else none of the warp's queries sees its keys
      const float* Qt = Qs + (buf * BT + qc0) * RT;  // the warp's NQ rows of the tile
      const float* dOt = dOs + (buf * BT + qc0) * RT;
      const float* Lt = Ls + buf * BT + qc0;
      const float* Dt = Ds + buf * BT + qc0;
      float st[NT][4], dpt[NT][4];
      product_t<D, NQ>(st, pk, Qt + g * RT + 2 * t);
      product_t<D, NQ, kDpGroup>(dpt, pv, dOt + g * RT + 2 * t);
      // element e of tile n: key key_lo + 8 (e / 2), query q0 + 8n + 2t + e % 2
      const bool masked = q0 + NQ > S || (causal && q0 < k0 + r0 + 15);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float2 lq = *reinterpret_cast<const float2*>(Lt + 8 * n + 2 * t);
        const float2 dq2 = *reinterpret_cast<const float2*>(Dt + 8 * n + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2f(fmaf(st[n][e], scale_log2, -((e & 1) ? lq.y : lq.x)));
          if (masked) {
            const int query = q0 + 8 * n + 2 * t + (e & 1);
            if (query >= S || (causal && query < key_lo + 8 * (e >> 1))) p = 0.f;
          }
          st[n][e] = p;                                             // P^T
          dpt[n][e] = p * (dpt[n][e] - ((e & 1) ? dq2.y : dq2.x));  // dS^T
        }
      }
      add_product_n<D, RT, NQ>(dva, st, dOt + 2 * t * RT + g, one);  // dV += P^T dO
      add_product_n<D, RT, NQ>(dka, dpt, Qt + 2 * t * RT + g, one);  // dK += dS^T Q
    }
    __syncthreads();
  }

  if (QS > 1) {  // the second query half's sums join the first's, through the idle ring
    float* part = Qs + (warp % (KB / 16)) * 2 * 16 * D;  // [2][16][D]: dK, dV of a key group
    const int lane_off = g * D + 2 * t;
    if (warp >= KB / 16) {
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int n = 0; n < DT; ++n) {
          const int o = lane_off + 8 * half * D + 8 * n;
          *reinterpret_cast<float2*>(part + o) = make_float2(dka[n][2 * half], dka[n][2 * half + 1]);
          *reinterpret_cast<float2*>(part + 16 * D + o) = make_float2(dva[n][2 * half], dva[n][2 * half + 1]);
        }
    }
    __syncthreads();
    if (warp >= KB / 16) return;
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int n = 0; n < DT; ++n) {
        const int o = lane_off + 8 * half * D + 8 * n;
        const float2 pk2 = *reinterpret_cast<const float2*>(part + o);
        const float2 pv2 = *reinterpret_cast<const float2*>(part + 16 * D + o);
        dka[n][2 * half] += pk2.x;
        dka[n][2 * half + 1] += pk2.y;
        dva[n][2 * half] += pv2.x;
        dva[n][2 * half + 1] += pv2.y;
      }
  }

  float* kd = dk + b * dks.b + kvh * dks.h;
  float* vd = dv + b * dvs.b + kvh * dvs.h;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = key_lo + 8 * half;
    if (key < Sk)
#pragma unroll
      for (int n = 0; n < DT; ++n) {
        *reinterpret_cast<float2*>(kd + static_cast<int64_t>(key) * dks.s + 8 * n + 2 * t) =
            make_float2(dka[n][2 * half] * scale, dka[n][2 * half + 1] * scale);
        *reinterpret_cast<float2*>(vd + static_cast<int64_t>(key) * dvs.s + 8 * n + 2 * t) =
            make_float2(dva[n][2 * half], dva[n][2 * half + 1]);
      }
  }
}

}  // namespace tf


// --------------------------------------------------------------- decode --
//
// B11's decode form (no TPU counterpart: the JAX package decodes in XLA,
// repro/models/layers.py decode_attention).  One query a row against the
// FLAT caches [B, Sk, KV*D] that decode_attention holds, read in place in
// their own dtype; the first n keys count.  Bound: the bytes of K and V
// read once (24.6 MB a whisper layer, 7.3 us).  Whisper's 64 (row, KV head)
// pairs are fewer than the card's 132 SMs, so the keys of a pair are split
// over the blocks of one thread-block cluster: each block runs an online
// softmax (f32 max, sum and P V on CUDA cores) over its chunk of keys, its
// warps' partials land in its shared memory, and block 0 of the cluster
// combines every split's partials in a fixed order (split, then warp)
// through distributed shared memory and writes the output.  No atomics and
// no scratch in device memory, so two calls give the same bits.
//
// A key row is D values of T: LPK lanes read it, 16 bytes (EPL values)
// each, so a warp holds KPW = 32 / LPK keys at once, and each group of LPK
// lanes takes kUnroll consecutive keys an iteration, their loads issued
// together.  A block takes G <= 4 query rows of its KV head's group of g
// (grid.y = KV x row tiles); rows past g run on zeros and are not stored.
namespace dec {

constexpr int kWarps = 4;
constexpr int kUnroll = 4;

__device__ __forceinline__ void to_f32(const uint4& u, float (&f)[8], const __nv_bfloat16*) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}
__device__ __forceinline__ void to_f32(const uint4& u, float (&f)[4], const float*) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// One warp's partial: per row the max (log2 units of the scaled scores), the sum, and P V.
template <int D, int G>
struct Part {
  float m[G], l[G], acc[G][D];
};

// grid (splits, KV x row tiles, B) in clusters of (splits, 1, 1); split s
// takes keys [s chunk, min(n, (s + 1) chunk)).
template <typename T, int D, int G>
__global__ void __launch_bounds__(kWarps * 32)
flash_decode(const T* __restrict__ q, const T* __restrict__ kc, const T* __restrict__ vc,
             T* __restrict__ o, int H, int KV, int n, int chunk, int64_t q_sb, int64_t q_sh,
             int64_t k_sb, int64_t k_ss, int64_t v_sb, int64_t v_ss, int64_t o_sb,
             float scale_log2) {
  constexpr int EPL = 16 / sizeof(T), LPK = D / EPL, KPW = 32 / LPK;
  __shared__ Part<D, G> part[kWarps];
  cg::cluster_group cluster = cg::this_cluster();
  const int split = blockIdx.x, splits = gridDim.x;  // a cluster spans grid.x: rank = blockIdx.x
  const int g = H / KV, tiles = (g + G - 1) / G, tile = blockIdx.y % tiles;
  const int kvh = blockIdx.y / tiles, h0 = kvh * g + tile * G, rows = min(G, g - tile * G);
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane / LPK, c0 = (lane % LPK) * EPL;  // the lane's key group and columns

  float qf[G][EPL];  // the rows' columns c0.., times scale log2(e)
#pragma unroll
  for (int r = 0; r < G; ++r) {
    float f[EPL];
    const uint4 u = r < rows ? *reinterpret_cast<const uint4*>(q + b * q_sb + (h0 + r) * q_sh + c0)
                             : make_uint4(0, 0, 0, 0);
    to_f32(u, f, q);
#pragma unroll
    for (int e = 0; e < EPL; ++e) qf[r][e] = f[e] * scale_log2;
  }
  float m[G], l[G], acc[G][EPL];
#pragma unroll
  for (int r = 0; r < G; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[r][e] = 0.f;
  }

  const int k_lo = split * chunk, k_hi = min(n, k_lo + chunk);
  const T* kb = kc + b * k_sb + kvh * D + c0;
  const T* vb = vc + b * v_sb + kvh * D + c0;
  // warp-uniform trip count: the lanes' shuffles need the whole warp
  for (int w0 = k_lo + warp * KPW * kUnroll; w0 < k_hi; w0 += kWarps * KPW * kUnroll) {
    const int key0 = w0 + grp * kUnroll;
    uint4 kr[kUnroll], vr[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool ok = key0 + u < k_hi;
      kr[u] = ok ? *reinterpret_cast<const uint4*>(kb + (key0 + u) * k_ss) : make_uint4(0, 0, 0, 0);
      vr[u] = ok ? *reinterpret_cast<const uint4*>(vb + (key0 + u) * v_ss) : make_uint4(0, 0, 0, 0);
    }
    float s[kUnroll][G];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float kf[EPL];
      to_f32(kr[u], kf, kc);
#pragma unroll
      for (int r = 0; r < G; ++r) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) dot = fmaf(qf[r][e], kf[e], dot);
#pragma unroll
        for (int off = LPK / 2; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
        s[u][r] = key0 + u < k_hi ? dot : -INFINITY;
      }
    }
#pragma unroll
    for (int r = 0; r < G; ++r) {  // online softmax over the group's keys
      float mx = m[r];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) mx = fmaxf(mx, s[u][r]);
      const float base = mx == -INFINITY ? 0.f : mx;  // no key yet: p = 0, not NaN
      const float alpha = exp2f(m[r] - base);
      l[r] *= alpha;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[r][e] *= alpha;
      m[r] = mx;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float p = exp2f(s[u][r] - base);
        float vf[EPL];
        to_f32(vr[u], vf, vc);
        l[r] += p;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[r][e] = fmaf(p, vf[e], acc[r][e]);
      }
    }
  }
  // the warp's key groups, combined by a fixed butterfly; group 0 keeps the result
#pragma unroll
  for (int off = LPK; off < 32; off <<= 1)
#pragma unroll
    for (int r = 0; r < G; ++r) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[r], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[r], off);
      const float mx = fmaxf(m[r], mo), base = mx == -INFINITY ? 0.f : mx;
      const float a = exp2f(m[r] - base), c = exp2f(mo - base);
      l[r] = l[r] * a + lo * c;
#pragma unroll
      for (int e = 0; e < EPL; ++e)
        acc[r][e] = acc[r][e] * a + __shfl_xor_sync(0xffffffffu, acc[r][e], off) * c;
      m[r] = mx;
    }
  if (grp == 0) {
#pragma unroll
    for (int r = 0; r < G; ++r) {
#pragma unroll
      for (int e = 0; e < EPL; ++e) part[warp].acc[r][c0 + e] = acc[r][e];
      if (lane == 0) {
        part[warp].m[r] = m[r];
        part[warp].l[r] = l[r];
      }
    }
  }
  cluster.sync();  // every block's partials are in its shared memory
  if (split == 0) {
    T* ob = o + b * o_sb + static_cast<int64_t>(h0) * D;
    for (int i = threadIdx.x; i < rows * D; i += kWarps * 32) {
      const int r = i / D, c = i % D;
      float mx = -INFINITY;  // finite: split 0's warp 0 holds key 0
      for (int sp = 0; sp < splits; ++sp) {
        const Part<D, G>* p = cluster.map_shared_rank(part, sp);
#pragma unroll
        for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, p[w].m[r]);
      }
      float sum = 0.f, val = 0.f;
      for (int sp = 0; sp < splits; ++sp) {
        const Part<D, G>* p = cluster.map_shared_rank(part, sp);
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          const float wgt = exp2f(p[w].m[r] - mx);
          sum = fmaf(p[w].l[r], wgt, sum);
          val = fmaf(p[w].acc[r][c], wgt, val);
        }
      }
      store(ob + i, val / sum);
    }
  }
  cluster.sync();  // block 0 has read every block's partials before they go
}

// Query rows a block takes: the group's g where it is 1 or 2, else tiles of 4.
constexpr int rows_for(int g) { return g == 1 ? 1 : g == 2 ? 2 : 4; }

template <typename T, int D, int G>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int H, int KV, int n,
                   int chunk, int64_t q_sb, int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t v_sb,
                   int64_t v_ss, float scale_log2, dim3 grid, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kWarps * 32);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = grid.x;  // one cluster of `splits` blocks a (row, KV head, row tile)
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, flash_decode<T, D, G>, static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, KV, n, chunk, q_sb, q_sh, k_sb, k_ss, v_sb,
      v_ss, static_cast<int64_t>(H) * D, scale_log2);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_rows(int rows, const void* q, const void* k, const void* v, void* o, int H,
                        int KV, int n, int chunk, int64_t q_sb, int64_t q_sh, int64_t k_sb,
                        int64_t k_ss, int64_t v_sb, int64_t v_ss, float scale_log2, dim3 grid,
                        cudaStream_t stream) {
  auto f = rows == 1 ? launch<T, D, 1> : rows == 2 ? launch<T, D, 2> : launch<T, D, 4>;
  return f(q, k, v, o, H, KV, n, chunk, q_sb, q_sh, k_sb, k_ss, v_sb, v_ss, scale_log2, grid,
           stream);
}

}  // namespace dec

// Launch a kernel after checking that the plan computed in Python (grid,
// shared-memory bytes) is the one it was written for.
template <typename Kernel, typename... Args>
cudaError_t launch_checked(Kernel kernel, dim3 want, size_t bytes, dim3 grid, int64_t smem,
                           cudaStream_t stream, Args... args) {
  if (smem != static_cast<int64_t>(bytes) || grid.x != want.x || grid.y != want.y ||
      grid.z != want.z)
    return cudaErrorInvalidConfiguration;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, bytes, stream>>>(args...);
  return cudaGetLastError();
}

constexpr int row_tiles(int S) { return (S + 63) / 64; }  // every template: 64-row tiles

template <int D>
cudaError_t fwd(int dtype, const void* q, const void* k, const void* v, void* o, void* lse, int B,
                int H, int KV, int S, int Sk, Strides qs, Strides ks, Strides vs, Strides os,
                float scale, int causal, dim3 grid, int64_t smem, cudaStream_t st) {
  using tc::bf16;
  float* l = static_cast<float*>(lse);
  if (dtype == 1)
    return launch_checked(l ? tc::flash_fwd_bf16<D, true> : tc::flash_fwd_bf16<D, false>,
                          dim3(H, row_tiles(S), B), tc::Layout<D>::bytes,
                          grid, smem, st, static_cast<const bf16*>(q),
                          static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                          static_cast<bf16*>(o), l, S, H, KV, qs, ks, vs, os,
                          scale * kLog2e, causal);  // exp(x) = exp2(x log2 e)
  return launch_checked(l ? tf::flash_fwd_tf32<D, true> : tf::flash_fwd_tf32<D, false>,
                        dim3(H, row_tiles(S), B), tf::FwdSmem<D>::bytes, grid,
                        smem, st, static_cast<const float*>(q), static_cast<const float*>(k),
                        static_cast<const float*>(v), static_cast<float*>(o), l, S, Sk, H, KV, qs,
                        ks, vs, os, scale * kLog2e, causal);
}

// B11's bf16 forward (xa::) after checking the grid and shared memory of
// flash_attention.py::cross_plan; the caller has checked its splits and chunk.
template <int D>
cudaError_t cross_bf16(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                       int H, int KV, int S, int Sk, Strides qs, Strides ks, Strides vs, Strides os,
                       float scale, int chunk, dim3 grid, int64_t smem, cudaStream_t st) {
  using L = xa::Smem<D>;
  if (smem != L::bytes || grid.y != static_cast<unsigned>(H * ((S + xa::BQ - 1) / xa::BQ)) ||
      grid.z != static_cast<unsigned>(B))
    return cudaErrorInvalidConfiguration;
  CUtensorMap tq, tk, tv;
  if (!hopper::map_bf16_rows(&tq, q, B, H, S, D, qs.b, qs.h, qs.s, xa::BQ) ||
      !hopper::map_bf16_rows(&tk, k, B, KV, Sk, D, ks.b, ks.h, ks.s, L::BK) ||
      !hopper::map_bf16_rows(&tv, v, B, KV, Sk, D, vs.b, vs.h, vs.s, L::BK))
    return cudaErrorInvalidValue;
  auto kernel = lse ? xa::flash_cross_fwd_wgmma<D, true> : xa::flash_cross_fwd_wgmma<D, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::bytes);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(xa::kBlockThreads);
  cfg.dynamicSmemBytes = L::bytes;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = grid.x;  // one cluster of `splits` blocks a (batch, head, row tile)
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  // One split launches without clusters, which measured 4% faster at whisper's LM
  // shape; its blocks' cluster barriers are then the block's own.
  cfg.numAttrs = grid.x > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, tq, tk, tv, static_cast<xa::bf16*>(o), lse, S, Sk, H, KV,
                           chunk, os, scale * kLog2e);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// Backward views: q, k, v, o, dout, dq, dk, dv, each given by (b, h, s) strides.
struct Views {
  Strides q, k, v, o, dout, dq, dk, dv;
};

Views views_from(const int64_t* st) {
  Strides s[8];
  for (int i = 0; i < 8; ++i) s[i] = Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
  return Views{s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7]};
}

// The bf16 backward's warpgroups per block, each by the length it tiles:
// 128-row dq tiles past S = 256 queries and 128-key dkdv tiles (d = 64)
// past Sk = 256 keys, where they halve the streamed bytes per row; 64
// below, where the smaller tiles keep the card full.  At d = 128 a dkdv
// block has one consumer warpgroup: its dK and dV accumulators alone are
// 128 f32 registers a thread.
int dq_warpgroups(int S) { return S > 256 ? 2 : 1; }
int dkdv_warpgroups(int D, int Sk) { return D == 64 && Sk > 256 ? 2 : 1; }

// Launch a warp-specialised kernel after the same plan check as
// launch_checked; `threads` is its consumers plus one producer warp.
// With `dependent`, the kernel may start while the one before it on the
// stream finishes (hopper::launch_dependent).
template <typename Kernel, typename... Args>
cudaError_t launch_wgmma(Kernel kernel, bool dependent, dim3 want, int bytes, int threads,
                         dim3 grid, int64_t smem, cudaStream_t stream, Args... args) {
  if (smem != bytes || grid.x != want.x || grid.y != want.y || grid.z != want.z)
    return cudaErrorInvalidConfiguration;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  if (dependent)
    err = hopper::launch_dependent(kernel, grid, dim3(threads), bytes, stream, args...);
  else
    kernel<<<grid, threads, bytes, stream>>>(args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int D, int NWG>
cudaError_t dq_bf16(const void* q, const void* k, const void* v, const void* o, const void* dout,
                    const void* lse, void* delta, void* dq, int B, int H, int KV, int S, int Sk,
                    const Views& w, float scale, int causal, dim3 grid, int64_t smem,
                    cudaStream_t st) {
  using wg::bf16;
  constexpr int BQ = 64 * NWG;
  CUtensorMap tq, tdo, tk, tv;
  if (!hopper::map_bf16_rows(&tq, q, B, H, S, D, w.q.b, w.q.h, w.q.s, BQ) ||
      !hopper::map_bf16_rows(&tdo, dout, B, H, S, D, w.dout.b, w.dout.h, w.dout.s, BQ) ||
      !hopper::map_bf16_rows(&tk, k, B, KV, Sk, D, w.k.b, w.k.h, w.k.s, 64) ||
      !hopper::map_bf16_rows(&tv, v, B, KV, Sk, D, w.v.b, w.v.h, w.v.s, 64))
    return cudaErrorInvalidValue;
  return launch_wgmma(wg::flash_bwd_dq_wgmma<D, NWG>, false, dim3(H, (S + BQ - 1) / BQ, B),
                      wg::DqSmem<D, NWG>::bytes, NWG * 128 + 32, grid, smem, st, tq, tdo, tk, tv,
                      static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
                      static_cast<const float*>(lse), static_cast<float*>(delta),
                      static_cast<bf16*>(dq), S, Sk, H, KV, w.o, w.dout, w.dq, scale * kLog2e,
                      scale, causal);
}

template <int D, int NWG, int kMinBlocks>
cudaError_t dkdv_bf16(const void* q, const void* k, const void* v, const void* dout,
                      const void* stats, void* dk, void* dv, int B, int H, int KV, int S, int Sk,
                      const Views& w, float scale, int causal, dim3 grid, int64_t smem,
                      cudaStream_t st) {
  using wg::bf16;
  constexpr int BK = 64 * NWG;
  CUtensorMap tq, tdo, tk, tv, ts;
  if (!hopper::map_bf16_rows(&tq, q, B, H, S, D, w.q.b, w.q.h, w.q.s, 64) ||
      !hopper::map_bf16_rows(&tdo, dout, B, H, S, D, w.dout.b, w.dout.h, w.dout.s, 64) ||
      !hopper::map_bf16_rows(&tk, k, B, KV, Sk, D, w.k.b, w.k.h, w.k.s, BK) ||
      !hopper::map_bf16_rows(&tv, v, B, KV, Sk, D, w.v.b, w.v.h, w.v.s, BK) ||
      !hopper::map_f32_rows(&ts, stats, 2 * B * H, S, stats_row(S), 64))
    return cudaErrorInvalidValue;
  return launch_wgmma(wg::flash_bwd_dkdv_wgmma<D, NWG, kMinBlocks>, true,
                      dim3((Sk + BK - 1) / BK, KV, B),
                      wg::DkdvSmem<D, NWG>::bytes, NWG * 128 + 32, grid, smem, st, tq, tdo, tk, tv,
                      ts, static_cast<bf16*>(dk), static_cast<bf16*>(dv), S, Sk, H, KV, w.dk, w.dv,
                      scale * kLog2e, scale, causal);
}

// B11's bf16 backward, first launch: the statistics pass over B H S rows, `blocks`
// blocks (flash_attention.py::cross_bwd_plan's stats_blocks); it zeroes the
// pass's n_counters counters.
template <int D>
cudaError_t cross_bwd_stats_bf16(const void* o, const void* dout, const void* lse, void* stats,
                                 void* counters, int n_counters, int B, int H, int S, Strides os,
                                 Strides dos, int blocks, cudaStream_t st) {
  constexpr int rows_per_block = xa::kStatsThreads / 32 * (32 / (D / 8));
  if (static_cast<int64_t>(blocks) != (static_cast<int64_t>(B) * H * S + rows_per_block - 1) / rows_per_block ||
      n_counters < 0 || (n_counters > 0 && !counters))
    return cudaErrorInvalidConfiguration;
  xa::cross_bwd_stats<D><<<blocks, xa::kStatsThreads, 0, st>>>(
      static_cast<const xa::bf16*>(o), static_cast<const xa::bf16*>(dout),
      static_cast<const float*>(lse), static_cast<float*>(stats), static_cast<int*>(counters),
      n_counters, S, H, B * H, os, dos);
  return cudaGetLastError();
}

// Second launch: the one pass, after checking the plan of
// flash_attention.py::cross_bwd_plan: grid (splits, KV, B), splits <= 8 and
// no more than the key tiles, rows = g S_pad, and the shared memory that
// holds the dQ partials (in_smem) or not; scratch [splits][B][KV][rows][D]
// f32 wherever they are not all in one block's shared memory, counters
// [B][KV][splits] (zeroed by the first launch) past one split.
template <int D, int NWG>
cudaError_t cross_bwd_bf16(const void* q, const void* k, const void* v, const void* dout,
                           const void* stats, void* dq, void* dk, void* dv, void* scratch,
                           void* counters, int B, int H, int KV, int S, int Sk, const Views& w,
                           float scale, int rows, int in_smem, dim3 grid, int64_t smem,
                           cudaStream_t st) {
  constexpr int BK = 64 * NWG;
  const int64_t want_smem = xa::BwdSmem<D, NWG>::fixed + (in_smem ? static_cast<int64_t>(rows) * D * 4 : 0);
  if (grid.x < 1 || grid.x > 8 || static_cast<int>(grid.x) > (Sk + BK - 1) / BK ||
      grid.y != static_cast<unsigned>(KV) || grid.z != static_cast<unsigned>(B) ||
      rows != H / KV * ((S + 63) / 64 * 64) || smem != want_smem || smem > 232448 ||
      ((grid.x > 1 || !in_smem) && !scratch) || (grid.x > 1 && !counters))
    return cudaErrorInvalidConfiguration;
  CUtensorMap tq, tdo, tk, tv, ts;
  if (!hopper::map_bf16_rows(&tq, q, B, H, S, D, w.q.b, w.q.h, w.q.s, 64) ||
      !hopper::map_bf16_rows(&tdo, dout, B, H, S, D, w.dout.b, w.dout.h, w.dout.s, 64) ||
      !hopper::map_bf16_rows(&tk, k, B, KV, Sk, D, w.k.b, w.k.h, w.k.s, BK) ||
      !hopper::map_bf16_rows(&tv, v, B, KV, Sk, D, w.v.b, w.v.h, w.v.s, BK) ||
      !hopper::map_f32_rows(&ts, stats, 2 * B * H, S, stats_row(S), 64))
    return cudaErrorInvalidValue;
  // may start under the statistics pass: it waits for that grid before the stats
  return launch_wgmma(xa::flash_cross_bwd_wgmma<D, NWG>, true, grid, static_cast<int>(smem),
                      xa::bwd_threads<NWG>(), grid, smem, st, tq, tdo, tk, tv, ts,
                      static_cast<xa::bf16*>(dq), static_cast<xa::bf16*>(dk),
                      static_cast<xa::bf16*>(dv), static_cast<float*>(scratch),
                      static_cast<int*>(counters), in_smem, S, Sk, H, KV, rows, w.dq, w.dk, w.dv,
                      scale * kLog2e, scale);
}

template <int D>
cudaError_t bwd_dq(int dtype, const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const void* lse, void* delta, void* dq, int B, int H,
                   int KV, int S, int Sk, const Views& w, float scale, int causal, dim3 grid,
                   int64_t smem, cudaStream_t st) {
  if (dtype == 1) {
    return (dq_warpgroups(S) == 2 ? dq_bf16<D, 2> : dq_bf16<D, 1>)(
        q, k, v, o, dout, lse, delta, dq, B, H, KV, S, Sk, w, scale, causal, grid, smem, st);
  }
  return launch_checked(tf::flash_bwd_dq_tf32<D>, dim3(H, row_tiles(S), B), tf::DqSmem<D>::bytes,
                        grid, smem, st, static_cast<const float*>(q), static_cast<const float*>(k),
                        static_cast<const float*>(v), static_cast<const float*>(o),
                        static_cast<const float*>(dout), static_cast<const float*>(lse),
                        static_cast<float*>(delta), static_cast<float*>(dq), S, Sk, H, KV, w.q,
                        w.k, w.v, w.o, w.dout, w.dq, scale * kLog2e, scale, causal);
}

template <int D>
cudaError_t bwd_dkdv(int dtype, const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, void* dk, void* dv, int B, int H, int KV,
                     int S, int Sk, const Views& w, float scale, int causal, dim3 grid,
                     int64_t smem, cudaStream_t st) {
  if (dtype == 1) {
    const bool two_per_sm = static_cast<int64_t>(grid.x) * grid.y * grid.z > hopper::kSMs;
    return (dkdv_warpgroups(D, Sk) == 2   ? dkdv_bf16<64, 2, 1>
            : D == 64 && two_per_sm ? dkdv_bf16<64, 1, 2>
                                    : dkdv_bf16<D, 1, 1>)(
        q, k, v, dout, delta, dk, dv, B, H, KV, S, Sk, w, scale, causal, grid, smem, st);
  }
  const int kb = tf::dkdv_keys(Sk, KV, B);
  return launch_checked(kb == 64 ? tf::flash_bwd_dkdv_tf32<D, 64> : tf::flash_bwd_dkdv_tf32<D, 32>,
                        dim3((Sk + kb - 1) / kb, KV, B),
                        kb == 64 ? tf::DkdvSmem<D, 64>::bytes : tf::DkdvSmem<D, 32>::bytes, grid,
                        smem, st, static_cast<const float*>(q),
                        static_cast<const float*>(k), static_cast<const float*>(v),
                        static_cast<const float*>(dout), static_cast<const float*>(delta),
                        static_cast<float*>(dk), static_cast<float*>(dv), S, Sk, H, KV, w.q, w.k,
                        w.v, w.dout, w.dk, w.dv, scale * kLog2e, scale, causal);
}

// Causal attention masks by the sequence index, which needs keys of q's own length.
bool bad_args(int dtype, int D, int B, int H, int KV, int S, int Sk, int causal) {
  return (dtype != 0 && dtype != 1) || (D != 64 && D != 128) || B <= 0 || H <= 0 || KV <= 0 ||
         S <= 0 || Sk <= 0 || (causal && Sk != S) || H % KV != 0 || B > 65535 || H > 65535;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q is [B,H,S,D], k and v [B,KV,Sk,D]
// and o [B,H,S,D], views given by their (b, h, s) strides in elements; the
// last dimension is contiguous and every row starts 16-byte aligned.  Sk is
// the keys' own length (B11: cross-attention); causal needs Sk == S.  lse
// is null, or [B,H,S] f32 contiguous to receive each row's log-sum-exp.
// grid and smem are the launch plan of flash_attention.py::launch_plan;
// a plan that does not match the template returns
// cudaErrorInvalidConfiguration.  Returns cudaGetLastError() after the launch.
extern "C" int flash_attention_fwd(int dtype, int D, const void* q, const void* k, const void* v,
                                   void* o, void* lse, int B, int H, int KV, int S, int Sk,
                                   int64_t q_sb, int64_t q_sh, int64_t q_ss,
                                   int64_t k_sb, int64_t k_sh, int64_t k_ss,
                                   int64_t v_sb, int64_t v_sh, int64_t v_ss,
                                   int64_t o_sb, int64_t o_sh, int64_t o_ss,
                                   float scale, int causal, int grid_x, int grid_y, int grid_z,
                                   int64_t smem, void* stream) {
  // keys of their own length go to flash_attention_cross_fwd (bf16) or its f32 route
  if (bad_args(dtype, D, B, H, KV, S, Sk, causal) || (dtype == 1 && Sk != S))
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss}, vs{v_sb, v_sh, v_ss},
      os{o_sb, o_sh, o_ss};
  const dim3 grid(grid_x, grid_y, grid_z);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f = D == 64 ? fwd<64> : fwd<128>;
  return static_cast<int>(f(dtype, q, k, v, o, lse, B, H, KV, S, Sk, qs, ks, vs, os, scale, causal,
                            grid, smem, s));
}

// B11's forward: non-causal attention of q [B,H,S,D] over k and v
// [B,KV,Sk,D] of their own length, views and lse as flash_attention_fwd
// takes them.  block_q, splits, chunk, grid and smem are the plan of
// flash_attention.py::cross_plan.  bf16: block_q 64 (one consumer
// warpgroup), grid (splits, row tiles x H, B) in clusters of
// splits <= 8 blocks, each taking chunk keys (whole key tiles of
// xa::key_tile(D), none empty).  f32: the FMA template, block_q 64, one split over all Sk keys,
// grid (row tiles, H, B).  Any other plan returns
// cudaErrorInvalidConfiguration.
extern "C" int flash_attention_cross_fwd(int dtype, int D, const void* q, const void* k,
                                         const void* v, void* o, void* lse, int B, int H, int KV,
                                         int S, int Sk, int64_t q_sb, int64_t q_sh, int64_t q_ss,
                                         int64_t k_sb, int64_t k_sh, int64_t k_ss,
                                         int64_t v_sb, int64_t v_sh, int64_t v_ss,
                                         int64_t o_sb, int64_t o_sh, int64_t o_ss, float scale,
                                         int block_q, int splits, int chunk, int grid_x,
                                         int grid_y, int grid_z, int64_t smem, void* stream) {
  if (bad_args(dtype, D, B, H, KV, S, Sk, 0)) return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss}, vs{v_sb, v_sh, v_ss},
      os{o_sb, o_sh, o_ss};
  const dim3 grid(grid_x, grid_y, grid_z);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (block_q != tf::BQ || splits != 1 || chunk < Sk)
      return static_cast<int>(cudaErrorInvalidConfiguration);
    auto f = D == 64 ? fwd<64> : fwd<128>;
    return static_cast<int>(f(dtype, q, k, v, o, lse, B, H, KV, S, Sk, qs, ks, vs, os, scale, 0,
                              grid, smem, st));
  }
  const int bk = xa::key_tile(D);
  if (block_q != xa::BQ || splits < 1 || splits > 8 || grid_x != splits ||
      chunk < bk || chunk % bk != 0 || static_cast<int64_t>(chunk) * (splits - 1) >= Sk ||
      static_cast<int64_t>(chunk) * splits < Sk)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  auto f = D == 64 ? cross_bf16<64> : cross_bf16<128>;
  return static_cast<int>(f(q, k, v, o, static_cast<float*>(lse), B, H, KV, S, Sk, qs, ks, vs, os,
                            scale, chunk, grid, smem, st));
}

// Backward, first kernel: dq, and into delta ([2,B,H,stats_row(S)] f32)
// D = rowsum(dout o) and (bf16 only) lse log2(e) for the second kernel.
// Keys of their own length (Sk != S) in bf16 are flash_attention_cross_bwd's.
// strides: 24 int64, the (b, h, s) strides of q, k, v, o, dout, dq, dk, dv;
// lse from the forward; dq laid out by its strides; grid and smem from
// flash_attention.py::bwd_plans.
extern "C" int flash_attention_bwd_dq(int dtype, int D, const void* q, const void* k,
                                      const void* v, const void* o, const void* dout,
                                      const void* lse, void* delta, void* dq, int B, int H,
                                      int KV, int S, int Sk, const int64_t* strides, float scale,
                                      int causal, int grid_x, int grid_y, int grid_z,
                                      int64_t smem, void* stream) {
  if (bad_args(dtype, D, B, H, KV, S, Sk, causal) || (dtype == 1 && Sk != S))
    return static_cast<int>(cudaErrorInvalidValue);
  auto f = D == 64 ? bwd_dq<64> : bwd_dq<128>;
  return static_cast<int>(f(dtype, q, k, v, o, dout, lse, delta, dq, B, H, KV, S, Sk,
                            views_from(strides), scale, causal, dim3(grid_x, grid_y, grid_z),
                            smem, static_cast<cudaStream_t>(stream)));
}

// Backward, second kernel (after flash_attention_bwd_dq on the same
// stream, whose delta it reads): dk and dv, a block per key tile of Sk.
extern "C" int flash_attention_bwd_dkdv(int dtype, int D, const void* q, const void* k,
                                        const void* v, const void* dout, const void* lse,
                                        const void* delta, void* dk, void* dv, int B, int H,
                                        int KV, int S, int Sk, const int64_t* strides, float scale,
                                        int causal, int grid_x, int grid_y, int grid_z,
                                        int64_t smem, void* stream) {
  if (bad_args(dtype, D, B, H, KV, S, Sk, causal) || (dtype == 1 && Sk != S))
    return static_cast<int>(cudaErrorInvalidValue);
  auto f = D == 64 ? bwd_dkdv<64> : bwd_dkdv<128>;
  return static_cast<int>(f(dtype, q, k, v, dout, lse, delta, dk, dv, B, H, KV, S, Sk,
                            views_from(strides), scale, causal, dim3(grid_x, grid_y, grid_z),
                            smem, static_cast<cudaStream_t>(stream)));
}

// B11's bf16 backward, first launch: D = rowsum(dout o) and lse log2(e) of
// each row of o and dout [B,H,S,D] (by their (b, h, s) strides) into stats
// [2,B,H,stats_row(S)] f32; lse [B,H,S] f32 from the forward.  It also
// zeroes n_counters ints at counters (the second launch's).  blocks is
// flash_attention.py::cross_bwd_plan's stats_blocks; any other count
// returns cudaErrorInvalidConfiguration.
extern "C" int flash_attention_cross_bwd_stats(int D, const void* o, const void* dout,
                                               const void* lse, void* stats, void* counters,
                                               int n_counters, int B, int H, int S,
                                               int64_t o_sb, int64_t o_sh, int64_t o_ss,
                                               int64_t d_sb, int64_t d_sh, int64_t d_ss,
                                               int blocks, void* stream) {
  if ((D != 64 && D != 128) || B <= 0 || H <= 0 || S <= 0) return static_cast<int>(cudaErrorInvalidValue);
  auto f = D == 64 ? cross_bwd_stats_bf16<64> : cross_bwd_stats_bf16<128>;
  return static_cast<int>(f(o, dout, lse, stats, counters, n_counters, B, H, S,
                            Strides{o_sb, o_sh, o_ss}, Strides{d_sb, d_sh, d_ss}, blocks,
                            static_cast<cudaStream_t>(stream)));
}

// Second launch (after the first on the same stream, whose stats and
// counters it reads): dq, dk and dv of non-causal bf16 attention of q
// [B,H,S,D] over k, v [B,KV,Sk,D] in one pass.  strides: 24 int64 as
// flash_attention_bwd_dq takes them (its o slot unused).  scratch: null, or
// the [splits,B,KV,rows,D] f32 dQ partials; counters: null, or the
// [B,KV,splits] ints the first launch zeroed.  rows, in_smem, grid and smem are
// flash_attention.py::cross_bwd_plan's: 128-key blocks at d = 64 (two
// consumer warpgroups), 64 at d = 128 (one); any other plan returns
// cudaErrorInvalidConfiguration.
extern "C" int flash_attention_cross_bwd(int D, const void* q, const void* k, const void* v,
                                         const void* dout, const void* stats, void* dq, void* dk,
                                         void* dv, void* scratch, void* counters, int B, int H,
                                         int KV, int S, int Sk, const int64_t* strides, float scale,
                                         int rows, int in_smem, int grid_x, int grid_y, int grid_z,
                                         int64_t smem, void* stream) {
  if (bad_args(1, D, B, H, KV, S, Sk, 0)) return static_cast<int>(cudaErrorInvalidValue);
  auto f = D == 64 ? cross_bwd_bf16<64, 2> : cross_bwd_bf16<128, 1>;
  return static_cast<int>(f(q, k, v, dout, stats, dq, dk, dv, scratch, counters, B, H, KV, S, Sk,
                            views_from(strides), scale, rows, in_smem, dim3(grid_x, grid_y, grid_z),
                            smem, static_cast<cudaStream_t>(stream)));
}

// B11's decode: q [B,H,1,D] by its (b, h) strides; k and v the FLAT caches
// [B, Sk, KV*D] by their (b, s) strides, the last dimension contiguous and
// rows 16-byte aligned; the first n keys count (1 <= n <= Sk).  o is
// [B, 1, H*D] contiguous.  rows, chunk and grid (splits, KV x row tiles, B)
// are flash_attention.py::decode_plan's; any other returns
// cudaErrorInvalidConfiguration.
extern "C" int flash_attention_decode(int dtype, int D, const void* q, const void* k,
                                      const void* v, void* o, int B, int H, int KV, int n,
                                      int64_t q_sb, int64_t q_sh, int64_t k_sb, int64_t k_ss,
                                      int64_t v_sb, int64_t v_ss, float scale, int rows,
                                      int chunk, int grid_x, int grid_y, int grid_z,
                                      void* stream) {
  if (bad_args(dtype, D, B, H, KV, 1, 1, 0) || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int g = H / KV;
  if (rows != dec::rows_for(g) || grid_y != KV * ((g + rows - 1) / rows) || grid_z != B ||
      grid_x < 1 || grid_x > 8 || chunk < 1 || static_cast<int64_t>(chunk) * grid_x < n ||
      static_cast<int64_t>(chunk) * (grid_x - 1) >= n)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(grid_x, grid_y, grid_z);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float sl = scale * kLog2e;
  if (dtype == 1)
    return static_cast<int>((D == 64 ? dec::launch_rows<__nv_bfloat16, 64>
                                     : dec::launch_rows<__nv_bfloat16, 128>)(
        rows, q, k, v, o, H, KV, n, chunk, q_sb, q_sh, k_sb, k_ss, v_sb, v_ss, sl, grid, st));
  return static_cast<int>((D == 64 ? dec::launch_rows<float, 64> : dec::launch_rows<float, 128>)(
      rows, q, k, v, o, H, KV, n, chunk, q_sb, q_sh, k_sb, k_ss, v_sb, v_ss, sl, grid, st));
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
