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
// f32: CUDA-core FMAs.  Its limit of 2e-5 cannot be met with bf16 or TF32
// tensor cores.  Grid (row tiles, H, B); 128 threads =
// 4 warps; each warp owns 16 query rows of the block's 64.  The block
// stages Q once and then one 32-key tile of K and V at a time in shared
// memory.  In Q K^T each lane owns one key of the tile and all 16 rows of
// its warp (Q rows are broadcast reads); in P V each lane owns D/32
// output columns and reads P from the warp's slice of shared memory.  The
// online softmax keeps (m, l, acc) in f32 registers, step for step as the
// TPU kernel: m' = max(m, rowmax), alpha = exp(m - m'), p = exp(s - m'),
// l' = l*alpha + sum(p), acc' = acc*alpha + p V, out = acc / max(l, 1e-30).
// P stays f32, as in the TPU kernel.
//
// Both: strides are arguments, so the model's q [B,S,H,d] and k/v
// [B,S,KV,d] are read in place, with only the last dimension required to
// be contiguous and rows 16-byte aligned.  Ragged S is masked (keys >= S
// get no weight, rows >= S are not stored), so S is unrestricted.  With a
// non-null lse pointer the forward also writes each row's log-sum-exp of
// the scaled scores (natural log, f32, [B,H,S]) for the backward; serving
// passes null, which selects the instantiation without it (kLse = false),
// so serving runs the code it ran before.
//
// Backward (no TPU counterpart: the JAX package differentiates plain XLA
// attention).  With P = exp(scale q k^T - lse) recomputed from the saved
// lse and D = rowsum(dO o): dV = P^T dO, dS = P (dO V^T - D),
// dQ = scale dS K, dK = scale dS^T Q.  Two kernels, no atomics, so the
// results do not depend on the order blocks run in:
//   dq:   one block per (query head, 64-row tile); it first writes D for
//         its rows (read from o and dO), then walks the key tiles up to
//         the diagonal, as the forward does;
//   dkdv: one block per (KV head, 64-key tile); it walks every query tile
//         at or after the diagonal of each of the KV head's g query heads,
//         reading the lse and the D the dq kernel wrote (it runs second on
//         the same stream).
// bf16 runs all four products per tile (Q K^T, dO V^T, then dS K or
// P^T dO and dS^T Q) on mma.sync m16n8k16 with f32 accumulators, in the
// forward's fragment layouts: score accumulators become bf16 A fragments
// in registers, the streamed tiles (K/V in dq, Q/dO in dkdv) are
// double-buffered by cp.async.  P and dS are rounded to bf16 before their
// products, as the reference's bf16 einsums round their operands.  f32
// keeps FMAs with one key (dq) or one query (dkdv) per lane, as the f32
// forward does.  Bound: at the training shapes (S 160-256, d 64) the
// bytes of q, k, v, o, dO and the three gradients; at long S the
// ~2.5x forward operations.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Strides {
  int64_t b, h, s;  // in elements; the head dim is contiguous
};

constexpr int kThreads = 128;  // both templates: 4 warps
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

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

// grid (H, row tiles, B); kLse: write the rows' log-sum-exp (training)
template <int D, bool kLse>
__global__ void __launch_bounds__(kThreads)
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

// 4-byte cp.async for the per-row statistics (lse, D); bytes = 0 zero-fills.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(bytes));
}

// acc[n] += A B over one 16-row warp slice and a 64-deep k range held as
// score accumulators s[8][4] (rounded to bf16 A fragments here), with B read
// from a padded tile by ldmatrix.trans: B[k][n] = tile[k][n] (V, dO, Q or K
// as the right-hand operand of P V, P^T dO, dS^T Q or dS K).
template <int D>
__device__ __forceinline__ void acc_scores_times_tile(float (&acc)[D / 8][4],
                                                      const float (&s)[8][4], const bf16* tile,
                                                      int ar, int ac) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t pa[4];
    pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
    pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
    pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
    for (int dn = 0; dn < D / 16; ++dn) {
      uint32_t vb[4];
      ldmatrix_x4_trans(vb, tile + (kk * 16 + ar) * Layout<D>::kRow + dn * 16 + ac);
      mma_bf16(acc[2 * dn], pa, vb[0], vb[1]);
      mma_bf16(acc[2 * dn + 1], pa, vb[2], vb[3]);
    }
  }
}

// s += A B^T over k-step kk for a warp's 16 rows (A fragment fa) against a
// tile's 64 rows, whose B fragments come by ldmatrix (K in Q K^T, V in
// dO V^T, Q in K Q^T, dO in V dO^T).
template <int D>
__device__ __forceinline__ void mma_rows_tile(float (&s)[8][4], const uint32_t (&fa)[4],
                                              const bf16* tile, int kk, int kr, int kc) {
#pragma unroll
  for (int nj = 0; nj < 4; ++nj) {
    uint32_t kb[4];
    ldmatrix_x4(kb, tile + (nj * 16 + kr) * Layout<D>::kRow + kk * 16 + kc);
    mma_bf16(s[2 * nj], fa, kb[0], kb[1]);
    mma_bf16(s[2 * nj + 1], fa, kb[2], kb[3]);
  }
}

__device__ __forceinline__ void zero(float (&s)[8][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
}

// s = A B^T with the warp's A fragments held in registers.
template <int D>
__device__ __forceinline__ void scores_reg(float (&s)[8][4], const uint32_t (&af)[D / 16][4],
                                           const bf16* tile, int kr, int kc) {
  zero(s);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) mma_rows_tile<D>(s, af[kk], tile, kk, kr, kc);
}

// s = A B^T with A = the warp's 16 rows of the shared tile a.
template <int D>
__device__ __forceinline__ void scores_smem(float (&s)[8][4], const bf16* a, const bf16* tile,
                                            int ar, int ac, int kr, int kc) {
  zero(s);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t fa[4];
    ldmatrix_x4(fa, a + ar * Layout<D>::kRow + kk * 16 + ac);
    mma_rows_tile<D>(s, fa, tile, kk, kr, kc);
  }
}

// Store a warp's 16 accumulator rows (times mul) as bf16 rows row0.. of a
// [.., D] tensor, staged through the warp's rows of a padded shared tile.
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 8][4], float mul, bf16* stage,
                                           bf16* dst, int64_t s_stride, int row0, int S,
                                           int lane) {
  using L = Layout<D>;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(stage + (g + 8 * half) * L::kRow + 8 * n + 2 * t) =
          pack_bf16(acc[n][2 * half] * mul, acc[n][2 * half + 1] * mul);
  __syncwarp();
  constexpr int kChunks = D / 8;
#pragma unroll
  for (int i = lane; i < 16 * kChunks; i += 32) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    if (row0 + r < S)
      *reinterpret_cast<uint4*>(dst + static_cast<int64_t>(row0 + r) * s_stride + c) =
          *reinterpret_cast<const uint4*>(stage + r * L::kRow + c);
  }
}

// dQ and D.  grid (H, row tiles, B), row tiles last-first as the forward.
// Shared: Q, dO, then K and V double-buffered (six padded tiles).
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ o,
                  const bf16* __restrict__ dout, const float* __restrict__ lse,
                  float* __restrict__ delta, bf16* __restrict__ dq, int S, int H, int KV,
                  Strides qs, Strides ks, Strides vs, Strides os, Strides dos, Strides dqs,
                  float scale_log2, float scale, int causal) {
  using L = Layout<D>;
  constexpr int KD = D / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dOs = Qs + L::kTile;
  bf16* Ks = dOs + L::kTile;     // [2][64][kRow]
  bf16* Vs = Ks + 2 * L::kTile;  // [2][64][kRow]
  __shared__ float Ds[BQ];

  const int h = blockIdx.x, b = blockIdx.z;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int kvh = h / (H / KV);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ar = (lane & 7) + ((lane >> 3) & 1) * 8, ac = (lane >> 4) * 8;
  const int kr = (lane & 7) + (lane >> 4) * 8, kc = ((lane >> 3) & 1) * 8;

  const bf16* kh = k + b * ks.b + kvh * ks.h;
  const bf16* vh = v + b * vs.b + kvh * vs.h;
  const bf16* doh = dout + b * dos.b + h * dos.h;
  const int k_end = causal ? min(S, q0 + BQ) : S;
  const int n_tiles = (k_end + BK - 1) / BK;

  load_tile<D>(Qs, q + b * qs.b + h * qs.h, qs.s, q0, S);
  load_tile<D>(dOs, doh, dos.s, q0, S);
  load_tile<D>(Ks, kh, ks.s, 0, S);
  load_tile<D>(Vs, vh, vs.s, 0, S);
  cp_async_commit();

  // D = rowsum(dO o) of the warp's 16 rows, straight from device memory
  const int64_t stat = (static_cast<int64_t>(b) * H + h) * S;
  const bf16* oh = o + b * os.b + h * os.h;
  for (int r = 0; r < 16; ++r) {
    const int row = q0 + warp * 16 + r;
    float sum = 0.f;
    if (row < S) {
      for (int c = 2 * lane; c < D; c += 64) {
        const float2 a = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(oh + static_cast<int64_t>(row) * os.s + c));
        const float2 d2 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(doh + static_cast<int64_t>(row) * dos.s + c));
        sum = fmaf(a.x, d2.x, fmaf(a.y, d2.y, sum));
      }
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      Ds[warp * 16 + r] = sum;
      if (row < S) delta[stat + row] = sum;
    }
  }
  __syncwarp();
  const int row_lo = q0 + warp * 16 + g;
  float lse2[2], dd[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row_lo + 8 * half;
    lse2[half] = row < S ? lse[stat + row] * kLog2e : 0.f;
    dd[half] = Ds[warp * 16 + g + 8 * half];
  }

  uint32_t qf[KD][4], df[KD][4];
  float acc[2 * KD][4];
#pragma unroll
  for (int n = 0; n < 2 * KD; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_tiles) {
      load_tile<D>(Ks + (buf ^ 1) * L::kTile, kh, ks.s, (it + 1) * BK, S);
      load_tile<D>(Vs + (buf ^ 1) * L::kTile, vh, vs.s, (it + 1) * BK, S);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        ldmatrix_x4(qf[kk], Qs + (warp * 16 + ar) * L::kRow + kk * 16 + ac);
        ldmatrix_x4(df[kk], dOs + (warp * 16 + ar) * L::kRow + kk * 16 + ac);
      }
    }
    const bf16* Kt = Ks + buf * L::kTile;
    const bf16* Vt = Vs + buf * L::kTile;
    const int k0 = it * BK;

    float s[8][4], dp[8][4];
    scores_reg<D>(s, qf, Kt, kr, kc);   // Q K^T
    scores_reg<D>(dp, df, Vt, kr, kc);  // dO V^T
    const bool masked = k0 + BK > S || (causal && k0 + BK - 1 > q0);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(s[n][e] * scale_log2 - lse2[e >> 1]);
        if (masked) {
          const int key = k0 + 8 * n + 2 * t + (e & 1);
          if (key >= S || (causal && key > row_lo + 8 * (e >> 1))) p = 0.f;
        }
        s[n][e] = p * (dp[n][e] - dd[e >> 1]);  // dS
      }
    acc_scores_times_tile<D>(acc, s, Kt, ar, ac);  // dQ += dS K
    __syncthreads();
  }
  store_rows<D>(acc, scale, Qs + warp * 16 * L::kRow, dq + b * dqs.b + h * dqs.h, dqs.s,
                q0 + warp * 16, S, lane);
}

// dK, dV.  grid (key tiles, KV, B).  Shared: K, V, then Q and dO
// double-buffered (six padded tiles), and each stage's lse and D rows.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int H, int KV,
                    Strides qs, Strides ks, Strides vs, Strides dos, Strides dks, Strides dvs,
                    float scale_log2, float scale, int causal) {
  using L = Layout<D>;
  constexpr int KD = D / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + L::kTile;
  bf16* Qs = Vs + L::kTile;       // [2][64][kRow]
  bf16* dOs = Qs + 2 * L::kTile;  // [2][64][kRow]
  float* Ls = reinterpret_cast<float*>(dOs + 2 * L::kTile);  // [2][64] lse
  float* Dl = Ls + 2 * BQ;                                    // [2][64] D

  const int k0 = blockIdx.x * BK, kvh = blockIdx.y, b = blockIdx.z;
  const int g_heads = H / KV;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ar = (lane & 7) + ((lane >> 3) & 1) * 8, ac = (lane >> 4) * 8;
  const int kr = (lane & 7) + (lane >> 4) * 8, kc = ((lane >> 3) & 1) * 8;
  // causal: query tiles before the key tile see none of its keys
  const int qt0 = causal ? blockIdx.x : 0;
  const int per_head = (S + BQ - 1) / BQ - qt0;
  const int n_it = g_heads * per_head;

  auto load_stage = [&](int it, int buf) {
    const int h = kvh * g_heads + it / per_head, row0 = (qt0 + it % per_head) * BQ;
    load_tile<D>(Qs + buf * L::kTile, q + b * qs.b + h * qs.h, qs.s, row0, S);
    load_tile<D>(dOs + buf * L::kTile, dout + b * dos.b + h * dos.h, dos.s, row0, S);
    const int64_t stat = (static_cast<int64_t>(b) * H + h) * S;
    if (threadIdx.x < BQ) {
      const int row = row0 + threadIdx.x;
      const int64_t at = stat + (row < S ? row : 0);
      cp_async4(Ls + buf * BQ + threadIdx.x, lse + at, row < S ? 4 : 0);
      cp_async4(Dl + buf * BQ + threadIdx.x, delta + at, row < S ? 4 : 0);
    }
  };
  load_tile<D>(Ks, k + b * ks.b + kvh * ks.h, ks.s, k0, S);
  load_tile<D>(Vs, v + b * vs.b + kvh * vs.h, vs.s, k0, S);
  load_stage(0, 0);
  cp_async_commit();

  float dka[2 * KD][4], dva[2 * KD][4];
#pragma unroll
  for (int n = 0; n < 2 * KD; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;
  const int key_lo = k0 + warp * 16 + g;  // this thread's first key

  for (int it = 0; it < n_it; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_it) load_stage(it + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int q0 = (qt0 + it % per_head) * BQ;
    const bf16* Qt = Qs + buf * L::kTile;
    const bf16* dOt = dOs + buf * L::kTile;
    const float* Lt = Ls + buf * BQ;
    const float* Dt = Dl + buf * BQ;

    // P^T: element e of tile n is key key_lo + 8*(e/2), query q0 + 8n + 2t + e%2
    float s[8][4];
    scores_smem<D>(s, Ks + warp * 16 * L::kRow, Qt, ar, ac, kr, kc);  // K Q^T
    const bool masked = q0 + BQ > S || (causal && q0 < k0 + BK - 1);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = 8 * n + 2 * t + (e & 1);
        float p = exp2f(s[n][e] * scale_log2 - Lt[ql] * kLog2e);
        if (masked && (q0 + ql >= S || (causal && q0 + ql < key_lo + 8 * (e >> 1)))) p = 0.f;
        s[n][e] = p;
      }
    acc_scores_times_tile<D>(dva, s, dOt, ar, ac);  // dV += P^T dO
    float dp[8][4];
    scores_smem<D>(dp, Vs + warp * 16 * L::kRow, dOt, ar, ac, kr, kc);  // V dO^T
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] *= dp[n][e] - Dt[8 * n + 2 * t + (e & 1)];  // dS^T
    acc_scores_times_tile<D>(dka, s, Qt, ar, ac);  // dK += dS^T Q
    __syncthreads();
  }
  store_rows<D>(dka, scale, Ks + warp * 16 * L::kRow, dk + b * dks.b + kvh * dks.h, dks.s,
                k0 + warp * 16, S, lane);
  store_rows<D>(dva, 1.f, Vs + warp * 16 * L::kRow, dv + b * dvs.b + kvh * dvs.h, dvs.s,
                k0 + warp * 16, S, lane);
}

}  // namespace tc

// ----------------------------------------------------------------- f32 --

namespace cc {

constexpr int BQ = 64;             // query rows per block
constexpr int BK = 32;             // keys per tile: one per lane
constexpr int kRows = BQ / (kThreads / 32);  // query rows per warp
constexpr float kNegInf = -1e30f;  // the TPU kernel's mask value

template <int D>
struct Smem {
  static constexpr int kQ = D + 4;   // Q row stride: rows 16-byte aligned for float4 broadcasts
  static constexpr int kK = D + 1;   // K row stride: lane j, column c -> bank (j + c) % 32
  static constexpr int kP = BK + 4;  // P row stride: rows 16-byte aligned
  static constexpr size_t bytes = sizeof(float) * (BQ * kQ + BK * kK + BK * D + BQ * kP);
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
// Rows [row0, row0 + nrows) of one head into shared memory, 16 bytes per
// thread and load; rows at or past S are zero.
template <int D>
__device__ __forceinline__ void load_tile(const float* base, int64_t s_stride, int row0,
                                          int nrows, int S, float* dst, int dst_stride) {
  constexpr int kPerRow = D / 4;
  for (int i = threadIdx.x; i < nrows * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * 4;
    float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < S) f = *reinterpret_cast<const float4*>(base + (row0 + r) * s_stride + c);
    float* d = dst + r * dst_stride + c;
    d[0] = f.x; d[1] = f.y; d[2] = f.z; d[3] = f.w;
  }
}

// grid (row tiles, H, B); kLse: write the rows' log-sum-exp (training)
template <int D, bool kLse>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse, int S,
              int H, int KV, Strides qs, Strides ks, Strides vs, Strides os, float scale,
              int causal) {
  using L = Smem<D>;
  constexpr int DL = D / 32;  // output columns per lane
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * L::kQ;
  float* Vs = Ks + BK * L::kK;
  float* Ps = Vs + BK * D;

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row_base = warp * kRows;  // this warp's first row within the tile
  const int warp_last_q = q0 + row_base + kRows - 1;
  float* Pw = Ps + row_base * L::kP;

  const float* kh = k + b * ks.b + kvh * ks.h;
  const float* vh = v + b * vs.b + kvh * vs.h;
  load_tile<D>(q + b * qs.b + h * qs.h, qs.s, q0, BQ, S, Qs, L::kQ);

  float m[kRows], l[kRows], acc[kRows][DL];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int t = 0; t < DL; ++t) acc[r][t] = 0.f;
  }

  // causal: key tiles wholly after the block's last row contribute nothing
  const int k_end = causal ? min(S, q0 + BQ) : S;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<D>(kh, ks.s, k0, BK, S, Ks, L::kK);
    load_tile<D>(vh, vs.s, k0, BK, S, Vs, D);
    __syncthreads();
    if (causal && k0 > warp_last_q) continue;  // masked for all of this warp's rows

    // scores of this lane's key against the warp's rows
    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
    const float* kr = Ks + lane * L::kK;
    for (int c = 0; c < D; c += 4) {
      const float k_0 = kr[c], k_1 = kr[c + 1], k_2 = kr[c + 2], k_3 = kr[c + 3];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(Qs + (row_base + r) * L::kQ + c);
        s[r] = fmaf(qv.x, k_0, s[r]);
        s[r] = fmaf(qv.y, k_1, s[r]);
        s[r] = fmaf(qv.z, k_2, s[r]);
        s[r] = fmaf(qv.w, k_3, s[r]);
      }
    }

    // online softmax, one row at a time across the warp
    const int key = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qpos = q0 + row_base + r;
      const bool valid = key < S && (!causal || key <= qpos);
      const float sc = valid ? s[r] * scale : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(sc));
      const float alpha = expf(m[r] - m_new);
      const float p = expf(sc - m_new);
      l[r] = l[r] * alpha + warp_sum(p);
      m[r] = m_new;
#pragma unroll
      for (int t = 0; t < DL; ++t) acc[r][t] *= alpha;
      Pw[r * L::kP + lane] = p;
    }
    __syncwarp();

    // acc += P V, this lane's columns lane + 32 t
    for (int j = 0; j < BK; j += 4) {
      float vv[4][DL];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int t = 0; t < DL; ++t) vv[jj][t] = Vs[(j + jj) * D + lane + 32 * t];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 pv = *reinterpret_cast<const float4*>(Pw + r * L::kP + j);
#pragma unroll
        for (int t = 0; t < DL; ++t) {
          acc[r][t] = fmaf(pv.x, vv[0][t], acc[r][t]);
          acc[r][t] = fmaf(pv.y, vv[1][t], acc[r][t]);
          acc[r][t] = fmaf(pv.z, vv[2][t], acc[r][t]);
          acc[r][t] = fmaf(pv.w, vv[3][t], acc[r][t]);
        }
      }
    }
    __syncwarp();  // P is rewritten by the next tile
  }

  float* oh = o + b * os.b + h * os.h;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qpos = q0 + row_base + r;
    if (qpos < S) {
      const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
      for (int t = 0; t < DL; ++t) oh[qpos * os.s + lane + 32 * t] = acc[r][t] / denom;
      if (kLse && lane == 0)
        lse[(static_cast<int64_t>(b) * H + h) * S + qpos] = m[r] + logf(l[r]);
    }
  }
}


// dQ and D.  grid (H, row tiles, B), row tiles last-first.  Each warp owns
// 16 query rows; each lane one key of the 32-key tile.  Shared: Q and dO
// (rows D+4: float4 broadcasts), K and V (rows D+1: lane j, column c on
// bank (j + c) % 32), dS (rows 36).
template <int D>
struct BwdDq {
  static constexpr int kQ = D + 4, kK = D + 1, kP = BK + 4;
  static constexpr size_t bytes = sizeof(float) * (2 * BQ * kQ + 2 * BK * kK + BQ * kP);
};

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ o,
                 const float* __restrict__ dout, const float* __restrict__ lse,
                 float* __restrict__ delta, float* __restrict__ dq, int S, int H, int KV,
                 Strides qs, Strides ks, Strides vs, Strides os, Strides dos, Strides dqs,
                 float scale, int causal) {
  using L = BwdDq<D>;
  constexpr int DL = D / 32;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* dOs = Qs + BQ * L::kQ;
  float* Ks = dOs + BQ * L::kQ;
  float* Vs = Ks + BK * L::kK;
  float* Ps = Vs + BK * L::kK;

  const int h = blockIdx.x, b = blockIdx.z;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int kvh = h / (H / KV);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row_base = warp * kRows;
  const int warp_last_q = q0 + row_base + kRows - 1;
  float* Pw = Ps + row_base * L::kP;

  const float* kh = k + b * ks.b + kvh * ks.h;
  const float* vh = v + b * vs.b + kvh * vs.h;
  load_tile<D>(q + b * qs.b + h * qs.h, qs.s, q0, BQ, S, Qs, L::kQ);
  load_tile<D>(dout + b * dos.b + h * dos.h, dos.s, q0, BQ, S, dOs, L::kQ);
  __syncthreads();

  const int64_t stat = (static_cast<int64_t>(b) * H + h) * S;
  const float* oh = o + b * os.b + h * os.h;
  float lse_r[kRows], d_r[kRows], acc[kRows][DL];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qpos = q0 + row_base + r;
    float sum = 0.f;
    if (qpos < S)
      for (int c = lane; c < D; c += 32)
        sum = fmaf(dOs[(row_base + r) * L::kQ + c], oh[static_cast<int64_t>(qpos) * os.s + c], sum);
    d_r[r] = warp_sum(sum);
    lse_r[r] = qpos < S ? lse[stat + qpos] : 0.f;
    if (lane == 0 && qpos < S) delta[stat + qpos] = d_r[r];
#pragma unroll
    for (int t = 0; t < DL; ++t) acc[r][t] = 0.f;
  }

  const int k_end = causal ? min(S, q0 + BQ) : S;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();
    load_tile<D>(kh, ks.s, k0, BK, S, Ks, L::kK);
    load_tile<D>(vh, vs.s, k0, BK, S, Vs, L::kK);
    __syncthreads();
    if (causal && k0 > warp_last_q) continue;

    float s[kRows], dp[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = dp[r] = 0.f;
    const float* kr = Ks + lane * L::kK;
    const float* vr = Vs + lane * L::kK;
    for (int c = 0; c < D; c += 4) {
      const float k_0 = kr[c], k_1 = kr[c + 1], k_2 = kr[c + 2], k_3 = kr[c + 3];
      const float v_0 = vr[c], v_1 = vr[c + 1], v_2 = vr[c + 2], v_3 = vr[c + 3];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(Qs + (row_base + r) * L::kQ + c);
        const float4 ov = *reinterpret_cast<const float4*>(dOs + (row_base + r) * L::kQ + c);
        s[r] = fmaf(qv.x, k_0, fmaf(qv.y, k_1, fmaf(qv.z, k_2, fmaf(qv.w, k_3, s[r]))));
        dp[r] = fmaf(ov.x, v_0, fmaf(ov.y, v_1, fmaf(ov.z, v_2, fmaf(ov.w, v_3, dp[r]))));
      }
    }
    const int key = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qpos = q0 + row_base + r;
      const bool valid = key < S && (!causal || key <= qpos);
      const float p = valid ? expf(s[r] * scale - lse_r[r]) : 0.f;
      Pw[r * L::kP + lane] = p * (dp[r] - d_r[r]);  // dS
    }
    __syncwarp();

    // acc += dS K, this lane's columns lane + 32 t
    for (int j = 0; j < BK; j += 4) {
      float kk[4][DL];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int t = 0; t < DL; ++t) kk[jj][t] = Ks[(j + jj) * L::kK + lane + 32 * t];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 pv = *reinterpret_cast<const float4*>(Pw + r * L::kP + j);
#pragma unroll
        for (int t = 0; t < DL; ++t)
          acc[r][t] = fmaf(pv.x, kk[0][t], fmaf(pv.y, kk[1][t],
                      fmaf(pv.z, kk[2][t], fmaf(pv.w, kk[3][t], acc[r][t]))));
      }
    }
    __syncwarp();
  }

  float* qh = dq + b * dqs.b + h * dqs.h;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qpos = q0 + row_base + r;
    if (qpos < S)
#pragma unroll
      for (int t = 0; t < DL; ++t)
        qh[static_cast<int64_t>(qpos) * dqs.s + lane + 32 * t] = acc[r][t] * scale;
  }
}

// dK, dV.  grid (64-key tiles, KV, B).  Each warp owns 16 keys; each lane
// one query of the 32-row tile.  Shared: K and V (rows D+4), Q and dO
// (rows D+1), P and dS (rows 36), the tile's lse and D.
template <int D>
struct BwdDkdv {
  static constexpr int kQ = D + 4, kK = D + 1, kP = BK + 4;
  static constexpr size_t bytes =
      sizeof(float) * (2 * BQ * kQ + 2 * BK * kK + 2 * BQ * kP + 2 * BK);
};

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_f32(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   float* __restrict__ dk, float* __restrict__ dv, int S, int H, int KV,
                   Strides qs, Strides ks, Strides vs, Strides dos, Strides dks, Strides dvs,
                   float scale, int causal) {
  using L = BwdDkdv<D>;
  constexpr int DL = D / 32;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + BQ * L::kQ;
  float* Qs = Vs + BQ * L::kQ;
  float* dOs = Qs + BK * L::kK;
  float* Ps = dOs + BK * L::kK;
  float* dSs = Ps + BQ * L::kP;
  float* Ls = dSs + BQ * L::kP;
  float* Dl = Ls + BK;

  const int k0 = blockIdx.x * BQ, kvh = blockIdx.y, b = blockIdx.z;
  const int g_heads = H / KV;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row_base = warp * kRows;
  const int warp_key0 = k0 + row_base;
  float* Pw = Ps + row_base * L::kP;
  float* dSw = dSs + row_base * L::kP;

  load_tile<D>(k + b * ks.b + kvh * ks.h, ks.s, k0, BQ, S, Ks, L::kQ);
  load_tile<D>(v + b * vs.b + kvh * vs.h, vs.s, k0, BQ, S, Vs, L::kQ);
  float dka[kRows][DL], dva[kRows][DL];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int t = 0; t < DL; ++t) dka[r][t] = dva[r][t] = 0.f;

  // causal: 32-row query tiles wholly before the key tile see none of it
  const int qt0 = causal ? k0 / BK : 0;
  const int per_head = (S + BK - 1) / BK - qt0;
  for (int it = 0; it < g_heads * per_head; ++it) {
    const int h = kvh * g_heads + it / per_head, q0 = (qt0 + it % per_head) * BK;
    const int64_t stat = (static_cast<int64_t>(b) * H + h) * S;
    __syncthreads();  // every warp is done with the previous tile
    load_tile<D>(q + b * qs.b + h * qs.h, qs.s, q0, BK, S, Qs, L::kK);
    load_tile<D>(dout + b * dos.b + h * dos.h, dos.s, q0, BK, S, dOs, L::kK);
    if (threadIdx.x < BK) {
      const int row = q0 + threadIdx.x;
      Ls[threadIdx.x] = row < S ? lse[stat + row] : 0.f;
      Dl[threadIdx.x] = row < S ? delta[stat + row] : 0.f;
    }
    __syncthreads();
    if (causal && q0 + BK - 1 < warp_key0) continue;  // no query of the tile sees these keys

    float s[kRows], dp[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = dp[r] = 0.f;
    const float* qr = Qs + lane * L::kK;
    const float* orow = dOs + lane * L::kK;
    for (int c = 0; c < D; c += 4) {
      const float q_0 = qr[c], q_1 = qr[c + 1], q_2 = qr[c + 2], q_3 = qr[c + 3];
      const float o_0 = orow[c], o_1 = orow[c + 1], o_2 = orow[c + 2], o_3 = orow[c + 3];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 kv = *reinterpret_cast<const float4*>(Ks + (row_base + r) * L::kQ + c);
        const float4 vv = *reinterpret_cast<const float4*>(Vs + (row_base + r) * L::kQ + c);
        s[r] = fmaf(kv.x, q_0, fmaf(kv.y, q_1, fmaf(kv.z, q_2, fmaf(kv.w, q_3, s[r]))));
        dp[r] = fmaf(vv.x, o_0, fmaf(vv.y, o_1, fmaf(vv.z, o_2, fmaf(vv.w, o_3, dp[r]))));
      }
    }
    const int query = q0 + lane;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const bool valid = query < S && (!causal || query >= warp_key0 + r);
      const float p = valid ? expf(s[r] * scale - Ls[lane]) : 0.f;
      Pw[r * L::kP + lane] = p;
      dSw[r * L::kP + lane] = p * (dp[r] - Dl[lane]);
    }
    __syncwarp();

    // dV += P^T dO and dK += dS^T Q, this lane's columns lane + 32 t
    for (int j = 0; j < BK; j += 4) {
      float oo[4][DL], qq[4][DL];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int t = 0; t < DL; ++t) {
          oo[jj][t] = dOs[(j + jj) * L::kK + lane + 32 * t];
          qq[jj][t] = Qs[(j + jj) * L::kK + lane + 32 * t];
        }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 pv = *reinterpret_cast<const float4*>(Pw + r * L::kP + j);
        const float4 sv = *reinterpret_cast<const float4*>(dSw + r * L::kP + j);
#pragma unroll
        for (int t = 0; t < DL; ++t) {
          dva[r][t] = fmaf(pv.x, oo[0][t], fmaf(pv.y, oo[1][t],
                      fmaf(pv.z, oo[2][t], fmaf(pv.w, oo[3][t], dva[r][t]))));
          dka[r][t] = fmaf(sv.x, qq[0][t], fmaf(sv.y, qq[1][t],
                      fmaf(sv.z, qq[2][t], fmaf(sv.w, qq[3][t], dka[r][t]))));
        }
      }
    }
    __syncwarp();
  }

  float* kd = dk + b * dks.b + kvh * dks.h;
  float* vd = dv + b * dvs.b + kvh * dvs.h;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int key = warp_key0 + r;
    if (key < S)
#pragma unroll
      for (int t = 0; t < DL; ++t) {
        kd[static_cast<int64_t>(key) * dks.s + lane + 32 * t] = dka[r][t] * scale;
        vd[static_cast<int64_t>(key) * dvs.s + lane + 32 * t] = dva[r][t];
      }
  }
}

}  // namespace cc

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
                int H, int KV, int S, Strides qs, Strides ks, Strides vs, Strides os, float scale,
                int causal, dim3 grid, int64_t smem, cudaStream_t st) {
  using tc::bf16;
  float* l = static_cast<float*>(lse);
  if (dtype == 1)
    return launch_checked(l ? tc::flash_fwd_bf16<D, true> : tc::flash_fwd_bf16<D, false>,
                          dim3(H, row_tiles(S), B), tc::Layout<D>::bytes,
                          grid, smem, st, static_cast<const bf16*>(q),
                          static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                          static_cast<bf16*>(o), l, S, H, KV, qs, ks, vs, os,
                          scale * kLog2e, causal);  // exp(x) = exp2(x log2 e)
  return launch_checked(l ? cc::flash_fwd_f32<D, true> : cc::flash_fwd_f32<D, false>,
                        dim3(row_tiles(S), H, B), cc::Smem<D>::bytes, grid,
                        smem, st, static_cast<const float*>(q), static_cast<const float*>(k),
                        static_cast<const float*>(v), static_cast<float*>(o), l, S, H, KV, qs, ks,
                        vs, os, scale, causal);
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

template <int D>
cudaError_t bwd_dq(int dtype, const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const void* lse, void* delta, void* dq, int B, int H,
                   int KV, int S, const Views& w, float scale, int causal, dim3 grid,
                   int64_t smem, cudaStream_t st) {
  using tc::bf16;
  const dim3 want(H, row_tiles(S), B);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (dtype == 1)
    return launch_checked(tc::flash_bwd_dq_bf16<D>, want, sizeof(bf16) * 6 * tc::Layout<D>::kTile,
                          grid, smem, st, static_cast<const bf16*>(q),
                          static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                          static_cast<const bf16*>(o), static_cast<const bf16*>(dout), l, dl,
                          static_cast<bf16*>(dq), S, H, KV, w.q, w.k, w.v, w.o, w.dout, w.dq,
                          scale * kLog2e, scale, causal);
  return launch_checked(cc::flash_bwd_dq_f32<D>, want, cc::BwdDq<D>::bytes, grid, smem, st,
                        static_cast<const float*>(q), static_cast<const float*>(k),
                        static_cast<const float*>(v), static_cast<const float*>(o),
                        static_cast<const float*>(dout), l, dl, static_cast<float*>(dq), S, H, KV,
                        w.q, w.k, w.v, w.o, w.dout, w.dq, scale, causal);
}

template <int D>
cudaError_t bwd_dkdv(int dtype, const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, void* dk, void* dv, int B, int H, int KV,
                     int S, const Views& w, float scale, int causal, dim3 grid, int64_t smem,
                     cudaStream_t st) {
  using tc::bf16;
  const dim3 want(row_tiles(S), KV, B);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (dtype == 1)
    return launch_checked(
        tc::flash_bwd_dkdv_bf16<D>, want,
        sizeof(bf16) * 6 * tc::Layout<D>::kTile + sizeof(float) * 4 * tc::BQ, grid, smem, st,
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(dout), l, dl, static_cast<bf16*>(dk), static_cast<bf16*>(dv), S,
        H, KV, w.q, w.k, w.v, w.dout, w.dk, w.dv, scale * kLog2e, scale, causal);
  return launch_checked(cc::flash_bwd_dkdv_f32<D>, want, cc::BwdDkdv<D>::bytes, grid, smem, st,
                        static_cast<const float*>(q), static_cast<const float*>(k),
                        static_cast<const float*>(v), static_cast<const float*>(dout), l, dl,
                        static_cast<float*>(dk), static_cast<float*>(dv), S, H, KV, w.q, w.k, w.v,
                        w.dout, w.dk, w.dv, scale, causal);
}

bool bad_args(int dtype, int D, int B, int H, int KV, int S) {
  return (dtype != 0 && dtype != 1) || (D != 64 && D != 128) || B <= 0 || H <= 0 || KV <= 0 ||
         S <= 0 || H % KV != 0 || B > 65535 || H > 65535;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q is [B,H,S,D] and k, v, o are
// [B,KV,S,D] / [B,H,S,D] views given by their (b, h, s) strides in elements;
// the last dimension is contiguous and every row starts 16-byte aligned.
// lse is null, or [B,H,S] f32 contiguous to receive each row's log-sum-exp.
// grid and smem are the launch plan of flash_attention.py::launch_plan;
// a plan that does not match the template returns
// cudaErrorInvalidConfiguration.  Returns cudaGetLastError() after the launch.
extern "C" int flash_attention_fwd(int dtype, int D, const void* q, const void* k, const void* v,
                                   void* o, void* lse, int B, int H, int KV, int S,
                                   int64_t q_sb, int64_t q_sh, int64_t q_ss,
                                   int64_t k_sb, int64_t k_sh, int64_t k_ss,
                                   int64_t v_sb, int64_t v_sh, int64_t v_ss,
                                   int64_t o_sb, int64_t o_sh, int64_t o_ss,
                                   float scale, int causal, int grid_x, int grid_y, int grid_z,
                                   int64_t smem, void* stream) {
  if (bad_args(dtype, D, B, H, KV, S)) return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss}, vs{v_sb, v_sh, v_ss},
      os{o_sb, o_sh, o_ss};
  const dim3 grid(grid_x, grid_y, grid_z);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f = D == 64 ? fwd<64> : fwd<128>;
  return static_cast<int>(f(dtype, q, k, v, o, lse, B, H, KV, S, qs, ks, vs, os, scale, causal,
                            grid, smem, s));
}

// Backward, first kernel: dq and delta = rowsum(dout o) ([B,H,S] f32).
// strides: 24 int64, the (b, h, s) strides of q, k, v, o, dout, dq, dk, dv;
// lse from the forward; dq laid out by its strides; grid and smem from
// flash_attention.py::bwd_plans.
extern "C" int flash_attention_bwd_dq(int dtype, int D, const void* q, const void* k,
                                      const void* v, const void* o, const void* dout,
                                      const void* lse, void* delta, void* dq, int B, int H,
                                      int KV, int S, const int64_t* strides, float scale,
                                      int causal, int grid_x, int grid_y, int grid_z,
                                      int64_t smem, void* stream) {
  if (bad_args(dtype, D, B, H, KV, S)) return static_cast<int>(cudaErrorInvalidValue);
  auto f = D == 64 ? bwd_dq<64> : bwd_dq<128>;
  return static_cast<int>(f(dtype, q, k, v, o, dout, lse, delta, dq, B, H, KV, S,
                            views_from(strides), scale, causal, dim3(grid_x, grid_y, grid_z),
                            smem, static_cast<cudaStream_t>(stream)));
}

// Backward, second kernel (after flash_attention_bwd_dq on the same
// stream, whose delta it reads): dk and dv.
extern "C" int flash_attention_bwd_dkdv(int dtype, int D, const void* q, const void* k,
                                        const void* v, const void* dout, const void* lse,
                                        const void* delta, void* dk, void* dv, int B, int H,
                                        int KV, int S, const int64_t* strides, float scale,
                                        int causal, int grid_x, int grid_y, int grid_z,
                                        int64_t smem, void* stream) {
  if (bad_args(dtype, D, B, H, KV, S)) return static_cast<int>(cudaErrorInvalidValue);
  auto f = D == 64 ? bwd_dkdv<64> : bwd_dkdv<128>;
  return static_cast<int>(f(dtype, q, k, v, dout, lse, delta, dk, dv, B, H, KV, S,
                            views_from(strides), scale, causal, dim3(grid_x, grid_y, grid_z),
                            smem, static_cast<cudaStream_t>(stream)));
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
