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
// get no weight, rows >= S are not stored), so S is unrestricted.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Strides {
  int64_t b, h, s;  // in elements; the head dim is contiguous
};

constexpr int kThreads = 128;  // both templates: 4 warps

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

// grid (H, row tiles, B)
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
               bf16* __restrict__ o, int S, int H, int KV, Strides qs, Strides ks, Strides vs,
               Strides os, float scale_log2, int causal) {
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
    const float inv = 1.f / fmaxf(quad_sum(l[half]), 1e-30f);
#pragma unroll
    for (int n = 0; n < 2 * KD; ++n)
      *reinterpret_cast<uint32_t*>(Os + (g + 8 * half) * L::kRow + 8 * n + 2 * t) =
          pack_bf16(acc[n][2 * half] * inv, acc[n][2 * half + 1] * inv);
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
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
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

// grid (row tiles, H, B)
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int S, int H, int KV,
              Strides qs, Strides ks, Strides vs, Strides os, float scale, int causal) {
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
    }
  }
}

}  // namespace cc

// Launch one template after checking that the plan computed in Python
// (grid, shared-memory bytes) is the one this template was written for.
template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int H, int KV,
                   int S, Strides qs, Strides ks, Strides vs, Strides os, float scale, int causal,
                   dim3 grid, int64_t smem, cudaStream_t stream) {
  constexpr bool kTc = sizeof(T) == 2;
  constexpr size_t bytes = kTc ? tc::Layout<D>::bytes : cc::Smem<D>::bytes;
  const int row_tiles = (S + 63) / 64;  // both templates own 64 query rows per block
  const dim3 want = kTc ? dim3(H, row_tiles, B) : dim3(row_tiles, H, B);
  if (smem != static_cast<int64_t>(bytes) || grid.x != want.x || grid.y != want.y ||
      grid.z != want.z)
    return cudaErrorInvalidConfiguration;
  cudaError_t err;
  if constexpr (kTc) {
    auto kernel = tc::flash_fwd_bf16<D>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, bytes, stream>>>(
        static_cast<const tc::bf16*>(q), static_cast<const tc::bf16*>(k),
        static_cast<const tc::bf16*>(v), static_cast<tc::bf16*>(o), S, H, KV, qs, ks, vs, os,
        scale * 1.4426950408889634f, causal);  // exp(x) = exp2(x log2 e)
  } else {
    auto kernel = cc::flash_fwd_f32<D>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, bytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<float*>(o), S, H, KV, qs, ks, vs, os, scale, causal);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v, void* o, int B, int H,
                       int KV, int S, Strides qs, Strides ks, Strides vs, Strides os,
                       float scale, int causal, dim3 grid, int64_t smem, cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch<T, 64>(q, k, v, o, B, H, KV, S, qs, ks, vs, os, scale, causal, grid, smem,
                           stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, H, KV, S, qs, ks, vs, os, scale, causal, grid, smem,
                            stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q is [B,H,S,D] and k, v, o are
// [B,KV,S,D] / [B,H,S,D] views given by their (b, h, s) strides in elements;
// the last dimension is contiguous and every row starts 16-byte aligned.
// grid and smem are the launch plan of flash_attention.py::launch_plan;
// a plan that does not match the template returns
// cudaErrorInvalidConfiguration.  Returns cudaGetLastError() after the launch.
extern "C" int flash_attention_fwd(int dtype, int D, const void* q, const void* k, const void* v,
                                   void* o, int B, int H, int KV, int S,
                                   int64_t q_sb, int64_t q_sh, int64_t q_ss,
                                   int64_t k_sb, int64_t k_sh, int64_t k_ss,
                                   int64_t v_sb, int64_t v_sh, int64_t v_ss,
                                   int64_t o_sb, int64_t o_sh, int64_t o_ss,
                                   float scale, int causal, int grid_x, int grid_y, int grid_z,
                                   int64_t smem, void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || S <= 0 || H % KV != 0 || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss}, vs{v_sb, v_sh, v_ss},
      os{o_sb, o_sh, o_ss};
  const dim3 grid(grid_x, grid_y, grid_z);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(dispatch_d<float>(D, q, k, v, o, B, H, KV, S, qs, ks, vs, os,
                                                scale, causal, grid, smem, s));
    case 1:
      return static_cast<int>(dispatch_d<__nv_bfloat16>(D, q, k, v, o, B, H, KV, S, qs, ks, vs,
                                                        os, scale, causal, grid, smem, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
