// Mamba-2 SSD intra-chunk for Hopper (sm_90a): for every (chunk i, head h)
//   y[i,h]     = ((C_i B_i^T) o L) x[i,h]          in x's dtype,
//   state[i,h] = (x[i,h] o exp(cum_last - cum))^T B_i  in f32,
// with L[q, j] = exp(cum[q] - cum[j]) for q >= j and 0 above the diagonal.
// x [BNC, H, Q, HD], b and c [BNC, Q, N] (shared by the heads), cum
// [BNC, H, Q], all f32 but x (f32 or bf16).
//
// Replaces: src/repro/kernels/ssd_scan.py::ssd_intra_chunk (Pallas body _ssd_kernel).
//
// Bound: operations.  Per chunk the function needs C B^T once (2N per
// causal pair q >= j; B and C are shared by the heads), and per (chunk,
// head) the decay and (C B^T o L) x (1 + 2 HD per pair) and the state
// (2 HD N per row), against ~4 Q (N + HD) bytes of x, y and the state plus
// B and C once per chunk.  At mamba2-130m's serving shapes (Q = 128..256,
// N = 128, HD = 64) that is ~90 operations per byte, so the arithmetic
// sets the card's least time: on f32 operands, the CUDA cores' 67 TFLOP/s
// of FMAs, far below the tensor cores' 989 TFLOP/s of bf16.
//
// Nothing of size Q x Q exists per head: the TPU kernel's [Q, Q] f32 mask
// per (chunk, head) is 256 KB at Q = 256, more than a Hopper block's
// 227 KB.  Two block roles share one grid (x: role tiles, y: chunk): y
// blocks own 64 rows q of one chunk and a group of heads, walk the
// 64-column tiles j <= the diagonal, and compute each C B^T tile once for
// the group; state blocks own a range of columns n of one (chunk, head)
// and sum over all rows j.  The decay is evaluated only where q >= j:
// above the diagonal its exponent is positive, and inf * 0 would be NaN.
// Ragged Q (128 and 160 on the serving path) and N are masked: rows and
// columns at or past them are zero.  The launch plan (route, heads per
// block, grid, shared-memory bytes) is computed in Python
// (ssd_scan.py::launch_plan) and checked here.  Shared memory does not
// grow with Q or N.
//
// bf16 x: tensor cores (namespace tc, 128 threads).  Every product runs on
// mma.sync m16n8k16 (bf16 inputs, f32 accumulator), with each f32 operand
// split into two bf16 halves (hi = bf16(v), lo = bf16(v - hi), ~16 bits of
// mantissa together) and the products summed as hi*hi + hi*lo + lo*hi;
// x, which bf16 holds exactly, needs no split.  That keeps ~1e-5 relative
// error: the chunk state stays within its 1e-4 (chip_smoke.py and
// tests/test_torch_gpu.py hold it), and the decayed scores are far more
// precise than the bf16 rounding the JAX model gives them
// (repro/models/ssm.py:103-105).  A y block computes the C B^T tile of its
// rows into mma accumulators, which hold it in exactly the layout of the
// A fragments of (C B^T o L) x, so each head of the group applies its decay
// and splits the scores in registers; the heads' x tiles and cum values
// arrive by cp.async while C B^T is being computed.  B and C are staged
// in 64-wide slices of N, split as they are stored.  State blocks stage
// x o exp(cum_last - cum) and B in 32-row slices, split the same way.
//
// Backward (namespace bwd; no TPU counterpart: the JAX package
// differentiates the plain scan).  Per (chunk, head), with G = C B^T,
// M = G o L, w_k = exp(cum_last - cum_k) and the gradients dy, dstate:
//   dM = dy x^T (lower triangle), dML = dM o L, P = dM o M;
//   dx = M^T dy + w o (B dstate^T);            (per head, in x's dtype)
//   dC = sum_h dML B;  dB = sum_h dML^T C + sum_h (x o w) dstate;
//   dcum_q = rowsum P - colsum P - w_q x_q.(dstate B_q), and dcum_last
//   also gets sum_k w_k x_k.(dstate B_k).
// Bound: operations, as the forward (about twice its products).  Two block
// roles per (chunk, head), 256 threads each on f32 CUDA-core FMAs for both
// x dtypes (a simple first kernel: bf16 x is widened as it is staged): a
// "k" block owns 64 columns k and walks the row tiles q >= k, recomputing
// the G and dM tiles, for dx, the dML^T C part of dB and the column sums of
// P, then adds the dstate terms; a "q" block owns 64 rows q and walks the
// column tiles k <= q for the dML B part of dC and the row sums of P.  L is
// evaluated only where q >= k (masked before exp, as in the forward).  The
// heads' dB and dC and the two halves of dcum go to f32 partials that a
// second launch sums in a fixed order (no atomics: two calls give the same
// bits).  dstate may be absent (a sequence of one chunk): its terms are
// skipped.  N <= 128 (a thread's row of dB or dC lives in registers).
//
// f32 x: CUDA-core FMAs throughout (namespace cc, 256 threads), so every
// product stays f32.  y blocks keep up to 4 heads' accumulators in
// registers and compute each C B^T tile once for them (FMAs over 32-deep
// slices of N staged transposed, each thread a 4 x 4 piece fed by two
// float4 loads per step); the decayed scores go through shared memory.
// State blocks own 64 columns n, each thread a (HD/16) x 4 piece.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int BQ = 64;  // rows q per y block; columns j per tile (both routes)

// ------------------------------------------------------------------ bf16 --

namespace tc {

constexpr int kThreads = 128;  // 4 warps
constexpr int kMaxHeads = 2;   // heads per y block
constexpr int BNK = 64;        // slice of N per C B^T step
constexpr int BJ = 32;         // rows j per state slice
constexpr int BNS = 128;       // columns n per state block, 32 per warp
constexpr int kS = BNK + 8;    // row stride (bf16) of the C and B slices: 16 bytes of pad
constexpr int kBS = BNS + 8;   // row stride (bf16) of the state's B slice

__host__ __device__ constexpr size_t smem_bytes(int HD) {
  const size_t y_role = 2 * (4 * BQ * kS + kMaxHeads * BQ * (HD + 8)) + 4 * kMaxHeads * BQ;
  const size_t state_role = 2 * (2 * BJ * (HD + 8) + 2 * BJ * kBS);
  return y_role > state_role ? y_role : state_role;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 (or 4) bytes from global to shared memory, asynchronously; bytes = 0
// writes zeros and reads nothing (src must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

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
// (v0, v1) as two bf16 halves each: hi = bf16(v), lo = bf16(v - hi)
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(v0 - hf.x, v1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// ldmatrix x4 lane addresses.  "ar/ac": A operands stored [m][k] and B
// operands stored [k][n] (through .trans): row lane%8 + 8*(lane/8 % 2),
// column 8*(lane/16).  "kr/kc": B operands stored [n][k], and A operands
// stored [k][m] (through .trans): row lane%8 + 8*(lane/16), column
// 8*(lane/8 % 2).
struct Lanes {
  int ar, ac, kr, kc;
  __device__ __forceinline__ explicit Lanes(int lane)
      : ar((lane & 7) + ((lane >> 3) & 1) * 8), ac((lane >> 4) * 8),
        kr((lane & 7) + (lane >> 4) * 8), kc(((lane >> 3) & 1) * 8) {}
};

// rows [r0, r0 + nrows) x columns [c0, c0 + 4 * n4) of a row-major f32
// matrix (ld elements, rows < R and columns < Cn valid) split into two
// bf16 tiles with row stride ldt; zero outside.
template <int nrows, int n4>
__device__ __forceinline__ void stage_split(const float* __restrict__ src, int64_t ld, int r0,
                                            int R, int c0, int Cn, bool vec, bf16* hi, bf16* lo,
                                            int ldt) {
  for (int i = threadIdx.x; i < nrows * n4; i += kThreads) {
    const int r = i / n4, c = (i % n4) * 4;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (r0 + r < R) {
      const float* p = src + static_cast<int64_t>(r0 + r) * ld + c0 + c;
      if (vec) {
        if (c0 + c < Cn) {
          const float4 f = *reinterpret_cast<const float4*>(p);
          v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = c0 + c + e < Cn ? p[e] : 0.f;
      }
    }
    uint2 h, l;
    split2(v[0], v[1], h.x, l.x);
    split2(v[2], v[3], h.y, l.y);
    *reinterpret_cast<uint2*>(hi + r * ldt + c) = h;
    *reinterpret_cast<uint2*>(lo + r * ldt + c) = l;
  }
}

// y rows [q0, q0 + 64) of heads [h0, h0 + nh) of one chunk.  Warp w owns
// rows q0 + 16w .. q0 + 16w + 15.
template <int HD>
__device__ __forceinline__ void y_block(const bf16* __restrict__ xi, const float* __restrict__ bi,
                                        const float* __restrict__ ci,
                                        const float* __restrict__ cumi, bf16* __restrict__ yi,
                                        int Q, int N, int q0, int h0, int nh, bool vec_bc,
                                        bool vec_x, unsigned char* smem) {
  constexpr int kX = HD + 8;
  bf16* Chi = reinterpret_cast<bf16*>(smem);  // [BQ][kS] C rows q0.., one slice of N
  bf16* Clo = Chi + BQ * kS;
  bf16* Bhi = Clo + BQ * kS;                  // [BQ][kS] B rows j0.., the same slice
  bf16* Blo = Bhi + BQ * kS;
  bf16* Xs = Blo + BQ * kS;                   // [kMaxHeads][BQ][kX] x rows j0..
  float* cjs = reinterpret_cast<float*>(Xs + kMaxHeads * BQ * kX);  // [kMaxHeads][BQ]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const Lanes L(lane);
  const int r0 = warp * 16 + g;  // this thread's rows r0 and r0 + 8 of the tile

  float acc[kMaxHeads][HD / 8][4];
  float cq[kMaxHeads][2];
#pragma unroll
  for (int hh = 0; hh < kMaxHeads; ++hh) {
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[hh][n][e] = 0.f;
    const float* cumh = cumi + static_cast<int64_t>(min(h0 + hh, h0 + nh - 1)) * Q;
    cq[hh][0] = q0 + r0 < Q ? cumh[q0 + r0] : 0.f;
    cq[hh][1] = q0 + r0 + 8 < Q ? cumh[q0 + r0 + 8] : 0.f;
  }

  const int j_end = min(Q, q0 + BQ);  // causal: columns past the block's last row add nothing
  for (int j0 = 0; j0 < j_end; j0 += BQ) {
    __syncthreads();  // every warp is done with the previous tile's x
    // the heads' x tiles and cum values fly while C B^T is computed
    for (int hh = 0; hh < nh; ++hh) {
      const bf16* xh = xi + static_cast<int64_t>(h0 + hh) * Q * HD;
      bf16* X = Xs + hh * BQ * kX;
      for (int i = threadIdx.x; i < BQ * HD / 8; i += kThreads) {
        const int r = i / (HD / 8), c = (i % (HD / 8)) * 8;
        const bool ok = j0 + r < Q;
        const bf16* src = xh + static_cast<int64_t>(ok ? j0 + r : 0) * HD + c;
        if (vec_x) {
          cp_async16(X + r * kX + c, src, ok ? 16 : 0);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) X[r * kX + c + e] = ok ? src[e] : __float2bfloat16(0.f);
        }
      }
      if (threadIdx.x < BQ) {
        const bool ok = j0 + threadIdx.x < Q;
        cp_async4(cjs + hh * BQ + threadIdx.x,
                  cumi + static_cast<int64_t>(h0 + hh) * Q + (ok ? j0 + threadIdx.x : 0),
                  ok ? 4 : 0);
      }
    }
    cp_async_commit();

    // C B^T of the warp's 16 rows and the tile's 64 columns, as m16n8
    // accumulators: cb[n][e] is row r0 + 8 (e / 2), column 8n + 2t + e % 2
    float cb[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) cb[n][e] = 0.f;
    for (int n0 = 0; n0 < N; n0 += BNK) {
      if (n0 > 0) __syncthreads();  // the previous slice is consumed
      stage_split<BQ, BNK / 4>(ci, N, q0, Q, n0, N, vec_bc, Chi, Clo, kS);
      stage_split<BQ, BNK / 4>(bi, N, j0, Q, n0, N, vec_bc, Bhi, Blo, kS);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BNK / 16; ++kk) {
        uint32_t chi[4], clo[4];
        ldmatrix_x4(chi, Chi + (warp * 16 + L.ar) * kS + kk * 16 + L.ac);
        ldmatrix_x4(clo, Clo + (warp * 16 + L.ar) * kS + kk * 16 + L.ac);
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) {
          uint32_t bh[4], bl[4];
          ldmatrix_x4(bh, Bhi + (nj * 16 + L.kr) * kS + kk * 16 + L.kc);
          ldmatrix_x4(bl, Blo + (nj * 16 + L.kr) * kS + kk * 16 + L.kc);
          mma_bf16(cb[2 * nj], chi, bh[0], bh[1]);
          mma_bf16(cb[2 * nj + 1], chi, bh[2], bh[3]);
          mma_bf16(cb[2 * nj], chi, bl[0], bl[1]);
          mma_bf16(cb[2 * nj + 1], chi, bl[2], bl[3]);
          mma_bf16(cb[2 * nj], clo, bh[0], bh[1]);
          mma_bf16(cb[2 * nj + 1], clo, bh[2], bh[3]);
        }
      }
    }
    cp_async_wait_all();
    __syncthreads();  // x tiles and cum values are visible to every warp

    // each head: S = C B^T o L in two bf16 halves, y += S x
#pragma unroll
    for (int hh = 0; hh < kMaxHeads; ++hh) {
      if (hh >= nh) break;
      const float* cj = cjs + hh * BQ;
      const bf16* X = Xs + hh * BQ * kX;
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        uint32_t ahi[4], alo[4];
#pragma unroll
        for (int f = 0; f < 4; ++f) {  // A register f: row r0 + 8 (f % 2), columns + 8 (f / 2)
          const float* s = cb[2 * kk + (f >> 1)] + 2 * (f & 1);
          const int c = kk * 16 + 8 * (f >> 1) + 2 * t;
          const int q = q0 + r0 + 8 * (f & 1), j = j0 + c;
          const float cqv = cq[hh][f & 1];
          const float2 cjv = *reinterpret_cast<const float2*>(cj + c);
          // exp only where q >= j (both inside the chunk)
          const float s0 = (q >= j && q < Q) ? s[0] * expf(cqv - cjv.x) : 0.f;
          const float s1 = (q >= j + 1 && q < Q) ? s[1] * expf(cqv - cjv.y) : 0.f;
          split2(s0, s1, ahi[f], alo[f]);
        }
#pragma unroll
        for (int dn = 0; dn < HD / 16; ++dn) {
          uint32_t xb[4];
          ldmatrix_x4_trans(xb, X + (kk * 16 + L.ar) * kX + dn * 16 + L.ac);
          mma_bf16(acc[hh][2 * dn], ahi, xb[0], xb[1]);
          mma_bf16(acc[hh][2 * dn + 1], ahi, xb[2], xb[3]);
          mma_bf16(acc[hh][2 * dn], alo, xb[0], xb[1]);
          mma_bf16(acc[hh][2 * dn + 1], alo, xb[2], xb[3]);
        }
      }
    }
  }

#pragma unroll
  for (int hh = 0; hh < kMaxHeads; ++hh) {
    if (hh >= nh) break;
    bf16* yh = yi + static_cast<int64_t>(h0 + hh) * Q * HD;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int q = q0 + r0 + 8 * half;
      if (q < Q) {
#pragma unroll
        for (int n = 0; n < HD / 8; ++n)
          *reinterpret_cast<__nv_bfloat162*>(yh + static_cast<int64_t>(q) * HD + 8 * n + 2 * t) =
              __floats2bfloat162_rn(acc[hh][n][2 * half], acc[hh][n][2 * half + 1]);
      }
    }
  }
}

// state columns [n0, n0 + BNS) of one (chunk, head): sum over all rows j.
// Warp w owns columns n0 + 32w .. n0 + 32w + 31 and all HD rows d.
template <int HD>
__device__ __forceinline__ void state_block(const bf16* __restrict__ xh,
                                            const float* __restrict__ bi,
                                            const float* __restrict__ cumh,
                                            float* __restrict__ sth, int Q, int N, int n0,
                                            bool vec_bc, unsigned char* smem) {
  constexpr int kXW = HD + 8, MT = HD / 16;
  bf16* XWhi = reinterpret_cast<bf16*>(smem);  // [BJ][kXW] x o exp(cum_last - cum), rows j0..
  bf16* XWlo = XWhi + BJ * kXW;
  bf16* Bhi = XWlo + BJ * kXW;                 // [BJ][kBS] B rows j0.., columns n0..
  bf16* Blo = Bhi + BJ * kBS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const Lanes L(lane);
  const float c_last = cumh[Q - 1];

  float acc[MT][4][4];  // m16 tile of d, n8 tile of the warp's 32 columns
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;

  for (int j0 = 0; j0 < Q; j0 += BJ) {
    __syncthreads();  // the previous slice is consumed
    for (int i = threadIdx.x; i < BJ * HD / 2; i += kThreads) {
      const int r = i / (HD / 2), d = (i % (HD / 2)) * 2, j = j0 + r;
      float v0 = 0.f, v1 = 0.f;
      if (j < Q) {
        const float w = expf(c_last - cumh[j]);
        const bf16* xr = xh + static_cast<int64_t>(j) * HD + d;
        v0 = __bfloat162float(xr[0]) * w;
        v1 = __bfloat162float(xr[1]) * w;
      }
      uint32_t h, l;
      split2(v0, v1, h, l);
      *reinterpret_cast<uint32_t*>(XWhi + r * kXW + d) = h;
      *reinterpret_cast<uint32_t*>(XWlo + r * kXW + d) = l;
    }
    stage_split<BJ, BNS / 4>(bi, N, j0, Q, n0, N, vec_bc, Bhi, Blo, kBS);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BJ / 16; ++kk) {
      uint32_t ah[MT][4], al[MT][4];  // A[d][j] from XW[j][d] through .trans
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        ldmatrix_x4_trans(ah[m], XWhi + (kk * 16 + L.kr) * kXW + m * 16 + L.kc);
        ldmatrix_x4_trans(al[m], XWlo + (kk * 16 + L.kr) * kXW + m * 16 + L.kc);
      }
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        uint32_t bh[4], bl[4];
        ldmatrix_x4_trans(bh, Bhi + (kk * 16 + L.ar) * kBS + warp * 32 + nj * 16 + L.ac);
        ldmatrix_x4_trans(bl, Blo + (kk * 16 + L.ar) * kBS + warp * 32 + nj * 16 + L.ac);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          mma_bf16(acc[m][2 * nj], ah[m], bh[0], bh[1]);
          mma_bf16(acc[m][2 * nj + 1], ah[m], bh[2], bh[3]);
          mma_bf16(acc[m][2 * nj], ah[m], bl[0], bl[1]);
          mma_bf16(acc[m][2 * nj + 1], ah[m], bl[2], bl[3]);
          mma_bf16(acc[m][2 * nj], al[m], bh[0], bh[1]);
          mma_bf16(acc[m][2 * nj + 1], al[m], bh[2], bh[3]);
        }
      }
    }
  }

#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = m * 16 + g + 8 * (e >> 1), col = n0 + warp * 32 + n * 8 + 2 * t + (e & 1);
        if (col < N) sth[static_cast<int64_t>(d) * N + col] = acc[m][n][e];
      }
}

// grid (y blocks + state blocks, BNC).  y blocks: row tiles last-first (the
// longest causal rows start first), head groups fastest; then state blocks,
// (head, column tile).
template <int HD>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const bf16* __restrict__ x, const float* __restrict__ b, const float* __restrict__ c,
           const float* __restrict__ cum, bf16* __restrict__ y, float* __restrict__ state, int H,
           int Q, int N, int heads_per_block) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int64_t i = blockIdx.y;
  const int row_tiles = (Q + BQ - 1) / BQ;
  const int groups = (H + heads_per_block - 1) / heads_per_block;
  const int y_blocks = row_tiles * groups;
  const int bx = blockIdx.x;
  const float* bi = b + i * Q * N;
  const float* ci = c + i * Q * N;
  const bool vec_bc = N % 4 == 0 && ((reinterpret_cast<uintptr_t>(b) |
                                       reinterpret_cast<uintptr_t>(c)) & 15) == 0;
  if (bx < y_blocks) {
    const int q0 = (row_tiles - 1 - bx / groups) * BQ;
    const int h0 = (bx % groups) * heads_per_block;
    const bool vec_x = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
    y_block<HD>(x + i * H * Q * HD, bi, ci, cum + i * H * Q, y + i * H * Q * HD, Q, N, q0, h0,
                min(heads_per_block, H - h0), vec_bc, vec_x, smem);
  } else {
    const int n_tiles = (N + BNS - 1) / BNS;
    const int s = bx - y_blocks, h = s / n_tiles;
    const int64_t ih = i * H + h;
    state_block<HD>(x + ih * Q * HD, bi, cum + ih * Q, state + ih * HD * N, Q, N,
                    (s % n_tiles) * BNS, vec_bc, smem);
  }
}

}  // namespace tc

// ------------------------------------------------------------------- f32 --

namespace cc {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kMaxHeads = 4;   // heads per y block
constexpr int BN = 32;         // depth of one C B^T slice of N
constexpr int BJ = 64;         // rows j per state slice
constexpr int BNS = 64;        // columns n per state block
constexpr int kT = BQ + 4;     // row stride of the transposed C and B slices and of S^T
constexpr int kCB = BQ + 1;    // row stride of the C B^T tile

__host__ __device__ constexpr size_t smem_bytes(int HD) {
  const size_t y_role = 4 * (2 * BN * kT + BQ * kCB + BQ * kT + BQ * (HD + 4) + 2 * BQ);
  const size_t state_role = 4 * (BJ * HD + BJ * BNS);
  return y_role > state_role ? y_role : state_role;
}

// y rows [q0, q0 + 64) of heads [h0, h0 + nh) of one chunk.
template <int HD>
__device__ __forceinline__ void y_block(const float* __restrict__ xi, const float* __restrict__ bi,
                                        const float* __restrict__ ci,
                                        const float* __restrict__ cumi, float* __restrict__ yi,
                                        int Q, int N, int q0, int h0, int nh, float* smem) {
  constexpr int KD = HD / 16, kX = HD + 4;
  float* Ct = smem;           // [BN][kT]  C rows q0.., one slice of N, transposed
  float* Bt = Ct + BN * kT;   // [BN][kT]  B rows j0.., the same slice
  float* CB = Bt + BN * kT;   // [BQ][kCB] C B^T tile
  float* St = CB + BQ * kCB;  // [BQ][kT]  S^T [j][q] of one head
  float* Xs = St + BQ * kT;   // [BQ][kX]  x rows j0.. of one head
  float* cj = Xs + BQ * kX;   // [BQ]      cum of columns j0.. of one head
  float* cq = cj + BQ;        // [BQ]      cum of rows q0.. of one head
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  float acc[kMaxHeads][KD][4];  // rows ty*4 + a, columns tx*KD + k
#pragma unroll
  for (int hh = 0; hh < kMaxHeads; ++hh)
#pragma unroll
    for (int k = 0; k < KD; ++k)
#pragma unroll
      for (int a = 0; a < 4; ++a) acc[hh][k][a] = 0.f;

  const int j_end = min(Q, q0 + BQ);  // causal: columns past the block's last row add nothing
  for (int j0 = 0; j0 < j_end; j0 += BQ) {
    // C B^T tile: rows ty*4 + a, columns tx*4 + b
    float cb[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) cb[a][b] = 0.f;
    for (int n0 = 0; n0 < N; n0 += BN) {
      __syncthreads();  // the previous slice (or head loop) is consumed
      for (int i = tid; i < BQ * BN; i += kThreads) {
        const int r = i / BN, n = n0 + i % BN;  // a warp reads 32 n of one row
        Ct[(i % BN) * kT + r] = (q0 + r < Q && n < N) ? ci[static_cast<int64_t>(q0 + r) * N + n] : 0.f;
        Bt[(i % BN) * kT + r] = (j0 + r < Q && n < N) ? bi[static_cast<int64_t>(j0 + r) * N + n] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int n = 0; n < BN; ++n) {
        const float4 cv = *reinterpret_cast<const float4*>(Ct + n * kT + ty * 4);
        const float4 bv = *reinterpret_cast<const float4*>(Bt + n * kT + tx * 4);
        const float c4[4] = {cv.x, cv.y, cv.z, cv.w}, b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) cb[a][b] = fmaf(c4[a], b4[b], cb[a][b]);
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) CB[(ty * 4 + a) * kCB + tx * 4 + b] = cb[a][b];

#pragma unroll
    for (int hh = 0; hh < kMaxHeads; ++hh) {  // unrolled: acc[hh] stays in registers
      if (hh >= nh) break;
      const float* xh = xi + static_cast<int64_t>(h0 + hh) * Q * HD;
      const float* cumh = cumi + static_cast<int64_t>(h0 + hh) * Q;
      __syncthreads();  // CB is written; the previous head's S and x are consumed
      for (int i = tid; i < BQ * HD; i += kThreads) {
        const int r = i / HD, d = i % HD;
        Xs[r * kX + d] = j0 + r < Q ? xh[static_cast<int64_t>(j0 + r) * HD + d] : 0.f;
      }
      if (tid < BQ) cj[tid] = j0 + tid < Q ? cumh[j0 + tid] : 0.f;
      else if (tid < 2 * BQ) cq[tid - BQ] = q0 + tid - BQ < Q ? cumh[q0 + tid - BQ] : 0.f;
      __syncthreads();
      for (int i = tid; i < BQ * BQ; i += kThreads) {
        const int r = i % BQ, c = i / BQ, q = q0 + r, j = j0 + c;
        // exp only where q >= j (both inside the chunk)
        St[c * kT + r] = (q >= j && q < Q) ? CB[r * kCB + c] * expf(cq[r] - cj[c]) : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int c = 0; c < BQ; ++c) {
        const float4 sv = *reinterpret_cast<const float4*>(St + c * kT + ty * 4);
        const float s4[4] = {sv.x, sv.y, sv.z, sv.w};
        float xv[KD];
#pragma unroll
        for (int k = 0; k < KD; ++k) xv[k] = Xs[c * kX + tx * KD + k];
#pragma unroll
        for (int k = 0; k < KD; ++k)
#pragma unroll
          for (int a = 0; a < 4; ++a) acc[hh][k][a] = fmaf(s4[a], xv[k], acc[hh][k][a]);
      }
    }
  }

#pragma unroll
  for (int hh = 0; hh < kMaxHeads; ++hh) {
    if (hh >= nh) break;
    float* yh = yi + static_cast<int64_t>(h0 + hh) * Q * HD;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int q = q0 + ty * 4 + a;
      if (q < Q) {
#pragma unroll
        for (int k = 0; k < KD; ++k) yh[static_cast<int64_t>(q) * HD + tx * KD + k] = acc[hh][k][a];
      }
    }
  }
}

// state columns [n0, n0 + BNS) of one (chunk, head): sum over all rows j.
template <int HD>
__device__ __forceinline__ void state_block(const float* __restrict__ xh,
                                            const float* __restrict__ bi,
                                            const float* __restrict__ cumh,
                                            float* __restrict__ sth, int Q, int N, int n0,
                                            float* smem) {
  constexpr int KD = HD / 16;
  float* Xs = smem;           // [BJ][HD]  x rows j0.. times exp(cum_last - cum_j)
  float* Bs = Xs + BJ * HD;   // [BJ][BNS] B rows j0.., columns n0..
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float c_last = cumh[Q - 1];

  float acc[KD][4];
#pragma unroll
  for (int k = 0; k < KD; ++k)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[k][b] = 0.f;

  for (int j0 = 0; j0 < Q; j0 += BJ) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < BJ * HD; idx += kThreads) {
      const int r = idx / HD, d = idx - r * HD;
      const int j = j0 + r;
      Xs[idx] = j < Q ? xh[static_cast<int64_t>(j) * HD + d] * expf(c_last - cumh[j]) : 0.f;
    }
    for (int idx = threadIdx.x; idx < BJ * BNS; idx += kThreads) {
      const int r = idx / BNS, n = n0 + idx - r * BNS;
      Bs[idx] = (j0 + r < Q && n < N) ? bi[static_cast<int64_t>(j0 + r) * N + n] : 0.f;
    }
    __syncthreads();
    // state[d][n] += sum_j xw[j][d] B[j][n] for d = ty + 16 k, n = tx + 16 b
#pragma unroll 4
    for (int r = 0; r < BJ; ++r) {
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

// grid as tc::ssd_kernel's
template <int HD>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const float* __restrict__ x, const float* __restrict__ b, const float* __restrict__ c,
           const float* __restrict__ cum, float* __restrict__ y, float* __restrict__ state, int H,
           int Q, int N, int heads_per_block) {
  extern __shared__ __align__(16) float smem_f[];
  const int64_t i = blockIdx.y;
  const int row_tiles = (Q + BQ - 1) / BQ;
  const int groups = (H + heads_per_block - 1) / heads_per_block;
  const int y_blocks = row_tiles * groups;
  const int bx = blockIdx.x;
  const float* bi = b + i * Q * N;
  if (bx < y_blocks) {
    const int q0 = (row_tiles - 1 - bx / groups) * BQ;
    const int h0 = (bx % groups) * heads_per_block;
    y_block<HD>(x + i * H * Q * HD, bi, c + i * Q * N, cum + i * H * Q, y + i * H * Q * HD, Q, N,
                q0, h0, min(heads_per_block, H - h0), smem_f);
  } else {
    const int n_tiles = (N + BNS - 1) / BNS;
    const int s = bx - y_blocks, h = s / n_tiles;
    const int64_t ih = i * H + h;
    state_block<HD>(x + ih * Q * HD, bi, cum + ih * Q, state + ih * HD * N, Q, N,
                    (s % n_tiles) * BNS, smem_f);
  }
}

}  // namespace cc


// ------------------------------------------------------------- backward --

namespace bwd {

constexpr int kThreads = 256;  // 16 x 16: thread (ty, tx) owns rows 4 ty.. and columns 4 tx.. of a tile
constexpr int kLd = BQ + 4;    // row stride of the [*][64] tiles
constexpr int kMaxState = 128;

// f32 words of shared memory: x^T and dy^T [HD][kLd], B^T and C^T [N][kLd],
// two [64][kLd] tiles, four [64] vectors
__host__ __device__ constexpr size_t smem_floats(int HD, int N) {
  return static_cast<size_t>(kLd) * (2 * HD + 2 * N + 2 * BQ) + 4 * BQ;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) { *p = __float2bfloat16(v); }

// rows [r0, r0 + 64) x columns [0, ncols) of a row-major matrix (ld
// elements) into dst[col][row] as f32; rows at or past R are zero.
template <typename T>
__device__ __forceinline__ void stage_t(const T* __restrict__ src, int64_t ld, int r0, int R,
                                        int ncols, float* dst) {
  for (int i = threadIdx.x; i < BQ * ncols; i += kThreads) {
    const int r = i / ncols, col = i - r * ncols;  // neighbouring threads, neighbouring columns
    dst[col * kLd + r] = r0 + r < R ? to_f(src[static_cast<int64_t>(r0 + r) * ld + col]) : 0.f;
  }
}

// Sum over the 16 threads of a half-warp (the tx of one ty).
__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// grid (2 row tiles, H, BNC): x < row tiles are "k" blocks (column tile x),
// the rest "q" blocks, the longest row tile first.  Partials: db_part,
// dc_part [BNC, H, Q, N]; dcum_row (q blocks), dcum_col (k blocks) [BNC, H,
// Q]; last_part [BNC, H, row tiles] (each k block's sum of w x.(dstate B)).
template <typename T, int HD, int NB>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_kernel(const T* __restrict__ x, const float* __restrict__ b, const float* __restrict__ c,
               const float* __restrict__ cum, const T* __restrict__ dy,
               const float* __restrict__ dstate, T* __restrict__ dx, float* __restrict__ db_part,
               float* __restrict__ dc_part, float* __restrict__ dcum_row,
               float* __restrict__ dcum_col, float* __restrict__ last_part, int H, int Q, int N) {
  extern __shared__ __align__(16) float sm[];
  float* XkT = sm;              // [HD][kLd]  x of the k tile, transposed
  float* dyT = XkT + HD * kLd;  // [HD][kLd]  dy of the q tile, transposed
  float* BkT = dyT + HD * kLd;  // [N][kLd]   B of the k tile, transposed
  float* CqT = BkT + N * kLd;   // [N][kLd]   C of the q tile, transposed
  float* Ms = CqT + N * kLd;    // [BQ][kLd]  k blocks: M [q][k]; q blocks: dML^T [k][q]
  float* dMs = Ms + BQ * kLd;   // [BQ][kLd]  k blocks: dML [q][k]
  float* cq = dMs + BQ * kLd;   // [BQ] cum of the q tile's rows
  float* ck = cq + BQ;          // [BQ] cum of the k tile's columns
  float* wk = ck + BQ;          // [BQ] exp(cum_last - cum) of the k tile's columns
  float* tws = wk + BQ;         // [BQ] w_k x_k.(dstate B_k)
  constexpr int KD = HD / 16;
  const int RT = (Q + BQ - 1) / BQ;
  const int h = blockIdx.y, i = blockIdx.z;
  const int64_t ih = static_cast<int64_t>(i) * H + h;
  const T* xh = x + ih * Q * HD;
  const T* dyh = dy + ih * Q * HD;
  const float* bi = b + static_cast<int64_t>(i) * Q * N;
  const float* ci = c + static_cast<int64_t>(i) * Q * N;
  const float* cumh = cum + ih * Q;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const bool k_role = static_cast<int>(blockIdx.x) < RT;
  const int tile = k_role ? blockIdx.x : 2 * RT - 1 - blockIdx.x;

  // G and dM of the staged tiles (rows q = 4 ty + a, columns k = 4 tx + b),
  // then weighed: ml = M (or nothing), dml = dM o L; returns P = dML o G.
  auto tiles = [&](int q0, int k0, float (&ml)[4][4], float (&dml)[4][4], float (&p)[4][4]) {
    float g[4][4], dm[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int e = 0; e < 4; ++e) g[a][e] = dm[a][e] = 0.f;
    for (int n = 0; n < N; ++n) {
      const float4 cv = *reinterpret_cast<const float4*>(CqT + n * kLd + ty * 4);
      const float4 bv = *reinterpret_cast<const float4*>(BkT + n * kLd + tx * 4);
      const float c4[4] = {cv.x, cv.y, cv.z, cv.w}, b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int e = 0; e < 4; ++e) g[a][e] = fmaf(c4[a], b4[e], g[a][e]);
    }
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      const float4 yv = *reinterpret_cast<const float4*>(dyT + d * kLd + ty * 4);
      const float4 xv = *reinterpret_cast<const float4*>(XkT + d * kLd + tx * 4);
      const float y4[4] = {yv.x, yv.y, yv.z, yv.w}, x4[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int e = 0; e < 4; ++e) dm[a][e] = fmaf(y4[a], x4[e], dm[a][e]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int q = q0 + ty * 4 + a, k = k0 + tx * 4 + e;
        // exp only where q >= k (both inside the chunk)
        const float L = (q >= k && q < Q) ? expf(cq[ty * 4 + a] - ck[tx * 4 + e]) : 0.f;
        ml[a][e] = g[a][e] * L;
        dml[a][e] = dm[a][e] * L;
        p[a][e] = dml[a][e] * g[a][e];
      }
  };
  auto stage_cum = [&](float* dst, int r0) {
    if (tid < BQ) dst[tid] = r0 + tid < Q ? cumh[r0 + tid] : 0.f;
  };

  if (k_role) {
    const int k0 = tile * BQ;
    stage_t(xh, HD, k0, Q, HD, XkT);
    stage_t(bi, N, k0, Q, N, BkT);
    stage_cum(ck, k0);
    if (tid < BQ) wk[tid] = k0 + tid < Q ? expf(cumh[Q - 1] - cumh[k0 + tid]) : 0.f;
    float dxa[4][KD], dba[4][NB], colp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int j = 0; j < KD; ++j) dxa[a][j] = 0.f;
#pragma unroll
      for (int j = 0; j < NB; ++j) dba[a][j] = 0.f;
    }
    for (int q0 = k0; q0 < Q; q0 += BQ) {
      __syncthreads();  // the previous row tile's products are consumed
      stage_t(ci, N, q0, Q, N, CqT);
      stage_t(dyh, HD, q0, Q, HD, dyT);
      stage_cum(cq, q0);
      __syncthreads();
      float m[4][4], dml[4][4], p[4][4];
      tiles(q0, k0, m, dml, p);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          colp[e] += p[a][e];
          Ms[(ty * 4 + a) * kLd + tx * 4 + e] = m[a][e];
          dMs[(ty * 4 + a) * kLd + tx * 4 + e] = dml[a][e];
        }
      __syncthreads();
      // rows k = 4 ty + a: dx[k][d] += M[q][k] dy[q][d], dB[k][n] += dML[q][k] C[q][n]
      for (int q = 0; q < BQ; ++q) {
        const float4 mv = *reinterpret_cast<const float4*>(Ms + q * kLd + ty * 4);
        const float4 lv = *reinterpret_cast<const float4*>(dMs + q * kLd + ty * 4);
        const float m4[4] = {mv.x, mv.y, mv.z, mv.w}, l4[4] = {lv.x, lv.y, lv.z, lv.w};
#pragma unroll
        for (int j = 0; j < KD; ++j) {
          const float yv = dyT[(tx + 16 * j) * kLd + q];
#pragma unroll
          for (int a = 0; a < 4; ++a) dxa[a][j] = fmaf(m4[a], yv, dxa[a][j]);
        }
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          const int n = tx + 16 * j;
          const float cv = n < N ? CqT[n * kLd + q] : 0.f;
#pragma unroll
          for (int a = 0; a < 4; ++a) dba[a][j] = fmaf(l4[a], cv, dba[a][j]);
        }
      }
    }
    __syncthreads();  // the last row tile's products are consumed
    float* red = dyT;  // [16][BQ]: each ty's column sums of P
#pragma unroll
    for (int e = 0; e < 4; ++e) red[ty * BQ + tx * 4 + e] = colp[e];
    float tw[4] = {0.f, 0.f, 0.f, 0.f};
    if (dstate != nullptr) {
      const float* ds = dstate + ih * HD * N;
      float* dS = Ms;    // [HD][N]
      float* dST = CqT;  // [N][HD]
      for (int e = tid; e < HD * N; e += kThreads) {
        const float v = ds[e];
        const int d = e / N, n = e - d * N;
        dS[e] = v;
        dST[n * HD + d] = v;
      }
      __syncthreads();
      // (B dstate^T)[k][d] for k = 4 ty + a, d = tx + 16 j
      float bds[4][KD];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int j = 0; j < KD; ++j) bds[a][j] = 0.f;
      for (int n = 0; n < N; ++n) {
        const float4 bv = *reinterpret_cast<const float4*>(BkT + n * kLd + ty * 4);
        const float b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int j = 0; j < KD; ++j) {
          const float sv = dST[n * HD + tx + 16 * j];
#pragma unroll
          for (int a = 0; a < 4; ++a) bds[a][j] = fmaf(b4[a], sv, bds[a][j]);
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float w = wk[ty * 4 + a];
        float xd = 0.f;
#pragma unroll
        for (int j = 0; j < KD; ++j) {
          xd = fmaf(XkT[(tx + 16 * j) * kLd + ty * 4 + a], bds[a][j], xd);
          dxa[a][j] = fmaf(w, bds[a][j], dxa[a][j]);
        }
        tw[a] = w * sum16(xd);
      }
      // dB[k][n] += w_k sum_d x[k][d] dstate[d][n]
      for (int d = 0; d < HD; ++d) {
        const float4 xv = *reinterpret_cast<const float4*>(XkT + d * kLd + ty * 4);
        const float xw[4] = {xv.x * wk[ty * 4], xv.y * wk[ty * 4 + 1], xv.z * wk[ty * 4 + 2],
                             xv.w * wk[ty * 4 + 3]};
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          const int n = tx + 16 * j;
          const float sv = n < N ? dS[d * N + n] : 0.f;
#pragma unroll
          for (int a = 0; a < 4; ++a) dba[a][j] = fmaf(xw[a], sv, dba[a][j]);
        }
      }
    }
    if (tx == 0)
#pragma unroll
      for (int a = 0; a < 4; ++a) tws[ty * 4 + a] = tw[a];
    __syncthreads();
    if (tid < BQ && k0 + tid < Q) {
      float s = 0.f;
      for (int r = 0; r < 16; ++r) s += red[r * BQ + tid];
      dcum_col[ih * Q + k0 + tid] = -s - tws[tid];
    }
    if (tid == 0) {
      float s = 0.f;
      for (int t = 0; t < BQ; ++t) s += tws[t];  // zero past Q (w is zero there)
      last_part[ih * RT + tile] = s;
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int k = k0 + ty * 4 + a;
      if (k >= Q) break;
#pragma unroll
      for (int j = 0; j < KD; ++j) store(dx + (ih * Q + k) * HD + tx + 16 * j, dxa[a][j]);
#pragma unroll
      for (int j = 0; j < NB; ++j)
        if (tx + 16 * j < N) db_part[(ih * Q + k) * N + tx + 16 * j] = dba[a][j];
    }
  } else {
    const int q0 = tile * BQ;
    stage_t(ci, N, q0, Q, N, CqT);
    stage_t(dyh, HD, q0, Q, HD, dyT);
    stage_cum(cq, q0);
    float dca[4][NB], rowp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int j = 0; j < NB; ++j) dca[a][j] = 0.f;
    for (int k0 = 0; k0 <= q0; k0 += BQ) {
      __syncthreads();  // the previous column tile's products are consumed
      stage_t(xh, HD, k0, Q, HD, XkT);
      stage_t(bi, N, k0, Q, N, BkT);
      stage_cum(ck, k0);
      __syncthreads();
      float m[4][4], dml[4][4], p[4][4];
      tiles(q0, k0, m, dml, p);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          rowp[a] += p[a][e];
          Ms[(tx * 4 + e) * kLd + ty * 4 + a] = dml[a][e];  // dML^T [k][q]
        }
      __syncthreads();
      // rows q = 4 ty + a: dC[q][n] += dML[q][k] B[k][n]
      for (int k = 0; k < BQ; ++k) {
        const float4 lv = *reinterpret_cast<const float4*>(Ms + k * kLd + ty * 4);
        const float l4[4] = {lv.x, lv.y, lv.z, lv.w};
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          const int n = tx + 16 * j;
          const float bv = n < N ? BkT[n * kLd + k] : 0.f;
#pragma unroll
          for (int a = 0; a < 4; ++a) dca[a][j] = fmaf(l4[a], bv, dca[a][j]);
        }
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float rs = sum16(rowp[a]);
      const int q = q0 + ty * 4 + a;
      if (q >= Q) continue;
      if (tx == 0) dcum_row[ih * Q + q] = rs;
#pragma unroll
      for (int j = 0; j < NB; ++j)
        if (tx + 16 * j < N) dc_part[(ih * Q + q) * N + tx + 16 * j] = dca[a][j];
    }
  }
}

// db, dc [BNC, Q, N] = the heads' partials summed in head order; dcum [BNC,
// H, Q] = dcum_row + dcum_col, and at q = Q - 1 the k blocks' last_part in
// tile order.  One thread per output element, the b and c elements first.
__global__ void __launch_bounds__(256)
ssd_bwd_reduce(const float* __restrict__ db_part, const float* __restrict__ dc_part,
               const float* __restrict__ dcum_row, const float* __restrict__ dcum_col,
               const float* __restrict__ last_part, float* __restrict__ db, float* __restrict__ dc,
               float* __restrict__ dcum, int BNC, int H, int Q, int N) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x;
  const int64_t qn = static_cast<int64_t>(Q) * N, nbc = BNC * qn;
  if (idx < nbc) {
    const int64_t i = idx / qn, r = idx - i * qn;
    float sb = 0.f, sc = 0.f;
    for (int h = 0; h < H; ++h) {
      sb += db_part[(i * H + h) * qn + r];
      sc += dc_part[(i * H + h) * qn + r];
    }
    db[idx] = sb;
    dc[idx] = sc;
  } else if (idx < nbc + static_cast<int64_t>(BNC) * H * Q) {
    const int64_t j = idx - nbc, ih = j / Q;
    float v = dcum_row[j] + dcum_col[j];
    if (j - ih * Q == Q - 1) {
      const int RT = (Q + BQ - 1) / BQ;
      for (int t = 0; t < RT; ++t) v += last_part[ih * RT + t];
    }
    dcum[j] = v;
  }
}

template <typename T, int HD>
cudaError_t launch(int NB, const void* x, const float* b, const float* c, const float* cum,
                   const void* dy, const float* dstate, void* dx, float* db_part, float* dc_part,
                   float* dcum_row, float* dcum_col, float* last_part, int BNC, int H, int Q,
                   int N, size_t smem, cudaStream_t stream) {
  const int RT = (Q + BQ - 1) / BQ;
  const dim3 grid(2 * RT, H, BNC);
  void* fn;
  switch (NB) {
    case 1: fn = reinterpret_cast<void*>(ssd_bwd_kernel<T, HD, 1>); break;
    case 4: fn = reinterpret_cast<void*>(ssd_bwd_kernel<T, HD, 4>); break;
    case 8: fn = reinterpret_cast<void*>(ssd_bwd_kernel<T, HD, 8>); break;
    default: return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const T* xp = static_cast<const T*>(x);
  const T* dyp = static_cast<const T*>(dy);
  T* dxp = static_cast<T*>(dx);
  void* args[] = {&xp, &b, &c, &cum, &dyp, &dstate, &dxp, &db_part, &dc_part, &dcum_row,
                  &dcum_col, &last_part, &H, &Q, &N};
  err = cudaLaunchKernel(fn, grid, dim3(kThreads), args, smem, stream);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace bwd

// Launch one route after checking that the plan computed in Python (heads
// per block, grid, shared-memory bytes) is the one it was written for.
template <typename T, int HD>
cudaError_t launch(const void* x, const float* b, const float* c, const float* cum, void* y,
                   float* state, int BNC, int H, int Q, int N, int heads_per_block, int grid_x,
                   int64_t smem, cudaStream_t stream) {
  constexpr bool kTc = sizeof(T) == 2;
  const int max_heads = kTc ? tc::kMaxHeads : cc::kMaxHeads;
  const int bns = kTc ? tc::BNS : cc::BNS;
  const size_t bytes = kTc ? tc::smem_bytes(HD) : cc::smem_bytes(HD);
  const int64_t want_x =
      static_cast<int64_t>((Q + BQ - 1) / BQ) * ((H + heads_per_block - 1) / heads_per_block) +
      static_cast<int64_t>(H) * ((N + bns - 1) / bns);
  if (heads_per_block < 1 || heads_per_block > max_heads || grid_x != want_x ||
      smem != static_cast<int64_t>(bytes))
    return cudaErrorInvalidConfiguration;
  const dim3 grid(grid_x, BNC);
  cudaError_t err;
  if constexpr (kTc) {
    auto kernel = tc::ssd_kernel<HD>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    kernel<<<grid, tc::kThreads, bytes, stream>>>(static_cast<const bf16*>(x), b, c, cum,
                                                  static_cast<bf16*>(y), state, H, Q, N,
                                                  heads_per_block);
  } else {
    auto kernel = cc::ssd_kernel<HD>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    kernel<<<grid, cc::kThreads, bytes, stream>>>(static_cast<const float*>(x), b, c, cum,
                                                  static_cast<float*>(y), state, H, Q, N,
                                                  heads_per_block);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int HD, const void* x, const float* b, const float* c, const float* cum,
                        void* y, float* state, int BNC, int H, int Q, int N, int hpb, int grid_x,
                        int64_t smem, cudaStream_t s) {
  switch (HD) {
    case 32: return launch<T, 32>(x, b, c, cum, y, state, BNC, H, Q, N, hpb, grid_x, smem, s);
    case 64: return launch<T, 64>(x, b, c, cum, y, state, BNC, H, Q, N, hpb, grid_x, smem, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype of x and y: 0 = float32, 1 = bfloat16.  x, y [BNC, H, Q, HD];
// b, c [BNC, Q, N], cum [BNC, H, Q] and state [BNC, H, HD, N] are f32; all
// contiguous.  heads_per_block, grid_x and smem are the launch plan of
// ssd_scan.py::launch_plan; one that does not match the route returns
// cudaErrorInvalidConfiguration.  Returns cudaGetLastError() after the launch.
extern "C" int ssd_intra_chunk_fwd(int dtype, int HD, const void* x, const float* b,
                                   const float* c, const float* cum, void* y, float* state,
                                   int BNC, int H, int Q, int N, int heads_per_block, int grid_x,
                                   int64_t smem, void* stream) {
  if (BNC <= 0 || H <= 0 || Q <= 0 || N <= 0 || BNC > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(dispatch_hd<float>(HD, x, b, c, cum, y, state, BNC, H, Q, N,
                                                 heads_per_block, grid_x, smem, s));
    case 1:
      return static_cast<int>(dispatch_hd<bf16>(HD, x, b, c, cum, y, state, BNC, H, Q, N,
                                                heads_per_block, grid_x, smem, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Backward, first launch: dx [BNC, H, Q, HD] in x's dtype (0 f32, 1 bf16;
// dy the same) and the f32 partials (see bwd::ssd_bwd_kernel); dstate
// [BNC, H, HD, N] f32 or null (zero).  grid_x, state_cols and smem are
// ssd_scan.py::bwd_plan's (2 row tiles; the N columns a thread's registers
// cover, 16, 64 or 128; the shared-memory bytes); any other returns
// cudaErrorInvalidConfiguration.  All contiguous.
extern "C" int ssd_intra_chunk_bwd(int dtype, int HD, const void* x, const float* b,
                                   const float* c, const float* cum, const void* dy,
                                   const float* dstate, void* dx, float* db_part, float* dc_part,
                                   float* dcum_row, float* dcum_col, float* last_part, int BNC,
                                   int H, int Q, int N, int grid_x, int state_cols, int64_t smem,
                                   void* stream) {
  if (BNC <= 0 || H <= 0 || Q <= 0 || N <= 0 || BNC > 65535 || H > 65535 || N > bwd::kMaxState)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nb = N <= 16 ? 1 : N <= 64 ? 4 : 8;
  const size_t bytes = 4 * bwd::smem_floats(HD, N);
  if (grid_x != 2 * ((Q + BQ - 1) / BQ) || state_cols != 16 * nb || smem != static_cast<int64_t>(bytes))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0 && HD == 32)
    err = bwd::launch<float, 32>(nb, x, b, c, cum, dy, dstate, dx, db_part, dc_part, dcum_row,
                                 dcum_col, last_part, BNC, H, Q, N, bytes, s);
  else if (dtype == 0 && HD == 64)
    err = bwd::launch<float, 64>(nb, x, b, c, cum, dy, dstate, dx, db_part, dc_part, dcum_row,
                                 dcum_col, last_part, BNC, H, Q, N, bytes, s);
  else if (dtype == 1 && HD == 32)
    err = bwd::launch<bf16, 32>(nb, x, b, c, cum, dy, dstate, dx, db_part, dc_part, dcum_row,
                                dcum_col, last_part, BNC, H, Q, N, bytes, s);
  else if (dtype == 1 && HD == 64)
    err = bwd::launch<bf16, 64>(nb, x, b, c, cum, dy, dstate, dx, db_part, dc_part, dcum_row,
                                dcum_col, last_part, BNC, H, Q, N, bytes, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// Backward, second launch: db, dc [BNC, Q, N] and dcum [BNC, H, Q], f32,
// from the first launch's partials; blocks of 256 threads, one thread per
// output element (blocks: ssd_scan.py::bwd_plan's).
extern "C" int ssd_intra_chunk_bwd_reduce(const float* db_part, const float* dc_part,
                                          const float* dcum_row, const float* dcum_col,
                                          const float* last_part, float* db, float* dc,
                                          float* dcum, int BNC, int H, int Q, int N, int64_t blocks,
                                          void* stream) {
  if (BNC <= 0 || H <= 0 || Q <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t outs = static_cast<int64_t>(BNC) * Q * N + static_cast<int64_t>(BNC) * H * Q;
  if (blocks != (outs + 255) / 256 || blocks > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  bwd::ssd_bwd_reduce<<<static_cast<unsigned>(blocks), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      db_part, dc_part, dcum_row, dcum_col, last_part, db, dc, dcum, BNC, H, Q, N);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
