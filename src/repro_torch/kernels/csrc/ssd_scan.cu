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
// sets the card's least time.  Both routes run it on the bf16 tensor cores
// (989 TFLOP/s) with the f32 operands split into bf16 pieces, so each
// product costs 3 (bf16 x) or 6 (f32 x) tensor-core products.
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
// The forward (namespace tc, 128 threads) runs every product on mma.sync
// m16n8k16 (bf16 inputs, f32 accumulator) with each f32 operand split into
// P bf16 pieces, piece p = bf16(what pieces 0..p-1 left), keeping the
// products of pieces i and j with i + j < P (tc::Pieces).  bf16 x ("mma"):
// P = 2 (hi = bf16(v), lo = bf16(v - hi), ~16 bits of mantissa together;
// products hi*hi + hi*lo + lo*hi) and x, which bf16 holds exactly, in one
// piece.  That keeps ~1e-5 relative error: the chunk state stays within its
// 1e-4 (chip_smoke.py and tests/test_torch_gpu.py hold it), and the decayed
// scores are far more precise than the bf16 rounding the JAX model gives
// them (repro/models/ssm.py:103-105).  f32 x ("mma3"): P = 3 for every
// operand, x included: three pieces hold an f32 value exactly, and the six
// products kept leave ~2^-24 relative error, as B8's f32 route; each
// k-step's six products are summed from zero, the smallest first, and added
// to the running sum in f32 (mma_route).  A y block
// computes the C B^T tile of its rows into mma accumulators, which hold it
// in exactly the layout of the A fragments of (C B^T o L) x, so each head
// of the group applies its decay and splits the scores in registers; the
// heads' x tiles and cum values arrive by cp.async while C B^T is being
// computed (f32 x as f32 rows, split into its pieces over the C and B
// slices once C B^T is done, so the f32 route's y blocks fit two an SM).  B
// and C are staged in 64-wide slices of N, split as they are stored.  State
// blocks stage x o exp(cum_last - cum) and B in 32-row slices, split the
// same way.
//
// Backward (namespace bwd; no TPU counterpart: the JAX package
// differentiates the plain scan).  Per (chunk, head), with G = C B^T,
// M = G o L, w_k = exp(cum_last - cum_k) and the gradients dy, dstate:
//   dM = dy x^T (lower triangle), dML = dM o L, P = dM o M;
//   dx = M^T dy + w o (B dstate^T);            (per head, in x's dtype)
//   dC = sum_h dML B;  dB = sum_h dML^T C + sum_h (x o w) dstate;
//   dcum_q = rowsum P - colsum P - w_q x_q.(dstate B_q), and dcum_last
//   also gets sum_k w_k x_k.(dstate B_k).
// Bound: operations, as the forward (about twice its products).  The function
// needs G, S = sum_h dML, dC = S B and dB's S^T C once per chunk, since B and C
// are shared by the heads; only dM, dx and the chunk-state terms per head.  So
// two launches.  The main one has a block per (head group, chunk, 64-column
// tile k), the longest tiles first.  It first adds the chunk-state terms (dx
// += (w o B) dstate^T; tw = w x.(dstate B); the group's (x o w) dstate for
// dB), then walks the row tiles q >= k: each G tile is computed once for the
// group and kept in shared memory, and per head dM, L (masked before exp, as
// in the forward), M, dML, P and dx += M^T dy run in registers, in the
// transposed layout [k][q], where M^T's mma accumulators are the A fragments
// of M^T dy as they lie.  P's column sums complete in the block; its row
// sums go out per warp.  The group's dML, summed in head order, goes to an
// f32 scratch [BNC, groups, Q, Q] (transposed; only the tiles q >= k are
// written), its (x o w) dstate to a [BNC, groups, Q, N] one.  The second
// launch has a block per 16 rows of dC or dB, whose two teams of warps take
// turns at its partner tiles: each copies the groups' tiles of S by cp.async,
// sums them in group order and multiplies, dC = S B and dB = S^T C plus the
// groups' chunk-state terms; dcum's parts are summed in a fixed order too (no
// atomics: two calls give the same bits).  Every product runs on mma.sync
// m16n8k16, each f32 operand split into bf16 pieces: for bf16 x two, as the
// forward's y blocks, with x and dy exact in one piece (dy x^T one product,
// M^T dy two, f32 x f32 three); for f32 x three pieces of every operand,
// which hold an f32 value exactly, and the six products i + j < 3, so the
// result keeps f32's precision.  B, C and dstate are staged in 64-wide
// slices of N, so shared memory does not grow with Q or N, and two main
// blocks fit an SM.  The big loops stay rolled: fully unrolled, the main
// kernel ran 6-27% slower at the LM shapes (PERF.md).  dstate may be absent
// (a sequence of one chunk): its terms are skipped.  N <= 128 (the reduce
// stages a partner tile's rows of B or C whole).
//
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int BQ = 64;  // rows q per y block; columns j per tile (both routes)

// --------------------------------------------------------------- forward --

namespace tc {

constexpr int kThreads = 128;  // 4 warps
constexpr int kMaxHeads = 2;   // heads per y block
constexpr int BNK = 64;        // slice of N per C B^T step
constexpr int BJ = 32;         // rows j per state slice
constexpr int BNS = 128;       // columns n per state block, 32 per warp
constexpr int kS = BNK + 8;    // row stride (bf16) of the C and B slices: 16 bytes of pad
constexpr int kBS = BNS + 8;   // row stride (bf16) of the state's B slice
constexpr int kPiece = BQ * kS;  // bf16 elements of one piece of a C or B slice

// The bf16 pieces an f32 operand (B, C, the decayed scores, x o w) is split into (P; of the
// products of pieces i and j those with i + j < P are kept) and those of x (PX).  bf16 x
// ("mma"): P = 2, x exact in one piece.  f32 x ("mma3"): three pieces hold an f32 value
// exactly and the six products kept leave ~2^-24 relative error, as f32 FMAs do.
template <typename T> struct Pieces;
template <> struct Pieces<bf16> { static constexpr int P = 2, PX = 1; };
template <> struct Pieces<float> { static constexpr int P = 3, PX = 3; };

// y role: the C and B slices [P][64][kS] each; the group's x, bf16 as its tiles [heads][64][HD + 8]
// (by cp.async), f32 as rows [heads][64][HD] (by cp.async) split after C B^T into three pieces
// [heads][3][64][HD + 8] laid over the C and B slices, which C B^T no longer needs; cum
// [heads][64].  State role: x o exp(cum_last - cum) and B slices [P][32][HD + 8] and [P][32][kBS].
template <typename T>
__host__ __device__ constexpr size_t smem_bytes(int HD) {
  constexpr int P = Pieces<T>::P;
  const size_t x_tiles = sizeof(T) == 2 ? 2 * kMaxHeads * BQ * (HD + 8) : 4 * kMaxHeads * BQ * HD;
  const size_t y_role = 2 * 2 * P * kPiece + x_tiles + 4 * kMaxHeads * BQ;
  const size_t state_role = 2 * P * BJ * (HD + 8 + kBS);
  return y_role > state_role ? y_role : state_role;
}
static_assert(kMaxHeads * 3 * BQ * (64 + 8) <= 2 * 3 * kPiece, "f32 x pieces fit over the slices");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 (or 4) bytes from global to shared memory, asynchronously; bytes = 0 writes
// zeros and reads nothing (src must still be a valid address).
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
// (v0, v1) as P bf16 pieces each: piece p = bf16(what pieces 0..p-1 left)
template <int P>
__device__ __forceinline__ void split(float v0, float v1, uint32_t (&out)[P]) {
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
    out[p] = *reinterpret_cast<const uint32_t*>(&h);
    const float2 f = __bfloat1622float2(h);
    v0 -= f.x;
    v1 -= f.y;
  }
}
// d += a b over the pieces (the n8 half of b's x4 registers), the larger products first
template <int P, int PA, int PB>
__device__ __forceinline__ void mma_pieces(float (&d)[4], const uint32_t (&a)[PA][4],
                                           const uint32_t (&b)[PB][4], int half) {
#pragma unroll
  for (int i = 0; i < PA; ++i)
#pragma unroll
    for (int j = 0; j < PB; ++j)
      if (i + j < P) mma_bf16(d, a[i], b[j][2 * half], b[j][2 * half + 1]);
}
// d += a b over the pieces as each route sums them.  bf16 x: mma_pieces into d.  f32 x: the
// tensor cores add a product into an f32 accumulator with truncation, which over a chunk's
// hundreds of products strayed ~4e-5 from f32's sum of y (an H100, PERF.md); so each k-step's
// six products start from zero, the smallest first (i + j = 2, then 1, then the hi hi
// product), and join d by an f32 add.
template <bool kF32, int P, int PA, int PB>
__device__ __forceinline__ void mma_route(float (&d)[4], const uint32_t (&a)[PA][4],
                                          const uint32_t (&b)[PB][4], int half) {
  if constexpr (!kF32) {
    mma_pieces<P, PA, PB>(d, a, b, half);
  } else {
    float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int sum = P - 1; sum >= 0; --sum)
#pragma unroll
      for (int i = 0; i <= sum; ++i)
        if (i < PA && sum - i < PB) mma_bf16(s, a[i], b[sum - i][2 * half], b[sum - i][2 * half + 1]);
#pragma unroll
    for (int e = 0; e < 4; ++e) d[e] += s[e];
  }
}
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
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
// matrix (ld elements, rows < R and columns < Cn valid) split into P bf16
// pieces with row stride ldt, piece p at dst + p * piece; zero outside.
template <int P, int nrows, int n4>
__device__ __forceinline__ void stage_split(const float* __restrict__ src, int64_t ld, int r0,
                                            int R, int c0, int Cn, bool vec, bf16* dst, int ldt,
                                            int piece) {
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
    uint32_t lo[P], hi[P];
    split<P>(v[0], v[1], lo);
    split<P>(v[2], v[3], hi);
#pragma unroll
    for (int p = 0; p < P; ++p)
      *reinterpret_cast<uint2*>(dst + p * piece + r * ldt + c) = make_uint2(lo[p], hi[p]);
  }
}

// y rows [q0, q0 + 64) of heads [h0, h0 + nh) of one chunk.  Warp w owns
// rows q0 + 16w .. q0 + 16w + 15.
template <typename T, int HD>
__device__ __forceinline__ void y_block(const T* __restrict__ xi, const float* __restrict__ bi,
                                        const float* __restrict__ ci,
                                        const float* __restrict__ cumi, T* __restrict__ yi,
                                        int Q, int N, int q0, int h0, int nh, bool vec_bc,
                                        bool vec_x, unsigned char* smem) {
  constexpr int P = Pieces<T>::P, PX = Pieces<T>::PX, kX = HD + 8;
  constexpr bool kF32 = sizeof(T) == 4;
  bf16* Cs = reinterpret_cast<bf16*>(smem);  // [P][BQ][kS] C rows q0.., one slice of N
  bf16* Bs = Cs + P * kPiece;                 // [P][BQ][kS] B rows j0.., the same slice
  // [kMaxHeads][PX][BQ][kX] x rows j0..: bf16 after the slices, f32 split over them
  bf16* Xs = kF32 ? Cs : Bs + P * kPiece;
  float* Xraw = reinterpret_cast<float*>(Bs + P * kPiece);  // f32: [kMaxHeads][BQ][HD] as loaded
  float* cjs = kF32 ? Xraw + kMaxHeads * BQ * HD
                    : reinterpret_cast<float*>(Xs + kMaxHeads * BQ * kX);  // [kMaxHeads][BQ]
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
      const T* xh = xi + static_cast<int64_t>(h0 + hh) * Q * HD;
      constexpr int kV = 16 / sizeof(T);  // elements of a 16-byte copy
      T* X = kF32 ? reinterpret_cast<T*>(Xraw + hh * BQ * HD) : reinterpret_cast<T*>(Xs + hh * BQ * kX);
      constexpr int kLd = kF32 ? HD : kX;
      for (int i = threadIdx.x; i < BQ * HD / kV; i += kThreads) {
        const int r = i / (HD / kV), c = (i % (HD / kV)) * kV;
        const bool ok = j0 + r < Q;
        const T* src = xh + static_cast<int64_t>(ok ? j0 + r : 0) * HD + c;
        if (vec_x) {
          cp_async16(X + r * kLd + c, src, ok ? 16 : 0);
        } else {
#pragma unroll
          for (int e = 0; e < kV; ++e) X[r * kLd + c + e] = ok ? src[e] : T(0.f);
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
      stage_split<P, BQ, BNK / 4>(ci, N, q0, Q, n0, N, vec_bc, Cs, kS, kPiece);
      stage_split<P, BQ, BNK / 4>(bi, N, j0, Q, n0, N, vec_bc, Bs, kS, kPiece);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BNK / 16; ++kk) {
        uint32_t cf[P][4];
#pragma unroll
        for (int p = 0; p < P; ++p)
          ldmatrix_x4(cf[p], Cs + p * kPiece + (warp * 16 + L.ar) * kS + kk * 16 + L.ac);
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) {
          uint32_t bf[P][4];
#pragma unroll
          for (int p = 0; p < P; ++p)
            ldmatrix_x4(bf[p], Bs + p * kPiece + (nj * 16 + L.kr) * kS + kk * 16 + L.kc);
          mma_route<kF32, P>(cb[2 * nj], cf, bf, 0);
          mma_route<kF32, P>(cb[2 * nj + 1], cf, bf, 1);
        }
      }
    }
    cp_async_wait_all();
    __syncthreads();  // x tiles and cum values are visible to every warp
    if constexpr (kF32) {  // f32 x into its three pieces, over the slices C B^T has consumed
      for (int hh = 0; hh < nh; ++hh)
        for (int i = threadIdx.x; i < BQ * HD / 4; i += kThreads) {
          const int r = i / (HD / 4), c = (i % (HD / 4)) * 4;
          const float4 v = *reinterpret_cast<const float4*>(Xraw + hh * BQ * HD + r * HD + c);
          uint32_t lo[P], hi[P];
          split<P>(v.x, v.y, lo);
          split<P>(v.z, v.w, hi);
#pragma unroll
          for (int p = 0; p < P; ++p)
            *reinterpret_cast<uint2*>(Xs + (hh * PX + p) * BQ * kX + r * kX + c) =
                make_uint2(lo[p], hi[p]);
        }
      __syncthreads();
    }

    // each head: S = C B^T o L in P bf16 pieces, y += S x
#pragma unroll
    for (int hh = 0; hh < kMaxHeads; ++hh) {
      if (hh >= nh) break;
      const float* cj = cjs + hh * BQ;
      const bf16* X = Xs + hh * PX * BQ * kX;
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        uint32_t a[P][4];
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
          uint32_t sp[P];
          split<P>(s0, s1, sp);
#pragma unroll
          for (int p = 0; p < P; ++p) a[p][f] = sp[p];
        }
#pragma unroll
        for (int dn = 0; dn < HD / 16; ++dn) {
          uint32_t xb[PX][4];
#pragma unroll
          for (int p = 0; p < PX; ++p)
            ldmatrix_x4_trans(xb[p], X + p * BQ * kX + (kk * 16 + L.ar) * kX + dn * 16 + L.ac);
          mma_route<kF32, P>(acc[hh][2 * dn], a, xb, 0);
          mma_route<kF32, P>(acc[hh][2 * dn + 1], a, xb, 1);
        }
      }
    }
  }

#pragma unroll
  for (int hh = 0; hh < kMaxHeads; ++hh) {
    if (hh >= nh) break;
    T* yh = yi + static_cast<int64_t>(h0 + hh) * Q * HD;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int q = q0 + r0 + 8 * half;
      if (q < Q) {
#pragma unroll
        for (int n = 0; n < HD / 8; ++n)
          store2(yh + static_cast<int64_t>(q) * HD + 8 * n + 2 * t, acc[hh][n][2 * half],
                 acc[hh][n][2 * half + 1]);
      }
    }
  }
}

// state columns [n0, n0 + BNS) of one (chunk, head): sum over all rows j.
// Warp w owns columns n0 + 32w .. n0 + 32w + 31 and all HD rows d.
template <typename T, int HD>
__device__ __forceinline__ void state_block(const T* __restrict__ xh,
                                            const float* __restrict__ bi,
                                            const float* __restrict__ cumh,
                                            float* __restrict__ sth, int Q, int N, int n0,
                                            bool vec_bc, unsigned char* smem) {
  constexpr int P = Pieces<T>::P, kXW = HD + 8, MT = HD / 16;
  constexpr bool kF32 = sizeof(T) == 4;
  bf16* XW = reinterpret_cast<bf16*>(smem);  // [P][BJ][kXW] x o exp(cum_last - cum), rows j0..
  bf16* Bs = XW + P * BJ * kXW;               // [P][BJ][kBS] B rows j0.., columns n0..
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
        const T* xr = xh + static_cast<int64_t>(j) * HD + d;
        v0 = to_float(xr[0]) * w;
        v1 = to_float(xr[1]) * w;
      }
      uint32_t s[P];
      split<P>(v0, v1, s);
#pragma unroll
      for (int p = 0; p < P; ++p) *reinterpret_cast<uint32_t*>(XW + p * BJ * kXW + r * kXW + d) = s[p];
    }
    stage_split<P, BJ, BNS / 4>(bi, N, j0, Q, n0, N, vec_bc, Bs, kBS, BJ * kBS);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BJ / 16; ++kk) {
      uint32_t ah[MT][P][4];  // A[d][j] from XW[j][d] through .trans
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int p = 0; p < P; ++p)
          ldmatrix_x4_trans(ah[m][p], XW + p * BJ * kXW + (kk * 16 + L.kr) * kXW + m * 16 + L.kc);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        uint32_t bh[P][4];
#pragma unroll
        for (int p = 0; p < P; ++p)
          ldmatrix_x4_trans(bh[p], Bs + p * BJ * kBS + (kk * 16 + L.ar) * kBS + warp * 32 + nj * 16 + L.ac);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          mma_route<kF32, P>(acc[m][2 * nj], ah[m], bh, 0);
          mma_route<kF32, P>(acc[m][2 * nj + 1], ah[m], bh, 1);
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
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ b, const float* __restrict__ c,
           const float* __restrict__ cum, T* __restrict__ y, float* __restrict__ state, int H,
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
    y_block<T, HD>(x + i * H * Q * HD, bi, ci, cum + i * H * Q, y + i * H * Q * HD, Q, N, q0, h0,
                   min(heads_per_block, H - h0), vec_bc, vec_x, smem);
  } else {
    const int n_tiles = (N + BNS - 1) / BNS;
    const int s = bx - y_blocks, h = s / n_tiles;
    const int64_t ih = i * H + h;
    state_block<T, HD>(x + ih * Q * HD, bi, cum + ih * Q, state + ih * HD * N, Q, N,
                       (s % n_tiles) * BNS, vec_bc, smem);
  }
}

}  // namespace tc


// ------------------------------------------------------------- backward --

namespace bwd {

using tc::cp_async16;
using tc::cp_async4;
using tc::cp_async_commit;
using tc::cp_async_wait_all;
using tc::Lanes;
using tc::ldmatrix_x4;
using tc::ldmatrix_x4_trans;
using tc::mma_bf16;
using tc::mma_pieces;
using tc::split;
using tc::store2;

constexpr int kThreads = 128;      // main blocks: warp w owns rows 16w.. of the k tile
constexpr int kRedThreads = 256;   // reduce blocks: two teams of 4 warps, each its own partners
constexpr int kTeam = 128;         // a team's warp w owns the 16-column groups w, w + 4 of N
constexpr int kMaxState = 128;
constexpr int BN = 64;             // slice of N per staging step
constexpr int RB = 16;             // output rows of a reduce block
constexpr int kS = BN + 8;         // row stride (bf16) of the 64-wide tiles: 16 bytes of pad
constexpr int kO = kMaxState + 8;  // row stride (bf16) of the reduce's B or C rows
constexpr int kTile = BQ * kS;     // bf16 elements of one piece of a [64][kS] tile

// The forward's pieces (tc::Pieces: P of every f32 operand, PX of x and dy) and the heads a main
// block takes at most: two on bf16 x, one on f32 x, whose three-piece x and dy tiles fill shared
// memory.
template <typename T> struct Route;
template <> struct Route<bf16> : tc::Pieces<bf16> { static constexpr int kMaxHeads = 2; };
template <> struct Route<float> : tc::Pieces<float> { static constexpr int kMaxHeads = 1; };

// main: B and C slices [P][64][kS]; the group's x and dy tiles [kMaxHeads][PX][64][HD + 8];
// cum [kMaxHeads][64]
template <typename T, int HD>
__host__ __device__ constexpr size_t main_smem_bytes() {
  return 2 * (2 * Route<T>::P * kTile + 2 * Route<T>::kMaxHeads * Route<T>::PX * BQ * (HD + 8)) +
         4 * Route<T>::kMaxHeads * BQ;
}
// reduce, for each of its two teams: S rows [P][16][kS], the partner tile's B or C rows
// [P][64][kO], and a batch of the head groups' f32 tiles
constexpr int kStage = 13 * RB * BQ;  // floats: 13 groups' [16][64] tiles of S (hymba's 25 in two)
template <int P>
__host__ __device__ constexpr size_t reduce_team_bytes() {
  return 2 * P * (RB * kS + BQ * kO) + 4 * kStage;
}
template <int P>
__host__ __device__ constexpr size_t reduce_smem_bytes() {
  return 2 * reduce_team_bytes<P>();
}

__device__ __forceinline__ float2 to_f2(uint32_t r) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r));
}

// An A fragment (its PA pieces add up to the f32 values) with rows g and g + 8 scaled by w[0]
// and w[1], in P pieces.
template <int PA, int P>
__device__ __forceinline__ void scale_rows(const uint32_t (&a)[PA][4], const float (&w)[2],
                                           uint32_t (&out)[P][4]) {
#pragma unroll
  for (int f = 0; f < 4; ++f) {  // register f: row g + 8 (f % 2)
    float2 v = make_float2(0.f, 0.f);
#pragma unroll
    for (int p = 0; p < PA; ++p) {
      const float2 u = to_f2(a[p][f]);
      v.x += u.x;
      v.y += u.y;
    }
    uint32_t s[P];
    split<P>(v.x * w[f & 1], v.y * w[f & 1], s);
#pragma unroll
    for (int p = 0; p < P; ++p) out[p][f] = s[p];
  }
}

// Rows [r0, r0 + rows) x columns [c0, c0 + 4 cols4) of a row-major f32 matrix (ld elements; rows
// < R and columns < Cn valid, zero outside).  vec: 16-byte loads (Cn % 4 == 0, an aligned base).
struct Tile {
  const float* src;
  int64_t ld;
  int r0, R, c0, Cn, rows, cols4;
  bool vec;
};

// The share of a tile of thread `tid` of a team of NT, float4 it of it being number tid + it NT
// (rows x cols4 <= kItems NT): every load is issued before any is used, so a tile costs one trip
// to memory.
template <int NT, int kItems>
__device__ __forceinline__ void load_f32(const Tile& s, float4 (&v)[kItems], int tid) {
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int idx = tid + it * NT, r = idx / s.cols4, c = (idx - r * s.cols4) * 4;
    v[it] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (idx >= s.rows * s.cols4 || s.r0 + r >= s.R) continue;
    const float* p = s.src + static_cast<int64_t>(s.r0 + r) * s.ld + s.c0 + c;
    if (s.vec) {
      if (s.c0 + c < s.Cn) v[it] = *reinterpret_cast<const float4*>(p);
    } else {
      const int n = s.Cn - s.c0 - c;
      v[it] = make_float4(n > 0 ? p[0] : 0.f, n > 1 ? p[1] : 0.f, n > 2 ? p[2] : 0.f,
                          n > 3 ? p[3] : 0.f);
    }
  }
}
// ... then split into P bf16 pieces of row stride ldt, piece p at dst + p * piece
template <int P, int NT, int kItems>
__device__ __forceinline__ void store_split(const Tile& s, const float4 (&v)[kItems], bf16* dst,
                                            int ldt, int piece, int tid) {
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int idx = tid + it * NT, r = idx / s.cols4, c = (idx - r * s.cols4) * 4;
    if (idx >= s.rows * s.cols4) break;
    uint32_t lo[P], hi[P];
    split<P>(v[it].x, v[it].y, lo);
    split<P>(v[it].z, v[it].w, hi);
#pragma unroll
    for (int p = 0; p < P; ++p)
      *reinterpret_cast<uint2*>(dst + p * piece + r * ldt + c) = make_uint2(lo[p], hi[p]);
  }
}
template <int P, int NT, int kItems>
__device__ __forceinline__ void stage_f32(const Tile& s, bf16* dst, int ldt, int piece) {
  float4 v[kItems];
  load_f32<NT>(s, v, threadIdx.x);
  store_split<P, NT>(s, v, dst, ldt, piece, threadIdx.x);
}

// rows [r0, r0 + 64) of one head's x or dy [Q][HD] into its pieces [64][HD + 8], zero past Q:
// bf16 by cp.async (the caller commits and waits), f32 split into three pieces.
template <int HD>
__device__ __forceinline__ void stage_x(const bf16* __restrict__ src, int r0, int Q, bool vec,
                                        bf16* dst) {
  constexpr int kX = HD + 8;
  for (int idx = threadIdx.x; idx < BQ * HD / 8; idx += kThreads) {
    const int r = idx / (HD / 8), c = (idx % (HD / 8)) * 8;
    const bool ok = r0 + r < Q;
    const bf16* s = src + static_cast<int64_t>(ok ? r0 + r : 0) * HD + c;
    if (vec) {
      cp_async16(dst + r * kX + c, s, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) dst[r * kX + c + e] = ok ? s[e] : __float2bfloat16(0.f);
    }
  }
}
template <int HD>
__device__ __forceinline__ void stage_x(const float* __restrict__ src, int r0, int Q, bool vec,
                                        bf16* dst) {
  stage_f32<3, kThreads, BQ * HD / 4 / kThreads>(Tile{src, HD, r0, Q, 0, HD, BQ, HD / 4, vec}, dst,
                                                 HD + 8, BQ * (HD + 8));
}

constexpr int kSum = BQ + 8;  // row stride (f32) of the G tile in shared memory

// mma accumulators v[n][e] (row r0 + 8 (e / 2), column 8 n + 2 t + e % 2 of a [64][64] tile)
// to the f32 tile at dst (row stride ld), columns < ncols.
__device__ __forceinline__ void put_tile(const float (&v)[8][4], float* dst, int64_t ld, int r0,
                                         int t, int ncols) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int col = 8 * n + 2 * t;
      float* d = dst + (r0 + 8 * hr) * ld + col;
      if (col + 1 < ncols && (ld & 1) == 0) {
        *reinterpret_cast<float2*>(d) = make_float2(v[n][2 * hr], v[n][2 * hr + 1]);
      } else {
        if (col < ncols) d[0] = v[n][2 * hr];
        if (col + 1 < ncols) d[1] = v[n][2 * hr + 1];
      }
    }
}

// Main launch, grid (groups, BNC, row tiles): the block of (head group, chunk i, k tile kt)
// walks the q tiles >= kt.  Per q tile it computes G^T = B_k
// C_q^T once for the group, then per head dM^T = x_k dy_q^T and, in registers, L^T, M^T = G^T o
// L^T, dML^T = dM^T o L^T and P^T = dML^T o G^T; dx_k += M^T dy_q (M^T's accumulators are the A
// fragments as they lie); the column sums of P complete in the block, the row sums go out per
// warp.  It sums the group's dML^T in head order and stores each tile; the chunk-state terms, w o
// (B dstate^T) into dx, w x.(dstate B) into dcum and the group's (x o w) dstate for dB, come first.
// Outputs: dx; st [BNC, groups, RQ, RQ] (S^T [k][q], the tiles q >= k) and dbs [BNC, groups, RQ,
// N]; rowp [BNC, H, 4 RT, Q];
// dcol = -colsum P - tw [BNC, H, Q] with tw = w x.(dstate B); twp [BNC, H, 4 RT], each warp's
// sum of tw.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 2)
ssd_bwd_main(const T* __restrict__ x, const float* __restrict__ b, const float* __restrict__ c,
             const float* __restrict__ cum, const T* __restrict__ dy,
             const float* __restrict__ dstate, T* __restrict__ dx, float* __restrict__ st,
             float* __restrict__ dbs, float* __restrict__ rowp, float* __restrict__ dcol,
             float* __restrict__ twp, int H, int Q, int N, int G) {
  using R = Route<T>;
  constexpr int P = R::P, PX = R::PX, MH = R::kMaxHeads, kX = HD + 8, XP = BQ * kX, DT = HD / 8;
  constexpr int kIt = BQ * BN / 4 / kThreads;  // float4 of one [64][64] slice a thread stages
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Bs = reinterpret_cast<bf16*>(smem);  // [P][64][kS] B rows k0.., one slice of N
  bf16* Cs = Bs + P * kTile;                 // [P][64][kS] C rows q0.. (later dstate rows d)
  bf16* Xs = Cs + P * kTile;                 // [MH][PX][64][kX] x rows k0.. of the group's heads
  bf16* Ys = Xs + MH * PX * XP;              // [MH][PX][64][kX] dy rows q0..
  float* cqs = reinterpret_cast<float*>(Ys + MH * PX * XP);  // [MH][64] cum of rows q0..
  // C's tiles, once C is consumed: the f32 tile [64][kSum] of G^T
  float* tile = reinterpret_cast<float*>(Cs);
  static_assert(P * kTile * 2 >= BQ * kSum * 4, "an f32 tile fits C's tiles");

  const int grp = blockIdx.x, i = blockIdx.y, kt = blockIdx.z;
  const int groups = gridDim.x, RT = gridDim.z, RQ = RT * BQ;
  const int k0 = kt * BQ, h0 = grp * G, nh = min(G, H - h0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const Lanes L(lane);
  const int r0 = warp * 16 + g;  // this thread's rows r0 and r0 + 8 of the k tile
  const float* bi = b + static_cast<int64_t>(i) * Q * N;
  const float* ci = c + static_cast<int64_t>(i) * Q * N;
  const bool vec_bc = N % 4 == 0 && ((reinterpret_cast<uintptr_t>(b) |
                                       reinterpret_cast<uintptr_t>(c)) & 15) == 0;
  const bool vec_x = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(dy)) & 15) == 0;
  const int64_t ih0 = static_cast<int64_t>(i) * H + h0;
  // the group's sums of dM^T o L^T and of (x o w) dstate, in the scratch
  float* s_out = st + (static_cast<int64_t>(i) * groups + grp) * RQ * RQ;
  float* d_out = dbs + (static_cast<int64_t>(i) * groups + grp) * RQ * N;
  // rows r of b or c, columns [n0, n0 + 64) of N in 16-column steps
  auto slice = [&](const float* m, int r, int n0) {
    return Tile{m, N, r, Q, n0, N, BQ, 4 * ((min(BN, N - n0) + 15) / 16), vec_bc};
  };

  float ck[MH][2], wk[MH][2];  // cum and w = exp(cum_last - cum) of the thread's rows
#pragma unroll
  for (int hh = 0; hh < MH; ++hh) {
    const float* cumh = cum + (ih0 + min(hh, nh - 1)) * Q;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int k = k0 + r0 + 8 * e;
      ck[hh][e] = k < Q ? cumh[k] : 0.f;
      wk[hh][e] = k < Q ? expf(cumh[Q - 1] - cumh[k]) : 0.f;
    }
  }
  for (int hh = 0; hh < nh; ++hh)
    stage_x<HD>(x + (ih0 + hh) * Q * HD, k0, Q, vec_x, Xs + hh * PX * XP);
  cp_async_commit();

  float dxa[MH][DT][4], colp[MH][2], twv[MH][2];  // twv: w x.(dstate B) of the thread's rows
#pragma unroll
  for (int hh = 0; hh < MH; ++hh) {
    colp[hh][0] = colp[hh][1] = twv[hh][0] = twv[hh][1] = 0.f;
#pragma unroll
    for (int n = 0; n < DT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dxa[hh][n][e] = 0.f;
  }

  // The chunk-state terms first, while x flies: per slice of N, dx += (w o B) dstate^T and the
  // group's (x o w) dstate, dh per head, whose row dot with B is tw = w x.(dstate B).  Head 0's
  // dstate slice goes to C's tiles, head 1's to dy's, each [P][HD][kS].
  if (dstate != nullptr) {
    static_assert(MH == 1 || MH * PX * XP >= P * HD * kS, "head 1's dstate fits dy's tiles");
    const bool vec_ds = N % 4 == 0 && (reinterpret_cast<uintptr_t>(dstate) & 15) == 0;
    for (int n0 = 0; n0 < N; n0 += BN) {
      const int ncols = min(BN, N - n0), ksteps = (ncols + 15) / 16;
      float4 vb[kIt], vd[MH][kIt];
      load_f32<kThreads>(slice(bi, k0, n0), vb, threadIdx.x);
#pragma unroll
      for (int hh = 0; hh < MH; ++hh)
        if (hh < nh)
          load_f32<kThreads>(Tile{dstate + (ih0 + hh) * HD * N, N, 0, HD, n0, N, HD, 4 * ksteps,
                                  vec_ds}, vd[hh], threadIdx.x);
      if (n0 > 0) __syncthreads();  // the previous slice is consumed
      store_split<P, kThreads>(slice(bi, k0, n0), vb, Bs, kS, kTile, threadIdx.x);
#pragma unroll
      for (int hh = 0; hh < MH; ++hh)
        if (hh < nh)
          store_split<P, kThreads>(Tile{nullptr, N, 0, HD, n0, N, HD, 4 * ksteps, vec_ds}, vd[hh],
                                   hh == 0 ? Cs : Ys, kS, HD * kS, threadIdx.x);
      cp_async_wait_all();
      __syncthreads();  // B, dstate and x are visible to every warp
      float da[8][4];   // the group's (x o w) dstate: rows r0 (+ 8), columns n0 + 8 n + 2 t (+ 1)
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) da[n][e] = 0.f;
#pragma unroll
      for (int hh = 0; hh < MH; ++hh) {
        if (hh >= nh) break;
        const bf16* D = hh == 0 ? Cs : Ys;  // dstate [d][n]
        const bf16* X = Xs + hh * PX * XP;
#pragma unroll 1
        for (int kk = 0; kk < ksteps; ++kk) {  // dx += (w o B) dstate^T, over this slice's n
          uint32_t a[P][4], aw[P][4];
#pragma unroll
          for (int p = 0; p < P; ++p)
            ldmatrix_x4(a[p], Bs + p * kTile + (warp * 16 + L.ar) * kS + kk * 16 + L.ac);
          scale_rows<P, P>(a, wk[hh], aw);
#pragma unroll
          for (int dn = 0; dn < HD / 16; ++dn) {
            uint32_t sb[P][4];
#pragma unroll
            for (int p = 0; p < P; ++p)
              ldmatrix_x4(sb[p], D + p * HD * kS + (dn * 16 + L.kr) * kS + kk * 16 + L.kc);
            mma_pieces<P>(dxa[hh][2 * dn], aw, sb, 0);
            mma_pieces<P>(dxa[hh][2 * dn + 1], aw, sb, 1);
          }
        }
        float dh[8][4];  // this head's (x o w) dstate
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) dh[n][e] = 0.f;
#pragma unroll 1
        for (int ks = 0; ks < HD / 16; ++ks) {
          uint32_t xa[PX][4], aw[P][4];
#pragma unroll
          for (int p = 0; p < PX; ++p)
            ldmatrix_x4(xa[p], X + p * XP + (warp * 16 + L.ar) * kX + ks * 16 + L.ac);
          scale_rows<PX, P>(xa, wk[hh], aw);
#pragma unroll
          for (int nj = 0; nj < BN / 16; ++nj) {
            if (nj >= ksteps) break;
            uint32_t sb[P][4];
#pragma unroll
            for (int p = 0; p < P; ++p)
              ldmatrix_x4_trans(sb[p], D + p * HD * kS + (ks * 16 + L.ar) * kS + nj * 16 + L.ac);
            mma_pieces<P>(dh[2 * nj], aw, sb, 0);
            mma_pieces<P>(dh[2 * nj + 1], aw, sb, 1);
          }
        }
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          if (n >= 2 * ksteps) break;  // columns this slice did not stage
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {  // B from its pieces at the thread's two columns
            float2 bv = make_float2(0.f, 0.f);
#pragma unroll
            for (int p = 0; p < P; ++p) {
              const float2 u = to_f2(*reinterpret_cast<const uint32_t*>(
                  Bs + p * kTile + (r0 + 8 * hr) * kS + 8 * n + 2 * t));
              bv.x += u.x;
              bv.y += u.y;
            }
            twv[hh][hr] = fmaf(bv.y, dh[n][2 * hr + 1], fmaf(bv.x, dh[n][2 * hr], twv[hh][hr]));
            da[n][2 * hr] += dh[n][2 * hr];
            da[n][2 * hr + 1] += dh[n][2 * hr + 1];
          }
        }
      }
      put_tile(da, d_out + static_cast<int64_t>(k0) * N + n0, N, r0, t, ncols);
    }
#pragma unroll
    for (int hh = 0; hh < MH; ++hh)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {  // over the row's columns: the 4 lanes of one g
        twv[hh][hr] += __shfl_xor_sync(0xffffffffu, twv[hh][hr], 1);
        twv[hh][hr] += __shfl_xor_sync(0xffffffffu, twv[hh][hr], 2);
      }
  }

  for (int q0 = k0; q0 < Q; q0 += BQ) {
    __syncthreads();  // every warp is done with the previous tile's C, dy and cum
    for (int hh = 0; hh < nh; ++hh) {
      stage_x<HD>(dy + (ih0 + hh) * Q * HD, q0, Q, vec_x, Ys + hh * PX * XP);
      if (threadIdx.x < BQ) {
        const bool ok = q0 + threadIdx.x < Q;
        cp_async4(cqs + hh * BQ + threadIdx.x, cum + (ih0 + hh) * Q + (ok ? q0 + threadIdx.x : 0),
                  ok ? 4 : 0);
      }
    }
    cp_async_commit();

    // G^T = B_k C_q^T: gt[n][e] is row r0 + 8 (e / 2), column q0 + 8 n + 2 t + e % 2
    float gt[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) gt[n][e] = 0.f;
    const int slices = (N + BN - 1) / BN;
    const bool stage_b = N > BN || q0 == k0;  // one slice of B serves every q tile
    float4 vb[kIt], vc[kIt];
    if (stage_b) load_f32<kThreads>(slice(bi, k0, 0), vb, threadIdx.x);
    load_f32<kThreads>(slice(ci, q0, 0), vc, threadIdx.x);
    for (int sl = 0; sl < slices; ++sl) {
      const int n0 = sl * BN, ksteps = (min(BN, N - n0) + 15) / 16;
      if (sl > 0) __syncthreads();  // the previous slice is consumed
      if (stage_b) store_split<P, kThreads>(slice(bi, k0, n0), vb, Bs, kS, kTile, threadIdx.x);
      store_split<P, kThreads>(slice(ci, q0, n0), vc, Cs, kS, kTile, threadIdx.x);
      __syncthreads();
      if (sl + 1 < slices) {  // the next slice flies while this one is multiplied
        load_f32<kThreads>(slice(bi, k0, n0 + BN), vb, threadIdx.x);
        load_f32<kThreads>(slice(ci, q0, n0 + BN), vc, threadIdx.x);
      }
#pragma unroll 1
      for (int kk = 0; kk < ksteps; ++kk) {
        uint32_t a[P][4];
#pragma unroll
        for (int p = 0; p < P; ++p)
          ldmatrix_x4(a[p], Bs + p * kTile + (warp * 16 + L.ar) * kS + kk * 16 + L.ac);
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) {
          uint32_t bq[P][4];
#pragma unroll
          for (int p = 0; p < P; ++p)
            ldmatrix_x4(bq[p], Cs + p * kTile + (nj * 16 + L.kr) * kS + kk * 16 + L.kc);
          mma_pieces<P>(gt[2 * nj], a, bq, 0);
          mma_pieces<P>(gt[2 * nj + 1], a, bq, 1);
        }
      }
    }
    cp_async_wait_all();
    __syncthreads();  // dy and cum are visible to every warp; every warp is done with C
    put_tile(gt, tile, kSum, r0, t, BQ);  // each thread reads back only its own elements

#pragma unroll 1  // rolled, as the other big loops: unrolled, the kernel ran slower
    for (int kk = 0; kk < BQ / 16; ++kk) {  // columns q0 + 16 kk .. + 15
      float gc[2][4], sc[2][4];  // G^T and the group's dM^T o L^T there, as accumulators
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const float2 v = *reinterpret_cast<const float2*>(tile + (r0 + 8 * hr) * kSum +
                                                            kk * 16 + 8 * j + 2 * t);
          gc[j][2 * hr] = v.x;
          gc[j][2 * hr + 1] = v.y;
          sc[j][2 * hr] = sc[j][2 * hr + 1] = 0.f;
        }
#pragma unroll
      for (int hh = 0; hh < MH; ++hh) {
        if (hh >= nh) break;
        const bf16* X = Xs + hh * PX * XP;
        const bf16* Y = Ys + hh * PX * XP;
        const float* cq = cqs + hh * BQ;
        float dm[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int ks = 0; ks < HD / 16; ++ks) {
          uint32_t a[PX][4], yb[PX][4];
#pragma unroll
          for (int p = 0; p < PX; ++p) {
            ldmatrix_x4(a[p], X + p * XP + (warp * 16 + L.ar) * kX + ks * 16 + L.ac);
            ldmatrix_x4(yb[p], Y + p * XP + (kk * 16 + L.kr) * kX + ks * 16 + L.kc);
          }
          mma_pieces<P>(dm[0], a, yb, 0);
          mma_pieces<P>(dm[1], a, yb, 1);
        }
        uint32_t am[P][4];  // M^T in pieces, as A fragments
        float cs[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // P's column sums over the thread's two rows
#pragma unroll
        for (int f = 0; f < 4; ++f) {  // A register f: row r0 + 8 (f % 2), columns + 8 (f / 2)
          const int j = f >> 1, hr = f & 1, e = 2 * hr;
          const int col = kk * 16 + 8 * j + 2 * t, q = q0 + col, k = k0 + r0 + 8 * hr;
          const float2 cqv = *reinterpret_cast<const float2*>(cq + col);
          // exp only where q >= k (both inside the chunk)
          const float l0 = (q >= k && q < Q) ? __expf(cqv.x - ck[hh][hr]) : 0.f;
          const float l1 = (q + 1 >= k && q + 1 < Q) ? __expf(cqv.y - ck[hh][hr]) : 0.f;
          const float d0 = dm[j][e] * l0, d1 = dm[j][e + 1] * l1;
          const float p0 = d0 * gc[j][e], p1 = d1 * gc[j][e + 1];
          sc[j][e] += d0;
          sc[j][e + 1] += d1;
          colp[hh][hr] += p0 + p1;
          cs[j][0] += p0;
          cs[j][1] += p1;
          uint32_t sp[P];
          split<P>(gc[j][e] * l0, gc[j][e + 1] * l1, sp);
#pragma unroll
          for (int p = 0; p < P; ++p) am[p][f] = sp[p];
        }
        {  // over the warp's 16 rows (the 8 lanes of one t), scattered: lanes g, g ^ 1 end
           // with column 8 (g / 4) + 2 t + (g / 2) % 2 of the chunk
          const bool hi = g & 4, mid = g & 2;
          const float s0 = __shfl_xor_sync(0xffffffffu, hi ? cs[0][0] : cs[1][0], 16);
          const float s1 = __shfl_xor_sync(0xffffffffu, hi ? cs[0][1] : cs[1][1], 16);
          const float a0 = (hi ? cs[1][0] : cs[0][0]) + s0, a1 = (hi ? cs[1][1] : cs[0][1]) + s1;
          float v = (mid ? a1 : a0) + __shfl_xor_sync(0xffffffffu, mid ? a0 : a1, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          const int q = q0 + kk * 16 + (hi ? 8 : 0) + 2 * t + (mid ? 1 : 0);
          if (!(g & 1) && q < Q) rowp[((ih0 + hh) * 4 * RT + kt * 4 + warp) * Q + q] = v;
        }
#pragma unroll
        for (int dn = 0; dn < HD / 16; ++dn) {
          uint32_t yb[PX][4];
#pragma unroll
          for (int p = 0; p < PX; ++p)
            ldmatrix_x4_trans(yb[p], Y + p * XP + (kk * 16 + L.ar) * kX + dn * 16 + L.ac);
          mma_pieces<P>(dxa[hh][2 * dn], am, yb, 0);
          mma_pieces<P>(dxa[hh][2 * dn + 1], am, yb, 1);
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
          *reinterpret_cast<float2*>(s_out + static_cast<int64_t>(k0 + r0 + 8 * hr) * RQ + q0 +
                                     kk * 16 + 8 * j + 2 * t) =
              make_float2(sc[j][2 * hr], sc[j][2 * hr + 1]);
    }
  }
#pragma unroll
  for (int hh = 0; hh < MH; ++hh)
#pragma unroll
    for (int e = 0; e < 2; ++e) {  // over the row's columns of every q tile: the 4 lanes of one g
      colp[hh][e] += __shfl_xor_sync(0xffffffffu, colp[hh][e], 1);
      colp[hh][e] += __shfl_xor_sync(0xffffffffu, colp[hh][e], 2);
    }

#pragma unroll
  for (int hh = 0; hh < MH; ++hh) {
    if (hh >= nh) break;
    const int64_t ih = ih0 + hh;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int k = k0 + r0 + 8 * hr;
      if (k >= Q) continue;
      T* dxr = dx + (ih * Q + k) * HD + 2 * t;
#pragma unroll
      for (int n = 0; n < DT; ++n)
        store2(dxr + 8 * n, dxa[hh][n][2 * hr], dxa[hh][n][2 * hr + 1]);
      if (t == 0) dcol[ih * Q + k] = -colp[hh][hr] - twv[hh][hr];
    }
    float tws = twv[hh][0] + twv[hh][1];  // over the warp's 16 rows (zero past Q)
    tws += __shfl_xor_sync(0xffffffffu, tws, 4);
    tws += __shfl_xor_sync(0xffffffffu, tws, 8);
    tws += __shfl_xor_sync(0xffffffffu, tws, 16);
    if (lane == 0) twp[ih * 4 * RT + kt * 4 + warp] = tws;
  }
}

// Reduce launch, grid (RQ / 16, 2, BNC): a role-0 block owns 16 rows q of dc, a role-1 block 16
// rows k of db and those rows of dcum for every head.  Its partner tiles (k <= q for dc, q >= k
// for db) are shared out between two teams of 4 warps, each with its own shared memory and
// barrier: for each partner a team copies the head groups' tiles of S^T by cp.async, up to 12
// groups a batch (the partner's rows of B or C fly beside the first batch), sums them in group
// order, splits S into pieces and multiplies: dc = S B, db = S^T C.  Team 0 then adds team 1's
// sums (in that order) and, for db, the groups' (x o w) dstate, staged the same way, while
// team 1 sums dcum.
template <int P>
__global__ void __launch_bounds__(kRedThreads)
ssd_bwd_reduce(const float* __restrict__ st, const float* __restrict__ dbs,
               const float* __restrict__ b, const float* __restrict__ c,
               const float* __restrict__ rowp, const float* __restrict__ dcol,
               const float* __restrict__ twp, float* __restrict__ db, float* __restrict__ dc,
               float* __restrict__ dcum, int H, int Q, int N, int groups) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int team = threadIdx.x / kTeam, tid = threadIdx.x % kTeam;
  bf16* As = reinterpret_cast<bf16*>(smem + team * reduce_team_bytes<P>());  // [P][16][kS]
  bf16* Os = As + P * RB * kS;                             // [P][64][kO] the partner's B or C rows
  float* Sg = reinterpret_cast<float*>(Os + P * BQ * kO);  // [kStage] a batch of the groups' tiles
  const int role = blockIdx.y, i = blockIdx.z;
  const int RT = (Q + BQ - 1) / BQ, RQ = RT * BQ, m0 = blockIdx.x * RB, tile = m0 / BQ;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const Lanes L(lane);
  const int nj_end = (N + 15) / 16;
  const float* opnd = (role == 0 ? b : c) + static_cast<int64_t>(i) * Q * N;
  const bool vec = N % 4 == 0 && ((reinterpret_cast<uintptr_t>(b) |
                                    reinterpret_cast<uintptr_t>(c)) & 15) == 0;
  const int64_t gstride = static_cast<int64_t>(RQ) * RQ;
  const float* sti = st + static_cast<int64_t>(i) * groups * gstride;
  constexpr int kOIt = BQ * kMaxState / 4 / kTeam, kSIt = RB * BQ / 4 / kTeam;
  constexpr int kTileF4 = RB * BQ / 4;  // float4 of one group's [16][64] tile
  constexpr int kBatch = kStage / (RB * BQ);
  // the scratch holds S^T [k][q]: role 0 reads rows k of the partner, columns q m0..; role 1 rows
  // k m0.., columns q of the partner.  float4 f of a group's tile: row, first column.
  auto s_row = [&](int f) { return role == 0 ? f >> 2 : f >> 4; };
  auto s_col = [&](int f) { return role == 0 ? (f & 3) * 4 : (f & 15) * 4; };
  auto team_sync = [&]() {  // barrier 1 + team over the team's threads
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + team), "n"(kTeam) : "memory");
  };

  float acc[2][2][4];  // 16-column groups warp + 4 jj of N, n8 halves
#pragma unroll
  for (int jj = 0; jj < 2; ++jj)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[jj][h][e] = 0.f;
  const int p_lo = role == 0 ? 0 : tile, p_hi = role == 0 ? tile : RT - 1;
  for (int pt = p_lo + team; pt <= p_hi; pt += 2) {
    const float* base = role == 0 ? sti + static_cast<int64_t>(pt * BQ) * RQ + m0
                                  : sti + static_cast<int64_t>(m0) * RQ + pt * BQ;
    const Tile to{opnd, N, pt * BQ, Q, 0, N, BQ, 4 * nj_end, vec};
    float4 vo[kOIt], sv[kSIt];
#pragma unroll
    for (int it = 0; it < kSIt; ++it) sv[it] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int g0 = 0; g0 < groups; g0 += kBatch) {
      const int nb = min(kBatch, groups - g0);
      team_sync();  // the previous batch (and partner tile) is consumed
      for (int f = tid; f < nb * kTileF4; f += kTeam) {
        const int gi = f / kTileF4, e = f - gi * kTileF4;
        cp_async16(Sg + 4 * f, base + (g0 + gi) * gstride + static_cast<int64_t>(s_row(e)) * RQ +
                                   s_col(e), 16);
      }
      cp_async_commit();
      if (g0 == 0) load_f32<kTeam>(to, vo, tid);  // flies beside the first batch
      cp_async_wait_all();
      team_sync();
      for (int gi = 0; gi < nb; ++gi)
#pragma unroll
        for (int it = 0; it < kSIt; ++it) {
          const float4 u =
              *reinterpret_cast<const float4*>(Sg + 4 * (gi * kTileF4 + tid + it * kTeam));
          sv[it].x += u.x; sv[it].y += u.y; sv[it].z += u.z; sv[it].w += u.w;
        }
    }
#pragma unroll
    for (int it = 0; it < kSIt; ++it) {
      const int f = tid + it * kTeam, r = s_row(f), col = s_col(f);
      uint32_t lo[P], hi[P];
      split<P>(sv[it].x, sv[it].y, lo);
      split<P>(sv[it].z, sv[it].w, hi);
      if (role == 0) {  // As[q][k]: four rows q, one column k
        unsigned short* a = reinterpret_cast<unsigned short*>(As);
#pragma unroll
        for (int p = 0; p < P; ++p) {
          unsigned short* ap = a + p * RB * kS + col * kS + r;
          ap[0] = static_cast<unsigned short>(lo[p] & 0xffffu);
          ap[kS] = static_cast<unsigned short>(lo[p] >> 16);
          ap[2 * kS] = static_cast<unsigned short>(hi[p] & 0xffffu);
          ap[3 * kS] = static_cast<unsigned short>(hi[p] >> 16);
        }
      } else {  // As[k][q]
#pragma unroll
        for (int p = 0; p < P; ++p)
          *reinterpret_cast<uint2*>(As + p * RB * kS + r * kS + col) = make_uint2(lo[p], hi[p]);
      }
    }
    store_split<P, kTeam>(to, vo, Os, kO, BQ * kO, tid);
    team_sync();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t a[P][4];
#pragma unroll
      for (int p = 0; p < P; ++p) ldmatrix_x4(a[p], As + p * RB * kS + L.ar * kS + kk * 16 + L.ac);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int nj = warp + 4 * jj;
        if (nj >= nj_end) break;
        uint32_t ob[P][4];
#pragma unroll
        for (int p = 0; p < P; ++p)
          ldmatrix_x4_trans(ob[p], Os + p * BQ * kO + (kk * 16 + L.ar) * kO + nj * 16 + L.ac);
        mma_pieces<P>(acc[jj][0], a, ob, 0);
        mma_pieces<P>(acc[jj][1], a, ob, 1);
      }
    }
  }
  // team 1's sums to team 0, through team 1's staging area
  float* xfer =
      reinterpret_cast<float*>(smem + reduce_team_bytes<P>() + 2 * P * (RB * kS + BQ * kO));
  __syncthreads();  // both teams are done with their partner tiles
  if (team == 1) {
#pragma unroll
    for (int e = 0; e < 16; ++e) xfer[e * kTeam + tid] = acc[e >> 3][(e >> 2) & 1][e & 3];
  }
  __syncthreads();
  if (team == 0) {
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[e >> 3][(e >> 2) & 1][e & 3] += xfer[e * kTeam + tid];
  }

  if (team == 0) {
    // db: the groups' chunk-state terms [16][N] a group, staged in batches, added in group order
    if (role == 1 && dbs != nullptr) {
      const float* dbi = dbs + (static_cast<int64_t>(i) * groups * RQ + m0) * N;
      const int per = RB * N, batch = kStage / per;  // floats of one group's rows; groups a batch
      const bool vec_d = N % 4 == 0 && (reinterpret_cast<uintptr_t>(dbs) & 15) == 0;
      for (int g0 = 0; g0 < groups; g0 += batch) {
        const int nb = min(batch, groups - g0);
        team_sync();  // the previous batch (or the last partner tile) is consumed
        for (int gi = 0; gi < nb; ++gi) {
          const float* src = dbi + (g0 + gi) * static_cast<int64_t>(RQ) * N;
          if (vec_d) {
            for (int e = 4 * tid; e < per; e += 4 * kTeam)
              cp_async16(Sg + gi * per + e, src + e, 16);
          } else {
            for (int e = tid; e < per; e += kTeam) cp_async4(Sg + gi * per + e, src + e, 4);
          }
        }
        cp_async_commit();
        cp_async_wait_all();
        team_sync();
        for (int gi = 0; gi < nb; ++gi)
#pragma unroll
          for (int jj = 0; jj < 2; ++jj)
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int col = (warp + 4 * jj) * 16 + 8 * h + 2 * t + (e & 1);
                if (col < N) acc[jj][h][e] += Sg[gi * per + (g + 8 * (e >> 1)) * N + col];
              }
      }
    }
    float* out = (role == 0 ? dc : db) + static_cast<int64_t>(i) * Q * N;
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int nj = warp + 4 * jj;
      if (nj >= nj_end) break;
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = m0 + g + 8 * (e >> 1), col = nj * 16 + 8 * h + 2 * t + (e & 1);
          if (row < Q && col < N) out[static_cast<int64_t>(row) * N + col] = acc[jj][h][e];
        }
    }
  } else if (role == 1) {
    // dcum rows m0.. of every head: the warps' row sums of P in order, then dcol, and at q = Q - 1
    // the warps' sums of tw; a thread sums kE elements at once, kP partials of each in flight
    constexpr int kE = 8, kP = 8;
    const int np = 4 * (tile + 1);  // the warps of k tiles 0..tile wrote rows q of this tile
    const float* rp = rowp + static_cast<int64_t>(i) * H * 4 * RT * Q;  // [H, 4 RT, Q] of chunk i
    for (int e0 = 0; e0 < H * RB; e0 += kE * kTeam) {
      float v[kE];
      int hq[kE], q[kE];  // the element's head (-1 where there is none) and row
#pragma unroll
      for (int j = 0; j < kE; ++j) {
        const int idx = e0 + j * kTeam + tid;
        q[j] = m0 + idx % RB;
        hq[j] = idx < H * RB && q[j] < Q ? idx / RB : -1;
        v[j] = 0.f;
      }
      for (int p0 = 0; p0 < np; p0 += kP) {
        float u[kE][kP];
#pragma unroll
        for (int j = 0; j < kE; ++j)
#pragma unroll
          for (int pp = 0; pp < kP; ++pp)
            if (hq[j] >= 0 && p0 + pp < np)
              u[j][pp] = rp[(static_cast<int64_t>(hq[j]) * 4 * RT + p0 + pp) * Q + q[j]];
#pragma unroll
        for (int j = 0; j < kE; ++j)
#pragma unroll
          for (int pp = 0; pp < kP; ++pp)
            if (hq[j] >= 0 && p0 + pp < np) v[j] += u[j][pp];
      }
#pragma unroll
      for (int j = 0; j < kE; ++j) {
        if (hq[j] < 0) continue;
        const int64_t ih = static_cast<int64_t>(i) * H + hq[j];
        v[j] += dcol[ih * Q + q[j]];
        if (q[j] == Q - 1)
          for (int p = 0; p < 4 * RT; ++p) v[j] += twp[ih * 4 * RT + p];
        dcum[ih * Q + q[j]] = v[j];
      }
    }
  }
}

template <typename T, int HD>
cudaError_t launch_main(const void* x, const float* b, const float* c, const float* cum,
                        const void* dy, const float* dstate, void* dx, float* st, float* dbs,
                        float* rowp, float* dcol, float* twp, int BNC, int H, int Q, int N, int G,
                        int groups, int64_t smem, cudaStream_t stream) {
  constexpr size_t bytes = main_smem_bytes<T, HD>();
  if (G < 1 || G > Route<T>::kMaxHeads || groups != (H + G - 1) / G ||
      smem != static_cast<int64_t>(bytes))
    return cudaErrorInvalidConfiguration;
  auto kernel = ssd_bwd_main<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(groups, BNC, (Q + BQ - 1) / BQ);
  kernel<<<grid, kThreads, bytes, stream>>>(static_cast<const T*>(x), b, c, cum,
                                            static_cast<const T*>(dy), dstate, static_cast<T*>(dx),
                                            st, dbs, rowp, dcol, twp, H, Q, N, G);
  return cudaGetLastError();
}

template <int P>
cudaError_t launch_reduce(const float* st, const float* dbs, const float* b, const float* c,
                          const float* rowp, const float* dcol, const float* twp, float* db,
                          float* dc, float* dcum, int BNC, int H, int Q, int N, int groups,
                          int64_t smem, cudaStream_t stream) {
  constexpr size_t bytes = reduce_smem_bytes<P>();
  if (smem != static_cast<int64_t>(bytes)) return cudaErrorInvalidConfiguration;
  auto kernel = ssd_bwd_reduce<P>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(((Q + BQ - 1) / BQ) * (BQ / RB), 2, BNC);
  kernel<<<grid, kRedThreads, bytes, stream>>>(st, dbs, b, c, rowp, dcol, twp, db, dc, dcum, H, Q,
                                               N, groups);
  return cudaGetLastError();
}

}  // namespace bwd

// Launch one route after checking that the plan computed in Python (heads
// per block, grid, shared-memory bytes) is the one it was written for.
template <typename T, int HD>
cudaError_t launch(const void* x, const float* b, const float* c, const float* cum, void* y,
                   float* state, int BNC, int H, int Q, int N, int heads_per_block, int grid_x,
                   int64_t smem, cudaStream_t stream) {
  constexpr size_t bytes = tc::smem_bytes<T>(HD);
  const int64_t want_x =
      static_cast<int64_t>((Q + BQ - 1) / BQ) * ((H + heads_per_block - 1) / heads_per_block) +
      static_cast<int64_t>(H) * ((N + tc::BNS - 1) / tc::BNS);
  if (heads_per_block < 1 || heads_per_block > tc::kMaxHeads || grid_x != want_x ||
      smem != static_cast<int64_t>(bytes))
    return cudaErrorInvalidConfiguration;
  auto kernel = tc::ssd_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(grid_x, BNC), tc::kThreads, bytes, stream>>>(
      static_cast<const T*>(x), b, c, cum, static_cast<T*>(y), state, H, Q, N, heads_per_block);
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

// Backward, first launch: dx [BNC, H, Q, HD] in x's dtype (0 f32, 1 bf16; dy the same) and the
// f32 partials of bwd::ssd_bwd_main (st, dbs, rowp, dcol, twp); dstate [BNC, H, HD, N] f32 or
// null (zero; dbs is then not written).  heads_per_block, groups and smem are
// ssd_scan.py::bwd_plan's; any other returns cudaErrorInvalidConfiguration.  All contiguous.
extern "C" int ssd_intra_chunk_bwd(int dtype, int HD, const void* x, const float* b,
                                   const float* c, const float* cum, const void* dy,
                                   const float* dstate, void* dx, float* st, float* dbs,
                                   float* rowp, float* dcol, float* twp, int BNC, int H, int Q,
                                   int N, int heads_per_block, int groups, int64_t smem,
                                   void* stream) {
  if (BNC <= 0 || H <= 0 || Q <= 0 || N <= 0 || BNC > 65535 || Q > 65535 * BQ ||
      N > bwd::kMaxState)
    return static_cast<int>(cudaErrorInvalidValue);
  auto run = [&](auto launch) {
    return static_cast<int>(launch(x, b, c, cum, dy, dstate, dx, st, dbs, rowp, dcol, twp, BNC, H,
                                   Q, N, heads_per_block, groups, smem,
                                   static_cast<cudaStream_t>(stream)));
  };
  if (dtype == 0 && HD == 32) return run(bwd::launch_main<float, 32>);
  if (dtype == 0 && HD == 64) return run(bwd::launch_main<float, 64>);
  if (dtype == 1 && HD == 32) return run(bwd::launch_main<bf16, 32>);
  if (dtype == 1 && HD == 64) return run(bwd::launch_main<bf16, 64>);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Backward, second launch: db, dc [BNC, Q, N] and dcum [BNC, H, Q], f32, from the first
// launch's partials and b, c (dbs null where dstate was); dtype picks the pieces as the first
// launch did.  groups (head groups a chunk) and smem are ssd_scan.py::bwd_plan's.
extern "C" int ssd_intra_chunk_bwd_reduce(int dtype, const float* st, const float* dbs,
                                          const float* b, const float* c, const float* rowp,
                                          const float* dcol, const float* twp, float* db,
                                          float* dc, float* dcum, int BNC, int H, int Q, int N,
                                          int groups, int64_t smem, void* stream) {
  if (BNC <= 0 || H <= 0 || Q <= 0 || N <= 0 || BNC > 65535 || N > bwd::kMaxState || groups < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = bwd::launch_reduce<3>(st, dbs, b, c, rowp, dcol, twp, db, dc, dcum, BNC, H, Q, N,
                                groups, smem, s);
  else if (dtype == 1)
    err = bwd::launch_reduce<2>(st, dbs, b, c, rowp, dcol, twp, db, dc, dcum, BNC, H, Q, N,
                                groups, smem, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
