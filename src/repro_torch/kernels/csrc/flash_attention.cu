// Flash-attention forward (GQA, causal or not) for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention
// (Pallas body _flash_kernel).
//
// Bound: at the main path's shapes (head dim 64, sequences of 128-160
// tokens) the work is ~4*d*S/2 operations per query row against ~2*d bytes
// of it, so the card's least time is set by the bytes of q, k, v and out;
// at long S the operations dominate and the tensor cores would set it.
// This first kernel does its products with f32 FMAs on the CUDA cores, so
// at long S it is held by the FMA rate, far from the bf16 tensor-core
// bound.  Tensor cores (mma.sync / wgmma) and TMA are later work.
//
// Design: grid (ceil(S/64), H, B); 128 threads = 4 warps; each warp owns
// 16 query rows of the block's 64.  The block stages Q once and then one
// 32-key tile of K and V at a time in shared memory, converted to f32.  In
// Q K^T each lane owns one key of the tile and all 16 rows of its warp
// (Q rows are broadcast reads); in P V each lane owns D/32 output columns
// and reads P from the warp's slice of shared memory.  The online softmax
// keeps (m, l, acc) in f32 registers, step for step as the TPU kernel:
// m' = max(m, rowmax), alpha = exp(m - m'), p = exp(s - m'),
// l' = l*alpha + sum(p), acc' = acc*alpha + p V, out = acc / max(l, 1e-30).
// P stays f32 (as in the TPU kernel; the JAX model path rounds it to the
// working type before P V, hence the bf16 tolerance of 2e-2).
//
// Strides are arguments: the model's q [B,S,H,d] and k/v [B,S,KV,d] are read
// in place, with only the last dimension required to be contiguous.
// Ragged S is masked (keys >= S score -1e30, rows >= S are not stored), so
// no S % block restriction.  Causal: k tiles past the block's diagonal are
// not loaded, and a warp skips a tile past its own rows' diagonal.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;             // query rows per block
constexpr int BK = 32;             // keys per tile: one per lane
constexpr int kThreads = 128;
constexpr int kRows = BQ / (kThreads / 32);  // query rows per warp
constexpr float kNegInf = -1e30f;  // the TPU kernel's mask value

struct Strides {
  int64_t b, h, s;  // in elements; the head dim is contiguous
};

template <int D>
struct Smem {
  static constexpr int kQ = D + 4;   // Q row stride: rows 16-byte aligned for float4 broadcasts
  static constexpr int kK = D + 1;   // K row stride: lane j, column c -> bank (j + c) % 32
  static constexpr int kP = BK + 4;  // P row stride: rows 16-byte aligned
  static constexpr size_t bytes = sizeof(float) * (BQ * kQ + BK * kK + BK * D + BQ * kP);
};

template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* f) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* f) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
};

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

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

// Rows [row0, row0 + nrows) of one head into shared memory as f32, 16 bytes
// per thread and load; rows at or past S are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(const T* base, int64_t s_stride, int row0, int nrows,
                                          int S, float* dst, int dst_stride) {
  constexpr int N = Vec<T>::N;
  constexpr int kPerRow = D / N;
  for (int i = threadIdx.x; i < nrows * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * N;
    float f[N];
    if (row0 + r < S) {
      Vec<T>::load(base + static_cast<int64_t>(row0 + r) * s_stride + c, f);
    } else {
#pragma unroll
      for (int j = 0; j < N; ++j) f[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < N; ++j) dst[r * dst_stride + c + j] = f[j];
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int S, int H, int KV, Strides qs, Strides ks, Strides vs,
                 Strides os, float scale, int causal) {
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

  const T* kh = k + b * ks.b + kvh * ks.h;
  const T* vh = v + b * vs.b + kvh * vs.h;
  load_tile<T, D>(q + b * qs.b + h * qs.h, qs.s, q0, BQ, S, Qs, L::kQ);

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
    load_tile<T, D>(kh, ks.s, k0, BK, S, Ks, L::kK);
    load_tile<T, D>(vh, vs.s, k0, BK, S, Vs, D);
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

  T* oh = o + b * os.b + h * os.h;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qpos = q0 + row_base + r;
    if (qpos < S) {
      const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
      for (int t = 0; t < DL; ++t) store(oh + qpos * os.s + lane + 32 * t, acc[r][t] / denom);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int H, int KV,
                   int S, Strides qs, Strides ks, Strides vs, Strides os, float scale,
                   int causal, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(Smem<D>::bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  kernel<<<grid, kThreads, Smem<D>::bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, H, KV, qs, ks, vs, os, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v, void* o, int B, int H,
                       int KV, int S, Strides qs, Strides ks, Strides vs, Strides os,
                       float scale, int causal, cudaStream_t stream) {
  switch (D) {
    case 64: return launch<T, 64>(q, k, v, o, B, H, KV, S, qs, ks, vs, os, scale, causal, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, H, KV, S, qs, ks, vs, os, scale, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q is [B,H,S,D] and k, v, o are
// [B,KV,S,D] / [B,H,S,D] views given by their (b, h, s) strides in elements;
// the last dimension is contiguous and every row starts 16-byte aligned.
// Returns cudaGetLastError() after the launch.
extern "C" int flash_attention_fwd(int dtype, int D, const void* q, const void* k, const void* v,
                                   void* o, int B, int H, int KV, int S,
                                   int64_t q_sb, int64_t q_sh, int64_t q_ss,
                                   int64_t k_sb, int64_t k_sh, int64_t k_ss,
                                   int64_t v_sb, int64_t v_sh, int64_t v_ss,
                                   int64_t o_sb, int64_t o_sh, int64_t o_ss,
                                   float scale, int causal, void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || S <= 0 || H % KV != 0 || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss}, vs{v_sb, v_sh, v_ss},
      os{o_sb, o_sh, o_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(
          dispatch_d<float>(D, q, k, v, o, B, H, KV, S, qs, ks, vs, os, scale, causal, s));
    case 1:
      return static_cast<int>(dispatch_d<__nv_bfloat16>(D, q, k, v, o, B, H, KV, S, qs, ks, vs,
                                                        os, scale, causal, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
