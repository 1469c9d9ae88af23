// flash_attn: blockwise online-softmax attention with GQA, a causal mask and
// a sliding window, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/flash_attn/kernel.py
// flash_attention_kernel (body _attn_kernel, :24).  The same arithmetic:
// f32 scores s = (q . k) * scale, masked entries set to NEG_INF = -1e30 (not
// -inf, so a tile in which a row sees no key gives no NaN), running max m,
// denominator l and accumulator acc carried across kv tiles, and the output
// acc / l with l > 0 guarded, stored in q's dtype.  Beyond the Pallas mask
// (col < kv_len; col <= row when causal) it takes the sliding window of
// the models' mea_attention (col > row - window when window > 0), and
// skips every kv tile wholly outside the causal triangle or the window band,
// as the Pallas kernel skips tiles above the diagonal.
//
// What bounds it on the H100: operations.  At hymba-1.5b's eval shape
// (B 2, 25 q heads over 5 kv heads, S 2048, d 64, window 1024) a head does
// ~391 visited (64 x 64) tile pairs of 2 x 64 x 64 x 64 x 2 flops, 20.5
// GFLOP in all, against 31.5 MB of q, k, v and o.
//
// Design, simple first: one CTA of 128 threads per (batch, q head, 64-row q
// tile).  The q tile and each 64-row K and V tile are widened to f32 in
// shared memory; thread (tr, tc) owns rows 4tr..4tr+3 and score columns
// tc + 8j, so each row's softmax reductions are a 3-step shuffle among 8
// lanes of one warp and P never leaves that warp.  QK^T and PV are scalar
// f32 FMAs from shared memory (no tensor cores yet: wgmma, TMA and bf16
// mma are later work).  GQA maps q head h to kv head h / (Hq / Hkv) in the
// kernel, so K and V are never repeated.  No atomics: a launch is bitwise
// repeatable.
#include <cuda_runtime.h>

#include <cstdint>

#include "../../csrc/float_io.cuh"

namespace repro_torch {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kFlashThreads = 128;
constexpr float kNegInf = -1e30f;

template <int D>
struct FlashSmem {
  static constexpr int kQStride = D + 1;  // read down columns: pad a bank
  static constexpr int kKStride = D + 1;
  static constexpr int kVStride = D;      // read along rows
  static constexpr int kPStride = kBK + 1;
  static constexpr size_t kBytes =
      sizeof(float) * (kBQ * kQStride + kBK * kKStride + kBK * kVStride +
                       kBQ * kPStride);
};

template <typename T, int D>
__global__ void __launch_bounds__(kFlashThreads)
    flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o, int hq,
                      int hkv, int sq, int skv, float scale, int causal,
                      int window) {
  using S = FlashSmem<D>;
  constexpr int kCols = D / 8;  // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kBQ * S::kQStride;
  float* vs = ks + kBK * S::kKStride;
  float* ps = vs + kBK * S::kVStride;

  const int i0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const T* qb = q + static_cast<int64_t>(b * hq + h) * sq * D;
  const T* kb = k + static_cast<int64_t>(b * hkv + hk) * skv * D;
  const T* vb = v + static_cast<int64_t>(b * hkv + hk) * skv * D;
  T* ob = o + static_cast<int64_t>(b * hq + h) * sq * D;
  const int tr = threadIdx.x / 8;  // rows 4tr .. 4tr+3 of the tile
  const int tc = threadIdx.x % 8;  // columns tc, tc+8, ...

  load_tile<T, D>(qs, S::kQStride, qb, i0, kBQ, sq);

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    m[ii] = kNegInf;
    l[ii] = 0.0f;
#pragma unroll
    for (int jj = 0; jj < kCols; ++jj) acc[ii][jj] = 0.0f;
  }

  // the kv tiles this q tile can see: none wholly past the diagonal (causal)
  // or wholly before the window of the tile's first row
  int last_col = skv - 1;
  if (causal) last_col = min(last_col, i0 + kBQ - 1);
  const int j_hi = last_col >= 0 ? last_col / kBK : -1;
  const int j_lo = window > 0 ? max(0, i0 - window + 1) / kBK : 0;

  for (int jt = j_lo; jt <= j_hi; ++jt) {
    const int j0 = jt * kBK;
    __syncthreads();  // the previous tile's K and V are no longer read
    load_tile<T, D>(ks, S::kKStride, kb, j0, kBK, skv);
    load_tile<T, D>(vs, S::kVStride, vb, j0, kBK, skv);
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) s[ii][jj] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], c[8];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) a[ii] = qs[(4 * tr + ii) * S::kQStride + d];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) c[jj] = ks[(tc + 8 * jj) * S::kKStride + d];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) s[ii][jj] = fmaf(a[ii], c[jj], s[ii][jj]);
    }

#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const int row = i0 + 4 * tr + ii;
      float mc = kNegInf;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int col = j0 + tc + 8 * jj;
        bool keep = col < skv;
        if (causal) keep = keep && col <= row;
        if (window > 0) keep = keep && col > row - window;
        s[ii][jj] = keep ? s[ii][jj] * scale : kNegInf;
        mc = fmaxf(mc, s[ii][jj]);
      }
      // the row's 64 columns live on 8 neighbouring lanes
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, off));
      const float m_new = fmaxf(m[ii], mc);
      float rs = 0.0f;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float p = expf(s[ii][jj] - m_new);
        ps[(4 * tr + ii) * S::kPStride + tc + 8 * jj] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float alpha = expf(m[ii] - m_new);
      l[ii] = l[ii] * alpha + rs;
      m[ii] = m_new;
#pragma unroll
      for (int jj = 0; jj < kCols; ++jj) acc[ii][jj] *= alpha;
    }
    __syncwarp();  // P rows are written and read by the same warp

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float p[4], w[kCols];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) p[ii] = ps[(4 * tr + ii) * S::kPStride + c];
#pragma unroll
      for (int jj = 0; jj < kCols; ++jj) w[jj] = vs[c * S::kVStride + tc + 8 * jj];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < kCols; ++jj) acc[ii][jj] = fmaf(p[ii], w[jj], acc[ii][jj]);
    }
    __syncwarp();  // P is read before the next tile overwrites it
  }

#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int row = i0 + 4 * tr + ii;
    if (row >= sq) continue;
    const float den = l[ii] > 0.0f ? l[ii] : 1.0f;
#pragma unroll
    for (int jj = 0; jj < kCols; ++jj)
      ob[static_cast<int64_t>(row) * D + tc + 8 * jj] = from_f32<T>(acc[ii][jj] / den);
  }
}

template <typename T, int D>
cudaError_t launch_flash(const void* q, const void* k, const void* v, void* o,
                         int batch, int hq, int hkv, int sq, int skv,
                         float scale, int causal, int window,
                         cudaStream_t stream) {
  const size_t smem = FlashSmem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kBQ - 1) / kBQ, hq, batch);
  flash_attn_kernel<T, D><<<grid, kFlashThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), hq, hkv, sq, skv, scale,
      causal, window);
  return cudaGetLastError();
}

}  // namespace repro_torch

// q (B, Hq, Sq, D), k and v (B, Hkv, Skv, D), o like q: contiguous, one
// dtype (code 0 f32, 3 bf16), D 64 or 128, Hq a multiple of Hkv.
extern "C" int flash_attn_launch(const void* q, const void* k, const void* v,
                                 void* o, int dtype, int batch, int hq,
                                 int hkv, int sq, int skv, int head_dim,
                                 float scale, int causal, int window,
                                 void* stream) {
  using namespace repro_torch;
  if (batch <= 0 || hq <= 0 || sq <= 0) return static_cast<int>(cudaGetLastError());
  const auto st = static_cast<cudaStream_t>(stream);
  if (dtype == kDtypeBF16 && head_dim == 64)
    return launch_flash<bf16, 64>(q, k, v, o, batch, hq, hkv, sq, skv, scale, causal, window, st);
  if (dtype == kDtypeBF16 && head_dim == 128)
    return launch_flash<bf16, 128>(q, k, v, o, batch, hq, hkv, sq, skv, scale, causal, window, st);
  if (dtype == kDtypeF32 && head_dim == 64)
    return launch_flash<float, 64>(q, k, v, o, batch, hq, hkv, sq, skv, scale, causal, window, st);
  if (dtype == kDtypeF32 && head_dim == 128)
    return launch_flash<float, 128>(q, k, v, o, batch, hq, hkv, sq, skv, scale, causal, window, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_attn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
