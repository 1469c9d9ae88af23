// Shared pieces of the gla_chunk kernels, forward (gla_chunk.cu) and
// backward (gla_chunk_bwd.cu): the chunk geometry, an exp for exponents
// <= 0, transposed tile loads and the clamped within-chunk cumulative decay.
#pragma once

#include <cstdint>

#include "float_io.cuh"

namespace repro_torch {

constexpr int kChunk = 64;
constexpr int kGlaThreads = 256;
constexpr int kGlaWarps = kGlaThreads / 32;
constexpr float kGClamp = -8.0f;
constexpr int kTS = kChunk + 4;  // row stride of a transposed (d, chunk) buffer
constexpr int kScanBatch = 8;    // chunks whose loads the scan issues together

// e^x for x <= 0 as 2^(x log2 e): within 2 ulp plus |x| 2^-24 relative
// (5e-6 at x = -87, below which f32 holds only subnormals, flushed to zero)
__device__ __forceinline__ float exp_le0(float x) { return ex2(x * 1.4426950408889634f); }

// Steps [t0, t0 + 64) of a row-major (T, W) matrix into dst[W][kTS] as f32,
// transposed; steps at or past T read as zeros.  A warp loads 32
// neighbouring steps, so its transposed stores hit 32 banks.
template <typename T, int W>
__device__ __forceinline__ void load_tile_t(float* dst, const T* src, int t0, int t_len) {
  constexpr int kVec = W / 8;
  for (int idx = threadIdx.x; idx < kChunk * kVec; idx += blockDim.x) {
    const int r = idx % kChunk;
    const int c = (idx / kChunk) * 8;
    float x[8];
    if (t0 + r < t_len) {
      load8(src + static_cast<int64_t>(t0 + r) * W + c, x);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] = 0.0f;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) dst[(c + e) * kTS + r] = x[e];
  }
}

// LT[ch][.] = cumsum(clamp(g, -8, 0)) along the chunk, in place: lane l holds
// steps 2l and 2l+1, then an inclusive warp scan
template <int DK>
__device__ __forceinline__ void cumsum_decay(float* LT) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int ch = warp; ch < DK; ch += kGlaWarps) {
    float2* p = reinterpret_cast<float2*>(LT + ch * kTS) + lane;
    const float2 g2 = *p;
    const float a = fminf(fmaxf(g2.x, kGClamp), 0.0f);
    const float b = a + fminf(fmaxf(g2.y, kGClamp), 0.0f);
    float scan = b;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float up = __shfl_up_sync(0xffffffffu, scan, off);
      if (lane >= off) scan += up;
    }
    *p = make_float2(scan - b + a, scan);
  }
}

}  // namespace repro_torch
