// Shared pieces of the model kernels (flash_attn, gla_chunk): loading f32 or
// bf16 tiles into shared memory as f32, storing f32 results back in the
// input's dtype, and a short exp2.  Every product and sum of those kernels
// runs in f32, like the reference's ``.astype(jnp.float32)`` inside its
// Pallas bodies.
#pragma once

#include <cuda_bf16.h>

#include <cstdint>

namespace repro_torch {

// dtype codes shared with the Python wrappers (kernels/_build.py FLOAT_CODES)
enum : int { kDtypeF32 = 0, kDtypeBF16 = 3 };

using bf16 = __nv_bfloat16;

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// 2^x by ex2.approx (2 ulp), subnormal results flushed to zero: the model
// kernels' exps, whose arguments are <= 0 and whose results below 2^-126
// add nothing an f32 sum keeps
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Eight consecutive elements widened to f32; ``p`` is 16-byte aligned (the
// wrappers check the base pointers, and every row width is a multiple of 8).
__device__ __forceinline__ void load8(const float* p, float (&out)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__device__ __forceinline__ void load8(const bf16* p, float (&out)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// Rows [row0, row0 + rows) of a row-major (n_rows, kWidth) matrix into
// shared memory as f32, row stride ``stride``; rows at or past ``n_rows``
// read as zeros (the reference's zero padding).  Neighbouring threads load
// neighbouring 16-byte pieces of a row.
template <typename T, int kWidth>
__device__ __forceinline__ void load_tile(float* dst, int stride,
                                          const T* src, int row0, int rows,
                                          int n_rows) {
  constexpr int kVec = kWidth / 8;
  for (int idx = threadIdx.x; idx < rows * kVec; idx += blockDim.x) {
    const int r = idx / kVec;
    const int c = (idx % kVec) * 8;
    float x[8];
    if (row0 + r < n_rows) {
      load8(src + static_cast<int64_t>(row0 + r) * kWidth + c, x);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] = 0.0f;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) dst[r * stride + c + e] = x[e];
  }
}

}  // namespace repro_torch
