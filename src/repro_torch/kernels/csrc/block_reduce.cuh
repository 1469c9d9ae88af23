// Shared pieces of the per-sampled-block kernels (filtered_agg, block_agg).
//
// One warp owns one sampled block: lane l reads rows l, l+32, ... of that
// block, so at block_rows = 32 a warp reads exactly one 128-byte segment of
// each 4-byte column (32 bytes of the bool validity column).  Lane partials
// are combined by a fixed __shfl_xor_sync butterfly: the reduction order is
// a function of block_rows alone, so results are bitwise equal run to run
// and between a solo launch and a batched launch, which calls the same
// __device__ body.  No atomics, no shared memory.
#pragma once

#include <cstdint>

namespace repro_torch {

constexpr int kWarpSize = 32;
constexpr int kWarpsPerCta = 8;

// dtype codes shared with the Python wrappers (kernels/_build.py DTYPE_CODES)
enum : int { kF32 = 0, kI32 = 1, kBool = 2, kAbsent = -1 };

// A column in its stored dtype.  Values are widened to f32 in registers,
// exactly like the reference's per-block ``.astype(jnp.float32)``: the wrapper
// never materialises a cast, padded or ones column.
struct Column {
  const void* ptr;
  int dtype;
};

__device__ __forceinline__ float load_f32(Column c, int64_t i) {
  if (c.dtype == kF32) return static_cast<const float*>(c.ptr)[i];
  if (c.dtype == kI32) return __int2float_rn(static_cast<const int32_t*>(c.ptr)[i]);
  if (c.dtype == kBool) return static_cast<const uint8_t*>(c.ptr)[i] ? 1.0f : 0.0f;
  return 1.0f;  // kAbsent: SUM(col) has no second factor
}

// __fadd_rn / __fmul_rn keep nvcc from contracting into FMAs, so each
// lane's partial rounds exactly like the reference's separate f32 ops.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = kWarpSize / 2; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = kWarpSize / 2; o > 0; o >>= 1)
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = kWarpSize / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

}  // namespace repro_torch
