// block_agg: per-sampled-block (count, sum, sumsq, min, max) over valid
// rows, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/block_agg/kernel.py
// (block_agg_kernel, body _kernel).  A sampled block with no valid row gives
// count = sum = sumsq = 0 and min = max = NaN, the reference's sentinel.
//
// What bounds it on the H100: device-memory bytes.  Per sampled block it
// reads block_rows rows of one 4-byte value column and the 1-byte validity
// column and does a few f32 operations per row: the bound is
// n_phys * block_rows * (4 + 1) bytes at 3.35 TB/s.
//
// Design against that bound: one warp per sampled block (unsampled blocks
// are never read); the value column is read in its stored dtype (f32, int32,
// or the bool validity column itself for a COUNT-only query) and widened in
// registers, so a call moves no full-table cast or pad.  Padding ids (zeros
// past n_real) are computed like any block and masked by the caller.
#include <cuda_runtime.h>

#include <cstdint>

#include "../../csrc/block_reduce.cuh"

namespace repro_torch {

struct BlockStats {
  float cnt, s, ss, mn, mx;
};

// The per-block body, shared with a later batched kernel so its lanes stay
// bitwise equal to this solo kernel.
__device__ __forceinline__ BlockStats block_stats(Column v,
                                                  const uint8_t* valid,
                                                  int64_t base, int block_rows,
                                                  int lane) {
  constexpr float kBig = 3.4e38f;
  float cnt = 0.0f, s = 0.0f, ss = 0.0f, mn = kBig, mx = -kBig;
  for (int r = lane; r < block_rows; r += kWarpSize) {
    const int64_t i = base + r;
    const float m = valid[i] ? 1.0f : 0.0f;
    const float x = load_f32(v, i);
    cnt = __fadd_rn(cnt, m);
    s = __fadd_rn(s, __fmul_rn(x, m));
    ss = __fadd_rn(ss, __fmul_rn(__fmul_rn(x, x), m));
    if (m > 0.0f) {
      mn = fminf(mn, x);
      mx = fmaxf(mx, x);
    }
  }
  BlockStats st{warp_sum(cnt), warp_sum(s), warp_sum(ss), warp_min(mn),
                warp_max(mx)};
  if (!(st.cnt > 0.0f)) {
    st.mn = __int_as_float(0x7fc00000);  // quiet NaN: the empty-block sentinel
    st.mx = st.mn;
  }
  return st;
}

__global__ void __launch_bounds__(kWarpsPerCta * kWarpSize)
    block_agg_kernel(Column v, const uint8_t* __restrict__ valid,
                     const int32_t* __restrict__ ids, int n_phys,
                     int block_rows, float* __restrict__ out) {
  const int warp = blockIdx.x * kWarpsPerCta + (threadIdx.x / kWarpSize);
  const int lane = threadIdx.x % kWarpSize;
  if (warp >= n_phys) return;  // whole warps exit together
  const int64_t base = static_cast<int64_t>(ids[warp]) * block_rows;
  const BlockStats st = block_stats(v, valid, base, block_rows, lane);
  if (lane == 0) {
    float* o = out + 5 * static_cast<int64_t>(warp);
    o[0] = st.cnt;
    o[1] = st.s;
    o[2] = st.ss;
    o[3] = st.mn;
    o[4] = st.mx;
  }
}

}  // namespace repro_torch

extern "C" int block_agg_launch(const void* values, int values_dtype,
                                const void* valid, const void* ids, int n_phys,
                                int block_rows, void* out, void* stream) {
  using namespace repro_torch;
  if (n_phys <= 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid((n_phys + kWarpsPerCta - 1) / kWarpsPerCta);
  const dim3 block(kWarpsPerCta * kWarpSize);
  block_agg_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      Column{values, values_dtype}, static_cast<const uint8_t*>(valid),
      static_cast<const int32_t*>(ids), n_phys, block_rows,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* block_agg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
