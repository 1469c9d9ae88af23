// filtered_agg: fused range predicate + per-sampled-block aggregation
// (the TPC-H Q6 shape), CUDA C++ for sm_90a.
//
// Replaces the TPU kernels src/repro/kernels/filtered_agg/kernel.py
// filtered_agg_kernel (body _kernel, :114) and filtered_agg_batched_kernel
// (body _kernel_batched, :85).  For each sampled block id it computes
//
//   keep = lo1<=f1<=hi1 AND lo2<=f2<=hi2 AND f3<c3 AND valid      (all in f32)
//   out  = (SUM keep, SUM x*y*keep, SUM (x*y)^2*keep)
//
// What bounds it on the H100: device-memory bytes.  Per sampled block it
// reads block_rows rows of up to five 4-byte columns and the 1-byte validity
// column, and does a handful of f32 operations per row — far below the
// card's ~20 operations per byte (67 TFLOP/s f32 / 3.35 TB/s).  The bound is
// n_phys * block_rows * (5*4 + 1) bytes (less where arguments alias, as in
// Q6, where f3 is f1) at 3.35 TB/s.
//
// Design against that bound: one warp per sampled block, so unsampled blocks
// are never read (theta * bytes); columns are read in their stored dtype
// (f32, int32 l_shipdate, bool valid) and widened in registers, so a call
// moves no full-table cast, pad or ones column; the five bounds are read
// from a (5,) device vector, so constant-varied queries share this binary and
// nothing syncs the host before the launch.  Padding ids (zeros past n_real)
// are computed like any block and masked by the caller.
//
// The batched kernel serves a drain group's final scans: B lanes, each with
// its own id row ids[b, :] and bounds row bounds[b, :], in ONE launch over a
// (ceil(n_phys / warps-per-CTA), B) grid.  Its bound is the same bytes
// count summed over lanes (distinct rows read once, plus the (B, n_phys) ids,
// (B, 5) bounds and (B, n_phys, 3) output); what it saves over B solo
// launches is B - 1 launch latencies and the tail of each small grid.  Every
// lane runs the same __device__ filtered_block as the solo kernel, so lane b
// is bitwise the solo kernel on ids[b, :] and bounds[b, :].
#include <cuda_runtime.h>

#include <cstdint>

#include "../../csrc/block_reduce.cuh"

namespace repro_torch {

struct Bounds {
  float lo1, hi1, lo2, hi2, c3;
};

struct FilteredStats {
  float cnt, s, ss;
};

// The per-block body.  The batched kernel (one id row and one bounds row per
// lane) calls this same function, which keeps every lane bitwise equal to
// the solo kernel.
__device__ __forceinline__ FilteredStats filtered_block(
    Column x, Column y, Column f1, Column f2, Column f3, const uint8_t* valid,
    int64_t base, int block_rows, Bounds b, int lane) {
  float cnt = 0.0f, s = 0.0f, ss = 0.0f;
  for (int r = lane; r < block_rows; r += kWarpSize) {
    const int64_t i = base + r;
    const float v1 = load_f32(f1, i);
    const float v2 = load_f32(f2, i);
    const float v3 = load_f32(f3, i);
    const bool pass = (v1 >= b.lo1) & (v1 <= b.hi1) & (v2 >= b.lo2) &
                      (v2 <= b.hi2) & (v3 < b.c3) & (valid[i] != 0);
    const float keep = pass ? 1.0f : 0.0f;
    const float prod = __fmul_rn(load_f32(x, i), load_f32(y, i));
    cnt = __fadd_rn(cnt, keep);
    s = __fadd_rn(s, __fmul_rn(prod, keep));
    ss = __fadd_rn(ss, __fmul_rn(__fmul_rn(prod, prod), keep));
  }
  return {warp_sum(cnt), warp_sum(s), warp_sum(ss)};
}

__global__ void __launch_bounds__(kWarpsPerCta * kWarpSize)
    filtered_agg_kernel(Column x, Column y, Column f1, Column f2, Column f3,
                        const uint8_t* __restrict__ valid,
                        const int32_t* __restrict__ ids, int n_phys,
                        int block_rows, const float* __restrict__ bounds,
                        float* __restrict__ out) {
  const int warp = blockIdx.x * kWarpsPerCta + (threadIdx.x / kWarpSize);
  const int lane = threadIdx.x % kWarpSize;
  if (warp >= n_phys) return;  // whole warps exit together
  const Bounds b{bounds[0], bounds[1], bounds[2], bounds[3], bounds[4]};
  const int64_t base = static_cast<int64_t>(ids[warp]) * block_rows;
  const FilteredStats st =
      filtered_block(x, y, f1, f2, f3, valid, base, block_rows, b, lane);
  if (lane == 0) {
    out[3 * static_cast<int64_t>(warp) + 0] = st.cnt;
    out[3 * static_cast<int64_t>(warp) + 1] = st.s;
    out[3 * static_cast<int64_t>(warp) + 2] = st.ss;
  }
}

// grid (ceil(n_phys / kWarpsPerCta), batch): blockIdx.y is the lane.
__global__ void __launch_bounds__(kWarpsPerCta * kWarpSize)
    filtered_agg_batched_kernel(Column x, Column y, Column f1, Column f2,
                                Column f3, const uint8_t* __restrict__ valid,
                                const int32_t* __restrict__ ids, int n_phys,
                                int block_rows,
                                const float* __restrict__ bounds,
                                float* __restrict__ out) {
  const int warp = blockIdx.x * kWarpsPerCta + (threadIdx.x / kWarpSize);
  const int lane = threadIdx.x % kWarpSize;
  if (warp >= n_phys) return;  // whole warps exit together
  const int64_t b = blockIdx.y;
  const float* lb = bounds + 5 * b;
  const Bounds bd{lb[0], lb[1], lb[2], lb[3], lb[4]};
  const int64_t slot = b * n_phys + warp;
  const int64_t base = static_cast<int64_t>(ids[slot]) * block_rows;
  const FilteredStats st =
      filtered_block(x, y, f1, f2, f3, valid, base, block_rows, bd, lane);
  if (lane == 0) {
    out[3 * slot + 0] = st.cnt;
    out[3 * slot + 1] = st.s;
    out[3 * slot + 2] = st.ss;
  }
}

}  // namespace repro_torch

extern "C" int filtered_agg_launch(const void* x, int x_dtype, const void* y,
                                   int y_dtype, const void* f1, int f1_dtype,
                                   const void* f2, int f2_dtype, const void* f3,
                                   int f3_dtype, const void* valid,
                                   const void* ids, int n_phys, int block_rows,
                                   const void* bounds, void* out,
                                   void* stream) {
  using namespace repro_torch;
  if (n_phys <= 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid((n_phys + kWarpsPerCta - 1) / kWarpsPerCta);
  const dim3 block(kWarpsPerCta * kWarpSize);
  filtered_agg_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      Column{x, x_dtype}, Column{y, y_dtype}, Column{f1, f1_dtype},
      Column{f2, f2_dtype}, Column{f3, f3_dtype},
      static_cast<const uint8_t*>(valid), static_cast<const int32_t*>(ids),
      n_phys, block_rows, static_cast<const float*>(bounds),
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int filtered_agg_batched_launch(
    const void* x, int x_dtype, const void* y, int y_dtype, const void* f1,
    int f1_dtype, const void* f2, int f2_dtype, const void* f3, int f3_dtype,
    const void* valid, const void* ids, int batch, int n_phys, int block_rows,
    const void* bounds, void* out, void* stream) {
  using namespace repro_torch;
  if (batch <= 0 || n_phys <= 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid((n_phys + kWarpsPerCta - 1) / kWarpsPerCta, batch);
  const dim3 block(kWarpsPerCta * kWarpSize);
  filtered_agg_batched_kernel<<<grid, block, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      Column{x, x_dtype}, Column{y, y_dtype}, Column{f1, f1_dtype},
      Column{f2, f2_dtype}, Column{f3, f3_dtype},
      static_cast<const uint8_t*>(valid), static_cast<const int32_t*>(ids),
      n_phys, block_rows, static_cast<const float*>(bounds),
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* filtered_agg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
