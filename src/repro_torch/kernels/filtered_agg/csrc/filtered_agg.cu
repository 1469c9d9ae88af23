// filtered_agg: fused range predicate + per-sampled-block aggregation
// (the TPC-H Q6 shape), CUDA C++ for sm_90a.
//
// Replaces the TPU kernels src/repro/kernels/filtered_agg/kernel.py
// filtered_agg_kernel (body _kernel, :114) and filtered_agg_batched_kernel
// (body _kernel_batched, :85) with ONE kernel, filtered_agg_kernel.  For each
// lane b and each sampled block id of that lane it computes
//
//   keep = lo1<=f1<=hi1 AND lo2<=f2<=hi2 AND f3<c3 AND valid      (all in f32)
//   out  = (SUM keep, SUM x*y*keep, SUM (x*y)^2*keep)
//
// with lane b's own ids row and bounds row.  A solo call is the launch with
// one lane; a drain group's batched final is the launch with B lanes.
//
// What bounds it on the H100.  On paper, device-memory bytes: per sampled
// block it reads block_rows rows of up to five 4-byte columns and the 1-byte
// validity column and does a handful of f32 operations per row, far below
// the card's ~20 operations per byte (67 TFLOP/s f32 / 3.35 TB/s).  The
// bound is the distinct sampled rows times (5*4 + 1) bytes (less where
// arguments alias, as in Q6, where f3 is f1 and f2 is y), plus the ids,
// bounds and output, at 3.35 TB/s.  In practice, memory latency paid per
// warp: a block is 672 bytes at block_rows 32, so a warp that owns one
// block and waits on its loads in several dependent rounds keeps too few
// bytes in flight to cover a cold-L2 DRAM latency.
//
// Design against that: every load of a row step is in flight before the
// first instruction that uses one.  A warp's work is two rounds of memory:
// (1) its K consecutive ids and its lane's five bounds, one 4-byte load per
// lane; (2) all columns of the K blocks, one unconditional load_row each (no
// branch on the dtype, so no load waits behind another's use), widened to
// f32 only after the last load.  A warp owns K = 1, 2 or 4 consecutive
// sampled blocks of one lane (template parameter; the wrapper picks K from
// the launch's whole CTA count, kernels/column_launch.py), so a large call
// keeps K blocks' loads in flight per warp and runs fewer CTAs, while a
// small one keeps K = 1 and spreads over the card.  Blocks longer than 32
// rows are read one row step (32 rows of each of the K blocks) at a time.
// Lane l of a warp still accumulates rows l, l+32, ... of each block in
// that order through filtered_row and reduces through warp_sum, so the
// output is bitwise the same for every K and every batch: lane b of a
// batched launch is bitwise the solo launch on ids[b, :] and bounds[b, :].
//
// Unsampled blocks are never read (theta * bytes); columns are read in
// their stored dtype (f32, int32 l_shipdate, bool valid) and widened in
// registers, so a call moves no full-table cast, pad or ones column; the
// bounds are read from a device tensor, so constant-varied queries share
// this binary and nothing syncs the host before the launch.  Padding ids
// (zeros past n_real) are computed like any block and masked by the caller.
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

// The per-row step: the predicate, then cnt, s and ss, each op rounded on
// its own.
__device__ __forceinline__ void filtered_row(FilteredStats& a, float v1,
                                             float v2, float v3, bool ok,
                                             float x, float y, Bounds b) {
  const bool pass = (v1 >= b.lo1) & (v1 <= b.hi1) & (v2 >= b.lo2) &
                    (v2 <= b.hi2) & (v3 < b.c3) & ok;
  const float keep = pass ? 1.0f : 0.0f;
  const float prod = __fmul_rn(x, y);
  a.cnt = __fadd_rn(a.cnt, keep);
  a.s = __fadd_rn(a.s, __fmul_rn(prod, keep));
  a.ss = __fadd_rn(a.ss, __fmul_rn(__fmul_rn(prod, prod), keep));
}

// grid (ceil(n_phys / (K * kWarpsPerCta)), batch): blockIdx.y is the lane,
// which reads ids[lane, :] ((batch, n_phys) row-major), bounds[lane, :]
// ((batch, 5)) and writes out[lane, :, :] ((batch, n_phys, 3)).  Within a
// lane, warp w owns sampled blocks K*w .. K*w + K - 1 (those below n_phys),
// kernels/column_launch.py's assignment.  kBytes: some column of the call
// is bool (load_row).  Where it is, an explicit minimum of two CTAs per SM
// (a cap of 128 registers, above the 96 that <4, true> uses) steers ptxas
// to issue every load of a row step before the first use: with no minimum
// it tests a bool row of <1, true> before the last loads issue, and with a
// minimum of one it issues one byte load of <4, true> after a use, each a
// third memory round (chip_smoke.py phase 2 counts them).  The all-4-byte
// instantiations take no minimum, which would cost them occupancy.
template <int K, bool kBytes>
__global__ void __launch_bounds__(kWarpsPerCta * kWarpSize, kBytes ? 2 : 0)
    filtered_agg_kernel(RawColumn x, RawColumn y, RawColumn f1, RawColumn f2,
                        RawColumn f3, const uint8_t* __restrict__ valid,
                        const int32_t* __restrict__ ids, int n_phys,
                        int block_rows, const float* __restrict__ bounds,
                        float* __restrict__ out) {
  const int warp = blockIdx.x * kWarpsPerCta + (threadIdx.x / kWarpSize);
  const int lane = threadIdx.x % kWarpSize;
  const int first = warp * K;
  if (first >= n_phys) return;  // whole warps exit together
  // this CTA's id row: its ids, its bounds and its output
  const int64_t row = blockIdx.y;
  ids += row * n_phys;
  bounds += row * 5;
  out += row * n_phys * 3;
  // round 1: this warp's K ids and the row's five bounds, one load per lane
  int64_t base[K];
  bool live[K];
  const uint32_t w0 = first_round<K>(ids, bounds, 5, first, n_phys, block_rows,
                                     lane, base, live);
  float bv[5];
#pragma unroll
  for (int t = 0; t < 5; ++t) bv[t] = __uint_as_float(__shfl_sync(kFullMask, w0, K + t));
  const Bounds b{bv[0], bv[1], bv[2], bv[3], bv[4]};
  FilteredStats acc[K];
#pragma unroll
  for (int j = 0; j < K; ++j) acc[j] = {0.0f, 0.0f, 0.0f};
#pragma unroll 1
  for (int r0 = 0; r0 < block_rows; r0 += kWarpSize) {
    // round 2: every load of this row step of the K blocks (a lane past
    // the block's last row reads that row again) ...
    const int r = min(r0 + lane, block_rows - 1);
    RawRow rx[K], ry[K], r1[K], r2[K], r3[K];
    uint8_t rv[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int64_t i = base[j] + r;
      r1[j] = load_row<kBytes>(f1, i);
      r2[j] = load_row<kBytes>(f2, i);
      r3[j] = load_row<kBytes>(f3, i);
      rv[j] = __ldg(valid + i);
      rx[j] = load_row<kBytes>(x, i);
      ry[j] = load_row<kBytes>(y, i);
    }
    // ... and only then the arithmetic, kept for live rows only
#pragma unroll
    for (int j = 0; j < K; ++j) {
      FilteredStats next = acc[j];
      filtered_row(next, widen(r1[j], f1.dtype), widen(r2[j], f2.dtype),
                   widen(r3[j], f3.dtype), rv[j] != 0, widen(rx[j], x.dtype),
                   widen(ry[j], y.dtype), b);
      if (live[j] && r0 + lane < block_rows) acc[j] = next;
    }
  }
  float cnt[K], s[K], ss[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    cnt[j] = warp_sum(acc[j].cnt);
    s[j] = warp_sum(acc[j].s);
    ss[j] = warp_sum(acc[j].ss);
  }
  // lane j < K writes block first + j
  if (lane < K && first + lane < n_phys) {
    float* o = out + 3 * static_cast<int64_t>(first + lane);
    o[0] = own_slot<K>(cnt, lane);
    o[1] = own_slot<K>(s, lane);
    o[2] = own_slot<K>(ss, lane);
  }
}

// A kernel that does nothing, launched on a column kernel's grid and CTA
// size: the least time any launch of that grid shows under the timing
// protocol (chip_smoke.py's launch floor).
__global__ void __launch_bounds__(kWarpsPerCta * kWarpSize)
    column_floor_kernel() {}

}  // namespace repro_torch

namespace {

using repro_torch::RawColumn;

template <int K>
void launch_k(RawColumn x, RawColumn y, RawColumn f1, RawColumn f2,
              RawColumn f3, const void* valid, const void* ids, int batch,
              int n_phys, int block_rows, const void* bounds, void* out,
              cudaStream_t stream) {
  using namespace repro_torch;
  constexpr int per_cta = K * kWarpsPerCta;
  const dim3 grid((n_phys + per_cta - 1) / per_cta, batch);
  const bool bytes = x.dtype == kBool || y.dtype == kBool ||
                     f1.dtype == kBool || f2.dtype == kBool || f3.dtype == kBool;
  auto kernel = bytes ? filtered_agg_kernel<K, true> : filtered_agg_kernel<K, false>;
  kernel<<<grid, kWarpsPerCta * kWarpSize, 0, stream>>>(
      x, y, f1, f2, f3, static_cast<const uint8_t*>(valid),
      static_cast<const int32_t*>(ids), n_phys, block_rows,
      static_cast<const float*>(bounds), static_cast<float*>(out));
}

}  // namespace

// ids (batch, n_phys) int32, bounds (batch, 5) f32, out (batch, n_phys, 3)
// f32, all row-major; a solo call passes batch 1.  blocks_per_warp is K: 1,
// 2 or 4 (anything else: cudaErrorInvalidValue); batch at most 65,535 (the
// grid's y extent).
extern "C" int filtered_agg_launch(const void* x, int x_dtype, const void* y,
                                   int y_dtype, const void* f1, int f1_dtype,
                                   const void* f2, int f2_dtype, const void* f3,
                                   int f3_dtype, const void* valid,
                                   const void* ids, int batch, int n_phys,
                                   int block_rows, int blocks_per_warp,
                                   const void* bounds, void* out, void* stream) {
  using namespace repro_torch;
  if (batch <= 0 || n_phys <= 0) return static_cast<int>(cudaGetLastError());
  const Column col_x{x, x_dtype};
  const RawColumn cx = raw_column(col_x, col_x, ids),
                  cy = raw_column({y, y_dtype}, col_x, ids),
                  c1 = raw_column({f1, f1_dtype}, col_x, ids),
                  c2 = raw_column({f2, f2_dtype}, col_x, ids),
                  c3 = raw_column({f3, f3_dtype}, col_x, ids);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (blocks_per_warp) {
    case 1: launch_k<1>(cx, cy, c1, c2, c3, valid, ids, batch, n_phys, block_rows, bounds, out, s); break;
    case 2: launch_k<2>(cx, cy, c1, c2, c3, valid, ids, batch, n_phys, block_rows, bounds, out, s); break;
    case 4: launch_k<4>(cx, cy, c1, c2, c3, valid, ids, batch, n_phys, block_rows, bounds, out, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The empty kernel on a (grid_x, grid_y) grid of 256-thread CTAs.
extern "C" int column_floor_launch(int grid_x, int grid_y, void* stream) {
  using namespace repro_torch;
  if (grid_x <= 0 || grid_y <= 0) return static_cast<int>(cudaGetLastError());
  column_floor_kernel<<<dim3(grid_x, grid_y), kWarpsPerCta * kWarpSize, 0,
                        static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* filtered_agg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
