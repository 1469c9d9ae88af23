// block_agg: per-sampled-block (count, sum, sumsq, min, max) over valid
// rows, CUDA C++ for sm_90a.
//
// Replaces the TPU kernels src/repro/kernels/block_agg/kernel.py
// block_agg_kernel (body _kernel, :92) and block_agg_batched_kernel (body
// _kernel_batched, :63) with ONE kernel, block_agg_kernel: lane b of a
// launch reads its own ids row.  A solo call is the launch with one lane; a
// drain group's batched final is the launch with B lanes.  A sampled block
// with no valid row gives count = sum = sumsq = 0 and min = max = NaN, the
// reference's sentinel.
//
// What bounds it on the H100.  On paper, device-memory bytes: per sampled
// block it reads block_rows rows of one 4-byte value column and the 1-byte
// validity column and does a few f32 operations per row: the bound is the
// distinct sampled rows times (4 + 1) bytes, plus the ids and output, at
// 3.35 TB/s.  In practice, memory latency paid per warp: a 32-row block is
// 160 bytes, and a warp that owns one block and reads its value behind its
// validity byte waits on DRAM in several dependent rounds with a few
// hundred bytes in flight.
//
// Design against that: a warp owns K = 1, 2 or 4 consecutive sampled
// blocks of one lane (template parameter; the wrapper picks K from the
// launch's whole CTA count, kernels/column_launch.py) and works in two
// rounds of memory: (1) its K ids in one coalesced load, shuffled to every
// lane; (2) the value and validity loads of all K blocks, one unconditional
// load_row each (no branch on the dtype), before the first instruction
// that uses one.  Blocks longer than 32 rows are read one row step (32 rows
// of each of the K blocks) at a time.  Lane l of a warp accumulates rows l,
// l+32, ... of each block in that order through block_row and reduces
// through block_total, so the output is bitwise the same for every K and
// every batch: lane b of a batched launch is bitwise the solo launch on
// ids[b, :].  The value column is read in its stored dtype (f32, int32, or
// the bool validity column itself for a COUNT-only query) and widened in
// registers, so a call moves no full-table cast or pad.  Padding ids (zeros
// past n_real) are computed like any block and masked by the caller.
#include <cuda_runtime.h>

#include <cstdint>

#include "../../csrc/block_reduce.cuh"

namespace repro_torch {

struct BlockStats {
  float cnt, s, ss, mn, mx;
};

// The per-row step.
__device__ __forceinline__ void block_row(BlockStats& a, float x, bool ok) {
  const float m = ok ? 1.0f : 0.0f;
  a.cnt = __fadd_rn(a.cnt, m);
  a.s = __fadd_rn(a.s, __fmul_rn(x, m));
  a.ss = __fadd_rn(a.ss, __fmul_rn(__fmul_rn(x, x), m));
  a.mn = m > 0.0f ? fminf(a.mn, x) : a.mn;
  a.mx = m > 0.0f ? fmaxf(a.mx, x) : a.mx;
}

constexpr float kBig = 3.4e38f;

// Lane partials to the block's statistics, with the empty-block sentinel.
__device__ __forceinline__ BlockStats block_total(BlockStats a) {
  BlockStats st{warp_sum(a.cnt), warp_sum(a.s), warp_sum(a.ss), warp_min(a.mn),
                warp_max(a.mx)};
  if (!(st.cnt > 0.0f)) {
    st.mn = __int_as_float(0x7fc00000);  // quiet NaN: the empty-block sentinel
    st.mx = st.mn;
  }
  return st;
}

// grid (ceil(n_phys / (K * kWarpsPerCta)), batch): blockIdx.y is the lane,
// which reads ids[lane, :] ((batch, n_phys) row-major) and writes
// out[lane, :, :] ((batch, n_phys, 5)).  Within a lane, warp w owns sampled
// blocks K*w .. K*w + K - 1 (those below n_phys), kernels/column_launch.py's
// assignment.  kBytes: the value column is bool (load_row).
template <int K, bool kBytes>
__global__ void __launch_bounds__(kWarpsPerCta * kWarpSize)
    block_agg_kernel(RawColumn v, const uint8_t* __restrict__ valid,
                     const int32_t* __restrict__ ids, int n_phys,
                     int block_rows, float* __restrict__ out) {
  const int warp = blockIdx.x * kWarpsPerCta + (threadIdx.x / kWarpSize);
  const int lane = threadIdx.x % kWarpSize;
  const int first = warp * K;
  if (first >= n_phys) return;  // whole warps exit together
  // this CTA's id row: its ids and its output
  const int64_t row = blockIdx.y;
  ids += row * n_phys;
  out += row * n_phys * 5;
  // round 1: this warp's K ids, one load per lane
  int64_t base[K];
  bool live[K];
  first_round<K>(ids, ids, 0, first, n_phys, block_rows, lane, base, live);
  BlockStats acc[K];
#pragma unroll
  for (int j = 0; j < K; ++j) acc[j] = {0.0f, 0.0f, 0.0f, kBig, -kBig};
#pragma unroll 1
  for (int r0 = 0; r0 < block_rows; r0 += kWarpSize) {
    // round 2: every load of this row step of the K blocks (a lane past
    // the block's last row reads that row again) ...
    const int r = min(r0 + lane, block_rows - 1);
    RawRow rx[K];
    uint8_t rv[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int64_t i = base[j] + r;
      rv[j] = __ldg(valid + i);
      rx[j] = load_row<kBytes>(v, i);
    }
    // ... and only then the arithmetic, kept for live rows only
#pragma unroll
    for (int j = 0; j < K; ++j) {
      BlockStats next = acc[j];
      block_row(next, widen(rx[j], v.dtype), rv[j] != 0);
      if (live[j] && r0 + lane < block_rows) acc[j] = next;
    }
  }
  BlockStats st[K];
#pragma unroll
  for (int j = 0; j < K; ++j) st[j] = block_total(acc[j]);
  // lane j < K writes block first + j
  if (lane < K && first + lane < n_phys) {
    const BlockStats mine = own_slot<K>(st, lane);
    float* o = out + 5 * static_cast<int64_t>(first + lane);
    o[0] = mine.cnt;
    o[1] = mine.s;
    o[2] = mine.ss;
    o[3] = mine.mn;
    o[4] = mine.mx;
  }
}

}  // namespace repro_torch

namespace {

template <int K>
void launch_k(repro_torch::RawColumn v, const void* valid, const void* ids,
              int batch, int n_phys, int block_rows, void* out,
              cudaStream_t stream) {
  using namespace repro_torch;
  constexpr int per_cta = K * kWarpsPerCta;
  const dim3 grid((n_phys + per_cta - 1) / per_cta, batch);
  auto kernel = v.dtype == kBool ? block_agg_kernel<K, true> : block_agg_kernel<K, false>;
  kernel<<<grid, kWarpsPerCta * kWarpSize, 0, stream>>>(
      v, static_cast<const uint8_t*>(valid), static_cast<const int32_t*>(ids),
      n_phys, block_rows, static_cast<float*>(out));
}

}  // namespace

// ids (batch, n_phys) int32 and out (batch, n_phys, 5) f32, row-major; a
// solo call passes batch 1.  blocks_per_warp is K: 1, 2 or 4 (anything
// else: cudaErrorInvalidValue); batch at most 65,535 (the grid's y extent).
extern "C" int block_agg_launch(const void* values, int values_dtype,
                                const void* valid, const void* ids, int batch,
                                int n_phys, int block_rows, int blocks_per_warp,
                                void* out, void* stream) {
  using namespace repro_torch;
  if (batch <= 0 || n_phys <= 0) return static_cast<int>(cudaGetLastError());
  const Column col{values, values_dtype};
  const RawColumn v = raw_column(col, col, ids);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (blocks_per_warp) {
    case 1: launch_k<1>(v, valid, ids, batch, n_phys, block_rows, out, s); break;
    case 2: launch_k<2>(v, valid, ids, batch, n_phys, block_rows, out, s); break;
    case 4: launch_k<4>(v, valid, ids, batch, n_phys, block_rows, out, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* block_agg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
