// block_agg: per-sampled-block (count, sum, sumsq, min, max) over valid
// rows, CUDA C++ for sm_90a.
//
// Replaces the TPU kernels src/repro/kernels/block_agg/kernel.py
// block_agg_kernel (body _kernel, :92) and block_agg_batched_kernel (body
// _kernel_batched, :63).  A sampled block with no valid row gives
// count = sum = sumsq = 0 and min = max = NaN, the reference's sentinel.
//
// What bounds it on the H100.  On paper, device-memory bytes: per sampled
// block it reads block_rows rows of one 4-byte value column and the 1-byte
// validity column and does a few f32 operations per row: the bound is
// n_phys * block_rows * (4 + 1) bytes at 3.35 TB/s.  In practice, memory
// latency paid per warp: a 32-row block is 160 bytes, and a warp that owns
// one block and reads its value behind its validity byte waits on DRAM in
// several dependent rounds with a few hundred bytes in flight.
//
// Design against that, in the solo kernel: a warp owns K = 1, 2 or 4
// consecutive sampled blocks (template parameter; the wrapper picks K from
// n_phys, kernels/column_launch.py) and works in two rounds of memory: (1)
// its K ids in one coalesced load, shuffled to every lane; (2) the value
// and validity loads of all K blocks, one unconditional load_row each (no
// branch on the dtype), before the first instruction that uses one.
// Blocks longer than 32 rows are read one row step (32 rows of each of the
// K blocks) at a time.  Lane l accumulates rows l, l+32, ... of each block
// in that order through block_row and reduces through block_total, so the
// output is bitwise the same for every K.  The value column is read in its stored
// dtype (f32, int32, or the bool validity column itself for a COUNT-only
// query) and widened in registers, so a call moves no full-table cast or
// pad.  Padding ids (zeros past n_real) are computed like any block and
// masked by the caller.
//
// The batched kernel runs B lanes (id rows ids[b, :]) of a drain group's
// final scans in ONE launch over a (ceil(n_phys / warps-per-CTA), B) grid,
// one block per warp, read through block_stats.  Its bound is the same bytes
// count summed over lanes plus the (B, n_phys) ids and (B, n_phys, 5)
// output; over B solo launches it saves B - 1 launch latencies.  block_stats
// runs the same block_row and block_total as the solo kernel, so lane b is
// bitwise the solo kernel on ids[b, :].
#include <cuda_runtime.h>

#include <cstdint>

#include "../../csrc/block_reduce.cuh"

namespace repro_torch {

struct BlockStats {
  float cnt, s, ss, mn, mx;
};

// The per-row step both kernels run.
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

// The per-block body of the batched kernel (one block per warp, loads
// through load_f32).
__device__ __forceinline__ BlockStats block_stats(Column v,
                                                  const uint8_t* valid,
                                                  int64_t base, int block_rows,
                                                  int lane) {
  BlockStats a{0.0f, 0.0f, 0.0f, kBig, -kBig};
  for (int r = lane; r < block_rows; r += kWarpSize) {
    const int64_t i = base + r;
    block_row(a, load_f32(v, i), valid[i] != 0);
  }
  return block_total(a);
}

// grid ceil(n_phys / (K * kWarpsPerCta)): warp w owns sampled blocks
// K*w .. K*w + K - 1 (those below n_phys), kernels/column_launch.py's
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

// grid (ceil(n_phys / kWarpsPerCta), batch): blockIdx.y is the lane.
__global__ void __launch_bounds__(kWarpsPerCta * kWarpSize)
    block_agg_batched_kernel(Column v, const uint8_t* __restrict__ valid,
                             const int32_t* __restrict__ ids, int n_phys,
                             int block_rows, float* __restrict__ out) {
  const int warp = blockIdx.x * kWarpsPerCta + (threadIdx.x / kWarpSize);
  const int lane = threadIdx.x % kWarpSize;
  if (warp >= n_phys) return;  // whole warps exit together
  const int64_t slot = static_cast<int64_t>(blockIdx.y) * n_phys + warp;
  const int64_t base = static_cast<int64_t>(ids[slot]) * block_rows;
  const BlockStats st = block_stats(v, valid, base, block_rows, lane);
  if (lane == 0) {
    float* o = out + 5 * slot;
    o[0] = st.cnt;
    o[1] = st.s;
    o[2] = st.ss;
    o[3] = st.mn;
    o[4] = st.mx;
  }
}

}  // namespace repro_torch

namespace {

template <int K>
void launch_solo(repro_torch::RawColumn v, const void* valid, const void* ids,
                 int n_phys, int block_rows, void* out, cudaStream_t stream) {
  using namespace repro_torch;
  constexpr int per_cta = K * kWarpsPerCta;
  const dim3 grid((n_phys + per_cta - 1) / per_cta);
  auto kernel = v.dtype == kBool ? block_agg_kernel<K, true> : block_agg_kernel<K, false>;
  kernel<<<grid, kWarpsPerCta * kWarpSize, 0, stream>>>(
      v, static_cast<const uint8_t*>(valid), static_cast<const int32_t*>(ids),
      n_phys, block_rows, static_cast<float*>(out));
}

}  // namespace

// blocks_per_warp is K: 1, 2 or 4 (anything else: cudaErrorInvalidValue)
extern "C" int block_agg_launch(const void* values, int values_dtype,
                                const void* valid, const void* ids, int n_phys,
                                int block_rows, int blocks_per_warp, void* out,
                                void* stream) {
  using namespace repro_torch;
  if (n_phys <= 0) return static_cast<int>(cudaGetLastError());
  const Column col{values, values_dtype};
  const RawColumn v = raw_column(col, col, ids);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (blocks_per_warp) {
    case 1: launch_solo<1>(v, valid, ids, n_phys, block_rows, out, s); break;
    case 2: launch_solo<2>(v, valid, ids, n_phys, block_rows, out, s); break;
    case 4: launch_solo<4>(v, valid, ids, n_phys, block_rows, out, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int block_agg_batched_launch(const void* values, int values_dtype,
                                        const void* valid, const void* ids,
                                        int batch, int n_phys, int block_rows,
                                        void* out, void* stream) {
  using namespace repro_torch;
  if (batch <= 0 || n_phys <= 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid((n_phys + kWarpsPerCta - 1) / kWarpsPerCta, batch);
  const dim3 block(kWarpsPerCta * kWarpSize);
  block_agg_batched_kernel<<<grid, block, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      Column{values, values_dtype}, static_cast<const uint8_t*>(valid),
      static_cast<const int32_t*>(ids), n_phys, block_rows,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* block_agg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
