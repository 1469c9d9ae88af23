// Shared pieces of the per-sampled-block kernels (filtered_agg, block_agg).
//
// Lane l of the warp that owns a sampled block accumulates rows l, l+32, ...
// of that block in that order, so at block_rows = 32 a warp reads exactly
// one 128-byte segment of each 4-byte column (32 bytes of the bool validity
// column).  Lane partials are combined by a fixed __shfl_xor_sync butterfly:
// the reduction order is a function of block_rows alone, so results are
// bitwise equal run to run, whatever number of blocks a warp owns and
// whatever number of lanes (id rows) a launch carries.  No atomics, no
// shared memory.
//
// Each kernel issues every load of a row step first through load_row, with
// no branch on the dtype, and widens the raw rows afterwards, then hands
// the f32 values to the per-row step of its .cu (filtered_row, block_row)
// and reduces through warp_sum / warp_min / warp_max.
#pragma once

#include <cstdint>

namespace repro_torch {

constexpr int kWarpSize = 32;
constexpr int kWarpsPerCta = 8;
constexpr unsigned kFullMask = 0xffffffffu;

// dtype codes shared with the Python wrappers (kernels/_build.py DTYPE_CODES)
enum : int { kF32 = 0, kI32 = 1, kBool = 2, kAbsent = -1 };

// A column in its stored dtype, as the host describes it to raw_column.
// Values are widened to f32 in registers, exactly like the reference's
// per-block ``.astype(jnp.float32)``: the wrapper never materialises a cast,
// padded or ones column.
struct Column {
  const void* ptr;
  int dtype;
};

// A column as the kernels read it: row i is words[i & word_mask] for
// a 4-byte dtype (f32, int32) and bytes[i & byte_mask] for bool, each mask
// all ones or zero.  The other pointer of the pair reads the call's ids at
// row 0 (a mask of zero), so every load a kernel issues is in bounds and
// none needs a branch on the dtype.  An absent column (SUM(col) has no y)
// reads x again and widens to 1.0.
struct RawColumn {
  const unsigned int* words;
  int64_t word_mask;
  const unsigned char* bytes;
  int64_t byte_mask;
  int dtype;
};

// ``x`` is the call's first column; ``ids`` a 4-byte-aligned word the
// kernel may read.
inline RawColumn raw_column(Column c, Column x, const void* ids) {
  if (c.dtype == kAbsent) {
    RawColumn r = raw_column(x, x, ids);
    r.dtype = kAbsent;
    return r;
  }
  const bool bytes = c.dtype == kBool;
  return {static_cast<const unsigned int*>(bytes ? ids : c.ptr), bytes ? 0 : ~int64_t{0},
          static_cast<const unsigned char*>(bytes ? c.ptr : ids), bytes ? ~int64_t{0} : 0,
          c.dtype};
}

// The raw row of a column for widen: its word and its byte.
struct RawRow {
  uint32_t word;
  uint8_t byte;
};

// Row i of a column, loaded with no branch on the dtype, so a caller can
// issue every load of a row step, unconditionally, before it widens the
// first row.  Where no column of the call is bool (kBytes false) every
// column is 4 bytes wide and this is one 4-byte load; where some column is
// bool, every column loads its word and its byte (one of them row 0 of the
// ids, over and over).
template <bool kBytes>
__device__ __forceinline__ RawRow load_row(RawColumn c, int64_t i) {
  if constexpr (!kBytes) {
    return {__ldg(c.words + i), 0};
  } else {
    return {__ldg(c.words + (i & c.word_mask)), __ldg(c.bytes + (i & c.byte_mask))};
  }
}

// The f32 value of a raw row of a column of ``dtype``, selected without a
// branch: a bool row is 0 or nonzero (1.0 or 0.0), an int32 is rounded to
// nearest, an absent column (SUM(col) has no second factor) is 1.0.
__device__ __forceinline__ float widen(RawRow r, int dtype) {
  const float f = dtype == kF32 ? __uint_as_float(r.word)
                                : __int2float_rn(static_cast<int32_t>(r.word));
  const float b = r.byte != 0 ? 1.0f : 0.0f;
  return dtype == kAbsent ? 1.0f : (dtype == kBool ? b : f);
}

// __fadd_rn / __fmul_rn keep nvcc from contracting into FMAs, so each
// lane's partial rounds exactly like the reference's separate f32 ops.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = kWarpSize / 2; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(kFullMask, v, o));
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = kWarpSize / 2; o > 0; o >>= 1)
    v = fminf(v, __shfl_xor_sync(kFullMask, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = kWarpSize / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFullMask, v, o));
  return v;
}

// The first round of a kernel's warp that owns K consecutive sampled
// blocks first, first+1, ... of one id row ``ids`` (its CTA's blockIdx.y
// row): one 4-byte load per lane of the warp, lane j < K loading
// ids[first + j] and lane K + t loading extra[t] for t < n_extra (that id
// row's bounds), so the ids and the bounds arrive in one memory round.
// Every lane then receives block j's first row, base[j], by shuffle; the
// word this lane loaded is returned, for the caller to shuffle the extra
// words from lanes K, K+1, ...  live[j] is false for a slot past n_phys;
// its loads read the warp's last block again and its rows are not
// accumulated.
template <int K>
__device__ __forceinline__ uint32_t first_round(const int32_t* __restrict__ ids,
                                                const void* extra, int n_extra,
                                                int first, int n_phys,
                                                int block_rows, int lane,
                                                int64_t (&base)[K],
                                                bool (&live)[K]) {
  const bool is_extra = lane >= K && lane < K + n_extra;
  const auto* src =
      is_extra ? static_cast<const unsigned int*>(extra) + (lane - K)
               : reinterpret_cast<const unsigned int*>(ids) + min(first + lane % K, n_phys - 1);
  const uint32_t w = __ldg(src);
#pragma unroll
  for (int j = 0; j < K; ++j) {
    base[j] = static_cast<int64_t>(static_cast<int32_t>(__shfl_sync(kFullMask, w, j))) *
              block_rows;
    live[j] = first + j < n_phys;
  }
  return w;
}

// The value lane j holds for j < K: v[lane], selected without indexing a
// register array by a run-time value (which would put it in local memory).
template <int K, typename T>
__device__ __forceinline__ T own_slot(const T (&v)[K], int lane) {
  T mine = v[0];
#pragma unroll
  for (int j = 1; j < K; ++j)
    if (lane == j) mine = v[j];
  return mine;
}

}  // namespace repro_torch
