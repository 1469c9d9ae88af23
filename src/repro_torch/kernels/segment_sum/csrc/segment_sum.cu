// segment_sum: per-segment sums of every channel of a (C, R) f32 value
// matrix, added in a fixed order, CUDA C++ for sm_90a.
//
//   out[c, s] = sum of vals[c, r] over the rows r with seg[r] == s,
//   out (C, S) f32, 0 where no row has key s; a key outside [0, S) is
//   dropped.
//
// Replaces no Pallas kernel: it is the device reduction of the reference's
// gather route, the XLA scatter-add ``.at[:, seg].add(vals)`` of
// src/repro/engine/physical.py (dense_block_group_sums :256,
// dense_block_pair_sums :276, the query body :877-878, the pilot body
// :1072-1082).  A scatter-add with float atomics (index_add_ /
// scatter_add_ on CUDA) adds in an order that changes from run to run; the
// port's contracts (a batched lane bitwise its solo run, equal seeds equal
// answers) need the same bits every time.  Here the output is a function of
// the inputs alone: no atomics, and every sum runs in an order fixed by the
// keys and the row count.
//
// Three routes.  The wrapper (ops.py launch_plan) picks one on the host from
// (C, R, S) and the caller's slab claim alone, never from the card, so a
// call's bits depend on its inputs alone and no call needs a host sync.
//
// 1. slab: the caller states that every row r with a key in [0, S) has
//    key / W == r / slab_rows (the gather pilots: a pilot block's rows are
//    contiguous, its keys block * W + group or block * W + right block).
//    One warp per slab of slab_rows rows, sorting nothing: no other warp
//    writes the slab's keys, so no partials and no second pass.  The warp
//    walks its slab in steps of 32 rows (lane l: row p + l); in each step
//    __match_any_sync groups the lanes by key, and for each key, in the
//    order of its lowest lane, the fixed warp_sum butterfly of
//    block_reduce.cuh adds its rows (the other lanes give 0).  One
//    butterfly serves every channel of a pass (warp_sum_scatter: at each of
//    the first levels a lane keeps half of its channels, so channel j's sum
//    lands on lanes j * 32 / kPass ..., in warp_sum's own tree and bits).
//    A key's step sums are added in step order: for W <= 32 the slab's
//    lanes write every key of the slab (a slab of one step straight from
//    the lanes holding the sums, zeros for its absent keys; a longer one
//    through lane key - slab * W's registers), so the output needs no zero
//    fill; for a wider W (a join pilot's pair sums, W = the right table's
//    block count) the lanes holding a channel's sums add them into the
//    zero-filled output.  A row whose key breaks the claim is dropped, so
//    warps never race; the plain version raises on it.
// 2. few: no claim and S * C <= 4,096 (the finals and exact grouped scans,
//    S = 1 or 3; a pilot without a claim, S = n_phys * W).  The rows are cut
//    into ranges of range_rows rows (a power of two from R alone), one warp
//    each; lane l adds rows l, l + 32, ... of its range in row order.  For
//    S <= 4 every lane keeps every key's sums in registers (a predicated
//    add per key and channel), then the butterfly per key and channel; for
//    a larger S the warp keeps S * C sums in shared memory and adds each
//    step's key sums as the slab route does, the lanes holding a channel's
//    sum adding it to the key's slot.  A second launch adds the range
//    partials of each output in a fixed order: thread t of a 256-thread CTA
//    takes ranges t, t + 256, ... in order, then the butterfly per warp and
//    over the 8 warp sums.
// 3. sorted: everything else (S * C over the budget and no claim).  The
//    wrapper sorts the keys with a stable sort (ordering, not arithmetic),
//    so each segment's rows form one run of sorted positions, in row order.
//    Runs are cut into chunks at the multiples of ``chunk`` positions, so
//    no chunk spans two runs and none is longer than ``chunk``: 1,024 up to
//    2^24 rows, 4,096 above.  Lane l of the warp that owns a chunk adds its
//    positions l, l + 32, ... in that order, and the butterfly combines the
//    lanes; a chunk that is a whole run writes its sums straight to the
//    output.  A second pass sums each longer run's chunk partials in chunk
//    order: lane l takes chunks l, l + 32, ... of the run, then the same
//    butterfly.  Passes, all on the wrapper's stream: keys (int64 -> int32,
//    out of range -> -1, sorted first, never written), the torch.sort,
//    tile_count (warp per tile of ``chunk`` sorted positions: its chunk
//    count), tile_scan (one CTA: each tile's first chunk, the total last),
//    chunk_start (warp per tile: each chunk's start and key), chunk_sum
//    (warp per chunk) and run_sum (warp per longer run).
//
// Latency.  Every pass keeps several independent loads in flight per lane
// before its first add: the slab and few kernels load the keys and values
// of 4 row steps at once (a slab of 32 rows its one step; the few route's
// lane kernel 8, its fastest at the exact Q1's 5 channels on the H100), the
// sorted tile passes kTileUnroll steps of keys, its chunk pass the row
// indices, then the values, of kRowUnroll positions, and the range and run
// passes kRowUnroll partials.  The adds
// stay in the orders above, so the unrolling changes no bit.
//
// What bounds it on the H100: device-memory bytes.  Each route must read
// each value once and each key once and write the dense output once,
// R·C·4 + R·8 + S·C·4 bytes at 3.35 TB/s, with one f32 add per value.  The
// few route moves that and its range partials (S·C·4 bytes a range); the
// slab route that alone, except that its wide form writes the output twice
// (the wrapper's zero fill, then the sums), which matters only where S ≫ R
// and the fill is the bound anyway (a join pilot's 3.84 GB of pair sums).
// Their arithmetic is a predicated add per key slot and channel per row
// (few, S <= 4) or one scattered butterfly per distinct key per 32-row step
// (slab, few with S > 4): at the Q1 pilot's 3 keys and 5 channels (a pass
// of 8) per 32-row block, 27 shuffles a step where one butterfly per
// channel would take 75.  Below ~100k rows no byte count matters: the
// launches' own latency sets the time (one launch for a slab call, two for
// a few call).  The
// sorted route moves several times the bytes (the sort's radix passes over
// int32 keys and int64 row indices, the keys twice more, the row index once
// more, the values gathered through it) and makes seven launches.
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include "../../csrc/block_reduce.cuh"

namespace repro_torch {

constexpr int kScanThreads = 1024;
constexpr int kTileUnroll = 8;       // row steps of keys a tile pass loads at once
constexpr int kRowUnroll = 4;        // positions (partials) a lane loads at once

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

__global__ void __launch_bounds__(256)
    segment_keys_kernel(const int64_t* __restrict__ seg, int64_t rows,
                        int64_t num_segments, int32_t* __restrict__ keys) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       r < rows; r += stride) {
    const int64_t s = seg[r];
    keys[r] = (s >= 0 && s < num_segments) ? static_cast<int32_t>(s) : -1;
  }
}

// Whether sorted position p starts a chunk: a tile's first position (tiles
// are ``chunk`` positions, a power of two), or the first position of a run.
// Both loads are issued whatever p is.
__device__ __forceinline__ bool starts_chunk(const int32_t* __restrict__ skeys,
                                             int64_t p, int64_t chunk) {
  const int32_t prev = skeys[p > 0 ? p - 1 : 0];
  return ((p & (chunk - 1)) == 0) | (skeys[p] != prev);
}

// The chunk-start flags of row steps p0, p0 + 32, ... (kTileUnroll of
// them) at this lane, every key load issued before the first is used; a
// position at or past hi is no start.
__device__ __forceinline__ void start_flags(const int32_t* __restrict__ skeys,
                                            int64_t p0, int64_t hi, int64_t chunk,
                                            int lane, bool (&flag)[kTileUnroll]) {
#pragma unroll
  for (int u = 0; u < kTileUnroll; ++u) {
    const int64_t p = p0 + u * kWarpSize + lane;
    flag[u] = (p < hi) & starts_chunk(skeys, min64(p, hi - 1), chunk);
  }
}

// grid: one warp per tile of ``chunk`` sorted positions.
__global__ void __launch_bounds__(kWarpsPerCta * kWarpSize)
    segment_tile_count_kernel(const int32_t* __restrict__ skeys, int64_t rows,
                              int64_t chunk, int64_t tiles,
                              int32_t* __restrict__ tile_count) {
  const int64_t tile = static_cast<int64_t>(blockIdx.x) * kWarpsPerCta +
                       threadIdx.x / kWarpSize;
  const int lane = threadIdx.x % kWarpSize;
  if (tile >= tiles) return;  // whole warps exit together
  const int64_t lo = tile * chunk;
  const int64_t hi = min64(lo + chunk, rows);
  int n = 0;
  for (int64_t p0 = lo; p0 < hi; p0 += kWarpSize * kTileUnroll) {
    bool flag[kTileUnroll];
    start_flags(skeys, p0, hi, chunk, lane, flag);
#pragma unroll
    for (int u = 0; u < kTileUnroll; ++u) n += __popc(__ballot_sync(kFullMask, flag[u]));
  }
  if (lane == 0) tile_count[tile] = n;
}

// grid: one CTA of kScanThreads.  tile_first[t] = sum of tile_count[0..t),
// tile_first[tiles] = the chunk total.  Integer sums: exact in any order.
__global__ void __launch_bounds__(kScanThreads)
    segment_tile_scan_kernel(const int32_t* __restrict__ tile_count,
                             int64_t tiles, int64_t* __restrict__ tile_first) {
  __shared__ int64_t part[kScanThreads];
  const int t = threadIdx.x;
  const int64_t per = (tiles + kScanThreads - 1) / kScanThreads;
  const int64_t lo = min64(t * per, tiles);
  const int64_t hi = min64(lo + per, tiles);
  int64_t mine = 0;
  for (int64_t i = lo; i < hi; ++i) mine += tile_count[i];
  part[t] = mine;
  __syncthreads();
  // Hillis-Steele inclusive scan over the per-thread totals
  for (int o = 1; o < kScanThreads; o <<= 1) {
    const int64_t add = t >= o ? part[t - o] : 0;
    __syncthreads();
    part[t] += add;
    __syncthreads();
  }
  int64_t run = part[t] - mine;
  for (int64_t i = lo; i < hi; ++i) {
    tile_first[i] = run;
    run += tile_count[i];
  }
  if (t == kScanThreads - 1) tile_first[tiles] = part[t];
}

// grid: one warp per tile.  chunk_start[i] = the first sorted position of
// chunk i, chunks numbered in position order.
__global__ void __launch_bounds__(kWarpsPerCta * kWarpSize)
    segment_chunk_start_kernel(const int32_t* __restrict__ skeys, int64_t rows,
                               int64_t chunk, int64_t tiles,
                               const int64_t* __restrict__ tile_first,
                               int64_t* __restrict__ chunk_start,
                               int32_t* __restrict__ chunk_key) {
  const int64_t tile = static_cast<int64_t>(blockIdx.x) * kWarpsPerCta +
                       threadIdx.x / kWarpSize;
  const int lane = threadIdx.x % kWarpSize;
  if (tile >= tiles) return;
  const int64_t lo = tile * chunk;
  const int64_t hi = min64(lo + chunk, rows);
  int64_t next = tile_first[tile];
  const unsigned below = (1u << lane) - 1u;
  for (int64_t p0 = lo; p0 < hi; p0 += kWarpSize * kTileUnroll) {
    bool flag[kTileUnroll];
    start_flags(skeys, p0, hi, chunk, lane, flag);
#pragma unroll
    for (int u = 0; u < kTileUnroll; ++u) {
      const unsigned ballot = __ballot_sync(kFullMask, flag[u]);
      if (flag[u]) {
        const int64_t p = p0 + u * kWarpSize + lane;
        chunk_start[next + __popc(ballot & below)] = p;
        chunk_key[next + __popc(ballot & below)] = skeys[p];
      }
      next += __popc(ballot);
    }
  }
}

// The end (exclusive) of chunk i's positions.
__device__ __forceinline__ int64_t chunk_end(const int64_t* __restrict__ chunk_start,
                                             int64_t i, int64_t n_chunks,
                                             int64_t rows) {
  return i + 1 < n_chunks ? chunk_start[i + 1] : rows;
}

// grid-stride warps over the chunks of kept keys; chunk_sum is (channels,
// cap), and a chunk that is a whole run writes out[c, key] instead.  A lane
// keeps kPass channel sums (2 where that holds every channel, else 4 a pass)
// and kRowUnroll x kPass values in registers: at most 40 registers, so
// enough warps stay resident to hide the latency of many short chunks.
template <int kPass>
__global__ void __launch_bounds__(kWarpsPerCta * kWarpSize)
    segment_chunk_sum_kernel(const float* __restrict__ vals,
                             const int64_t* __restrict__ order,
                             const int64_t* __restrict__ chunk_start,
                             const int32_t* __restrict__ chunk_key,
                             const int64_t* __restrict__ n_chunks_at,
                             int64_t rows, int channels, int64_t cap,
                             int64_t num_segments, float* __restrict__ chunk_sum,
                             float* __restrict__ out) {
  const int lane = threadIdx.x % kWarpSize;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarpsPerCta;
  const int64_t n_chunks = *n_chunks_at;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kWarpsPerCta +
                   threadIdx.x / kWarpSize;
       i < n_chunks; i += warps) {
    const int32_t key = chunk_key[i];
    if (key < 0) continue;  // dropped keys
    const bool whole = (i == 0 || chunk_key[i - 1] != key) &&
                       (i + 1 == n_chunks || chunk_key[i + 1] != key);
    const int64_t lo = chunk_start[i];
    const int64_t hi = chunk_end(chunk_start, i, n_chunks, rows);
    for (int c0 = 0; c0 < channels; c0 += kPass) {
      float acc[kPass];
#pragma unroll
      for (int j = 0; j < kPass; ++j) acc[j] = 0.0f;
      // lane l: positions lo + l, lo + l + 32, ... in order, kRowUnroll
      // of them loaded (row index, then every value) before the first add;
      // a position at or past hi reads position lo and is not added
      for (int64_t p0 = lo + lane; p0 < hi; p0 += kWarpSize * kRowUnroll) {
        int64_t r[kRowUnroll];
#pragma unroll
        for (int u = 0; u < kRowUnroll; ++u) {
          const int64_t p = p0 + u * kWarpSize;
          r[u] = __ldg(order + (p < hi ? p : lo));
        }
        float v[kRowUnroll][kPass];
#pragma unroll
        for (int u = 0; u < kRowUnroll; ++u)
#pragma unroll
          for (int j = 0; j < kPass; ++j)
            v[u][j] = c0 + j < channels
                          ? __ldg(vals + static_cast<int64_t>(c0 + j) * rows + r[u])
                          : 0.0f;
#pragma unroll
        for (int u = 0; u < kRowUnroll; ++u)
          if (p0 + u * kWarpSize < hi)
#pragma unroll
            for (int j = 0; j < kPass; ++j) acc[j] = __fadd_rn(acc[j], v[u][j]);
      }
#pragma unroll
      for (int j = 0; j < kPass; ++j) {
        const float total = warp_sum(acc[j]);
        if (lane == 0 && c0 + j < channels) {
          if (whole)
            out[static_cast<int64_t>(c0 + j) * num_segments + key] = total;
          else
            chunk_sum[static_cast<int64_t>(c0 + j) * cap + i] = total;
        }
      }
    }
  }
}

// grid-stride warps over the chunks; the warp of the first chunk of a run
// of two or more chunks sums the run's chunk partials and writes out[c, key]
// for every channel.
template <int kPass>
__global__ void __launch_bounds__(kWarpsPerCta * kWarpSize)
    segment_run_sum_kernel(const int32_t* __restrict__ chunk_key,
                           const int64_t* __restrict__ n_chunks_at,
                           const float* __restrict__ chunk_sum, int channels,
                           int64_t cap, int64_t num_segments,
                           float* __restrict__ out) {
  const int lane = threadIdx.x % kWarpSize;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarpsPerCta;
  const int64_t n_chunks = *n_chunks_at;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kWarpsPerCta +
                   threadIdx.x / kWarpSize;
       i < n_chunks; i += warps) {
    const int32_t key = chunk_key[i];
    if (key < 0) continue;                        // dropped keys
    if (i > 0 && chunk_key[i - 1] == key) continue;  // not a run start
    // the run's chunks are i .. end - 1: the first 32 by one ballot, the end
    // of a longer run by binary search (chunk keys ascend)
    int64_t end;
    const unsigned same = __ballot_sync(
        kFullMask, i + lane < n_chunks && chunk_key[i + lane] == key);
    if (same != kFullMask) {
      end = i + __ffs(~same) - 1;
      if (end == i + 1) continue;  // a whole run in one chunk: written already
    } else {
      int64_t lo = i + kWarpSize, hi = n_chunks;  // chunk lo - 1 is in the run
      while (lo < hi) {
        const int64_t mid = lo + (hi - lo) / 2;
        if (chunk_key[mid] == key) lo = mid + 1; else hi = mid;
      }
      end = lo;
    }
    // lane l: partials i + l, i + l + 32, ... in order, kRowUnroll of
    // every channel of a pass loaded before the first add
    for (int c0 = 0; c0 < channels; c0 += kPass) {
      float acc[kPass];
#pragma unroll
      for (int c = 0; c < kPass; ++c) acc[c] = 0.0f;
      for (int64_t j0 = i + lane; j0 < end; j0 += kWarpSize * kRowUnroll) {
        float v[kRowUnroll][kPass];
#pragma unroll
        for (int u = 0; u < kRowUnroll; ++u) {
          const int64_t j = j0 + u * kWarpSize;
#pragma unroll
          for (int c = 0; c < kPass; ++c)
            v[u][c] = j < end && c0 + c < channels
                          ? chunk_sum[static_cast<int64_t>(c0 + c) * cap + j]
                          : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < kRowUnroll; ++u)
          if (j0 + u * kWarpSize < end)
#pragma unroll
            for (int c = 0; c < kPass; ++c) acc[c] = __fadd_rn(acc[c], v[u][c]);
      }
#pragma unroll
      for (int c = 0; c < kPass; ++c) {
        const float total = warp_sum(acc[c]);
        if (lane == 0 && c0 + c < channels)
          out[static_cast<int64_t>(c0 + c) * num_segments + key] = total;
      }
    }
  }
}


// ---------------------------------------------------------------------------
// The sort-free routes: slab and few
// ---------------------------------------------------------------------------

constexpr int kStepUnroll = 4;   // row steps of 32 whose loads a lane issues at once
constexpr int kFewUnroll = 8;    // the same in the few route's lane kernel
constexpr int kLaneKeys = 4;     // few route: keys a lane keeps in registers (S <= 4)
constexpr int kSlabLaneKeys = kWarpSize;  // slab route: W a warp keeps in lanes
constexpr int kRangeThreads = 256;        // range pass: threads per output

// One step's row at this lane: its key (-1 where the row is past the span
// or its key lies outside [key_lo, key_hi)) and its values of channels c0,
// c0 + 1, ... (0 past the last channel).
template <int kPass>
struct StepRow {
  int64_t key;
  float v[kPass];
};

// The rows p0 + u * 32 + lane, u < kSteps, of a span ending at hi: every key
// and value load issued before the first is used.
template <int kPass, int kSteps>
__device__ __forceinline__ void load_steps(const float* __restrict__ vals,
                                           const int64_t* __restrict__ seg, int64_t rows,
                                           int channels, int c0, int64_t p0, int64_t hi,
                                           int64_t key_lo, int64_t key_hi, int lane,
                                           StepRow<kPass> (&st)[kSteps]) {
  int64_t k[kSteps];
#pragma unroll
  for (int u = 0; u < kSteps; ++u) {
    const int64_t r = p0 + u * kWarpSize + lane;
    k[u] = r < hi ? __ldg(seg + r) : int64_t{-1};
  }
#pragma unroll
  for (int u = 0; u < kSteps; ++u) {
    const int64_t r = p0 + u * kWarpSize + lane;
#pragma unroll
    for (int j = 0; j < kPass; ++j)
      st[u].v[j] = r < hi && c0 + j < channels
                       ? __ldg(vals + static_cast<int64_t>(c0 + j) * rows + r)
                       : 0.0f;
  }
#pragma unroll
  for (int u = 0; u < kSteps; ++u)
    st[u].key = k[u] >= key_lo && k[u] < key_hi ? k[u] : int64_t{-1};
}

// The distinct keys among the lanes' rows of one step, taken in the order
// of each key's lowest lane (its leader): ``peers`` groups the lanes by key,
// ``todo`` holds the lanes whose key is not yet taken (the same on every
// lane, so the warp stays converged).
struct StepKeys {
  unsigned peers;
  unsigned todo;
};

template <int kPass>
__device__ __forceinline__ StepKeys step_keys(const StepRow<kPass>& row) {
  return {__match_any_sync(kFullMask, row.key), __ballot_sync(kFullMask, row.key >= 0)};
}

// The butterfly of warp_sum over kPass values at once: lane l gets the sum
// over the 32 lanes of x[l / (32 / kPass)].  The first log2(kPass) levels
// (partners lane ^ 16, ^ 8, ...) halve the values a lane holds: it keeps
// the upper half where its partner bit is set, the lower half otherwise, and
// adds its partner's copy of that half; the remaining levels are warp_sum's.
// Each sum is added in warp_sum's tree (the same pairs at the same levels),
// so it is bitwise warp_sum(x[j]), for kPass - 1 + 5 - log2(kPass)
// shuffles instead of 5 kPass.
template <int kPass>
__device__ __forceinline__ float warp_sum_scatter(float (&x)[kPass], int lane) {
#pragma unroll
  for (int h = kPass / 2, o = kWarpSize / 2; h >= 1; h /= 2, o /= 2) {
    const bool upper = lane & o;
#pragma unroll
    for (int i = 0; i < h; ++i) {
      const float keep = upper ? x[i + h] : x[i];
      const float send = upper ? x[i] : x[i + h];
      x[i] = __fadd_rn(keep, __shfl_xor_sync(kFullMask, send, o));
    }
  }
  float v = x[0];
#pragma unroll
  for (int o = kWarpSize / 2 / kPass; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(kFullMask, v, o));
  return v;
}

// The next key of a step, if any: its leader lane, and on lane l the key's
// sum over the lanes of channel c0 + l / (32 / kPass) (warp_sum_scatter of
// the lanes' values, the other keys' lanes giving 0).
template <int kPass>
__device__ __forceinline__ bool next_key(const StepRow<kPass>& row, int lane,
                                         StepKeys& keys, int64_t& key, int& leader,
                                         float& total) {
  if (keys.todo == 0) return false;
  leader = __ffs(keys.todo) - 1;
  const unsigned group = __shfl_sync(kFullMask, keys.peers, leader);
  key = __shfl_sync(kFullMask, row.key, leader);
  const bool mine = (group >> lane) & 1u;
  float x[kPass];
#pragma unroll
  for (int j = 0; j < kPass; ++j) x[j] = mine ? row.v[j] : 0.0f;
  total = warp_sum_scatter(x, lane);
  keys.todo &= ~group;
  return true;
}

// grid: one warp per slab, W <= 32.  The warp walks its slab in steps of 32
// rows, kSteps steps' loads at a time.  A slab of one step (kSteps 1)
// writes each present key's sums from the lanes that hold them and zeros
// for the slab's other keys; a longer slab gathers each step's sums into
// lane key - slab * W, which adds them in step order and writes them.
// Either way every key of the slab is written (0 where no row has it), so
// the output needs no zero fill.  Slabs past the rows write their zeros.
template <int kPass, int kSteps>
__global__ void __launch_bounds__(kWarpsPerCta * kWarpSize)
    segment_slab_lane_kernel(const float* __restrict__ vals,
                             const int64_t* __restrict__ seg, int64_t rows, int channels,
                             int64_t num_segments, int64_t slab_rows, int64_t width,
                             int64_t slabs, float* __restrict__ out) {
  constexpr int kLanesPer = kWarpSize / kPass;  // lanes holding one channel's sum
  const int64_t slab = static_cast<int64_t>(blockIdx.x) * kWarpsPerCta +
                       threadIdx.x / kWarpSize;
  const int lane = threadIdx.x % kWarpSize;
  if (slab >= slabs) return;  // whole warps exit together
  const int64_t base = slab * width;
  const int64_t lo = min64(slab * slab_rows, rows);
  const int64_t hi = min64(lo + slab_rows, rows);
  const int64_t key_hi = min64(base + width, num_segments);
  const int mine = lane / kLanesPer;             // the channel this lane's sums are
  const bool writer = lane % kLanesPer == 0;
  for (int c0 = 0; c0 < channels; c0 += kPass) {
    const int live = min(kPass, channels - c0);
    float acc[kPass];
#pragma unroll
    for (int j = 0; j < kPass; ++j) acc[j] = 0.0f;
    unsigned written = 0;  // kSteps 1: the slab keys written, bit key - base
    for (int64_t p0 = lo; p0 < hi; p0 += kWarpSize * kSteps) {
      StepRow<kPass> st[kSteps];
      load_steps(vals, seg, rows, channels, c0, p0, hi, base, key_hi, lane, st);
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        if (p0 + u * kWarpSize >= hi) continue;  // uniform: past the slab
        StepKeys keys = step_keys(st[u]);
        int64_t key;
        int leader;
        float total;
        while (next_key(st[u], lane, keys, key, leader, total)) {
          if constexpr (kSteps == 1) {
            if (writer && mine < live)
              out[static_cast<int64_t>(c0 + mine) * num_segments + key] = total;
            written |= 1u << (key - base);
          } else {
#pragma unroll
            for (int j = 0; j < kPass; ++j) {
              const float sum = __shfl_sync(kFullMask, total, j * kLanesPer);
              if (lane == key - base) acc[j] = __fadd_rn(acc[j], sum);
            }
          }
        }
      }
    }
    if (base + lane < key_hi && !((written >> lane) & 1u))
#pragma unroll
      for (int j = 0; j < kPass; ++j)
        if (j < live)
          out[static_cast<int64_t>(c0 + j) * num_segments + base + lane] = acc[j];
  }
}

// grid: one warp per slab of rows, W > 32.  The output is zero-filled by
// the caller; for each key of a step the lanes holding its sums add them
// to it (the same lane for a channel every step), in step order.
template <int kPass, int kSteps>
__global__ void __launch_bounds__(kWarpsPerCta * kWarpSize)
    segment_slab_wide_kernel(const float* __restrict__ vals,
                             const int64_t* __restrict__ seg, int64_t rows, int channels,
                             int64_t num_segments, int64_t slab_rows, int64_t width,
                             int64_t slabs, float* __restrict__ out) {
  constexpr int kLanesPer = kWarpSize / kPass;
  const int64_t slab = static_cast<int64_t>(blockIdx.x) * kWarpsPerCta +
                       threadIdx.x / kWarpSize;
  const int lane = threadIdx.x % kWarpSize;
  if (slab >= slabs) return;
  const int64_t base = slab * width;
  const int64_t lo = slab * slab_rows;
  const int64_t hi = min64(lo + slab_rows, rows);
  const int64_t key_hi = min64(base + width, num_segments);
  const int mine = lane / kLanesPer;
  const bool writer = lane % kLanesPer == 0;
  for (int c0 = 0; c0 < channels; c0 += kPass) {
    const bool live = writer && mine < channels - c0;
    for (int64_t p0 = lo; p0 < hi; p0 += kWarpSize * kSteps) {
      StepRow<kPass> st[kSteps];
      load_steps(vals, seg, rows, channels, c0, p0, hi, base, key_hi, lane, st);
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        if (p0 + u * kWarpSize >= hi) continue;
        StepKeys keys = step_keys(st[u]);
        int64_t key;
        int leader;
        float total;
        while (next_key(st[u], lane, keys, key, leader, total))
          if (live) {
            float* o = out + static_cast<int64_t>(c0 + mine) * num_segments + key;
            *o = __fadd_rn(*o, total);
          }
      }
    }
  }
}

// grid: one warp per range of rows, S <= kLaneKeys.  Lane l adds rows l,
// l + 32, ... of the range in row order into its slot of the row's key
// (acc[s], a predicated add: a key outside [0, S) matches no slot that is
// written), then the butterfly per key and channel.  partial is (C * S,
// ranges): partial[(c * S + s) * ranges + range].
template <int kPass>
__global__ void __launch_bounds__(kWarpsPerCta * kWarpSize)
    segment_few_lane_kernel(const float* __restrict__ vals,
                            const int64_t* __restrict__ seg, int64_t rows, int channels,
                            int num_segments, int64_t range_rows, int64_t ranges,
                            float* __restrict__ partial) {
  const int64_t range = static_cast<int64_t>(blockIdx.x) * kWarpsPerCta +
                        threadIdx.x / kWarpSize;
  const int lane = threadIdx.x % kWarpSize;
  if (range >= ranges) return;
  const int64_t lo = range * range_rows;
  const int64_t hi = min64(lo + range_rows, rows);
  for (int c0 = 0; c0 < channels; c0 += kPass) {
    float acc[kLaneKeys][kPass];
#pragma unroll
    for (int s = 0; s < kLaneKeys; ++s)
#pragma unroll
      for (int j = 0; j < kPass; ++j) acc[s][j] = 0.0f;
    for (int64_t p0 = lo + lane; p0 < hi; p0 += kWarpSize * kFewUnroll) {
      int64_t k[kFewUnroll];
      float v[kFewUnroll][kPass];
#pragma unroll
      for (int u = 0; u < kFewUnroll; ++u) {
        const int64_t r = p0 + u * kWarpSize;
        k[u] = r < hi ? __ldg(seg + r) : int64_t{-1};
      }
#pragma unroll
      for (int u = 0; u < kFewUnroll; ++u) {
        const int64_t r = p0 + u * kWarpSize;
#pragma unroll
        for (int j = 0; j < kPass; ++j)
          v[u][j] = r < hi && c0 + j < channels
                        ? __ldg(vals + static_cast<int64_t>(c0 + j) * rows + r)
                        : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kFewUnroll; ++u)
#pragma unroll
        for (int s = 0; s < kLaneKeys; ++s)
          if (k[u] == s)
#pragma unroll
            for (int j = 0; j < kPass; ++j) acc[s][j] = __fadd_rn(acc[s][j], v[u][j]);
    }
#pragma unroll
    for (int s = 0; s < kLaneKeys; ++s)
#pragma unroll
      for (int j = 0; j < kPass; ++j)
        if (s < num_segments && c0 + j < channels) {  // uniform
          const float total = warp_sum(acc[s][j]);
          if (lane == 0)
            partial[(static_cast<int64_t>(c0 + j) * num_segments + s) * ranges + range] =
                total;
        }
  }
}

// grid: one warp per range of rows, kLaneKeys < S and S * C small enough
// that kWarpsPerCta warps' S * C sums fit the CTA's dynamic shared memory.
// The warp's slots start at 0; each step's leader of a key adds the step's
// sums to its slots; the slots are the range's partials.
template <int kPass>
__global__ void __launch_bounds__(kWarpsPerCta * kWarpSize)
    segment_few_warp_kernel(const float* __restrict__ vals,
                            const int64_t* __restrict__ seg, int64_t rows, int channels,
                            int num_segments, int64_t range_rows, int64_t ranges,
                            float* __restrict__ partial) {
  extern __shared__ float warp_slots[];
  const int warp = threadIdx.x / kWarpSize;
  const int lane = threadIdx.x % kWarpSize;
  const int64_t range = static_cast<int64_t>(blockIdx.x) * kWarpsPerCta + warp;
  if (range >= ranges) return;  // no CTA-wide barrier follows
  const int n_slots = num_segments * channels;
  float* slot = warp_slots + warp * n_slots;
  for (int i = lane; i < n_slots; i += kWarpSize) slot[i] = 0.0f;
  __syncwarp();
  const int64_t lo = range * range_rows;
  const int64_t hi = min64(lo + range_rows, rows);
  constexpr int kLanesPer = kWarpSize / kPass;
  const int mine = lane / kLanesPer;
  for (int c0 = 0; c0 < channels; c0 += kPass) {
    const bool live = lane % kLanesPer == 0 && mine < channels - c0;
    for (int64_t p0 = lo; p0 < hi; p0 += kWarpSize * kStepUnroll) {
      StepRow<kPass> st[kStepUnroll];
      load_steps(vals, seg, rows, channels, c0, p0, hi, 0, num_segments, lane, st);
#pragma unroll
      for (int u = 0; u < kStepUnroll; ++u) {
        if (p0 + u * kWarpSize >= hi) continue;
        StepKeys keys = step_keys(st[u]);
        int64_t key;
        int leader;
        float total;
        while (next_key(st[u], lane, keys, key, leader, total))
          if (live) {
            float* o = slot + (c0 + mine) * num_segments + key;
            *o = __fadd_rn(*o, total);
          }
      }
    }
  }
  __syncwarp();
  for (int i = lane; i < n_slots; i += kWarpSize)
    partial[static_cast<int64_t>(i) * ranges + range] = slot[i];
}

// grid: one CTA of kRangeThreads per output (c, s): thread t adds the
// partials of ranges t, t + 256, ... in order, kRowUnroll loads in flight;
// then the butterfly in each warp and over the 8 warp sums (lanes 8.. give
// 0); out[c * S + s] = partial row c * S + s.
__global__ void __launch_bounds__(kRangeThreads)
    segment_range_sum_kernel(const float* __restrict__ partial, int64_t ranges,
                             float* __restrict__ out) {
  __shared__ float warp_total[kRangeThreads / kWarpSize];
  const int64_t slot = blockIdx.x;
  const float* p = partial + slot * ranges;
  const int lane = threadIdx.x % kWarpSize;
  const int warp = threadIdx.x / kWarpSize;
  float acc = 0.0f;
  for (int64_t i0 = threadIdx.x; i0 < ranges; i0 += kRangeThreads * kRowUnroll) {
    float v[kRowUnroll];
#pragma unroll
    for (int u = 0; u < kRowUnroll; ++u) {
      const int64_t i = i0 + u * kRangeThreads;
      v[u] = i < ranges ? p[i] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kRowUnroll; ++u)
      if (i0 + u * kRangeThreads < ranges) acc = __fadd_rn(acc, v[u]);
  }
  const float w = warp_sum(acc);
  if (lane == 0) warp_total[warp] = w;
  __syncthreads();
  if (warp == 0) {
    const float total = warp_sum(lane < kRangeThreads / kWarpSize ? warp_total[lane] : 0.0f);
    if (lane == 0) out[slot] = total;
  }
}

}  // namespace repro_torch

namespace {

constexpr int kThreads = repro_torch::kWarpsPerCta * repro_torch::kWarpSize;
constexpr int64_t kMaxCtas = 4096;  // grid-stride passes: at most 32,768 warps

unsigned ctas_for_warps(int64_t warps) {
  return static_cast<unsigned>((warps + repro_torch::kWarpsPerCta - 1) /
                               repro_torch::kWarpsPerCta);
}

}  // namespace

// seg (rows,) int64 -> keys (rows,) int32: the key, or -1 outside [0, S).
extern "C" int segment_sum_keys_launch(const void* seg, int64_t rows,
                                       int64_t num_segments, void* keys,
                                       void* stream) {
  using namespace repro_torch;
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  const int64_t ctas = std::min((rows + kThreads - 1) / kThreads, int64_t{65536});
  segment_keys_kernel<<<static_cast<unsigned>(ctas), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(seg), rows, num_segments, static_cast<int32_t*>(keys));
  return static_cast<int>(cudaGetLastError());
}

// skeys (rows,) int32 sorted (stable) and order (rows,) int64 the sort's
// row indices; vals (channels, rows) f32 row-major; out (channels, S) f32,
// zero-filled by the caller.  Scratch: tile_count (tiles,) int32,
// tile_first (tiles + 1,) int64, chunk_start (cap,) int64, chunk_key (cap,)
// int32 and chunk_sum (channels, cap) f32, where tiles = ceil(rows /
// chunk) and cap >= the number of chunks (rows, and tiles + the number of
// distinct keys, bound it).  ``chunk`` is a power of two.
extern "C" int segment_sum_launch(const void* vals, const void* order,
                                  const void* skeys, int64_t rows, int64_t chunk,
                                  int channels,
                                  int64_t num_segments, void* tile_count,
                                  void* tile_first, void* chunk_start,
                                  void* chunk_key, void* chunk_sum, int64_t cap,
                                  void* out, void* stream) {
  using namespace repro_torch;
  if (rows <= 0 || channels <= 0 || num_segments <= 0)
    return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t tiles = (rows + chunk - 1) / chunk;
  const auto* keys = static_cast<const int32_t*>(skeys);
  auto* counts = static_cast<int32_t*>(tile_count);
  auto* first = static_cast<int64_t*>(tile_first);
  auto* starts = static_cast<int64_t*>(chunk_start);
  auto* ckeys = static_cast<int32_t*>(chunk_key);
  auto* partials = static_cast<float*>(chunk_sum);
  segment_tile_count_kernel<<<ctas_for_warps(tiles), kThreads, 0, s>>>(keys, rows, chunk,
                                                                       tiles, counts);
  segment_tile_scan_kernel<<<1, kScanThreads, 0, s>>>(counts, tiles, first);
  segment_chunk_start_kernel<<<ctas_for_warps(tiles), kThreads, 0, s>>>(
      keys, rows, chunk, tiles, first, starts, ckeys);
  const unsigned ctas =
      static_cast<unsigned>(std::min(static_cast<int64_t>(ctas_for_warps(cap)), kMaxCtas));
  const auto sums = [&](auto pass) {
    constexpr int kPass = decltype(pass)::value;
    segment_chunk_sum_kernel<kPass><<<ctas, kThreads, 0, s>>>(
        static_cast<const float*>(vals), static_cast<const int64_t*>(order), starts, ckeys,
        first + tiles, rows, channels, cap, num_segments, partials,
        static_cast<float*>(out));
    segment_run_sum_kernel<kPass><<<ctas, kThreads, 0, s>>>(
        ckeys, first + tiles, partials, channels, cap, num_segments,
        static_cast<float*>(out));
  };
  if (channels <= 2)
    sums(std::integral_constant<int, 2>{});
  else
    sums(std::integral_constant<int, 4>{});
  return static_cast<int>(cudaGetLastError());
}

namespace {

// The instantiation of a kernel template over the channels a pass keeps.
template <typename F>
void by_pass(int channels, F&& f) {
  if (channels <= 1) f(std::integral_constant<int, 1>{});
  else if (channels <= 2) f(std::integral_constant<int, 2>{});
  else if (channels <= 4) f(std::integral_constant<int, 4>{});
  else f(std::integral_constant<int, 8>{});
}

// The few route's lane kernel keeps kLaneKeys x kPass sums a lane, so it is
// instantiated for each channel count up to 8, a predicated add per sum.
template <typename F>
void by_channels(int channels, F&& f) {
  switch (channels) {
    case 1: f(std::integral_constant<int, 1>{}); break;
    case 2: f(std::integral_constant<int, 2>{}); break;
    case 3: f(std::integral_constant<int, 3>{}); break;
    case 4: f(std::integral_constant<int, 4>{}); break;
    case 5: f(std::integral_constant<int, 5>{}); break;
    case 6: f(std::integral_constant<int, 6>{}); break;
    case 7: f(std::integral_constant<int, 7>{}); break;
    default: f(std::integral_constant<int, 8>{}); break;
  }
}

int invalid() { return static_cast<int>(cudaErrorInvalidValue); }

}  // namespace

// The slab route.  vals (channels, rows) f32 row-major, seg (rows,) int64,
// out (channels, S) f32.  The caller states that every row r with a key in
// [0, S) has key / width == r / slab_rows.  lane_slots (width <= 32): one
// warp per slab of max(ceil(rows / slab_rows), ceil(S / width)), writing
// every output; otherwise one warp per slab of rows, adding into an out
// the caller zero-filled.
extern "C" int segment_sum_slab_launch(const void* vals, const void* seg, int64_t rows,
                                       int channels, int64_t num_segments,
                                       int64_t slab_rows, int64_t width, int lane_slots,
                                       void* out, void* stream) {
  using namespace repro_torch;
  if (rows < 0 || channels <= 0 || num_segments <= 0 || slab_rows <= 0 || width <= 0 ||
      (lane_slots && width > kSlabLaneKeys))
    return invalid();
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t row_slabs = (rows + slab_rows - 1) / slab_rows;
  const int64_t slabs =
      lane_slots ? std::max(row_slabs, (num_segments + width - 1) / width) : row_slabs;
  if (slabs == 0) return static_cast<int>(cudaGetLastError());
  const unsigned ctas = ctas_for_warps(slabs);
  const auto* v = static_cast<const float*>(vals);
  const auto* k = static_cast<const int64_t*>(seg);
  auto* o = static_cast<float*>(out);
  // a slab of at most 32 rows is one step: keep no registers for more
  const auto launch = [&](auto pass, auto steps) {
    constexpr int kPass = decltype(pass)::value;
    constexpr int kSteps = decltype(steps)::value;
    if (lane_slots)
      segment_slab_lane_kernel<kPass, kSteps><<<ctas, kThreads, 0, s>>>(
          v, k, rows, channels, num_segments, slab_rows, width, slabs, o);
    else
      segment_slab_wide_kernel<kPass, kSteps><<<ctas, kThreads, 0, s>>>(
          v, k, rows, channels, num_segments, slab_rows, width, slabs, o);
  };
  by_pass(channels, [&](auto pass) {
    if (slab_rows <= kWarpSize)
      launch(pass, std::integral_constant<int, 1>{});
    else
      launch(pass, std::integral_constant<int, kStepUnroll>{});
  });
  return static_cast<int>(cudaGetLastError());
}

// The few route.  vals, seg and out as above; partial (channels * S,
// ceil(rows / range_rows)) f32 scratch.  lane_slots: S <= 4, registers;
// otherwise the warps' S * channels sums in dynamic shared memory.  Then
// one CTA per output adds the ranges' partials.
extern "C" int segment_sum_few_launch(const void* vals, const void* seg, int64_t rows,
                                      int channels, int64_t num_segments,
                                      int64_t range_rows, int lane_slots, void* partial,
                                      void* out, void* stream) {
  using namespace repro_torch;
  const int64_t n_slots = num_segments * channels;
  const int64_t smem = kWarpsPerCta * n_slots * static_cast<int64_t>(sizeof(float));
  if (rows <= 0 || channels <= 0 || num_segments <= 0 || range_rows <= 0 ||
      (lane_slots ? num_segments > kLaneKeys : smem > 232448))
    return invalid();
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t ranges = (rows + range_rows - 1) / range_rows;
  const unsigned ctas = ctas_for_warps(ranges);
  const auto* v = static_cast<const float*>(vals);
  const auto* k = static_cast<const int64_t*>(seg);
  auto* part = static_cast<float*>(partial);
  const int nseg = static_cast<int>(num_segments);
  if (lane_slots) {
    by_channels(channels, [&](auto pass) {
      constexpr int kPass = decltype(pass)::value;
      segment_few_lane_kernel<kPass><<<ctas, kThreads, 0, s>>>(
          v, k, rows, channels, nseg, range_rows, ranges, part);
    });
  } else {
    int rc = 0;
    by_pass(channels, [&](auto pass) {
      constexpr int kPass = decltype(pass)::value;
      rc = static_cast<int>(cudaFuncSetAttribute(segment_few_warp_kernel<kPass>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem)));
      if (rc == 0)
        segment_few_warp_kernel<kPass><<<ctas, kThreads, static_cast<size_t>(smem), s>>>(
            v, k, rows, channels, nseg, range_rows, ranges, part);
    });
    if (rc != 0) return rc;
  }
  const int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  segment_range_sum_kernel<<<static_cast<unsigned>(n_slots), kRangeThreads, 0, s>>>(
      part, ranges, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}


extern "C" const char* segment_sum_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
