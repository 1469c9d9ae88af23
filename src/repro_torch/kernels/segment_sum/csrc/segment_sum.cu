// segment_sum: per-segment sums of every channel of a (C, R) f32 value
// matrix, added in a fixed order, CUDA C++ for sm_90a.
//
//   out[c, s] = sum of vals[c, r] over the rows r with seg[r] == s,
//   out (C, S) f32, 0 where no row has key s.
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
// keys.
//
// The order.  The wrapper sorts the keys with a stable sort (ordering, not
// arithmetic), so each segment's rows form one run of sorted positions, in
// row order.  Runs are cut into chunks at the multiples of ``chunk``
// positions, so no chunk spans two runs and none is longer than ``chunk``:
// 1,024 up to 2^24 rows, 4,096 above (the wrapper's choice, a function of
// the row count alone), so a short input has enough chunks to spread over
// the card and a long run few enough partials for the one warp that adds
// them.  Lane l of the warp that owns a chunk adds its positions l, l + 32,
// ... in that order, and the fixed warp_sum butterfly of block_reduce.cuh
// combines the lanes; a chunk that is a whole run writes its sums straight
// to the output.  A second pass sums each longer run's chunk partials in
// chunk order: lane l takes chunks l, l + 32, ... of the run, then the same
// butterfly.  The grouped exact scan of TPC-H Q1 at SF10 puts 60M rows into
// 3 runs (~4,900 chunks each, all warps busy); a final's 65,536 rows into 3
// runs make 66 chunks; a pilot puts 32,768 rows into runs of one or a few
// rows (one short chunk per warp, each a whole run).
//
// Latency.  Below a few million rows too few warps are in flight to hide
// device-memory latency, so each pass keeps several independent loads in
// flight per lane: the tile passes read kTileUnroll row steps of keys
// before their first ballot, the chunk pass the row indices of kRowUnroll
// positions, then their values, before its first add, and the run pass
// kRowUnroll partials of every channel of a pass.  The adds stay in the
// order above, so the unrolling changes no bit.
//
// Passes, all on the wrapper's stream:
//   keys        seg (int64) -> int32 keys, a key outside [0, S) -> -1
//               (sorted first, never written: a scatter drops it);
//   (torch.sort of the keys, stable, in the wrapper)
//   tile_count  warp per tile of ``chunk`` sorted positions: its chunk count
//               (its first position, plus each run start inside it);
//   tile_scan   one CTA: exclusive prefix of the tile counts -> each
//               tile's first chunk index, the chunk total last;
//   chunk_start warp per tile: the start position and key of each of its
//               chunks;
//   chunk_sum   warp per chunk: the chunk's sum of every channel, written
//               to the zero-filled (C, S) output where the chunk is a
//               whole run;
//   run_sum     warp per longer run: its chunk partials in chunk order,
//               written to the output at the run's key.
//
// What bounds it on the H100: device-memory bytes.  The function reads each
// value once and each key once and writes the dense output once:
// R·C·4 + R·8 + S·C·4 bytes (R·C·4 + R·12 + S·C·4 where one also counts a
// 4-byte row index the ordered sum has to carry), at 3.35 TB/s, with a few
// f32 adds per value.  This design moves several times that: the sort
// (radix passes over int32 keys and int64 row indices), the keys twice more
// (tile_count, chunk_start), the row index once more, and the values
// gathered through it.  The wrapper's zero fill is the output write of the
// bound, which dominates when S ≫ R (a join pilot's pair sums).  Below
// ~100k rows no byte count matters: the stable sort's own launches and the
// six passes' launch latencies set the time, several times that of one
// index_add_ launch; a sort-free pass for few segments is the next step.
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

extern "C" const char* segment_sum_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
