// The single-pass ordered compaction's tile protocol, shared by
// taqa_draw_compact (taqa_solve/csrc/taqa_solve.cu) and block_draw
// (block_draw/csrc/block_draw.cu): each CTA takes a tile, counts what it
// keeps, learns how many every earlier tile kept by a decoupled look-back,
// and writes its kept ids at their ranks.
//
// Tickets.  A CTA takes its tile from an integer ticket (atomicAdd), so tiles
// start in index order and a tile waits only on tiles that are already
// running: the look-back makes progress when the tiles outnumber the
// resident CTAs.
//
// The look-back.  A tile publishes its count as an aggregate status word.
// Warp 0 then resolves the tile's exclusive prefix from its predecessors'
// status words, 128 a window, newest first: the aggregates up to the first
// inclusive prefix, whose value ends the sum (relaxed reads with a short
// back-off while a status is missing, then one fence: the acquire).  It
// publishes the inclusive prefix.  Statuses are released with
// st.release.gpu by one thread after a __syncthreads, the pattern of
// CUTLASS's semaphore.  Integer counts are exact in any order.
//
// The scratch lives in a buffer the wrapper keeps per (device, stream):
// word 0 holds an epoch and the ticket, word 1 the wrap launch's done count,
// then one status word per tile: epoch, inclusive flag, count.  A status of
// another epoch reads as unpublished, so no launch clears the words of the
// last one.  The CTA that takes a launch's last ticket sets the next epoch
// and ticket 0 (every ticket is then taken); the epoch lives on the card, so
// a CUDA graph's replays advance it too.  Before the 32-bit epoch repeats,
// the launch of the last epoch counts its tiles past their look-backs
// (word 1), and the tile that completes the count clears every status word,
// so no stale word can carry a later launch's epoch.  Launches on one stream
// never overlap, so each finds the ticket at zero; the drain's worker
// threads launch on their own current streams, each with its own buffer, or
// share a stream and so run one after the other.  No host sync, no fill
// launch.
#pragma once

#include <cstdint>

namespace repro_torch {

constexpr int kLookWords = 4;  // status words per lane of a look-back window
constexpr unsigned long long kInclusive = 1ull << 31;  // status word: epoch | flag | count
constexpr unsigned long long kCount = kInclusive - 1;
constexpr unsigned kLastEpoch = 0xffffffffu;  // epochs run 1, ..., kLastEpoch, 1, ...

__device__ __forceinline__ unsigned long long load_relaxed(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ void fence_acq_rel() { asm volatile("fence.acq_rel.gpu;" ::: "memory"); }

// Thread 0 of a CTA: its tile and the launch's epoch, from the ticket in
// scratch[0]; the CTA that takes the last ticket sets the next epoch and
// ticket 0.
__device__ inline void take_ticket(unsigned long long* scratch, int n_tiles, int* tile,
                                   unsigned* epoch) {
  const unsigned long long word = atomicAdd(scratch, 1ull);
  *epoch = static_cast<unsigned>(word >> 32);
  *tile = static_cast<int>(word & 0xffffffffu);
  if (*tile == n_tiles - 1) {  // every ticket of this launch is taken
    const unsigned next = *epoch == kLastEpoch ? 1u : *epoch + 1u;
    scratch[0] = static_cast<unsigned long long>(next) << 32;
  }
}

// Warp 0 of tile `tile` > 0: the kept count of every earlier tile.  Lane l
// reads word q of a window at tile end - (32 q + l); a window is summed up
// to its first inclusive prefix, once every status up to it carries this
// launch's epoch.  Relaxed reads, then one fence: the acquire.
__device__ inline int look_back(const unsigned long long* status, int tile, unsigned epoch,
                                int lane) {
  const unsigned full = 0xffffffffu;
  const unsigned long long mine = static_cast<unsigned long long>(epoch) << 32;
  int excl = 0;
  for (int end = tile - 1;;) {
    unsigned long long w[kLookWords];
#pragma unroll
    for (int q = 0; q < kLookWords; ++q) {
      const int idx = end - (32 * q + lane);
      w[q] = idx >= 0 ? load_relaxed(status + idx) : mine | kInclusive;
    }
    int first = 32 * kLookWords;  // the window's first inclusive slot, if any
#pragma unroll
    for (int q = kLookWords - 1; q >= 0; --q) {
      const unsigned m = __ballot_sync(full, (w[q] & ~kCount) == (mine | kInclusive));
      if (m) first = 32 * q + __ffs(m) - 1;
    }
    bool wait = false;
    int sum = 0;
#pragma unroll
    for (int q = 0; q < kLookWords; ++q) {
      if (32 * q + lane <= first) {
        wait = wait || (w[q] >> 32) != epoch;
        sum += static_cast<int>(w[q] & kCount);
      }
    }
    if (__any_sync(full, wait)) {  // a status not yet published: back off, read again
      __nanosleep(100);
      continue;
    }
    excl += __reduce_add_sync(full, sum);
    if (first < 32 * kLookWords) {
      fence_acq_rel();
      return excl;
    }
    end -= 32 * kLookWords;
  }
}

// Warp 0 of a tile that keeps `agg`, after a __syncthreads that ends the
// tile's counting: publishes the aggregate, looks back, publishes the
// inclusive prefix, and returns the tile's exclusive prefix on every lane.
// On the wrap launch lane 0 then counts the tile past its look-back, and
// *clear (lane 0's) says whether it completed the count and so clears the
// statuses with clear_statuses once the tile's writes are done.
__device__ inline int tile_prefix(unsigned long long* scratch, int tile, int n_tiles,
                                  unsigned epoch, int agg, int lane, bool* clear) {
  unsigned long long* status = scratch + 2;
  const unsigned long long mine = static_cast<unsigned long long>(epoch) << 32;
  int excl = 0;
  if (tile == 0) {
    if (lane == 0) store_release(status, mine | kInclusive | static_cast<unsigned>(agg));
  } else {
    if (lane == 0) store_release(status + tile, mine | static_cast<unsigned>(agg));
    excl = look_back(status, tile, epoch, lane);
    if (lane == 0)
      store_release(status + tile, mine | kInclusive | static_cast<unsigned>(excl + agg));
  }
  __syncwarp();  // every lane's look-back reads before the done count
  *clear = false;
  if (lane == 0 && epoch == kLastEpoch) {
    fence_acq_rel();
    *clear = atomicAdd(reinterpret_cast<unsigned*>(scratch + 1), 1u) ==
             static_cast<unsigned>(n_tiles - 1);
    fence_acq_rel();
  }
  return excl;
}

// Thread t of `threads` in the tile that tile_prefix named: every look-back
// of the wrap launch is over, so its `words` status words and its done count
// go back to zero and no stale tag survives.
__device__ inline void clear_statuses(unsigned long long* scratch, int words, int t,
                                      int threads) {
  for (int j = t; j < words; j += threads) scratch[2 + j] = 0;
  if (t == 0) scratch[1] = 0;
}

}  // namespace repro_torch
