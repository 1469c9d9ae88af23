// block_draw: TABLESAMPLE SYSTEM's Bernoulli block draw on the card, CUDA C++
// for sm_90a.  One launch: keep block i where uniform i of numpy's
// default_rng(seed) stream lies below the rate, in f64, and write the kept
// ids in ascending order with their count: bitwise the host draw
// (engine/sampling.py draw_block_ids, `default_rng(seed).random(N) < rate`
// then `nonzero`).
//
// Replaces no Pallas kernel.  The reference draws its blocks on the host with
// numpy, as the port's host draw still does for the paths that need host ids
// (the staged and sharded sub-draws, the fused path's check, the eager
// executor, CPU tables); this kernel takes that draw to the card for the
// scans that read their ids there.
//
// The stream.  numpy's PCG64 is a 128-bit LCG, s <- A s + inc (mod 2^128),
// whose uniform i is (xsl_rr(s_(i+1)) >> 11) * 2^-53; the host passes the
// seed's s_0 and inc by value (np.random.PCG64(seed).state), so no copy to
// the card is made.  A jump by d is s_d = A^d s_0 + G_d inc with G_d =
// sum_(j<d) A^j; kJump holds (A^(2^k), G_(2^k)) for k < 32, which depend on
// no seed (ref.py derives the same table, and a test compares the two).  A
// CTA first forms G_(2^k) inc in shared memory; each thread then jumps to the
// first index of its chunk of kChunk consecutive indices, one multiply-add a
// set bit of the index + 1, and steps through the chunk, one multiply-add an
// index.  A 128-bit product mod 2^128 is three 64-bit products and a high
// half (__umul64hi).  The uniform is formed and compared in f64 as numpy
// forms and compares it, so the keep bits are numpy's.
//
// The compaction is taqa_draw_compact's single-pass design, its tickets,
// decoupled look-back, status words and scratch shared through
// csrc/look_back.cuh: a CTA takes its tile from a ticket, so tiles start in
// index order, counts what it keeps, and warp 0 resolves the tile's
// exclusive prefix over its predecessors' statuses.  A thread's ids are
// consecutive, so its rank within the tile is an exclusive scan of the
// threads' counts in thread order (a shuffle scan in each warp, then the 8
// warp sums).  Integer counts are exact in any order, so the ids are the
// same bits run to run.
//
// The output.  The last tile writes the count and zeroes the ids from the
// count up to min(bucket(count), N), the bucketed physical length of
// sampling.pad_block_ids, which is a function of the count alone: the first
// n_phys ids are then the padded draw, and the host copies those out after
// it has read the count.  Kept ids land below the count and the zeros at or
// above it, so no two writers meet.
//
// Bounds on the H100.  The draw must make N uniforms, one 128-bit
// multiply-add each, and write its kept ids, n_real * 4 bytes: nothing is
// read but the 2 KB table.  As compiled for sm_90a a step of the chunk loop
// (multiply-add, output, conversion, compare) is 36 instructions, 13 of them
// integer multiplies, so issuing N steps at 4 warp-instructions a clock an
// SM takes 2.0 us at SF10's 1,875,000 blocks and 10.0 us at SF100's
// 9,375,000 (1,980 MHz); the kept ids are a few KB.  The design spends what
// it can there: no uniform is stored, a thread's jump (about 11
// multiply-adds) is shared by its 16 indices, the tiles of 4,096 indices
// give 458 CTAs at SF10 to hide each thread's chain of dependent products,
// and only kept ids are written.

#include <cstdint>
#include <climits>
#include <cuda_runtime.h>

#include "../../csrc/look_back.cuh"

namespace {

using repro_torch::clear_statuses;
using repro_torch::take_ticket;
using repro_torch::tile_prefix;

constexpr int kThreads = 256;  // a CTA
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 16;     // consecutive indices a thread draws
constexpr int kTile = kThreads * kChunk;
constexpr int kJumps = 32;     // jumps by 2^0 ... 2^31: an index + 1 is at most 2^31
constexpr unsigned kFull = 0xffffffffu;

struct U128 {
  unsigned long long lo, hi;
};

// {A^(2^k) lo, hi, G_(2^k) lo, hi} mod 2^128, A = PCG's default 128-bit multiplier
__constant__ unsigned long long kJump[kJumps][4] = {
    {0x4385df649fccf645ull, 0x2360ed051fc65da4ull, 0x0000000000000001ull, 0x0000000000000000ull},  // 2^0
    {0x529ed9eb20e0ae99ull, 0x17bce35bdf69743cull, 0x4385df649fccf646ull, 0x2360ed051fc65da4ull},  // 2^1
    {0xd194dfbe42d45771ull, 0xf4dd417327db7a9bull, 0x817fa187adefba1cull, 0x610e11a14b07e063ull},  // 2^2
    {0xd1a2d6f33505ffe1ull, 0x6347af777a7898f6ull, 0x292967d144306478ull, 0x22ab9b110b39425cull},  // 2^3
    {0xf6ef6d3d288c03c1ull, 0xb6a4239f3b315f84ull, 0xa9072151352439f0ull, 0x6ed699db168fb143ull},  // 2^4
    {0x82b631ba6b261781ull, 0x2c82901ad1cb0cd1ull, 0xe2deea36e161b7e0ull, 0x8b144946fe438d94ull},  // 2^5
    {0xe49e66c4d2746f01ull, 0xdab03f988288676eull, 0xdf08a33a26647fc0ull, 0xdb8761d6953b44b4ull},  // 2^6
    {0x84fe009a6d09de01ull, 0x602167331d86cf56ull, 0x6f07a26f432d3f80ull, 0x8c092058667b980dull},  // 2^7
    {0xf04c80a23697bc01ull, 0x61ecb5c24d95b058ull, 0xfca794c07eeb7f00ull, 0x199cae2243bd8562ull},  // 2^8
    {0x60474e83bf3f7801ull, 0x4a5c31e0654c28aaull, 0x27636e67d81afe00ull, 0x87d1e4ce03f09acaull},  // 2^9
    {0x478331d3c6bef001ull, 0xae4f079d54fbece1ull, 0xd185d642d945fc00ull, 0x81417387e08bb69aull},  // 2^10
    {0x7ff1ed50ae7de001ull, 0x101b8cb830c7cb92ull, 0x437e6f1056cbf800ull, 0xe093f57a0dda0f13ull},  // 2^11
    {0x563f3505e0fbc001ull, 0xf54a27fc056b00e7ull, 0xea79ae3b3e97f000ull, 0x3a0ec29f30ee08f0ull},  // 2^12
    {0xf98d719dd1f78001ull, 0xdf8a6fc1a833d201ull, 0x8022cc60c12fe000ull, 0xb3716586d218cca0ull},  // 2^13
    {0xa7e3f183e3ef0001ull, 0x5480a5015f101a4eull, 0x91c4d46a925fc000ull, 0x25e1de6cc7a9c89bull},  // 2^14
    {0x5f539c28c7de0001ull, 0xa498509e76e5d792ull, 0x3d92777964bf8000ull, 0x4bc96ebfe12bf7d0ull},  // 2^15
    {0x60121cd58fbc0001ull, 0x0798a3d8b10dc72eull, 0x63a72983c97f0000ull, 0x5d57b94afaf08e76ull},  // 2^16
    {0x5fafcbbb1f780001ull, 0x1647d1e78ec02e66ull, 0x6c4f3d4b92fe0000ull, 0x26d2394f2dc26b7eull},  // 2^17
    {0x0c8ddfb63ef00001ull, 0xa7c982285e72bf8cull, 0x846223a725fc0000ull, 0x092acaf128cba5f3ull},  // 2^18
    {0xc5d4e06c7de00001ull, 0x3eb78ee8fb8c56dbull, 0x75d2eb8e4bf80000ull, 0xb9ff6d21bd6edb42ull},  // 2^19
    {0xfe8e44d8fbc00001ull, 0x72d03b6f4681f2f9ull, 0x8fe0681c97f00000ull, 0x72f64944eb196ff8ull},  // 2^20
    {0xc8ae99b1f7800001ull, 0xea85f81e4f502c9bull, 0x30ab14392fe00000ull, 0xd2a8477e4dbba5efull},  // 2^21
    {0xbfa57363ef000001ull, 0x629c320db08b00c6ull, 0xa4ff38725fc00000ull, 0x3fee0d4f29496552ull},  // 2^22
    {0x386be6c7de000001ull, 0xc5c4b9ce268d074aull, 0x58a2b0e4bf800000ull, 0x90c0589db5533c56ull},  // 2^23
    {0x555bcd8fbc000001ull, 0xf30bbbbed1596187ull, 0xebd661c97f000000ull, 0xc96ad9dd31689e70ull},  // 2^24
    {0x3cc79b1f78000001ull, 0x4a1000fb26c9eedaull, 0xc1f0c392fe000000ull, 0x8eb88b115bdccbf2ull},  // 2^25
    {0xc1cf363ef0000001ull, 0x89fb5307f6bf8ce2ull, 0x2cf18725fc000000ull, 0xe5d914dd8bff9429ull},  // 2^26
    {0xa49e6c7de0000001ull, 0x830b7b3358a5d67eull, 0xfe230e4bf8000000ull, 0x24e6dd9de9d51960ull},  // 2^27
    {0xcd3cd8fbc0000001ull, 0xfd8a51da91a69fe1ull, 0x8d461c97f0000000ull, 0x7641328320f1f6fcull},  // 2^28
    {0xaa79b1f780000001ull, 0x901a48b642b90b55ull, 0x5e8c392fe0000000ull, 0x8b038003a682fee3ull},  // 2^29
    {0x94f363ef00000001ull, 0x118cdefdf32144f3ull, 0xcd18725fc0000000ull, 0xf0855afe5b82416full},  // 2^30
    {0x29e6c7de00000001ull, 0x0a88c0a91cff4308ull, 0xda30e4bf80000000ull, 0xfcd399e4d0f59183ull},  // 2^31
};

__device__ __forceinline__ U128 mul(U128 a, U128 b) {  // a * b mod 2^128
  return {a.lo * b.lo, __umul64hi(a.lo, b.lo) + a.lo * b.hi + a.hi * b.lo};
}

__device__ __forceinline__ U128 add(U128 a, U128 b) {
  const unsigned long long lo = a.lo + b.lo;
  return {lo, a.hi + b.hi + (lo < a.lo)};
}

// PCG64's output: the xor of the state's halves rotated right by its top six bits
__device__ __forceinline__ unsigned long long xsl_rr(U128 s) {
  const unsigned long long x = s.hi ^ s.lo;
  const unsigned rot = static_cast<unsigned>(s.hi >> 58);
  return (x >> rot) | (x << ((64u - rot) & 63u));
}

// sampling.pad_block_ids's physical length: the count's power-of-two bucket,
// at least 64, at most n
__device__ __forceinline__ int64_t padded_length(int64_t count, int64_t n) {
  const int64_t k = count > 1 ? count : 1;
  const int64_t bucket = k <= 64 ? 64 : int64_t{1} << (64 - __clzll(k - 1));
  return bucket < n ? bucket : n;
}

// scratch (2 + capacity u64): [0] epoch << 32 | ticket, [1] the done count of
// the wrap launch, [2, 2 + capacity) the status words, epoch << 32 |
// inclusive << 31 | count; a word of another epoch reads as unpublished
// (csrc/look_back.cuh).
__global__ void __launch_bounds__(kThreads)
    block_draw_kernel(U128 state, U128 inc, double rate, int64_t n,
                      unsigned long long* __restrict__ scratch, int capacity,
                      int* __restrict__ ids, int* __restrict__ count_out) {
  __shared__ U128 plus[kJumps];  // G_(2^k) inc: this stream's jump increments
  __shared__ int warp_kept[kWarps];
  __shared__ int s_tile, s_excl, s_clear;
  __shared__ unsigned s_epoch;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int n_tiles = gridDim.x;

  if (t == 0) take_ticket(scratch, n_tiles, &s_tile, &s_epoch);
  if (t < kJumps) plus[t] = mul({kJump[t][2], kJump[t][3]}, inc);
  __syncthreads();
  const int tile = s_tile;
  const unsigned epoch = s_epoch;
  const int64_t first = static_cast<int64_t>(tile) * kTile + static_cast<int64_t>(t) * kChunk;

  unsigned keep = 0;  // bit j: index first + j is kept
  if (first < n) {
    U128 s = state;  // s_(first + 1), the state of uniform `first`
    const unsigned long long d = static_cast<unsigned long long>(first) + 1;
    for (int k = 0; k < kJumps; ++k)
      if ((d >> k) & 1ull) s = add(mul({kJump[k][0], kJump[k][1]}, s), plus[k]);
    const U128 a = {kJump[0][0], kJump[0][1]};
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const double u = static_cast<double>(xsl_rr(s) >> 11) * 0x1p-53;
      keep |= static_cast<unsigned>(first + j < n && u < rate) << j;
      s = add(mul(a, s), inc);
    }
  }

  // this thread's rank among the tile's kept ids, and the tile's count
  const int kept = __popc(keep);
  int incl = kept;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int x = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += x;
  }
  if (lane == 31) warp_kept[warp] = incl;
  __syncthreads();
  int rank = incl - kept, agg = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int c = warp_kept[w];
    rank += w < warp ? c : 0;
    agg += c;
  }

  if (warp == 0) {
    bool clear;
    const int excl = tile_prefix(scratch, tile, n_tiles, epoch, agg, lane, &clear);
    if (lane == 0) {
      s_excl = excl;
      s_clear = clear;
    }
  }
  __syncthreads();

  const int excl = s_excl;
  int pos = excl + rank;
  for (unsigned m = keep; m; m &= m - 1)
    ids[pos++] = static_cast<int>(first + __ffs(m) - 1);
  if (tile == n_tiles - 1) {  // the count, and the zeros up to the padded length
    const int64_t count = excl + agg;
    if (t == 0) *count_out = static_cast<int>(count);
    const int64_t end = padded_length(count, n);
    for (int64_t p = count + t; p < end; p += kThreads) ids[p] = 0;
  }
  if (s_clear) clear_statuses(scratch, capacity, t, kThreads);
}

}  // namespace

// state_* and inc_* the halves of the seed's PCG64 state and increment; rate
// in f64; scratch 2 + capacity u64 words with capacity >= ceil(n / 4096), made
// as epoch 1 (word 0 = 1 << 32) and zero elsewhere, used by no launch running
// at the same time; ids (n,) int32; count_out (1,) int32.  One launch.
extern "C" int block_draw_launch(unsigned long long state_hi, unsigned long long state_lo,
                                 unsigned long long inc_hi, unsigned long long inc_lo,
                                 double rate, int64_t n, void* scratch, int capacity,
                                 void* ids, void* count_out, void* stream) {
  if (n <= 0 || n > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = static_cast<int>((n + kTile - 1) / kTile);
  if (capacity < n_tiles) return static_cast<int>(cudaErrorInvalidValue);
  block_draw_kernel<<<n_tiles, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      U128{state_lo, state_hi}, U128{inc_lo, inc_hi}, rate, n,
      static_cast<unsigned long long*>(scratch), capacity, static_cast<int*>(ids),
      static_cast<int*>(count_out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* block_draw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
