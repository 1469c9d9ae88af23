// taqa_solve: the device half of the fused single-launch TAQA path between
// its pilot scan and its final scan, CUDA C++ for sm_90a.  Two kernels:
//
// 1. taqa_solve_rate (one CTA): from the pilot's per-block channel sums
//    (n_phys, n_ch) f32, zero past n_real, each solve channel's s1 = sum y
//    and s2 = sum y*y, then mean, var, L_mu and var_ub, and the 48-step
//    geometric bisection of the BSAP sampling rate; writes theta, theta_eff
//    (theta where the plan goes, else 0) and the flags 1 no groups | 2 bad
//    L_mu | 4 no feasible plan cheaper than exact.
// 2. taqa_draw_compact (one launch): keep = u < theta_eff over N f32
//    uniforms, then the kept ids in ascending order: padded (N,) int32, zero
//    past nsel, and nsel.
//
// Replaces no Pallas kernel: the reference computes this step in XLA inside
// its fused program (src/repro/engine/physical.py:1163-1218, the f32 solve,
// `feasible` and its fori_loop, then keep / cumsum / scatter).  As torch ops
// the bisection alone would be hundreds of launches.
//
// Numbers.  The solve is the reference's f32 program, the same operations in
// the same order, each rounded once: the _rn intrinsics keep nvcc from
// contracting a multiply and an add into an fma, which would round once
// where the plain version (ref.py) and the reference round twice.  s1 and s2
// are added in a fixed order: thread t of 256 adds rows t, t + 256, ... in
// row order, a fixed xor butterfly adds the 32 lanes of a warp, and one
// thread adds the 8 warp sums in warp order.  ref.py adds in exactly this
// order, so the kernel and its plain version give the same bits.  The
// compaction is integer work with one final value per output, so the ids
// are the same bits run to run.
//
// The solve: a speculative-tree bisection.  The plain loop runs 48
// dependent steps `mid = sqrt(lo * hi); f = feasible(mid); lo = f ? lo :
// mid; hi = f ? mid : hi`, each an IEEE divide and two square roots per
// channel.  Here the steps go in rounds of k levels.  Thread (path, channel)
// takes path p of the round's tree, 1 <= p < 2^k (heap node p - 1: its
// children are 2p for f false and 2p + 1 for f true, so the bits of p below
// its leading one spell its way from the root).  It replays that way from
// the round's root (lo, hi) with the loop's own operations, then tests its
// channel at the path's mid; an infeasible test clears the path's bit in
// shared memory (an AND over the path's channels, in any order).  After one
// barrier every thread walks the bits from path 1 to the round's last level
// and takes the next root from that path's (lo, hi, mid): the loop's state
// after those k steps.  Every midpoint comes from its ancestors by the
// loop's operations, so the bits are the loop's whatever `feasible` returns:
// monotonicity is not assumed.  Path 0 tests max_rate (feas_max) in the
// first round.  k is the largest <= 8 with 2^k * n_solve <= 1,024 threads:
// 6 rounds for 1 to 4 channels, 12 for 64; any k gives the same bits.  The
// masks rotate over three buffers (a round reads one, the next clears bits
// in another, and the third, read two rounds ago, is set again), so one
// barrier a round suffices.  The row sums take up to 4 channels a pass per
// group of 256 threads, every group at once, each channel in the order
// above; the inputs that wait on nothing are loaded first, and the block
// sums' lines asked of L2 while the channel indices arrive.  On the H100 a
// round costs ~1 us: the replay's chain of up to 8 rounded square roots,
// one feasibility test (a divide and two square roots), a barrier and the
// walk.
//
// The draw: a single-pass ordered compaction with a decoupled look-back,
// whose tickets, status words and scratch are csrc/look_back.cuh's.  Tile b
// holds indices [b T, (b + 1) T), T = 16 rows of 1,024: row k of the tile is
// 1,024 consecutive indices, one per thread, so every load is coalesced.  A
// CTA loads its tile of u once, into registers, writes zero to its own
// index range, counts its kept uniforms per (row, warp) with ballots, and
// publishes its count; once warp 0 has its exclusive prefix, the CTA writes
// its kept ids at their ranks (a ballot ranks an id among its warp's, the
// (row, warp) counts' exclusive scan among the tile's).  The last tile
// writes nsel.
//
// The zero fill past nsel needs no second pass.  Every tile zeroes its own
// index range [bT, (b + 1)T) before it publishes its aggregate.  A kept id
// of rank p lands at position p <= id, so its writer is the tile b that
// holds position p or a later tile.  Tile b zeroed p earlier in its own
// program order, behind a __syncthreads.  A later tile c writes only after
// its look-back has acquired, directly or through a chain of inclusive
// prefixes (each released after its tile's look-back acquired the statuses
// it summed), a status that tile b released after its zeroing, since tile
// b's count is part of every prefix past b.  So every position ends as its
// id or as 0, with no race.
//
// Bounds on the H100.  The solve reads n_phys * n_solve f32 (a few KB at a
// pilot) and runs 49 * n_solve feasibility tests: its floor is the 1-CTA
// launch and the ~48 dependent square roots.  The compaction must read u
// (4N bytes) and write padded (4N bytes): 15 MB at SF10's 1,875,000 blocks,
// 4.5 us at 3.35 TB/s.  It reads u once.

#include <cstdint>
#include <climits>
#include <cuda_runtime.h>

#include "../../csrc/look_back.cuh"

namespace {

using repro_torch::clear_statuses;
using repro_torch::take_ticket;
using repro_torch::tile_prefix;

constexpr int kThreads = 256;  // the solve's row-sum group
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSolve = 64;  // solve channels the CTA keeps in shared memory
constexpr int kSteps = 48;     // bisection steps, as the reference's fori_loop
constexpr int kMaxLevels = 8;  // bisection levels a round evaluates at most
constexpr int kMaxSolveThreads = 1024;
constexpr int kPass = 4;       // solve channels a row-sum thread adds per pass
constexpr int kPrefetchRows = 16;  // block-sum rows a thread asks L2 for up front
constexpr int kDrawThreads = 1024;  // the draw's CTA: one row of a tile
constexpr int kDrawWarps = kDrawThreads / 32;
constexpr int kTileRows = 16;
constexpr int kTile = kDrawThreads * kTileRows;
constexpr int kCountsPerLane = kTileRows * kDrawWarps / 32;  // (row, warp) counts per lane of warp 0
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxTiles = static_cast<int>((INT32_MAX + int64_t{kTile} - 1) / kTile);

// torch.maximum(a, b) for a finite b: NaN in a propagates (fmaxf would drop it)
__device__ __forceinline__ float max_nan(float a, float b) {
  return a != a ? a : fmaxf(a, b);
}

__device__ __forceinline__ float warp_sum(float v) {
  // lane l and lane l ^ off add the same two values: every lane ends with
  // the same bits
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

struct Channel {
  float L_mu;
  float var_ub;
  float z;
  float z_bin;
  float e;
};

// One channel's term of the reference's `feasible(theta)`.  A COUNT
// channel's var_ub is 0, so at every rate its u_v is 0 / n_lb = 0 and its
// square root sqrt(0); __fdiv_rn and __fsqrt_rn take their slow paths for a
// zero operand, so those cases are answered exactly here: +-0 / d = +-0 for
// d > 1, sqrt(+-0) = +-0 and sqrt(inf) = inf.
__device__ bool feasible(const Channel& c, float N, float theta) {
  const float one_minus = __fsub_rn(1.0f, theta);
  const float n_theta = __fmul_rn(N, theta);
  const float spread = __fsqrt_rn(max_nan(__fmul_rn(n_theta, one_minus), 0.0f));
  const float n_lb = max_nan(__fsub_rn(n_theta, __fmul_rn(c.z_bin, spread)), 0.0f);
  const float num = __fmul_rn(__fmul_rn(__fmul_rn(N, N), one_minus), c.var_ub);
  float u_v = INFINITY;
  if (n_lb > 1.0f)  // the untaken call gets an operand of its fast path
    u_v = num == 0.0f ? num : __fdiv_rn(num == 0.0f ? 1.0f : num, max_nan(n_lb, 1e-30f));
  if (theta >= 1.0f) u_v = 0.0f;
  const float v = max_nan(u_v, 0.0f);
  const bool exact = v == 0.0f || v == INFINITY;
  const float root = exact ? v : __fsqrt_rn(exact ? 1.0f : v);
  return (c.L_mu > 0.0f) && (__fmul_rn(c.z, root) <= __fmul_rn(c.e, c.L_mu));
}

// Path `path` (at `depth`) below the root (lo, hi): its (lo, hi) by the
// loop's steps along the bits of `path` below its leading one, then its mid.
__device__ __forceinline__ float replay(float& lo, float& hi, unsigned path, int depth) {
#pragma unroll 1
  for (int s = 0; s < depth; ++s) {
    const float m = __fsqrt_rn(__fmul_rn(lo, hi));  // geometric: rates span decades
    const bool f = (path >> (depth - 1 - s)) & 1u;
    lo = f ? lo : m;
    hi = f ? m : hi;
  }
  return __fsqrt_rn(__fmul_rn(lo, hi));
}

// solve (n_solve, 5) rows [t_q, chi_q, z, z_bin, e]; scal (6,) [N, max_rate,
// min_rate, cost_a, cost_b, exact_cost]; theta_out (2,) [theta, theta_eff].
// blockDim.x a multiple of 256 that holds 2^levels * n_solve threads.
// Thread t is (path t / n_solve, channel t % n_solve).
__global__ void __launch_bounds__(kMaxSolveThreads)
    taqa_solve_rate_kernel(const float* __restrict__ block_sums, int64_t n_phys, int n_ch,
                           const unsigned char* __restrict__ present, int n_real,
                           const int* __restrict__ channels, int n_solve,
                           const float* __restrict__ solve, const float* __restrict__ scal,
                           int levels, float* __restrict__ theta_out,
                           int* __restrict__ flags_out) {
  constexpr int kNodes = 1 << kMaxLevels;
  __shared__ float warp1[kMaxSolve][kWarps], warp2[kMaxSolve][kWarps];
  __shared__ Channel chans[kMaxSolve];
  __shared__ __align__(16) unsigned mask[3][kNodes / 32];  // bit p: path p feasible on every channel
  __shared__ float interval[2][3][kNodes];  // per path: lo, hi, mid
  __shared__ int feas_max;
  const int t = threadIdx.x, lane = t & 31;
  const int groups = blockDim.x / kThreads;
  const int g = t / kThreads, gt = t % kThreads, gwarp = gt >> 5;

  // every load that waits on nothing, in flight together; the block sums'
  // lines asked of L2 while the channel indices arrive
  const float N = scal[0], max_rate = scal[1], min_rate = scal[2];
  float row[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (t < n_solve) {
#pragma unroll
    for (int i = 0; i < 5; ++i) row[i] = solve[5 * t + i];
  }
  float cost_a = 0.0f, cost_b = 0.0f, exact_cost = 0.0f;
  bool has_groups = false;
  if (t == 0) {
    cost_a = scal[3];
    cost_b = scal[4];
    exact_cost = scal[5];
    has_groups = present[0] != 0;
  }
  if (g == 0) {
    int64_t r = gt;
    for (int i = 0; i < kPrefetchRows && r < n_phys; ++i, r += kThreads)
      asm volatile("prefetch.global.L2 [%0];" ::"l"(block_sums + r * n_ch));
  }

  // thread (path, ch): path p >= 1 is heap node p - 1, whose bits below the
  // leading one spell its way from the root; path 0 tests max_rate (feas_max)
  const int path = t / n_solve, ch = t - path * n_solve;
  const int depth = 31 - __clz(max(path, 1));

  // s1 and s2 of every solve channel, kPass channels a pass over the rows;
  // each channel in its fixed order
  for (int j0 = g * kPass; j0 < n_solve; j0 += groups * kPass) {
    int col[kPass];
    float a1[kPass], a2[kPass];
#pragma unroll
    for (int q = 0; q < kPass; ++q) {
      col[q] = j0 + q < n_solve ? channels[j0 + q] : 0;
      a1[q] = 0.0f;
      a2[q] = 0.0f;
    }
#pragma unroll 4
    for (int64_t r = gt; r < n_phys; r += kThreads) {
      const float* rp = block_sums + r * n_ch;
#pragma unroll
      for (int q = 0; q < kPass; ++q) {
        if (j0 + q < n_solve) {
          const float y = rp[col[q]];
          a1[q] = __fadd_rn(a1[q], y);
          a2[q] = __fadd_rn(a2[q], __fmul_rn(y, y));
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kPass; ++q) {
      if (j0 + q < n_solve) {  // the same for the whole warp
        const float b1 = warp_sum(a1[q]), b2 = warp_sum(a2[q]);
        if (lane == 0) {
          warp1[j0 + q][gwarp] = b1;
          warp2[j0 + q][gwarp] = b2;
        }
      }
    }
  }
  if (t < kNodes / 32) {
    mask[0][t] = ~0u;
    mask[1][t] = ~0u;
  }
  if (t == 0) feas_max = 1;
  __syncthreads();

  bool ok = true;
  if (t < n_solve) {  // one thread per channel: its warp sums in warp order
    const float n = static_cast<float>(n_real);
    float s1 = warp1[t][0], s2 = warp2[t][0];
    for (int w = 1; w < kWarps; ++w) {
      s1 = __fadd_rn(s1, warp1[t][w]);
      s2 = __fadd_rn(s2, warp2[t][w]);
    }
    const float mean = __fdiv_rn(s1, n);
    const float var = max_nan(
        __fdiv_rn(__fsub_rn(s2, __fdiv_rn(__fmul_rn(s1, s1), n)),
                  max_nan(__fsub_rn(n, 1.0f), 1.0f)),
        0.0f);
    const float L_mu =
        __fmul_rn(N, __fsub_rn(mean, __fdiv_rn(__fmul_rn(row[0], __fsqrt_rn(var)), __fsqrt_rn(n))));
    const float var_ub = __fmul_rn(__fdiv_rn(__fsub_rn(n, 1.0f), max_nan(row[1], 1e-12f)), var);
    chans[t] = Channel{L_mu, var_ub, row[2], row[3], row[4]};
    ok = (L_mu > 0.0f) && isfinite(L_mu);
  }
  const bool L_ok = __syncthreads_and(ok);  // also publishes chans

  // the bisection in rounds of `levels` levels, one barrier a round: each
  // path's (lo, hi, mid) goes to shared memory and an infeasible test clears
  // its bit; then every thread walks the bits to the round's last level and
  // takes the next root from that path's interval.  Masks rotate over three
  // buffers (a round reads one, sets the one read two rounds ago, the next
  // clears bits in the third), intervals over two.
  Channel c{};
  if (path < (1 << levels)) c = chans[ch];
  float root_lo = min_rate, root_hi = max_rate;
  for (int done = 0, round = 0; done < kSteps; ++round) {
    const int lv = min(levels, kSteps - done);
    const int rb = round % 3, ib = round & 1;
    const bool in_tree = path >= 1 && path < (1 << lv);
    float lo = root_lo, hi = root_hi, mid = max_rate;
    if (in_tree) {
      mid = replay(lo, hi, static_cast<unsigned>(path), depth);
      if (ch == 0) {
        interval[ib][0][path] = lo;
        interval[ib][1][path] = hi;
        interval[ib][2][path] = mid;
      }
    }
    if ((in_tree || (round == 0 && path == 0)) && !feasible(c, N, mid)) {
      if (in_tree) atomicAnd(&mask[rb][path >> 5], ~(1u << (path & 31)));
      else feas_max = 0;  // every writer writes 0
    }
    __syncthreads();
    const uint4 m03 = *reinterpret_cast<const uint4*>(&mask[rb][0]);
    const uint4 m47 = *reinterpret_cast<const uint4*>(&mask[rb][4]);
    const unsigned m[8] = {m03.x, m03.y, m03.z, m03.w, m47.x, m47.y, m47.z, m47.w};
    unsigned p = 1;  // the loop's path through this round's results
#pragma unroll
    for (int d = 0; d < kMaxLevels - 1; ++d) {
      if (d < lv - 1) {  // depth d's paths lie in [2^d, 2^(d + 1)): words known here
        const unsigned word = d <= 4 ? m[0] : d == 5 ? m[1] : d == 6 ? ((p & 32u) ? m[3] : m[2])
                              : ((p & 64u) ? ((p & 32u) ? m[7] : m[6]) : ((p & 32u) ? m[5] : m[4]));
        p = 2u * p + ((word >> (p & 31u)) & 1u);
      }
    }
    unsigned word = m[0];
#pragma unroll
    for (int w = 1; w < 8; ++w) word = (p >> 5) == static_cast<unsigned>(w) ? m[w] : word;
    const bool f = (word >> (p & 31u)) & 1u;
    root_lo = f ? interval[ib][0][p] : interval[ib][2][p];
    root_hi = f ? interval[ib][2][p] : interval[ib][1][p];
    if (t < kNodes / 32) mask[(round + 2) % 3][t] = ~0u;  // read two rounds ago
    done += lv;
  }
  if (t != 0) return;

  const float theta = root_hi;
  const bool have_plan =
      feas_max != 0 && (__fadd_rn(__fmul_rn(cost_a, theta), cost_b) < exact_cost);
  const bool go = has_groups && L_ok && have_plan;
  theta_out[0] = theta;
  theta_out[1] = go ? theta : 0.0f;
  flags_out[0] = (has_groups ? 0 : 1) + (L_ok ? 0 : 2) + (have_plan ? 0 : 4);
}

// scratch (2 + kMaxTiles u64): [0] epoch << 32 | ticket, [1] the done count
// of the wrap launch, [2, 2 + kMaxTiles) the status words, epoch << 32 |
// inclusive << 31 | count; a word of another epoch reads as unpublished
// (csrc/look_back.cuh).
__global__ void __launch_bounds__(kDrawThreads)
    draw_compact_kernel(const float* __restrict__ u, int64_t n,
                        const float* __restrict__ theta_eff,
                        unsigned long long* __restrict__ scratch, int* __restrict__ padded,
                        int* __restrict__ nsel_out) {
  __shared__ int row_warps[kTileRows * kDrawWarps];  // kept per (row, warp), then exclusive ranks
  __shared__ int s_tile, s_excl, s_clear;
  __shared__ unsigned s_epoch;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int n_tiles = gridDim.x;

  if (t == 0) take_ticket(scratch, n_tiles, &s_tile, &s_epoch);
  const float theta = *theta_eff;
  __syncthreads();
  const int tile = s_tile;
  const unsigned epoch = s_epoch;
  const int64_t base = static_cast<int64_t>(tile) * kTile;
  float v[kTileRows];
#pragma unroll
  for (int k = 0; k < kTileRows; ++k) {  // every load of the tile in flight first
    const int64_t i = base + k * kDrawThreads + t;
    v[k] = i < n ? u[i] : 1.0f;
  }
#pragma unroll
  for (int k = 0; k < kTileRows; ++k) {
    const int64_t i = base + k * kDrawThreads + t;
    if (i < n) padded[i] = 0;
  }
  unsigned keep = 0;
#pragma unroll
  for (int k = 0; k < kTileRows; ++k) {
    const int64_t i = base + k * kDrawThreads + t;
    const bool kp = i < n && v[k] < theta;
    const unsigned ballot = __ballot_sync(kFull, kp);
    keep |= static_cast<unsigned>(kp) << k;
    if (lane == 0) row_warps[k * kDrawWarps + warp] = __popc(ballot);
  }
  __syncthreads();  // the tile's zeros and counts done

  if (warp == 0) {
    // exclusive scan of the (row, warp) counts in (row, warp) order
    int c[kCountsPerLane], own = 0;
#pragma unroll
    for (int q = 0; q < kCountsPerLane; ++q) {
      c[q] = row_warps[kCountsPerLane * lane + q];
      own += c[q];
    }
    int incl = own;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int x = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += x;
    }
    int run = incl - own;
#pragma unroll
    for (int q = 0; q < kCountsPerLane; ++q) {
      row_warps[kCountsPerLane * lane + q] = run;
      run += c[q];
    }
    const int agg = __shfl_sync(kFull, incl, 31);
    bool clear;
    const int excl = tile_prefix(scratch, tile, n_tiles, epoch, agg, lane, &clear);
    if (lane == 0) {
      s_excl = excl;
      if (tile == n_tiles - 1) *nsel_out = excl + agg;
      s_clear = clear;
    }
  }
  __syncthreads();

  const int excl = s_excl;
  const unsigned lower = (1u << lane) - 1u;
#pragma unroll
  for (int k = 0; k < kTileRows; ++k) {
    const bool kp = (keep >> k) & 1u;
    const unsigned ballot = __ballot_sync(kFull, kp);
    if (kp)
      padded[excl + row_warps[k * kDrawWarps + warp] + __popc(ballot & lower)] =
          static_cast<int>(base + k * kDrawThreads + t);
  }
  if (s_clear) clear_statuses(scratch, kMaxTiles, t, kDrawThreads);
}

int invalid() { return static_cast<int>(cudaErrorInvalidValue); }

// The bisection levels a round evaluates: the most that fit 2^k * n_solve
// threads (paths 0 to 2^k - 1), at most kMaxLevels.  Any k gives the same bits.
int solve_levels(int n_solve) {
  int k = kMaxLevels;
  while ((n_solve << k) > kMaxSolveThreads) --k;
  return k;
}

}  // namespace

// block_sums (n_phys, n_ch) f32 row-major; present a bool scalar; channels
// (n_solve,) int32 in [0, n_ch); solve (n_solve, 5) and scal (6,) f32;
// theta_out (2,) f32; flags_out (1,) int32.  One CTA.
extern "C" int taqa_solve_rate_launch(const void* block_sums, int64_t n_phys, int n_ch,
                                      const void* present, int n_real, const void* channels,
                                      int n_solve, const void* solve, const void* scal,
                                      void* theta_out, void* flags_out, void* stream) {
  if (n_phys < 0 || n_ch <= 0 || n_solve < 1 || n_solve > kMaxSolve || n_real < 0)
    return invalid();
  const int levels = solve_levels(n_solve);
  const int pairs = n_solve << levels;
  const int threads = (pairs + kThreads - 1) / kThreads * kThreads;
  taqa_solve_rate_kernel<<<1, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(block_sums), n_phys, n_ch,
      static_cast<const unsigned char*>(present), n_real, static_cast<const int*>(channels),
      n_solve, static_cast<const float*>(solve), static_cast<const float*>(scal), levels,
      static_cast<float*>(theta_out), static_cast<int*>(flags_out));
  return static_cast<int>(cudaGetLastError());
}

// u (n,) f32; theta_eff a f32 scalar on the card; scratch 2 + kMaxTiles
// (131,074) u64 words, made as epoch 1 (word 0 = 1 << 32) and zero
// elsewhere, used by no launch running at the same time; padded (n,) int32;
// nsel_out (1,) int32.  One launch.
extern "C" int taqa_draw_compact_launch(const void* u, int64_t n, const void* theta_eff,
                                        void* scratch, void* padded, void* nsel_out,
                                        void* stream) {
  if (n <= 0 || n > INT32_MAX) return invalid();
  const int n_tiles = static_cast<int>((n + kTile - 1) / kTile);
  draw_compact_kernel<<<n_tiles, kDrawThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(u), n, static_cast<const float*>(theta_eff),
      static_cast<unsigned long long*>(scratch), static_cast<int*>(padded),
      static_cast<int*>(nsel_out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* taqa_solve_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
