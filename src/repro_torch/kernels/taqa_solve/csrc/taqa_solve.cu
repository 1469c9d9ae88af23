// taqa_solve: the device half of the fused single-launch TAQA path between
// its pilot scan and its final scan, CUDA C++ for sm_90a.  Two kernels:
//
// 1. taqa_solve_rate (one CTA): from the pilot's per-block channel sums
//    (n_phys, n_ch) f32, zero past n_real, each solve channel's s1 = sum y
//    and s2 = sum y*y, then mean, var, L_mu and var_ub, and the 48-step
//    geometric bisection of the BSAP sampling rate; writes theta, theta_eff
//    (theta where the plan goes, else 0) and the flags 1 no groups | 2 bad
//    L_mu | 4 no feasible plan cheaper than exact.
// 2. taqa_draw_compact (two launches): keep = u < theta_eff over N f32
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
// row order, a fixed xor butterfly adds the 32 lanes of a warp, and thread 0
// adds the 8 warp sums in warp order.  ref.py adds in exactly this order, so
// the kernel and its plain version give the same bits.  The compaction is
// integer work: no atomics, and every output is written exactly once, so
// the ids are the same bits run to run.
//
// Bounds on the H100.  The solve reads n_phys * n_ch f32 (a few KB at a
// pilot) and runs 48 * n_solve feasibility tests on one thread: a launch-
// floor kernel.  The compaction must read u (4N bytes) and write padded (4N
// bytes): 15 MB at SF10's 1,875,000 blocks, 4.5 us at 3.35 TB/s.  It reads
// u twice (count, then scatter), 22.5 MB, because a second pass over u is
// simpler than a decoupled look-back scan and the L2 (50 MB) holds u
// between the two launches at SF10.
//
// Draw order.  Tile b holds indices [b * 4096, (b + 1) * 4096): row k of the
// tile is 256 consecutive indices, one per thread, so every load is
// coalesced.  The count launch writes each tile's kept count.  The scatter
// launch sums the counts of the tiles before its own (its base) and of all
// tiles (nsel), then walks its rows in order: a ballot per warp gives a
// kept index its rank among the warp's, the warps' counts in shared memory
// its rank among the row's.  Kept index i lands at its rank in [0, nsel);
// the tile's own index range at or past nsel is zero-filled, so each of the
// N outputs is written once, by one thread.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSolve = 64;  // solve channels the CTA keeps in shared memory
constexpr int kSteps = 48;     // bisection steps, as the reference's fori_loop
constexpr int kTileRows = 16;
constexpr int kTile = kThreads * kTileRows;
constexpr unsigned kFull = 0xffffffffu;

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

// The reference's `feasible(theta)` for every solve channel.
__device__ bool feasible(const Channel* ch, int n_solve, float N, float theta) {
  bool all = true;
  const float one_minus = __fsub_rn(1.0f, theta);
  const float n_theta = __fmul_rn(N, theta);
  for (int j = 0; j < n_solve; ++j) {
    const Channel c = ch[j];
    const float spread = __fsqrt_rn(max_nan(__fmul_rn(n_theta, one_minus), 0.0f));
    const float n_lb = max_nan(__fsub_rn(n_theta, __fmul_rn(c.z_bin, spread)), 0.0f);
    float u_v = n_lb > 1.0f
                    ? __fdiv_rn(__fmul_rn(__fmul_rn(__fmul_rn(N, N), one_minus), c.var_ub),
                                max_nan(n_lb, 1e-30f))
                    : INFINITY;
    if (theta >= 1.0f) u_v = 0.0f;
    const bool ok = (c.L_mu > 0.0f) &&
                    (__fmul_rn(c.z, __fsqrt_rn(max_nan(u_v, 0.0f))) <= __fmul_rn(c.e, c.L_mu));
    all = all && ok;
  }
  return all;
}

// solve (n_solve, 5) rows [t_q, chi_q, z, z_bin, e]; scal (6,) [N, max_rate,
// min_rate, cost_a, cost_b, exact_cost]; theta_out (2,) [theta, theta_eff].
__global__ void __launch_bounds__(kThreads)
    taqa_solve_rate_kernel(const float* __restrict__ block_sums, int64_t n_phys, int n_ch,
                           const unsigned char* __restrict__ present, int n_real,
                           const int* __restrict__ channels, int n_solve,
                           const float* __restrict__ solve, const float* __restrict__ scal,
                           float* __restrict__ theta_out, int* __restrict__ flags_out) {
  __shared__ float warp1[kWarps], warp2[kWarps];
  __shared__ float s1[kMaxSolve], s2[kMaxSolve];
  __shared__ Channel chans[kMaxSolve];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;

  for (int j = 0; j < n_solve; ++j) {
    const int c = channels[j];
    float a1 = 0.0f, a2 = 0.0f;
    for (int64_t r = t; r < n_phys; r += kThreads) {
      const float y = block_sums[r * n_ch + c];
      a1 = __fadd_rn(a1, y);
      a2 = __fadd_rn(a2, __fmul_rn(y, y));
    }
    a1 = warp_sum(a1);
    a2 = warp_sum(a2);
    if (lane == 0) {
      warp1[warp] = a1;
      warp2[warp] = a2;
    }
    __syncthreads();
    if (t == 0) {
      float b1 = warp1[0], b2 = warp2[0];
      for (int w = 1; w < kWarps; ++w) {
        b1 = __fadd_rn(b1, warp1[w]);
        b2 = __fadd_rn(b2, warp2[w]);
      }
      s1[j] = b1;
      s2[j] = b2;
    }
    __syncthreads();
  }
  if (t != 0) return;

  const float n = static_cast<float>(n_real);
  const float N = scal[0], max_rate = scal[1], min_rate = scal[2];
  const float cost_a = scal[3], cost_b = scal[4], exact_cost = scal[5];
  bool L_ok = true;
  for (int j = 0; j < n_solve; ++j) {
    const float* row = solve + 5 * j;
    const float mean = __fdiv_rn(s1[j], n);
    const float var = max_nan(
        __fdiv_rn(__fsub_rn(s2[j], __fdiv_rn(__fmul_rn(s1[j], s1[j]), n)),
                  max_nan(__fsub_rn(n, 1.0f), 1.0f)),
        0.0f);
    const float L_mu =
        __fmul_rn(N, __fsub_rn(mean, __fdiv_rn(__fmul_rn(row[0], __fsqrt_rn(var)), __fsqrt_rn(n))));
    const float var_ub = __fmul_rn(__fdiv_rn(__fsub_rn(n, 1.0f), max_nan(row[1], 1e-12f)), var);
    chans[j] = Channel{L_mu, var_ub, row[2], row[3], row[4]};
    L_ok = L_ok && (L_mu > 0.0f) && isfinite(L_mu);
  }
  const bool feas_max = feasible(chans, n_solve, N, max_rate);
  float lo = min_rate, hi = max_rate;
  for (int step = 0; step < kSteps; ++step) {
    const float mid = __fsqrt_rn(__fmul_rn(lo, hi));  // geometric: rates span decades
    const bool f = feasible(chans, n_solve, N, mid);
    lo = f ? lo : mid;
    hi = f ? mid : hi;
  }
  const float theta = hi;
  const bool have_plan = feas_max && (__fadd_rn(__fmul_rn(cost_a, theta), cost_b) < exact_cost);
  const bool has_groups = present[0] != 0;
  const bool go = has_groups && L_ok && have_plan;
  theta_out[0] = theta;
  theta_out[1] = go ? theta : 0.0f;
  flags_out[0] = (has_groups ? 0 : 1) + (L_ok ? 0 : 2) + (have_plan ? 0 : 4);
}

// Each tile's kept count.
__global__ void __launch_bounds__(kThreads)
    compact_count_kernel(const float* __restrict__ u, int64_t n,
                         const float* __restrict__ theta_eff, int* __restrict__ tile_counts) {
  const float theta = *theta_eff;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
  float v[kTileRows];
#pragma unroll
  for (int k = 0; k < kTileRows; ++k) {  // every load of the tile in flight first
    const int64_t i = base + k * kThreads + threadIdx.x;
    v[k] = i < n ? u[i] : 1.0f;
  }
  int total = 0;
#pragma unroll
  for (int k = 0; k < kTileRows; ++k) {
    const int64_t i = base + k * kThreads + threadIdx.x;
    total += __syncthreads_count(i < n && v[k] < theta);
  }
  if (threadIdx.x == 0) tile_counts[blockIdx.x] = total;
}

// The kept ids at their ranks; the tile's own index range past nsel zeroed.
__global__ void __launch_bounds__(kThreads)
    compact_scatter_kernel(const float* __restrict__ u, int64_t n,
                           const float* __restrict__ theta_eff,
                           const int* __restrict__ tile_counts, int n_tiles,
                           int* __restrict__ padded, int* __restrict__ nsel_out) {
  __shared__ int red_before[kWarps], red_total[kWarps];
  __shared__ int row_warps[2][kWarps];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int tile = blockIdx.x;
  const float theta = *theta_eff;
  const int64_t base = static_cast<int64_t>(tile) * kTile;

  float v[kTileRows];
#pragma unroll
  for (int k = 0; k < kTileRows; ++k) {
    const int64_t i = base + k * kThreads + t;
    v[k] = i < n ? u[i] : 1.0f;
  }
  // integer sums: exact in any order
  int before = 0, total = 0;
  for (int j = t; j < n_tiles; j += kThreads) {
    const int c = tile_counts[j];
    total += c;
    before += j < tile ? c : 0;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    before += __shfl_xor_sync(kFull, before, off);
    total += __shfl_xor_sync(kFull, total, off);
  }
  if (lane == 0) {
    red_before[warp] = before;
    red_total[warp] = total;
  }
  __syncthreads();
  int rank = 0, nsel = 0;
  for (int w = 0; w < kWarps; ++w) {
    rank += red_before[w];
    nsel += red_total[w];
  }
  if (tile == 0 && t == 0) *nsel_out = nsel;

  const unsigned lower = (1u << lane) - 1u;
#pragma unroll
  for (int k = 0; k < kTileRows; ++k) {
    const int64_t i = base + k * kThreads + t;
    const bool keep = i < n && v[k] < theta;
    const unsigned ballot = __ballot_sync(kFull, keep);
    if (lane == 0) row_warps[k & 1][warp] = __popc(ballot);
    __syncthreads();  // row_warps[k & 1] complete; row k - 2's readers are past row k - 1's barrier
    int warp_rank = 0, row = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = row_warps[k & 1][w];
      warp_rank += w < warp ? c : 0;
      row += c;
    }
    if (keep) padded[rank + warp_rank + __popc(ballot & lower)] = static_cast<int>(i);
    if (i < n && i >= nsel) padded[i] = 0;
    rank += row;
  }
}

int invalid() { return static_cast<int>(cudaErrorInvalidValue); }

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
  taqa_solve_rate_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(block_sums), n_phys, n_ch,
      static_cast<const unsigned char*>(present), n_real, static_cast<const int*>(channels),
      n_solve, static_cast<const float*>(solve), static_cast<const float*>(scal),
      static_cast<float*>(theta_out), static_cast<int*>(flags_out));
  return static_cast<int>(cudaGetLastError());
}

// u (n,) f32; theta_eff a f32 scalar on the card; tile_counts
// (ceil(n / 4096),) int32 scratch; padded (n,) int32; nsel_out (1,) int32.
extern "C" int taqa_draw_compact_launch(const void* u, int64_t n, const void* theta_eff,
                                        void* tile_counts, void* padded, void* nsel_out,
                                        void* stream) {
  if (n <= 0 || n > INT32_MAX) return invalid();
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = static_cast<int>((n + kTile - 1) / kTile);
  const auto* uf = static_cast<const float*>(u);
  const auto* th = static_cast<const float*>(theta_eff);
  auto* counts = static_cast<int*>(tile_counts);
  compact_count_kernel<<<n_tiles, kThreads, 0, s>>>(uf, n, th, counts);
  const int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  compact_scatter_kernel<<<n_tiles, kThreads, 0, s>>>(uf, n, th, counts, n_tiles,
                                                     static_cast<int*>(padded),
                                                     static_cast<int*>(nsel_out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* taqa_solve_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
