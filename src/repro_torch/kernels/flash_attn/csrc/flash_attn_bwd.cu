// flash_attn_bwd: the gradients of blockwise attention (GQA, causal mask,
// sliding window), CUDA C++ for sm_90a.
//
// The backward of flash_attn.cu's forward.  The reference differentiates its
// XLA attention (src/repro/models/layers.py mea_attention) with
// jax.value_and_grad (src/repro/train/step.py) and has no Pallas backward;
// the port's forward is the hand-written kernel that replaces
// src/repro/kernels/flash_attn/kernel.py flash_attention_kernel, so its
// gradient is a kernel too.  The math, with P recomputed tile by tile from the
// forward's row log-sum-exp (natural units, f32):
//
//   P  = exp(scale q k^T - lse)   (0 where the mask hides the key)
//   D  = rowsum(dO o)              per query row
//   dV = P^T dO,  dS = P (dO V^T - D),  dQ = scale dS K,  dK = scale dS^T Q
//
// Two kernels on one stream and no atomics, so two launches are bitwise
// equal: first dQ (with D of its rows in a prologue, written out for the
// second), then dK and dV.  dK/dV walks the group's Hq / Hkv q heads in head
// order inside one CTA, so a kv head's gradient is the sum over its q heads
// with no second pass and no scatter; dQ stays a kernel of its own, since
// folding it into the dK/dV pass would need atomics or an ordered sum.
//
// What bounds it on the H100: operations.  At internlm2-1.8b's training
// shape (B 2, 16 q over 8 kv heads, S 4096, d 128, causal) the masks keep
// 8.39M (q, k) pairs per head.  The least work is five 2 d-flop products per
// pair (S, dO V^T, dV, dK, dQ): 343.6 GFLOP, 347.5 us at the bf16 tensor
// cores' 989 TFLOP/s, against 0.13 GB of q, k, v, o, dO and the gradients
// (40 us at 3.35 TB/s).  The atomic-free design does seven, since both
// kernels form S and dO V^T: 481 GFLOP, 0.49 ms at that peak.
//
// bf16 inputs: flash_bwd_dq_wgmma_kernel and flash_bwd_dkdv_wgmma_kernel, on
// the tensor cores, built from the forward's parts (hopper.cuh,
// tma_map.cuh): 128-byte swizzled TMA tiles, a ring of kStages stages each
// guarded by an mbarrier that counts the copy's bytes (thread 0 issues tile
// n + kStages - 1 before the warpgroups start on tile n), wgmma m64n64k16
// with D taken as D / 64 pieces of 64 columns.  Each consumer warpgroup owns
// 64 rows, wgmma's M.  BwdShape<D> sets the CTAs' shapes and the ring's
// depth (3 stages at D 64 and 128, 2 at D 256, where a stage is 64 KB);
// flash_attn_bwd_tile_rows reports the grids' rows to the host.
//   * dQ: one CTA per (b, q head, kDqRows q rows): two warpgroups (128
//     rows) at D 64 and 128, one (64 rows) at D 256, where Q and dO of 128
//     rows would take 128 KB; the heaviest (last) q tiles first.  Q and dO
//     come in once; a prologue forms D of its rows from o and dO (fixed
//     order, so repeatable) and writes each row's lse log2 e and D to a
//     stats scratch whose rows are padded to a multiple of 64 (zeros
//     there), so that dK/dV reads them as aligned 64-float TMA boxes.  The
//     64-row K and V tiles the mask admits stream through the ring:
//     S = Q K^T and dP = dO V^T (ss, both K-major), P and dS in registers,
//     dQ += dS K (rs, K the transposed, MN-major B).  At D 256: 194 KB of
//     shared memory, dQ's accumulator 128 f32 registers a thread.
//   * dK/dV: one CTA per (b, kv head, kKvRows kv rows).  K and V come in
//     once; then, for each q head of the group, every 64-row q tile the
//     mask admits streams Q, dO and its rows' stats through the ring.  Per
//     tile: S^T = K Q^T and dP^T = V dO^T (ss); P^T = ex2(S^T scale log2 e
//     - lse log2 e) with lse and D per column from shared memory, masked
//     only on a tile at an edge of the warpgroup's band; dS^T =
//     P^T (dP^T - D); then dV += P^T dO and dK += dS^T Q (rs: P^T and dS^T
//     as bf16 pairs straight from their accumulator fragments, dO and Q
//     MN-major).  One warpgroup (64 kv rows) at D 64, two (128) at D 128.
//     At D 256 the two warpgroups share 64 kv rows and split the work by
//     gradient: one warpgroup's dK and dV would be 256 f32 accumulator
//     registers a thread, one gradient is 128.  Warpgroup 0 forms S^T and
//     P^T and adds P^T dO to dV; warpgroup 1 forms dP^T and adds dS^T Q to
//     dK, after warpgroup 0 hands it P^T as f32 through shared memory in
//     fragment order (thread t of either warpgroup holds the same
//     elements) across one barrier.  So the CTA does four products a pair
//     (seven with dQ's three, as at D 64 and 128) and rounds P^T and dS^T
//     once each, as the other widths do; 210 KB of shared memory (K and V
//     64 KB, two 64 KB stages, the 16 KB P^T tile).  A split by columns,
//     both warpgroups holding P^T and dP^T and half of dK and dV each,
//     spilled 360 bytes at 255 registers.
// P and dS go into the products rounded once to bf16; every sum is f32 in
// the wgmma accumulators, and the gradients are rounded once to bf16.
// Ragged Sq and Skv: TMA fills rows past the ends with zeros, the q < Sq
// mask zeroes P on those columns, and rows past the ends are not stored.
//
// f32 inputs: flash_bwd_dq_kernel and flash_bwd_dkdv_kernel, scalar: wgmma on
// f32 is TF32 (about three digits), looser than the f32 check (1e-4 of the
// largest gradient).  256 threads, (64, D) tiles in shared memory (rows
// padded by one word, so reads down a column hit 32 banks), each thread a
// 4 x 4 tile of the (64, 64) products and 4 x D/16 of the (64, D) ones, all
// f32 FMAs; D 16, 64 and 128.
#include <cuda_runtime.h>

#include <cstdint>

#include "../../csrc/float_io.cuh"
#include "../../csrc/hopper.cuh"
#include "../../csrc/tma_map.cuh"

namespace repro_torch {

constexpr int kBwdThreads = 256;  // the scalar kernels' CTA: thread (tr, tc) a 16 x 16 grid
constexpr float kLog2eBwd = 1.4426950408889634f;

__device__ __forceinline__ bool seen(int row, int col, int skv, int causal, int window) {
  bool keep = col < skv;
  if (causal) keep = keep && col <= row;
  if (window > 0) keep = keep && col > row - window;
  return keep;
}

// ---- f32: the scalar kernels -------------------------------------------------------

constexpr int kBT = 64;  // rows of a q tile and of a kv tile

// Shared memory of a scalar CTA: (64, D) tiles of Q, dO, K and V (the dQ
// kernel's O while it forms D), then P and dS, then the q tile's lse and D
template <int D>
struct BwdSmem {
  static constexpr int kS = D + 1;    // row stride of the (64, D) tiles
  static constexpr int kP = kBT + 1;  // row stride of P and dS
  static constexpr size_t kBytes = sizeof(float) * (4 * kBT * kS + 2 * kBT * kP + 2 * kBT);
};

// P and dS of q rows [i0, i0 + kBT) against kv rows [j0, j0 + kBT) into ps and
// dss: S = Q K^T and dP = dO V^T by one pass over d, then P = exp(scale S -
// lse) where the key is seen (0 elsewhere, and on rows >= sq) and
// dS = P (dP - D).  Thread (tr, tc) owns rows R tr .. R tr + R - 1 and
// columns tc + 16 c, R = kBT / 16.
template <int D>
__device__ __forceinline__ void p_and_ds(const float* qs, const float* dos, const float* ks,
                                         const float* vs, const float* lse_s,
                                         const float* delta_s, float* ps, float* dss, int i0,
                                         int j0, int sq, int skv, float scale, int causal,
                                         int window) {
  using S = BwdSmem<D>;
  constexpr int R = kBT / 16;
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  float s[R][R], dp[R][R];
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int c = 0; c < R; ++c) s[a][c] = dp[a][c] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qa[R], oa[R], kc[R], vc[R];
#pragma unroll
    for (int a = 0; a < R; ++a) {
      qa[a] = qs[(R * tr + a) * S::kS + d];
      oa[a] = dos[(R * tr + a) * S::kS + d];
    }
#pragma unroll
    for (int c = 0; c < R; ++c) {
      kc[c] = ks[(tc + 16 * c) * S::kS + d];
      vc[c] = vs[(tc + 16 * c) * S::kS + d];
    }
#pragma unroll
    for (int a = 0; a < R; ++a)
#pragma unroll
      for (int c = 0; c < R; ++c) {
        s[a][c] = fmaf(qa[a], kc[c], s[a][c]);
        dp[a][c] = fmaf(oa[a], vc[c], dp[a][c]);
      }
  }
#pragma unroll
  for (int a = 0; a < R; ++a) {
    const int r = R * tr + a;
    const int row = i0 + r;
    const float l2 = lse_s[r] * kLog2eBwd;
#pragma unroll
    for (int c = 0; c < R; ++c) {
      const int col = j0 + tc + 16 * c;
      const float p = (row < sq && seen(row, col, skv, causal, window))
                          ? ex2(s[a][c] * scale * kLog2eBwd - l2)
                          : 0.0f;
      ps[r * S::kP + tc + 16 * c] = p;
      dss[r * S::kP + tc + 16 * c] = p * (dp[a][c] - delta_s[r]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kBwdThreads)
    flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ o,
                        const float* __restrict__ lse, const float* __restrict__ dout,
                        float* __restrict__ dq, float* __restrict__ delta, int hq, int hkv,
                        int sq, int skv, float scale, int causal, int window) {
  using S = BwdSmem<D>;
  constexpr int R = kBT / 16;
  constexpr int kCols = D / 16;
  constexpr int kPerRow = kBwdThreads / kBT;  // threads that form one row's D
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + kBT * S::kS;
  float* ks = dos + kBT * S::kS;
  float* vs = ks + kBT * S::kS;
  float* ps = vs + kBT * S::kS;
  float* dss = ps + kBT * S::kP;
  float* lse_s = dss + kBT * S::kP;
  float* delta_s = lse_s + kBT;

  const int i0 = blockIdx.x * kBT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int64_t bq = static_cast<int64_t>(b) * hq + h;
  const float* kb = k + (static_cast<int64_t>(b) * hkv + hk) * skv * D;
  const float* vb = v + (static_cast<int64_t>(b) * hkv + hk) * skv * D;
  const int tid = threadIdx.x;

  load_tile<float, D>(qs, S::kS, q + bq * sq * D, i0, kBT, sq);
  load_tile<float, D>(dos, S::kS, dout + bq * sq * D, i0, kBT, sq);
  load_tile<float, D>(ks, S::kS, o + bq * sq * D, i0, kBT, sq);  // O, for D only
  if (tid < kBT) lse_s[tid] = i0 + tid < sq ? lse[bq * sq + i0 + tid] : 0.0f;
  __syncthreads();
  // D = rowsum(dO O): kPerRow threads a row, each every kPerRow-th column
  {
    const int r = tid / kPerRow, part = tid % kPerRow;
    float acc = 0.0f;
    for (int d = part; d < D; d += kPerRow) acc = fmaf(dos[r * S::kS + d], ks[r * S::kS + d], acc);
#pragma unroll
    for (int off = 1; off < kPerRow; off <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (part == 0) {
      delta_s[r] = acc;
      if (i0 + r < sq) delta[bq * sq + i0 + r] = acc;
    }
  }

  const int tr = tid / 16, tc = tid % 16;
  float acc[R][kCols];
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[a][c] = 0.0f;

  // the kv tiles [lo, hi] rows [i0, i0 + kBT) can see (flash_attn.cu kv_tiles)
  int last_col = skv - 1;
  if (causal) last_col = min(last_col, i0 + kBT - 1);
  const int hi = last_col >= 0 ? last_col / kBT : -1;
  const int lo = window > 0 ? max(0, i0 - window + 1) / kBT : 0;
  for (int jt = lo; jt <= hi; ++jt) {
    const int j0 = jt * kBT;
    __syncthreads();  // the last tile's K, V, P and dS are read
    load_tile<float, D>(ks, S::kS, kb, j0, kBT, skv);
    load_tile<float, D>(vs, S::kS, vb, j0, kBT, skv);
    __syncthreads();
    p_and_ds<D>(qs, dos, ks, vs, lse_s, delta_s, ps, dss, i0, j0, sq, skv, scale, causal,
                window);
    __syncthreads();
    // dQ[r][c] += sum_j dS[r][j] K[j][c]
#pragma unroll 4
    for (int j = 0; j < kBT; ++j) {
      float sa[R], kc[kCols];
#pragma unroll
      for (int a = 0; a < R; ++a) sa[a] = dss[(R * tr + a) * S::kP + j];
#pragma unroll
      for (int c = 0; c < kCols; ++c) kc[c] = ks[j * S::kS + tc + 16 * c];
#pragma unroll
      for (int a = 0; a < R; ++a)
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[a][c] = fmaf(sa[a], kc[c], acc[a][c]);
    }
  }
  float* out = dq + bq * sq * D;
#pragma unroll
  for (int a = 0; a < R; ++a) {
    const int row = i0 + R * tr + a;
    if (row >= sq) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      out[static_cast<int64_t>(row) * D + tc + 16 * c] = acc[a][c] * scale;
  }
}

template <int D>
__global__ void __launch_bounds__(kBwdThreads)
    flash_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ lse,
                          const float* __restrict__ delta, const float* __restrict__ dout,
                          float* __restrict__ dk, float* __restrict__ dv, int hq, int hkv,
                          int sq, int skv, float scale, int causal, int window) {
  using S = BwdSmem<D>;
  constexpr int R = kBT / 16;
  constexpr int kCols = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + kBT * S::kS;
  float* ks = dos + kBT * S::kS;
  float* vs = ks + kBT * S::kS;
  float* ps = vs + kBT * S::kS;
  float* dss = ps + kBT * S::kP;
  float* lse_s = dss + kBT * S::kP;
  float* delta_s = lse_s + kBT;

  const int j0 = blockIdx.x * kBT;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int rep = hq / hkv;
  const int64_t bkv = static_cast<int64_t>(b) * hkv + hk;
  const int tid = threadIdx.x;
  const int tr = tid / 16, tc = tid % 16;

  load_tile<float, D>(ks, S::kS, k + bkv * skv * D, j0, kBT, skv);
  load_tile<float, D>(vs, S::kS, v + bkv * skv * D, j0, kBT, skv);

  // the q rows that see any key of [j0, j0 + kBT): from j0 when causal, to
  // the last key + window - 1 with a window
  const int r_lo = causal ? j0 : 0;
  const int r_hi = window > 0 ? min(sq - 1, j0 + kBT - 1 + window - 1) : sq - 1;
  const int it_lo = r_lo / kBT, it_hi = r_hi >= r_lo ? r_hi / kBT : -1;

  float dk_acc[R][kCols], dv_acc[R][kCols];
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dk_acc[a][c] = dv_acc[a][c] = 0.0f;

  for (int hh = 0; hh < rep; ++hh) {
    const int64_t bq = static_cast<int64_t>(b) * hq + hk * rep + hh;
    for (int it = it_lo; it <= it_hi; ++it) {
      const int i0 = it * kBT;
      __syncthreads();  // the last tile's Q, dO, P and dS are read
      load_tile<float, D>(qs, S::kS, q + bq * sq * D, i0, kBT, sq);
      load_tile<float, D>(dos, S::kS, dout + bq * sq * D, i0, kBT, sq);
      if (tid < kBT) {
        const bool in = i0 + tid < sq;
        lse_s[tid] = in ? lse[bq * sq + i0 + tid] : 0.0f;
        delta_s[tid] = in ? delta[bq * sq + i0 + tid] : 0.0f;
      }
      __syncthreads();
      p_and_ds<D>(qs, dos, ks, vs, lse_s, delta_s, ps, dss, i0, j0, sq, skv, scale, causal,
                  window);
      __syncthreads();
      // dV[j][c] += sum_r P[r][j] dO[r][c];  dK[j][c] += sum_r dS[r][j] Q[r][c]
#pragma unroll 2
      for (int r = 0; r < kBT; ++r) {
        float pa[R], sa[R], oc[kCols], qc[kCols];
#pragma unroll
        for (int a = 0; a < R; ++a) {
          pa[a] = ps[r * S::kP + R * tr + a];
          sa[a] = dss[r * S::kP + R * tr + a];
        }
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          oc[c] = dos[r * S::kS + tc + 16 * c];
          qc[c] = qs[r * S::kS + tc + 16 * c];
        }
#pragma unroll
        for (int a = 0; a < R; ++a)
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            dv_acc[a][c] = fmaf(pa[a], oc[c], dv_acc[a][c]);
            dk_acc[a][c] = fmaf(sa[a], qc[c], dk_acc[a][c]);
          }
      }
    }
  }
  float* dkb = dk + bkv * skv * D;
  float* dvb = dv + bkv * skv * D;
#pragma unroll
  for (int a = 0; a < R; ++a) {
    const int row = j0 + R * tr + a;
    if (row >= skv) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int64_t at = static_cast<int64_t>(row) * D + tc + 16 * c;
      dkb[at] = dk_acc[a][c] * scale;
      dvb[at] = dv_acc[a][c];
    }
  }
}

template <int D>
cudaError_t launch_bwd_scalar(const void* q, const void* k, const void* v, const void* o,
                              const float* lse, const void* dout, void* dq, void* dk, void* dv,
                              float* delta, int batch, int hq, int hkv, int sq, int skv,
                              float scale, int causal, int window, cudaStream_t stream) {
  const size_t smem = BwdSmem<D>::kBytes;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(smem))) != cudaSuccess)
    return err;
  if ((err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<D>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(smem))) != cudaSuccess)
    return err;
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  const float* dop = static_cast<const float*>(dout);
  flash_bwd_dq_kernel<D><<<dim3((sq + kBT - 1) / kBT, hq, batch), kBwdThreads, smem, stream>>>(
      qp, kp, vp, static_cast<const float*>(o), lse, dop, static_cast<float*>(dq), delta, hq,
      hkv, sq, skv, scale, causal, window);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  flash_bwd_dkdv_kernel<D><<<dim3((skv + kBT - 1) / kBT, hkv, batch), kBwdThreads, smem,
                             stream>>>(qp, kp, vp, lse, delta, dop, static_cast<float*>(dk),
                                       static_cast<float*>(dv), hq, hkv, sq, skv, scale, causal,
                                       window);
  return cudaGetLastError();
}

// ---- bf16: the tensor-core kernels ------------------------------------------------

constexpr int kWgRowsB = 64;    // rows per consumer warpgroup (wgmma M)
constexpr int kTileB = 64;      // rows of a streamed tile (wgmma N of S, K of the rs products)
constexpr int kPiece64 = kTileB * 128;  // one (64 rows x 64 columns) bf16 piece, bytes
constexpr int kMaxSmemB = 232448;       // shared memory a CTA may opt in to on sm_90

// The CTA shapes of the two bf16 kernels by head dim, which
// flash_attn_bwd_tile_rows reports to the host:
//   * dQ: kDqWg warpgroups of 64 q rows each: two at D 64 and 128, one at
//     D 256, where Q and dO of 128 rows alone would take 128 KB;
//   * dK/dV: kKvWg warpgroups: one of 64 kv rows at D 64, two of 64 each at
//     D 128 (the faster at the training inputs, PERF.md row 5b), and at
//     D 256 two over the same 64 kv rows, split by gradient (kSplit: dV in
//     one, dK in the other), since one warpgroup's dK and dV over 256
//     columns would be 256 accumulator registers a thread;
//   * kStages: the ring's depth, 3, and 2 at D 256, where a stage is 64 KB.
template <int D>
struct BwdShape {
  static constexpr int kDqWg = D == 256 ? 1 : 2;
  static constexpr int kKvWg = D == 64 ? 1 : 2;
  static constexpr bool kSplit = D == 256;
  static constexpr int kStages = D == 256 ? 2 : 3;
  static constexpr int kDqRows = kDqWg * kWgRowsB;
  static constexpr int kKvRows = kSplit ? kWgRowsB : kKvWg * kWgRowsB;
};

// thread 0: one stage of the ring: 64 rows of two (rows, D) tensors as D /
// 64 128-byte swizzled (64 x 64) pieces each, from maps ta and tb at (64 p,
// row, head), then, where ``vec`` is given, the 64 floats of the vector map
// at va0 and at vb0 into it, all counted on the stage's barrier
template <int P>
__device__ __forceinline__ void load_pair(uint8_t* st, uint64_t* bar, const CUtensorMap* ta,
                                          const CUtensorMap* tb, int row, int head,
                                          const CUtensorMap* vec_map, float* vec, int va0,
                                          int vb0, uint32_t bytes) {
  hopper::mbar_arrive_expect_tx(bar, bytes);
#pragma unroll
  for (int p = 0; p < P; ++p) {
    hopper::tma_load_3d(st + p * kPiece64, ta, bar, 64 * p, row, head);
    hopper::tma_load_3d(st + (P + p) * kPiece64, tb, bar, 64 * p, row, head);
  }
  if (vec != nullptr) {
    hopper::tma_load_1d(vec, vec_map, bar, va0);
    hopper::tma_load_1d(vec + kTileB, vec_map, bar, vb0);
  }
}

// (a, b) as one bf16 pair, a in the low half
__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// the accumulator fragments of a warpgroup's (64 x 64) product as the A
// operand of the next product over the same 64 columns: k16 step kk takes
// columns 16kk..16kk+15, the registers 8kk..8kk+7, in order
__device__ __forceinline__ void as_a_operand(const float (&acc)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kk][r] = pack_bf16(acc[8 * kk + 2 * r], acc[8 * kk + 2 * r + 1]);
}

// d (64 x 64 f32) += A B over depth D, A's rows from a (rows x 64) piece
// sequence at ``a`` (piece stride a_piece, the warpgroup's first row at
// a_row0 bytes), B's (64 rows) from pieces of kPiece64 bytes at ``b``: both
// K-major, one k16 step 32 bytes along a 128-byte row
template <int D>
__device__ __forceinline__ void product_ss(float (&d)[32], const uint8_t* a, int a_piece,
                                           int a_row0, const uint8_t* b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    hopper::wgmma_m64n64k16_ss(
        d, hopper::desc_sw128(a + (kk / 4) * a_piece + a_row0 + (kk % 4) * 32),
        hopper::desc_sw128(b + (kk / 4) * kPiece64 + (kk % 4) * 32));
}

// acc[p] (64 x 64 f32, output columns 64p..64p+63) += A B, A (64 x 64 bf16)
// in registers, B (64 rows x 64 P columns) from MN-major pieces at ``b``:
// one k16 step 16 rows = 2048 bytes further down
template <int P>
__device__ __forceinline__ void product_rs(float (&acc)[P][32], const uint32_t (&a)[4][4],
                                           const uint8_t* b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int p = 0; p < P; ++p)
      hopper::wgmma_m64n64k16_rs_tb(acc[p], a[kk],
                                    hopper::desc_sw128(b + p * kPiece64 + kk * 16 * 128));
}

template <int P>
__device__ __forceinline__ void fence_all(float (&acc)[P][32]) {
#pragma unroll
  for (int p = 0; p < P; ++p) hopper::fence_regs(acc[p]);
}

// Shared memory of a dK/dV CTA, bytes from a 1024-aligned base: K then V,
// each D / 64 pieces of (kKvRows rows x 64 columns); then kStages stages of
// Q and dO (D / 64 pieces of 64 rows each); the stages' lse log2 e and D
// (64 floats each, a stage after the other); under the split the tile P^T
// that warpgroup 0 hands to warpgroup 1 (64 x 64 f32); then the mbarriers
// (K and V, then one per stage).
template <int D>
struct DkdvSmem {
  using B = BwdShape<D>;
  static constexpr int kPieces = D / 64;
  static constexpr int kKVPiece = B::kKvRows * 128;
  static constexpr int kKV = 2 * kPieces * kKVPiece;
  static constexpr int kStage = 2 * kPieces * kPiece64;
  static constexpr int kStageTx = kStage + 2 * kTileB * 4;  // a stage's copies, with its stats
  static constexpr int kStats = kKV + B::kStages * kStage;
  static constexpr int kXchg = kStats + B::kStages * 2 * kTileB * 4;
  static constexpr int kBars = kXchg + (B::kSplit ? kWgRowsB * kTileB * 4 : 0);
  static constexpr size_t kBytes = kBars + 8 * (1 + B::kStages) + 1024;  // + alignment
};

// the q tiles [lo, hi] whose rows see any key of [c0, c_end): from c0 when
// causal, below c_end - 1 + window with a window, below sq
__device__ __forceinline__ void q_tiles(int c0, int c_end, int sq, int causal, int window,
                                        int& lo, int& hi) {
  const int r_lo = causal ? c0 : 0;
  const int r_hi = window > 0 ? min(sq - 1, c_end - 1 + window - 1) : sq - 1;
  lo = r_lo / kTileB;
  hi = r_hi >= r_lo ? r_hi / kTileB : lo - 1;
}

// P^T in place of S^T (rows kv, columns q, in the accumulator's fragments):
// ex2(S^T scale log2 e - lse log2 e) where kv row ``row0 + 8 i`` is seen by
// q row ``i0 + column``, 0 elsewhere; ``inside``: every pair is seen
__device__ __forceinline__ void probabilities_t(float (&s)[32], const float* lse2_s, int row0,
                                                int col0, int i0, int sq, bool inside,
                                                int causal, int window, float scale_log2) {
#pragma unroll
  for (int c = 0; c < 8; ++c)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * c + col0 + e;
      const float l2 = lse2_s[col];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = 4 * c + 2 * i + e;
        const int row = row0 + 8 * i;
        const int qrow = i0 + col;
        bool keep = true;
        if (!inside) {
          keep = qrow < sq;
          if (causal) keep = keep && row <= qrow;
          if (window > 0) keep = keep && row > qrow - window;
        }
        s[r] = keep ? ex2(fmaf(s[r], scale_log2, -l2)) : 0.0f;
      }
    }
}

// dS^T = P^T (dP^T - D) in place of dP^T, D per q column
__device__ __forceinline__ void ds_t(const float (&p)[32], float (&dp)[32], const float* delta_s,
                                     int col0) {
#pragma unroll
  for (int c = 0; c < 8; ++c)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float dl = delta_s[8 * c + col0 + e];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = 4 * c + 2 * i + e;
        dp[r] = p[r] * (dp[r] - dl);
      }
    }
}

// a thread's rows row0 and row0 + 8 of the warpgroup's (64 x 64 P)
// accumulator fragments, times ``mul``, as bf16 into the row-major (rows, D)
// ``out``; rows at or past ``rows`` are left alone
template <int D, int P>
__device__ __forceinline__ void store_rows(bf16* out, const float (&acc)[P][32], float mul,
                                           int row0, int col0, int rows) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= rows) continue;
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int c = 0; c < 8; ++c)
        *reinterpret_cast<__nv_bfloat162*>(out + static_cast<int64_t>(row) * D + 64 * p +
                                           8 * c + col0) =
            __floats2bfloat162_rn(acc[p][4 * c + 2 * i] * mul, acc[p][4 * c + 2 * i + 1] * mul);
  }
}

template <int D>
__global__ void __launch_bounds__(128 * BwdShape<D>::kKvWg, 1)
    flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                                const __grid_constant__ CUtensorMap tk,
                                const __grid_constant__ CUtensorMap tv,
                                const __grid_constant__ CUtensorMap tdo,
                                const __grid_constant__ CUtensorMap tstats,
                                bf16* __restrict__ dk, bf16* __restrict__ dv, int hq, int hkv,
                                int sq, int skv, int sq_pad, int bhq, float scale,
                                float scale_log2, int causal, int window) {
  using B = BwdShape<D>;
  using S = DkdvSmem<D>;
  constexpr int P = S::kPieces;
  constexpr int kStages = B::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  const uint8_t* ks = smem;
  const uint8_t* vs = smem + P * S::kKVPiece;
  float* stats_s = reinterpret_cast<float*>(smem + S::kStats);
  float* xchg = reinterpret_cast<float*>(smem + S::kXchg);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + S::kBars);

  const int j0 = blockIdx.x * B::kKvRows;
  const int bkv = blockIdx.z * hkv + blockIdx.y;
  const int rep = hq / hkv;
  const int bq0 = blockIdx.z * hq + blockIdx.y * rep;
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;

  // the CTA streams the q tiles any of its kv rows below skv can see; each
  // warpgroup computes on those its own 64 rows can see (under the split
  // both own the CTA's 64)
  const int r_wg = j0 + (B::kSplit ? 0 : wg * kWgRowsB);
  const bool wg_rows = r_wg < skv;
  int lo, hi, my_lo, my_hi;
  q_tiles(j0, min(j0 + B::kKvRows, skv), sq, causal, window, lo, hi);
  q_tiles(r_wg, min(r_wg + kWgRowsB, skv), sq, causal, window, my_lo, my_hi);
  const int per_head = hi - lo + 1;
  const int n_tiles = rep * per_head;

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 1 + kStages; ++i) hopper::mbar_init(&bars[i], 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  auto load_tile_n = [&](int n) {
    const int bq = bq0 + n / per_head;
    const int i0 = (lo + n % per_head) * kTileB;
    const int st = n % kStages;
    load_pair<P>(smem + S::kKV + st * S::kStage, &bars[1 + st], &tq, &tdo, i0, bq, &tstats,
                 stats_s + st * 2 * kTileB, bq * sq_pad + i0, (bhq + bq) * sq_pad + i0,
                 S::kStageTx);
  };
  if (tid == 0) {
    hopper::mbar_arrive_expect_tx(&bars[0], S::kKV);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      hopper::tma_load_3d(smem + p * S::kKVPiece, &tk, &bars[0], 64 * p, j0, bkv);
      hopper::tma_load_3d(smem + (P + p) * S::kKVPiece, &tv, &bars[0], 64 * p, j0, bkv);
    }
    for (int n = 0; n < kStages - 1 && n < n_tiles; ++n) load_tile_n(n);
  }
  __syncwarp();

  // accumulator fragment (i, c, e) of register 4c + 2i + e: row (kv)
  // 16 warp + lane / 4 + 8i of the warpgroup's 64, column (q or d)
  // 8c + 2 (lane % 4) + e.  dv_acc holds dV and dk_acc dK; under the split
  // a warpgroup holds one gradient, in dv_acc: dV in warpgroup 0, dK in 1
  float dv_acc[P][32], dk_acc[B::kSplit ? 1 : P][32];
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int r = 0; r < 32; ++r) dv_acc[p][r] = 0.0f;
#pragma unroll
  for (int p = 0; p < (B::kSplit ? 1 : P); ++p)
#pragma unroll
    for (int r = 0; r < 32; ++r) dk_acc[p][r] = 0.0f;
  const int row0 = r_wg + warp * 16 + lane / 4;
  const int col0 = 2 * (lane % 4);
  hopper::mbar_wait(&bars[0], 0);

  for (int n = 0; n < n_tiles; ++n) {
    // the stage tile n + kStages - 1 goes into held tile n - 1, which every
    // thread finished with before the barrier that closed the last iteration
    if (tid == 0 && n + kStages - 1 < n_tiles) load_tile_n(n + kStages - 1);
    __syncwarp();
    hopper::mbar_wait(&bars[1 + n % kStages], (n / kStages) & 1);
    const int it = lo + n % per_head;
    if (wg_rows && it >= my_lo && it <= my_hi) {
      const uint8_t* qs = smem + S::kKV + (n % kStages) * S::kStage;
      const uint8_t* dos = qs + P * kPiece64;
      const float* lse2_s = stats_s + (n % kStages) * 2 * kTileB;
      const float* delta_s = lse2_s + kTileB;
      // a tile inside the band of all 64 kv rows of the warpgroup needs no mask
      const int i0 = it * kTileB;
      const bool inside = i0 + kTileB <= sq && (!causal || r_wg + kWgRowsB - 1 <= i0) &&
                          (window <= 0 || i0 + kTileB - 1 < r_wg + window);

      if constexpr (B::kSplit) {
        // warpgroup 0 forms S^T = K Q^T, then P^T, hands P^T to warpgroup 1
        // as f32 through shared memory in fragment order (thread t of
        // either holds the same elements), and adds P^T dO to dV;
        // warpgroup 1 forms dP^T = V dO^T, then dS^T = P^T (dP^T - D), and
        // adds dS^T Q to dK
        float x[32];
#pragma unroll
        for (int r = 0; r < 32; ++r) x[r] = 0.0f;
        hopper::wgmma_fence();
        product_ss<D>(x, wg == 0 ? ks : vs, S::kKVPiece, 0, wg == 0 ? qs : dos);
        hopper::wgmma_commit();
        hopper::wgmma_wait_all();
        hopper::fence_regs(x);
        const int t = tid % 128;
        if (wg == 0) {
          probabilities_t(x, lse2_s, row0, col0, i0, sq, inside, causal, window, scale_log2);
#pragma unroll
          for (int r = 0; r < 32; ++r) xchg[r * 128 + t] = x[r];
        }
        __syncthreads();
        if (wg == 1) {
          float pt[32];
#pragma unroll
          for (int r = 0; r < 32; ++r) pt[r] = xchg[r * 128 + t];
          ds_t(pt, x, delta_s, col0);
        }
        uint32_t xa[4][4];
        as_a_operand(x, xa);
        fence_all<P>(dv_acc);
        hopper::wgmma_fence();
        product_rs<P>(dv_acc, xa, wg == 0 ? dos : qs);
        hopper::wgmma_commit();
        hopper::wgmma_wait_all();
        fence_all<P>(dv_acc);
      } else {
        // S^T = K Q^T and dP^T = V dO^T, both in flight at once; then
        // dV += P^T dO and dK += dS^T Q
        float sacc[32], pacc[32];
#pragma unroll
        for (int r = 0; r < 32; ++r) sacc[r] = pacc[r] = 0.0f;
        hopper::wgmma_fence();
        product_ss<D>(sacc, ks, S::kKVPiece, wg * kWgRowsB * 128, qs);
        product_ss<D>(pacc, vs, S::kKVPiece, wg * kWgRowsB * 128, dos);
        hopper::wgmma_commit();
        hopper::wgmma_wait_all();
        hopper::fence_regs(sacc);
        hopper::fence_regs(pacc);
        probabilities_t(sacc, lse2_s, row0, col0, i0, sq, inside, causal, window, scale_log2);
        ds_t(sacc, pacc, delta_s, col0);
        uint32_t pa[4][4], dsa[4][4];
        as_a_operand(sacc, pa);
        as_a_operand(pacc, dsa);
        fence_all<P>(dv_acc);
        fence_all<P>(dk_acc);
        hopper::wgmma_fence();
        product_rs<P>(dv_acc, pa, dos);
        product_rs<P>(dk_acc, dsa, qs);
        hopper::wgmma_commit();
        hopper::wgmma_wait_all();
        fence_all<P>(dv_acc);
        fence_all<P>(dk_acc);
      }
    }
    __syncthreads();  // every warpgroup is done with this stage
  }

  if (!wg_rows) return;
  bf16* dkb = dk + static_cast<int64_t>(bkv) * skv * D;
  bf16* dvb = dv + static_cast<int64_t>(bkv) * skv * D;
  if constexpr (B::kSplit) {
    store_rows<D, P>(wg == 0 ? dvb : dkb, dv_acc, wg == 0 ? 1.0f : scale, row0, col0, skv);
  } else {
    store_rows<D, P>(dkb, dk_acc, scale, row0, col0, skv);
    store_rows<D, P>(dvb, dv_acc, 1.0f, row0, col0, skv);
  }
}

// Shared memory of a dQ CTA, bytes from a 1024-aligned base: Q then dO, each
// D / 64 pieces of (kDqRows rows x 64 columns); kStages stages of K and V
// (D / 64 pieces of 64 rows each); lse log2 e and D of the CTA's rows; the
// mbarriers (Q and dO, then one per stage).
template <int D>
struct DqSmem {
  using B = BwdShape<D>;
  static constexpr int kPieces = D / 64;
  static constexpr int kQPiece = B::kDqRows * 128;
  static constexpr int kQ = 2 * kPieces * kQPiece;
  static constexpr int kStage = 2 * kPieces * kPiece64;
  static constexpr int kStats = kQ + B::kStages * kStage;
  static constexpr int kBars = kStats + 2 * B::kDqRows * 4;
  static constexpr size_t kBytes = kBars + 8 * (1 + B::kStages) + 1024;  // + alignment
};

static_assert(DqSmem<256>::kBytes <= kMaxSmemB && DkdvSmem<256>::kBytes <= kMaxSmemB,
              "the D 256 CTAs must fit in shared memory");

// the kv tiles [lo, hi] that query rows [r0, r_end) see: none wholly past
// the diagonal of row r_end - 1 (causal) or wholly before the window of row
// r0 (flash_attn.cu kv_tiles)
__device__ __forceinline__ void kv_tiles_b(int r0, int r_end, int skv, int causal, int window,
                                           int& lo, int& hi) {
  int last_col = skv - 1;
  if (causal) last_col = min(last_col, r_end - 1);
  hi = last_col >= 0 ? last_col / kTileB : -1;
  lo = window > 0 ? max(0, r0 - window + 1) / kTileB : 0;
}

template <int D>
__global__ void __launch_bounds__(128 * BwdShape<D>::kDqWg, 1)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap tdo,
                              const bf16* __restrict__ o, const bf16* __restrict__ dout,
                              const float* __restrict__ lse, bf16* __restrict__ dq,
                              float* __restrict__ stats, int hq, int hkv, int sq, int skv,
                              int sq_pad, int bhq, float scale, float scale_log2, int causal,
                              int window) {
  using B = BwdShape<D>;
  using S = DqSmem<D>;
  constexpr int P = S::kPieces;
  constexpr int kRows = B::kDqRows;
  constexpr int kStages = B::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  const uint8_t* qs = smem;
  const uint8_t* dos = smem + P * S::kQPiece;
  float* lse2_s = reinterpret_cast<float*>(smem + S::kStats);
  float* delta_s = lse2_s + kRows;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + S::kBars);

  // the last (under a causal mask, the heaviest) q tiles first
  const int i0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int bq = blockIdx.z * hq + blockIdx.y;
  const int bkv = blockIdx.z * hkv + blockIdx.y / (hq / hkv);
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;

  const int r_wg = i0 + wg * kWgRowsB;
  const bool wg_rows = r_wg < sq;
  int lo, hi, my_lo, my_hi;
  kv_tiles_b(i0, min(i0 + kRows, sq), skv, causal, window, lo, hi);
  kv_tiles_b(r_wg, min(r_wg + kWgRowsB, sq), skv, causal, window, my_lo, my_hi);
  const int n_tiles = hi - lo + 1;

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 1 + kStages; ++i) hopper::mbar_init(&bars[i], 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  auto load_kv_n = [&](int n) {
    load_pair<P>(smem + S::kQ + (n % kStages) * S::kStage, &bars[1 + n % kStages], &tk, &tv,
                 (lo + n) * kTileB, bkv, nullptr, nullptr, 0, 0, S::kStage);
  };
  if (tid == 0) {
    hopper::mbar_arrive_expect_tx(&bars[0], S::kQ);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      hopper::tma_load_3d(smem + p * S::kQPiece, &tq, &bars[0], 64 * p, i0, bq);
      hopper::tma_load_3d(smem + (P + p) * S::kQPiece, &tdo, &bars[0], 64 * p, i0, bq);
    }
    for (int n = 0; n < kStages - 1 && n < n_tiles; ++n) load_kv_n(n);
  }
  __syncwarp();

  // D = rowsum(dO o) of the CTA's rows: two threads a row, each half the
  // columns in order, then their sum (the same in either lane); each row's
  // lse log2 e and D to shared memory and to the stats scratch (0 on the
  // rows from sq to sq_pad) for the dK/dV kernel
  {
    const int r = tid / 2, half = tid % 2;
    const int row = i0 + r;
    float acc = 0.0f;
    if (row < sq) {
      const int64_t at = (static_cast<int64_t>(bq) * sq + row) * D + half * (D / 2);
#pragma unroll 4
      for (int c = 0; c < D / 2; c += 8) {
        float x[8], y[8];
        load8(dout + at + c, x);
        load8(o + at + c, y);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc = fmaf(x[e], y[e], acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      const float l2 = row < sq ? lse[static_cast<int64_t>(bq) * sq + row] * kLog2eBwd : 0.0f;
      lse2_s[r] = l2;
      delta_s[r] = acc;
      if (row < sq_pad) {
        stats[static_cast<int64_t>(bq) * sq_pad + row] = l2;
        stats[static_cast<int64_t>(bhq + bq) * sq_pad + row] = acc;
      }
    }
  }
  __syncthreads();

  const int row0 = r_wg + warp * 16 + lane / 4;
  const int col0 = 2 * (lane % 4);
  float l2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    l2[i] = lse2_s[row - i0];
    dl[i] = delta_s[row - i0];
  }
  float dq_acc[P][32];
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int r = 0; r < 32; ++r) dq_acc[p][r] = 0.0f;
  hopper::mbar_wait(&bars[0], 0);

  for (int n = 0; n < n_tiles; ++n) {
    if (tid == 0 && n + kStages - 1 < n_tiles) load_kv_n(n + kStages - 1);
    __syncwarp();
    hopper::mbar_wait(&bars[1 + n % kStages], (n / kStages) & 1);
    const int jt = lo + n;
    if (wg_rows && jt >= my_lo && jt <= my_hi) {
      const uint8_t* ks = smem + S::kQ + (n % kStages) * S::kStage;
      const uint8_t* vs = ks + P * kPiece64;

      // S = Q K^T and dP = dO V^T
      float sacc[32], pacc[32];
#pragma unroll
      for (int r = 0; r < 32; ++r) sacc[r] = pacc[r] = 0.0f;
      hopper::wgmma_fence();
      product_ss<D>(sacc, qs, S::kQPiece, wg * kWgRowsB * 128, ks);
      product_ss<D>(pacc, dos, S::kQPiece, wg * kWgRowsB * 128, vs);
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
      hopper::fence_regs(sacc);
      hopper::fence_regs(pacc);

      const int j0 = jt * kTileB;
      const bool inside = j0 + kTileB <= skv && (!causal || j0 + kTileB - 1 <= r_wg) &&
                          (window <= 0 || j0 > r_wg + kWgRowsB - 1 - window);
#pragma unroll
      for (int c = 0; c < 8; ++c)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int r = 4 * c + 2 * i + e;
            const bool keep = inside || seen(row0 + 8 * i, j0 + 8 * c + col0 + e, skv, causal,
                                             window);
            const float p = keep ? ex2(fmaf(sacc[r], scale_log2, -l2[i])) : 0.0f;
            pacc[r] = p * (pacc[r] - dl[i]);
          }
      // dQ += dS K
      uint32_t dsa[4][4];
      as_a_operand(pacc, dsa);
      fence_all<P>(dq_acc);
      hopper::wgmma_fence();
      product_rs<P>(dq_acc, dsa, ks);
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
      fence_all<P>(dq_acc);
    }
    __syncthreads();  // every warpgroup is done with this stage
  }

  if (wg_rows)
    store_rows<D, P>(dq + static_cast<int64_t>(bq) * sq * D, dq_acc, scale, row0, col0, sq);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int D>
cudaError_t launch_bwd_wgmma(const void* q, const void* k, const void* v, const void* o,
                             const float* lse, const void* dout, void* dq, void* dk, void* dv,
                             float* stats, int batch, int hq, int hkv, int sq, int skv,
                             float scale, int causal, int window, cudaStream_t stream) {
  using B = BwdShape<D>;
  // the runtime calls first: they make the device's context current on this
  // thread, which cuTensorMapEncodeTiled (make_map) needs.  autograd's
  // worker thread has none before its first CUDA runtime call, and there
  // the encoding failed when it came first.
  cudaError_t err;
  if ((err = allow_smem(flash_bwd_dq_wgmma_kernel<D>, DqSmem<D>::kBytes)) != cudaSuccess)
    return err;
  if ((err = allow_smem(flash_bwd_dkdv_wgmma_kernel<D>, DkdvSmem<D>::kBytes)) != cudaSuccess)
    return err;
  CUtensorMap tq_dq, tdo_dq, tkv_k, tkv_v, tq, tdo, tk, tv, tstats;
  const int sq_pad = (sq + kTileB - 1) / kTileB * kTileB;
  const int bhq = batch * hq;
  if (!make_map(&tq_dq, q, batch * hq, sq, D, B::kDqRows) ||
      !make_map(&tdo_dq, dout, batch * hq, sq, D, B::kDqRows) ||
      !make_map(&tkv_k, k, batch * hkv, skv, D, kTileB) ||
      !make_map(&tkv_v, v, batch * hkv, skv, D, kTileB) ||
      !make_map(&tq, q, batch * hq, sq, D, kTileB) ||
      !make_map(&tdo, dout, batch * hq, sq, D, kTileB) ||
      !make_map(&tk, k, batch * hkv, skv, D, B::kKvRows) ||
      !make_map(&tv, v, batch * hkv, skv, D, B::kKvRows) ||
      !make_map_1d(&tstats, stats, 2 * static_cast<int64_t>(bhq) * sq_pad, kTileB))
    return cudaErrorInvalidValue;
  const float scale_log2 = scale * kLog2eBwd;
  flash_bwd_dq_wgmma_kernel<D><<<dim3((sq + B::kDqRows - 1) / B::kDqRows, hq, batch),
                                 128 * B::kDqWg, DqSmem<D>::kBytes, stream>>>(
      tq_dq, tkv_k, tkv_v, tdo_dq, static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
      lse, static_cast<bf16*>(dq), stats, hq, hkv, sq, skv, sq_pad, bhq, scale, scale_log2,
      causal, window);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  flash_bwd_dkdv_wgmma_kernel<D><<<dim3((skv + B::kKvRows - 1) / B::kKvRows, hkv, batch),
                                   128 * B::kKvWg, DkdvSmem<D>::kBytes, stream>>>(
      tq, tk, tv, tdo, tstats, static_cast<bf16*>(dk), static_cast<bf16*>(dv), hq, hkv, sq, skv,
      sq_pad, bhq, scale, scale_log2, causal, window);
  return cudaGetLastError();
}

template <int D>
int wgmma_rows(int* q_rows, int* kv_rows) {
  *q_rows = BwdShape<D>::kDqRows;
  *kv_rows = BwdShape<D>::kKvRows;
  return 0;
}

}  // namespace repro_torch

// q, o, dout, dq (B, Hq, Sq, D); k, v, dk, dv (B, Hkv, Skv, D): contiguous,
// 16-byte aligned, one dtype (code 0 f32, 3 bf16), D 64, 128 or 256 in bf16
// and 16, 64 or 128 in f32, Hq a multiple of Hkv, 2 B Hq Sq below 2^31; lse
// (the forward's) (B, Hq, Sq) f32; stats f32 scratch of 2 B Hq ceil(Sq / 64)
// 64 floats, 16-byte aligned: the scalar kernels keep D there as (B, Hq,
// Sq), the wgmma ones lse log2 e, then D, as (2, B Hq, Sq rounded up to 64).
extern "C" int flash_attn_bwd_launch(const void* q, const void* k, const void* v,
                                     const void* o, const void* lse, const void* dout,
                                     void* dq, void* dk, void* dv, void* stats, int dtype,
                                     int batch, int hq, int hkv, int sq, int skv,
                                     int head_dim, float scale, int causal, int window,
                                     void* stream) {
  using namespace repro_torch;
  if (batch <= 0 || hq <= 0 || sq <= 0 || skv <= 0) return static_cast<int>(cudaGetLastError());
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* l = static_cast<const float*>(lse);
  auto* dl = static_cast<float*>(stats);
  if (dtype == kDtypeBF16 && head_dim == 64)
    return launch_bwd_wgmma<64>(q, k, v, o, l, dout, dq, dk, dv, dl, batch, hq, hkv, sq, skv,
                                scale, causal, window, st);
  if (dtype == kDtypeBF16 && head_dim == 128)
    return launch_bwd_wgmma<128>(q, k, v, o, l, dout, dq, dk, dv, dl, batch, hq, hkv, sq, skv,
                                 scale, causal, window, st);
  if (dtype == kDtypeBF16 && head_dim == 256)
    return launch_bwd_wgmma<256>(q, k, v, o, l, dout, dq, dk, dv, dl, batch, hq, hkv, sq, skv,
                                 scale, causal, window, st);
  if (dtype == kDtypeF32 && head_dim == 16)
    return launch_bwd_scalar<16>(q, k, v, o, l, dout, dq, dk, dv, dl, batch, hq, hkv, sq, skv,
                                 scale, causal, window, st);
  if (dtype == kDtypeF32 && head_dim == 64)
    return launch_bwd_scalar<64>(q, k, v, o, l, dout, dq, dk, dv, dl, batch, hq, hkv, sq, skv,
                                 scale, causal, window, st);
  if (dtype == kDtypeF32 && head_dim == 128)
    return launch_bwd_scalar<128>(q, k, v, o, l, dout, dq, dk, dv, dl, batch, hq, hkv, sq, skv,
                                  scale, causal, window, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The rows of one CTA of each launch for (dtype, head_dim): q rows of a dQ
// CTA and kv rows of a dK/dV CTA, the grids' shape
// (kernels/flash_attn/ops.py BWD_TILE_ROWS holds the host's copy, checked
// against this when the library is loaded); cudaErrorInvalidValue for a
// width the library does not take.
extern "C" int flash_attn_bwd_tile_rows(int dtype, int head_dim, int* q_rows, int* kv_rows) {
  using namespace repro_torch;
  if (dtype == kDtypeBF16 && head_dim == 64) return wgmma_rows<64>(q_rows, kv_rows);
  if (dtype == kDtypeBF16 && head_dim == 128) return wgmma_rows<128>(q_rows, kv_rows);
  if (dtype == kDtypeBF16 && head_dim == 256) return wgmma_rows<256>(q_rows, kv_rows);
  if (dtype == kDtypeF32 && (head_dim == 16 || head_dim == 64 || head_dim == 128)) {
    *q_rows = *kv_rows = kBT;
    return 0;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_attn_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
