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
// bf16 inputs at D 64 and 128: flash_bwd_dkdv_wgmma_kernel and
// flash_bwd_dq_wgmma_kernel, on the tensor cores, built from the forward's
// parts (hopper.cuh, tma_map.cuh):
// 128-byte swizzled TMA tiles, a ring of kStagesB (3) stages each guarded by an
// mbarrier that counts the copy's bytes (thread 0 issues tile n + kStagesB - 1
// before the warpgroups start on tile n), wgmma m64n64k16 with D 128 taken as
// two 64-column pieces.  Each consumer warpgroup owns 64 rows, wgmma's M.
//   * dQ: one CTA per (b, q head, 128 q rows), two warpgroups, the heaviest
//     (last) q tiles first.  Q and dO come in once; a prologue forms D of
//     its rows from o and dO (fixed order, so repeatable) and writes each
//     row's lse log2 e and D to a stats scratch whose rows are padded to a
//     multiple of 64 (zeros there), so that dK/dV reads them as aligned
//     64-float TMA boxes.  The 64-row K and V tiles the mask admits stream
//     through the ring: S = Q K^T and dP = dO V^T (ss, both K-major), P and
//     dS in registers, dQ += dS K (rs, K the transposed, MN-major B).
//   * dK/dV: one CTA per (b, kv head, 64 WG kv rows), WG warpgroups (one at
//     D 64, two at D 128, set in launch_bwd_wgmma; ops.BWD_KV_ROWS gives the
//     grid's shape to the host).  K and V
//     come in once; then, for each q head of the group, every 64-row q tile
//     the mask admits streams Q, dO and its rows' stats through the ring.
//     Per tile: S^T = K Q^T and dP^T = V dO^T (ss); P^T = ex2(S^T scale
//     log2 e - lse log2 e) with lse and D per column from shared memory,
//     masked only on a tile at an edge of the warpgroup's band;
//     dS^T = P^T (dP^T - D); then dV += P^T dO and dK += dS^T Q (rs: P^T and
//     dS^T as bf16 pairs straight from their accumulator fragments, dO and
//     Q MN-major).
// P and dS go into the products rounded once to bf16; every sum is f32 in
// the wgmma accumulators, and the gradients are rounded once to bf16.
// Ragged Sq and Skv: TMA fills rows past the ends with zeros, the q < Sq
// mask zeroes P on those columns, and rows past the ends are not stored.
//
// f32 inputs: flash_bwd_dq_kernel and flash_bwd_dkdv_kernel, scalar: wgmma on
// f32 is TF32 (about three digits), looser than the f32 check (1e-4 of the
// largest gradient).  256 threads, (BT, D) tiles in shared memory widened to
// f32 (rows padded by one word, so reads down a column hit 32 banks), each
// thread an R x R tile of the (BT, BT) products and R x D/16 of the (BT, D)
// ones, R = BT / 16, all f32 FMAs; BT 64 at D 16, 64 and 128.
// bf16 at D 256 (gemma-7b) takes the same scalar kernels on bf16 loads, with
// BT 32: neither wgmma design fits there (the dQ CTA's Q and dO alone are
// 128 KB before its three 64 KB ring stages; the dK/dV CTA's two 64 x 256
// f32 accumulators want 256 registers a thread), and four (64, 257) f32
// tiles would take 263 KB.  The same rules hold: no atomics, dQ (with D)
// then dK/dV, P from the forward's log-sum-exp; every sum is f32 and the
// gradients are rounded once to bf16.  A wgmma design at D 256 is later
// work.
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

// ---- the scalar kernels: f32 at every head dim, bf16 at D 256 ----------------------

// Shared memory of a scalar CTA: (BT, D) tiles of Q, dO, K and V widened to
// f32 (the dQ kernel's O while it forms D), then P and dS, then the q tile's
// lse and D
template <int D, int BT>
struct BwdSmem {
  static constexpr int kS = D + 1;    // row stride of the (BT, D) tiles
  static constexpr int kP = BT + 1;   // row stride of P and dS
  static constexpr size_t kBytes = sizeof(float) * (4 * BT * kS + 2 * BT * kP + 2 * BT);
};

// P and dS of q rows [i0, i0 + BT) against kv rows [j0, j0 + BT) into ps and
// dss: S = Q K^T and dP = dO V^T by one pass over d, then P = exp(scale S -
// lse) where the key is seen (0 elsewhere, and on rows >= sq) and
// dS = P (dP - D).  Thread (tr, tc) owns rows R tr .. R tr + R - 1 and
// columns tc + 16 c, R = BT / 16.
template <int D, int BT>
__device__ __forceinline__ void p_and_ds(const float* qs, const float* dos, const float* ks,
                                         const float* vs, const float* lse_s,
                                         const float* delta_s, float* ps, float* dss, int i0,
                                         int j0, int sq, int skv, float scale, int causal,
                                         int window) {
  using S = BwdSmem<D, BT>;
  constexpr int R = BT / 16;
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

template <typename T, int D, int BT>
__global__ void __launch_bounds__(kBwdThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ o,
                        const float* __restrict__ lse, const T* __restrict__ dout,
                        T* __restrict__ dq, float* __restrict__ delta, int hq, int hkv,
                        int sq, int skv, float scale, int causal, int window) {
  using S = BwdSmem<D, BT>;
  constexpr int R = BT / 16;
  constexpr int kCols = D / 16;
  constexpr int kPerRow = kBwdThreads / BT;  // threads that form one row's D
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + BT * S::kS;
  float* ks = dos + BT * S::kS;
  float* vs = ks + BT * S::kS;
  float* ps = vs + BT * S::kS;
  float* dss = ps + BT * S::kP;
  float* lse_s = dss + BT * S::kP;
  float* delta_s = lse_s + BT;

  const int i0 = blockIdx.x * BT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int64_t bq = static_cast<int64_t>(b) * hq + h;
  const T* kb = k + (static_cast<int64_t>(b) * hkv + hk) * skv * D;
  const T* vb = v + (static_cast<int64_t>(b) * hkv + hk) * skv * D;
  const int tid = threadIdx.x;

  load_tile<T, D>(qs, S::kS, q + bq * sq * D, i0, BT, sq);
  load_tile<T, D>(dos, S::kS, dout + bq * sq * D, i0, BT, sq);
  load_tile<T, D>(ks, S::kS, o + bq * sq * D, i0, BT, sq);  // O, for D only
  if (tid < BT) lse_s[tid] = i0 + tid < sq ? lse[bq * sq + i0 + tid] : 0.0f;
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

  // the kv tiles [lo, hi] rows [i0, i0 + BT) can see (flash_attn.cu kv_tiles)
  int last_col = skv - 1;
  if (causal) last_col = min(last_col, i0 + BT - 1);
  const int hi = last_col >= 0 ? last_col / BT : -1;
  const int lo = window > 0 ? max(0, i0 - window + 1) / BT : 0;
  for (int jt = lo; jt <= hi; ++jt) {
    const int j0 = jt * BT;
    __syncthreads();  // the last tile's K, V, P and dS are read
    load_tile<T, D>(ks, S::kS, kb, j0, BT, skv);
    load_tile<T, D>(vs, S::kS, vb, j0, BT, skv);
    __syncthreads();
    p_and_ds<D, BT>(qs, dos, ks, vs, lse_s, delta_s, ps, dss, i0, j0, sq, skv, scale, causal,
                    window);
    __syncthreads();
    // dQ[r][c] += sum_j dS[r][j] K[j][c]
#pragma unroll 4
    for (int j = 0; j < BT; ++j) {
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
  T* out = dq + bq * sq * D;
#pragma unroll
  for (int a = 0; a < R; ++a) {
    const int row = i0 + R * tr + a;
    if (row >= sq) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      out[static_cast<int64_t>(row) * D + tc + 16 * c] = from_f32<T>(acc[a][c] * scale);
  }
}

template <typename T, int D, int BT>
__global__ void __launch_bounds__(kBwdThreads)
    flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const float* __restrict__ lse,
                          const float* __restrict__ delta, const T* __restrict__ dout,
                          T* __restrict__ dk, T* __restrict__ dv, int hq, int hkv,
                          int sq, int skv, float scale, int causal, int window) {
  using S = BwdSmem<D, BT>;
  constexpr int R = BT / 16;
  constexpr int kCols = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + BT * S::kS;
  float* ks = dos + BT * S::kS;
  float* vs = ks + BT * S::kS;
  float* ps = vs + BT * S::kS;
  float* dss = ps + BT * S::kP;
  float* lse_s = dss + BT * S::kP;
  float* delta_s = lse_s + BT;

  const int j0 = blockIdx.x * BT;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int rep = hq / hkv;
  const int64_t bkv = static_cast<int64_t>(b) * hkv + hk;
  const int tid = threadIdx.x;
  const int tr = tid / 16, tc = tid % 16;

  load_tile<T, D>(ks, S::kS, k + bkv * skv * D, j0, BT, skv);
  load_tile<T, D>(vs, S::kS, v + bkv * skv * D, j0, BT, skv);

  // the q rows that see any key of [j0, j0 + BT): from j0 when causal, to
  // the last key + window - 1 with a window
  const int r_lo = causal ? j0 : 0;
  const int r_hi = window > 0 ? min(sq - 1, j0 + BT - 1 + window - 1) : sq - 1;
  const int it_lo = r_lo / BT, it_hi = r_hi >= r_lo ? r_hi / BT : -1;

  float dk_acc[R][kCols], dv_acc[R][kCols];
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dk_acc[a][c] = dv_acc[a][c] = 0.0f;

  for (int hh = 0; hh < rep; ++hh) {
    const int64_t bq = static_cast<int64_t>(b) * hq + hk * rep + hh;
    for (int it = it_lo; it <= it_hi; ++it) {
      const int i0 = it * BT;
      __syncthreads();  // the last tile's Q, dO, P and dS are read
      load_tile<T, D>(qs, S::kS, q + bq * sq * D, i0, BT, sq);
      load_tile<T, D>(dos, S::kS, dout + bq * sq * D, i0, BT, sq);
      if (tid < BT) {
        const bool in = i0 + tid < sq;
        lse_s[tid] = in ? lse[bq * sq + i0 + tid] : 0.0f;
        delta_s[tid] = in ? delta[bq * sq + i0 + tid] : 0.0f;
      }
      __syncthreads();
      p_and_ds<D, BT>(qs, dos, ks, vs, lse_s, delta_s, ps, dss, i0, j0, sq, skv, scale, causal,
                      window);
      __syncthreads();
      // dV[j][c] += sum_r P[r][j] dO[r][c];  dK[j][c] += sum_r dS[r][j] Q[r][c]
#pragma unroll 2
      for (int r = 0; r < BT; ++r) {
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
  T* dkb = dk + bkv * skv * D;
  T* dvb = dv + bkv * skv * D;
#pragma unroll
  for (int a = 0; a < R; ++a) {
    const int row = j0 + R * tr + a;
    if (row >= skv) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int64_t at = static_cast<int64_t>(row) * D + tc + 16 * c;
      dkb[at] = from_f32<T>(dk_acc[a][c] * scale);
      dvb[at] = from_f32<T>(dv_acc[a][c]);
    }
  }
}

// tiles of BT rows: 64, and 32 at D 256, where four (64, 257) f32 tiles
// alone would take 263 KB
template <typename T, int D, int BT>
cudaError_t launch_bwd_scalar(const void* q, const void* k, const void* v, const void* o,
                              const float* lse, const void* dout, void* dq, void* dk, void* dv,
                              float* delta, int batch, int hq, int hkv, int sq, int skv,
                              float scale, int causal, int window, cudaStream_t stream) {
  const size_t smem = BwdSmem<D, BT>::kBytes;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D, BT>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(smem))) != cudaSuccess)
    return err;
  if ((err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, D, BT>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(smem))) != cudaSuccess)
    return err;
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dop = static_cast<const T*>(dout);
  flash_bwd_dq_kernel<T, D, BT><<<dim3((sq + BT - 1) / BT, hq, batch), kBwdThreads, smem,
                                  stream>>>(qp, kp, vp, static_cast<const T*>(o), lse, dop,
                                            static_cast<T*>(dq), delta, hq, hkv, sq, skv,
                                            scale, causal, window);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  flash_bwd_dkdv_kernel<T, D, BT><<<dim3((skv + BT - 1) / BT, hkv, batch), kBwdThreads, smem,
                                    stream>>>(qp, kp, vp, lse, delta, dop, static_cast<T*>(dk),
                                              static_cast<T*>(dv), hq, hkv, sq, skv, scale,
                                              causal, window);
  return cudaGetLastError();
}

// ---- bf16: the tensor-core kernels ------------------------------------------------

constexpr int kWgRowsB = 64;    // rows per consumer warpgroup (wgmma M)
constexpr int kTileB = 64;      // rows of a streamed tile (wgmma N of S, K of the rs products)
constexpr int kStagesB = 3;     // ring depth
constexpr int kPiece64 = kTileB * 128;  // one (64 rows x 64 columns) bf16 piece, bytes

// thread 0: one stage of the ring: 64 rows of two (rows, D) tensors as D /
// 64 128-byte swizzled (64 x 64) pieces each, from maps ta and tb at (64 p,
// row, head), then, with a vector map, the 64 floats at va0 and at vb0, all
// counted on the stage's barrier
template <int P>
__device__ __forceinline__ void load_pair(uint8_t* st, uint64_t* bar, const CUtensorMap* ta,
                                          const CUtensorMap* tb, int row, int head,
                                          const CUtensorMap* vec_map, int va0, int vb0,
                                          uint32_t bytes) {
  hopper::mbar_arrive_expect_tx(bar, bytes);
#pragma unroll
  for (int p = 0; p < P; ++p) {
    hopper::tma_load_3d(st + p * kPiece64, ta, bar, 64 * p, row, head);
    hopper::tma_load_3d(st + (P + p) * kPiece64, tb, bar, 64 * p, row, head);
  }
  if (vec_map != nullptr) {
    float* vec = reinterpret_cast<float*>(st + 2 * P * kPiece64);
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
// in registers, B (64 rows x D) from MN-major pieces at ``b``: one k16 step
// 16 rows = 2048 bytes further down
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
// each D / 64 pieces of (64 WG rows x 64 columns); then kStagesB stages of
// Q and dO (D / 64 pieces of 64 rows each) and the tile's lse and D (64
// floats each), a stage rounded to 1024 bytes; then the mbarriers (K and V,
// then one per stage).
template <int D, int WG>
struct DkdvSmem {
  static constexpr int kPieces = D / 64;
  static constexpr int kKVPiece = WG * kWgRowsB * 128;
  static constexpr int kKV = 2 * kPieces * kKVPiece;
  static constexpr int kStageTx = 2 * kPieces * kPiece64 + 2 * kTileB * 4;
  static constexpr int kStage = (kStageTx + 1023) / 1024 * 1024;
  static constexpr int kBars = kKV + kStagesB * kStage;
  static constexpr size_t kBytes = kBars + 8 * (1 + kStagesB) + 1024;  // + alignment
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

template <int D, int WG>
__global__ void __launch_bounds__(128 * WG, 1)
    flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                                const __grid_constant__ CUtensorMap tk,
                                const __grid_constant__ CUtensorMap tv,
                                const __grid_constant__ CUtensorMap tdo,
                                const __grid_constant__ CUtensorMap tstats,
                                bf16* __restrict__ dk, bf16* __restrict__ dv, int hq, int hkv,
                                int sq, int skv, int sq_pad, int bhq, float scale,
                                float scale_log2, int causal, int window) {
  using S = DkdvSmem<D, WG>;
  constexpr int P = S::kPieces;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  const uint8_t* ks = smem;
  const uint8_t* vs = smem + P * S::kKVPiece;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + S::kBars);

  const int j0 = blockIdx.x * WG * kWgRowsB;
  const int bkv = blockIdx.z * hkv + blockIdx.y;
  const int rep = hq / hkv;
  const int bq0 = blockIdx.z * hq + blockIdx.y * rep;
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;

  // the CTA streams the q tiles any of its kv rows below skv can see; each
  // warpgroup computes on those its own 64 rows can see
  const int r_wg = j0 + wg * kWgRowsB;
  const bool wg_rows = r_wg < skv;
  int lo, hi, my_lo, my_hi;
  q_tiles(j0, min(j0 + WG * kWgRowsB, skv), sq, causal, window, lo, hi);
  q_tiles(r_wg, min(r_wg + kWgRowsB, skv), sq, causal, window, my_lo, my_hi);
  const int per_head = hi - lo + 1;
  const int n_tiles = rep * per_head;

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 1 + kStagesB; ++i) hopper::mbar_init(&bars[i], 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  auto load_tile_n = [&](int n) {
    const int bq = bq0 + n / per_head;
    const int i0 = (lo + n % per_head) * kTileB;
    load_pair<P>(smem + S::kKV + (n % kStagesB) * S::kStage, &bars[1 + n % kStagesB], &tq,
                 &tdo, i0, bq, &tstats, bq * sq_pad + i0, (bhq + bq) * sq_pad + i0,
                 S::kStageTx);
  };
  if (tid == 0) {
    hopper::mbar_arrive_expect_tx(&bars[0], S::kKV);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      hopper::tma_load_3d(smem + p * S::kKVPiece, &tk, &bars[0], 64 * p, j0, bkv);
      hopper::tma_load_3d(smem + (P + p) * S::kKVPiece, &tv, &bars[0], 64 * p, j0, bkv);
    }
    for (int n = 0; n < kStagesB - 1 && n < n_tiles; ++n) load_tile_n(n);
  }
  __syncwarp();

  // accumulator fragment (i, c, e) of register 4c + 2i + e: row (kv)
  // 16 warp + lane / 4 + 8i of the warpgroup's 64, column (q or d)
  // 8c + 2 (lane % 4) + e
  float dv_acc[P][32], dk_acc[P][32];
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int r = 0; r < 32; ++r) dv_acc[p][r] = dk_acc[p][r] = 0.0f;
  const int row0 = r_wg + warp * 16 + lane / 4;
  const int col0 = 2 * (lane % 4);
  hopper::mbar_wait(&bars[0], 0);

  for (int n = 0; n < n_tiles; ++n) {
    // the stage tile n + kStagesB - 1 goes into held tile n - 1, which every
    // thread finished with before the barrier that closed the last iteration
    if (tid == 0 && n + kStagesB - 1 < n_tiles) load_tile_n(n + kStagesB - 1);
    __syncwarp();
    hopper::mbar_wait(&bars[1 + n % kStagesB], (n / kStagesB) & 1);
    const int it = lo + n % per_head;
    if (wg_rows && it >= my_lo && it <= my_hi) {
      const uint8_t* qs = smem + S::kKV + (n % kStagesB) * S::kStage;
      const uint8_t* dos = qs + P * kPiece64;
      const float* lse2_s = reinterpret_cast<const float*>(qs + 2 * P * kPiece64);
      const float* delta_s = lse2_s + kTileB;

      // S^T = K Q^T and dP^T = V dO^T, both in flight at once
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

      // P^T and dS^T in place; a tile inside the band of all 64 kv rows of
      // the warpgroup needs no mask
      const int i0 = it * kTileB;
      const bool inside = i0 + kTileB <= sq && (!causal || r_wg + kWgRowsB - 1 <= i0) &&
                          (window <= 0 || i0 + kTileB - 1 < r_wg + window);
#pragma unroll
      for (int c = 0; c < 8; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * c + col0 + e;
          const float l2 = lse2_s[col];
          const float dl = delta_s[col];
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
            const float p = keep ? ex2(fmaf(sacc[r], scale_log2, -l2)) : 0.0f;
            sacc[r] = p;
            pacc[r] = p * (pacc[r] - dl);
          }
        }
      // dV += P^T dO and dK += dS^T Q
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
    __syncthreads();  // every warpgroup is done with this stage
  }

  if (!wg_rows) return;
  bf16* dkb = dk + static_cast<int64_t>(bkv) * skv * D;
  bf16* dvb = dv + static_cast<int64_t>(bkv) * skv * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= skv) continue;
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int64_t at = static_cast<int64_t>(row) * D + 64 * p + 8 * c + col0;
        *reinterpret_cast<__nv_bfloat162*>(dkb + at) = __floats2bfloat162_rn(
            dk_acc[p][4 * c + 2 * i] * scale, dk_acc[p][4 * c + 2 * i + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dvb + at) =
            __floats2bfloat162_rn(dv_acc[p][4 * c + 2 * i], dv_acc[p][4 * c + 2 * i + 1]);
      }
  }
}

constexpr int kDqRows = 2 * kWgRowsB;  // q rows of a dQ CTA

// Shared memory of a dQ CTA, bytes from a 1024-aligned base: Q then dO, each
// D / 64 pieces of (128 rows x 64 columns); kStagesB stages of K and V (D /
// 64 pieces of 64 rows each); lse log2 e and D of the CTA's rows; the
// mbarriers (Q and dO, then one per stage).
template <int D>
struct DqSmem {
  static constexpr int kPieces = D / 64;
  static constexpr int kQPiece = kDqRows * 128;
  static constexpr int kQ = 2 * kPieces * kQPiece;
  static constexpr int kStage = 2 * kPieces * kPiece64;
  static constexpr int kStats = kQ + kStagesB * kStage;
  static constexpr int kBars = kStats + 2 * kDqRows * 4;
  static constexpr size_t kBytes = kBars + 8 * (1 + kStagesB) + 1024;  // + alignment
};

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
__global__ void __launch_bounds__(2 * 128, 1)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap tdo,
                              const bf16* __restrict__ o, const bf16* __restrict__ dout,
                              const float* __restrict__ lse, bf16* __restrict__ dq,
                              float* __restrict__ stats, int hq, int hkv, int sq, int skv,
                              int sq_pad, int bhq, float scale, float scale_log2, int causal,
                              int window) {
  using S = DqSmem<D>;
  constexpr int P = S::kPieces;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  const uint8_t* qs = smem;
  const uint8_t* dos = smem + P * S::kQPiece;
  float* lse2_s = reinterpret_cast<float*>(smem + S::kStats);
  float* delta_s = lse2_s + kDqRows;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + S::kBars);

  // the last (under a causal mask, the heaviest) q tiles first
  const int i0 = (gridDim.x - 1 - blockIdx.x) * kDqRows;
  const int bq = blockIdx.z * hq + blockIdx.y;
  const int bkv = blockIdx.z * hkv + blockIdx.y / (hq / hkv);
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;

  const int r_wg = i0 + wg * kWgRowsB;
  const bool wg_rows = r_wg < sq;
  int lo, hi, my_lo, my_hi;
  kv_tiles_b(i0, min(i0 + kDqRows, sq), skv, causal, window, lo, hi);
  kv_tiles_b(r_wg, min(r_wg + kWgRowsB, sq), skv, causal, window, my_lo, my_hi);
  const int n_tiles = hi - lo + 1;

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 1 + kStagesB; ++i) hopper::mbar_init(&bars[i], 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  auto load_kv_n = [&](int n) {
    load_pair<P>(smem + S::kQ + (n % kStagesB) * S::kStage, &bars[1 + n % kStagesB], &tk, &tv,
                 (lo + n) * kTileB, bkv, nullptr, 0, 0, S::kStage);
  };
  if (tid == 0) {
    hopper::mbar_arrive_expect_tx(&bars[0], S::kQ);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      hopper::tma_load_3d(smem + p * S::kQPiece, &tq, &bars[0], 64 * p, i0, bq);
      hopper::tma_load_3d(smem + (P + p) * S::kQPiece, &tdo, &bars[0], 64 * p, i0, bq);
    }
    for (int n = 0; n < kStagesB - 1 && n < n_tiles; ++n) load_kv_n(n);
  }
  __syncwarp();

  // D = rowsum(dO o) of the CTA's 128 rows: two threads a row, each half the
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
    if (tid == 0 && n + kStagesB - 1 < n_tiles) load_kv_n(n + kStagesB - 1);
    __syncwarp();
    hopper::mbar_wait(&bars[1 + n % kStagesB], (n / kStagesB) & 1);
    const int jt = lo + n;
    if (wg_rows && jt >= my_lo && jt <= my_hi) {
      const uint8_t* ks = smem + S::kQ + (n % kStagesB) * S::kStage;
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
    __syncthreads();  // both warpgroups are done with this stage
  }

  if (!wg_rows) return;
  bf16* dqb = dq + static_cast<int64_t>(bq) * sq * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= sq) continue;
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int c = 0; c < 8; ++c)
        *reinterpret_cast<__nv_bfloat162*>(dqb + static_cast<int64_t>(row) * D + 64 * p +
                                           8 * c + col0) =
            __floats2bfloat162_rn(dq_acc[p][4 * c + 2 * i] * scale,
                                  dq_acc[p][4 * c + 2 * i + 1] * scale);
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// dK/dV CTAs of one warpgroup (64 kv rows) at D 64 and two (128) at D 128:
// the faster at the training inputs (PERF.md row 5b)
template <int D>
cudaError_t launch_bwd_wgmma(const void* q, const void* k, const void* v, const void* o,
                             const float* lse, const void* dout, void* dq, void* dk, void* dv,
                             float* stats, int batch, int hq, int hkv, int sq, int skv,
                             float scale, int causal, int window, cudaStream_t stream) {
  constexpr int WG = D == 64 ? 1 : 2;
  CUtensorMap tq_dq, tdo_dq, tkv_k, tkv_v, tq, tdo, tk, tv, tstats;
  const int sq_pad = (sq + kTileB - 1) / kTileB * kTileB;
  const int bhq = batch * hq;
  if (!make_map(&tq_dq, q, batch * hq, sq, D, kDqRows) ||
      !make_map(&tdo_dq, dout, batch * hq, sq, D, kDqRows) ||
      !make_map(&tkv_k, k, batch * hkv, skv, D, kTileB) ||
      !make_map(&tkv_v, v, batch * hkv, skv, D, kTileB) ||
      !make_map(&tq, q, batch * hq, sq, D, kTileB) ||
      !make_map(&tdo, dout, batch * hq, sq, D, kTileB) ||
      !make_map(&tk, k, batch * hkv, skv, D, WG * kWgRowsB) ||
      !make_map(&tv, v, batch * hkv, skv, D, WG * kWgRowsB) ||
      !make_map_1d(&tstats, stats, 2 * static_cast<int64_t>(bhq) * sq_pad, kTileB))
    return cudaErrorInvalidValue;
  cudaError_t err;
  if ((err = allow_smem(flash_bwd_dq_wgmma_kernel<D>, DqSmem<D>::kBytes)) != cudaSuccess)
    return err;
  if ((err = allow_smem(flash_bwd_dkdv_wgmma_kernel<D, WG>, DkdvSmem<D, WG>::kBytes)) !=
      cudaSuccess)
    return err;
  const float scale_log2 = scale * kLog2eBwd;
  flash_bwd_dq_wgmma_kernel<D>
      <<<dim3((sq + kDqRows - 1) / kDqRows, hq, batch), 2 * 128, DqSmem<D>::kBytes, stream>>>(
          tq_dq, tkv_k, tkv_v, tdo_dq, static_cast<const bf16*>(o),
          static_cast<const bf16*>(dout), lse, static_cast<bf16*>(dq), stats, hq, hkv, sq, skv,
          sq_pad, bhq, scale, scale_log2, causal, window);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int kv_rows = WG * kWgRowsB;
  flash_bwd_dkdv_wgmma_kernel<D, WG>
      <<<dim3((skv + kv_rows - 1) / kv_rows, hkv, batch), 128 * WG, DkdvSmem<D, WG>::kBytes,
         stream>>>(tq, tk, tv, tdo, tstats, static_cast<bf16*>(dk), static_cast<bf16*>(dv), hq,
                   hkv, sq, skv, sq_pad, bhq, scale, scale_log2, causal, window);
  return cudaGetLastError();
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
    return launch_bwd_scalar<bf16, 256, 32>(q, k, v, o, l, dout, dq, dk, dv, dl, batch, hq,
                                            hkv, sq, skv, scale, causal, window, st);
  if (dtype == kDtypeF32 && head_dim == 16)
    return launch_bwd_scalar<float, 16, 64>(q, k, v, o, l, dout, dq, dk, dv, dl, batch, hq,
                                            hkv, sq, skv, scale, causal, window, st);
  if (dtype == kDtypeF32 && head_dim == 64)
    return launch_bwd_scalar<float, 64, 64>(q, k, v, o, l, dout, dq, dk, dv, dl, batch, hq,
                                            hkv, sq, skv, scale, causal, window, st);
  if (dtype == kDtypeF32 && head_dim == 128)
    return launch_bwd_scalar<float, 128, 64>(q, k, v, o, l, dout, dq, dk, dv, dl, batch, hq,
                                             hkv, sq, skv, scale, causal, window, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_attn_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
