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
// equal:
//   1. flash_bwd_dq_kernel, one CTA per (b, q head, 64 q rows): D of its
//      rows in a prologue (written out for kernel 2), then every kv tile the
//      mask admits (the forward's kv_tiles), dQ accumulated in registers.
//   2. flash_bwd_dkdv_kernel, one CTA per (b, kv head, 64 kv rows): the
//      group's Hq / Hkv q heads in head order and, for each, the q tiles the
//      mask admits (rows from the tile's first key when causal, to its last
//      key + window - 1 with a window); dK and dV accumulated in registers,
//      so a kv head's gradient is the sum over its q heads with no second
//      pass and no scatter.
// Scores, P, dS and every sum are f32 (bf16 inputs are widened on load);
// the gradients are stored once in the inputs' dtype.
//
// What bounds it on the H100: operations.  At internlm2-1.8b's training
// shape (B 2, 16 q over 8 kv heads, S 4096, d 128, causal) the masks keep
// 8.39M (q, k) pairs per head and the two kernels do seven 2 d-flop products
// per pair (S and dO V^T twice, dV, dK, dQ): 481 GFLOP, 0.49 ms at the bf16
// tensor cores' 989 TFLOP/s, against 0.13 GB of q, k, v, o, dO and the
// gradients (40 us at 3.35 TB/s).  This first version is simple and right:
// 256 threads, (64, D) tiles widened to f32 in shared memory (rows padded by
// one word, so reads down a column hit 32 banks), each thread a 4 x 4 tile
// of the (64, 64) products and 4 x D/16 of the (64, D) ones, all f32 FMAs
// (the f32 rate, 67 TFLOP/s, not the tensor cores: wgmma and TMA are later
// work).
#include <cuda_runtime.h>

#include <cstdint>

#include "../../csrc/float_io.cuh"

namespace repro_torch {

constexpr int kBT = 64;           // rows of a q tile and of a kv tile
constexpr int kBwdThreads = 256;  // thread (tr, tc): rows 4tr.., columns tc + 16j
constexpr float kLog2eBwd = 1.4426950408889634f;

template <int D>
struct BwdSmem {
  static constexpr int kS = D + 1;    // row stride of the (64, D) tiles
  static constexpr int kP = kBT + 1;  // row stride of P and dS
  // Q, dO, K, V (the dQ kernel's O while it forms D), then P, dS, then the
  // q tile's lse and D
  static constexpr size_t kBytes = sizeof(float) * (4 * kBT * kS + 2 * kBT * kP + 2 * kBT);
};

__device__ __forceinline__ bool seen(int row, int col, int skv, int causal, int window) {
  bool keep = col < skv;
  if (causal) keep = keep && col <= row;
  if (window > 0) keep = keep && col > row - window;
  return keep;
}

// P and dS of q rows [i0, i0 + 64) against kv rows [j0, j0 + 64) into ps and
// dss: S = Q K^T and dP = dO V^T by one pass over d, then P = exp(scale S -
// lse) where the key is seen (0 elsewhere, and on rows >= sq) and
// dS = P (dP - D)
template <int D>
__device__ __forceinline__ void p_and_ds(const float* qs, const float* dos, const float* ks,
                                         const float* vs, const float* lse_s,
                                         const float* delta_s, float* ps, float* dss, int i0,
                                         int j0, int sq, int skv, float scale, int causal,
                                         int window) {
  using S = BwdSmem<D>;
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[a][c] = dp[a][c] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qa[4], oa[4], kc[4], vc[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      qa[a] = qs[(4 * tr + a) * S::kS + d];
      oa[a] = dos[(4 * tr + a) * S::kS + d];
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      kc[c] = ks[(tc + 16 * c) * S::kS + d];
      vc[c] = vs[(tc + 16 * c) * S::kS + d];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[a][c] = fmaf(qa[a], kc[c], s[a][c]);
        dp[a][c] = fmaf(oa[a], vc[c], dp[a][c]);
      }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = 4 * tr + a;
    const int row = i0 + r;
    const float l2 = lse_s[r] * kLog2eBwd;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = j0 + tc + 16 * c;
      const float p = (row < sq && seen(row, col, skv, causal, window))
                          ? ex2(s[a][c] * scale * kLog2eBwd - l2)
                          : 0.0f;
      ps[r * S::kP + tc + 16 * c] = p;
      dss[r * S::kP + tc + 16 * c] = p * (dp[a][c] - delta_s[r]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kBwdThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ o,
                        const float* __restrict__ lse, const T* __restrict__ dout,
                        T* __restrict__ dq, float* __restrict__ delta, int hq, int hkv,
                        int sq, int skv, float scale, int causal, int window) {
  using S = BwdSmem<D>;
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

  const int i0 = blockIdx.x * kBT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int64_t bq = static_cast<int64_t>(b) * hq + h;
  const T* kb = k + (static_cast<int64_t>(b) * hkv + hk) * skv * D;
  const T* vb = v + (static_cast<int64_t>(b) * hkv + hk) * skv * D;
  const int tid = threadIdx.x;

  load_tile<T, D>(qs, S::kS, q + bq * sq * D, i0, kBT, sq);
  load_tile<T, D>(dos, S::kS, dout + bq * sq * D, i0, kBT, sq);
  load_tile<T, D>(ks, S::kS, o + bq * sq * D, i0, kBT, sq);  // O, for D only
  if (tid < kBT) lse_s[tid] = i0 + tid < sq ? lse[bq * sq + i0 + tid] : 0.0f;
  __syncthreads();
  // D = rowsum(dO O): four threads a row, each a quarter of the columns
  {
    const int r = tid / 4, part = tid % 4;
    float acc = 0.0f;
    for (int d = part; d < D; d += 4) acc = fmaf(dos[r * S::kS + d], ks[r * S::kS + d], acc);
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (part == 0) {
      delta_s[r] = acc;
      if (i0 + r < sq) delta[bq * sq + i0 + r] = acc;
    }
  }

  const int tr = tid / 16, tc = tid % 16;
  float acc[4][kCols];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[a][c] = 0.0f;

  // the kv tiles [lo, hi] rows [i0, i0 + 64) can see (flash_attn.cu kv_tiles)
  int last_col = skv - 1;
  if (causal) last_col = min(last_col, i0 + kBT - 1);
  const int hi = last_col >= 0 ? last_col / kBT : -1;
  const int lo = window > 0 ? max(0, i0 - window + 1) / kBT : 0;
  for (int jt = lo; jt <= hi; ++jt) {
    const int j0 = jt * kBT;
    __syncthreads();  // the last tile's K, V, P and dS are read
    load_tile<T, D>(ks, S::kS, kb, j0, kBT, skv);
    load_tile<T, D>(vs, S::kS, vb, j0, kBT, skv);
    __syncthreads();
    p_and_ds<D>(qs, dos, ks, vs, lse_s, delta_s, ps, dss, i0, j0, sq, skv, scale, causal,
                window);
    __syncthreads();
    // dQ[r][c] += sum_j dS[r][j] K[j][c]
#pragma unroll 4
    for (int j = 0; j < kBT; ++j) {
      float sa[4], kc[kCols];
#pragma unroll
      for (int a = 0; a < 4; ++a) sa[a] = dss[(4 * tr + a) * S::kP + j];
#pragma unroll
      for (int c = 0; c < kCols; ++c) kc[c] = ks[j * S::kS + tc + 16 * c];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[a][c] = fmaf(sa[a], kc[c], acc[a][c]);
    }
  }
  T* out = dq + bq * sq * D;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = i0 + 4 * tr + a;
    if (row >= sq) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      out[static_cast<int64_t>(row) * D + tc + 16 * c] = from_f32<T>(acc[a][c] * scale);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kBwdThreads)
    flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const float* __restrict__ lse,
                          const float* __restrict__ delta, const T* __restrict__ dout,
                          T* __restrict__ dk, T* __restrict__ dv, int hq, int hkv, int sq,
                          int skv, float scale, int causal, int window) {
  using S = BwdSmem<D>;
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

  load_tile<T, D>(ks, S::kS, k + bkv * skv * D, j0, kBT, skv);
  load_tile<T, D>(vs, S::kS, v + bkv * skv * D, j0, kBT, skv);

  // the q rows that see any key of [j0, j0 + 64): from j0 when causal, to
  // the last key + window - 1 with a window
  const int r_lo = causal ? j0 : 0;
  const int r_hi = window > 0 ? min(sq - 1, j0 + kBT - 1 + window - 1) : sq - 1;
  const int it_lo = r_lo / kBT, it_hi = r_hi >= r_lo ? r_hi / kBT : -1;

  float dk_acc[4][kCols], dv_acc[4][kCols];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dk_acc[a][c] = dv_acc[a][c] = 0.0f;

  for (int hh = 0; hh < rep; ++hh) {
    const int64_t bq = static_cast<int64_t>(b) * hq + hk * rep + hh;
    for (int it = it_lo; it <= it_hi; ++it) {
      const int i0 = it * kBT;
      __syncthreads();  // the last tile's Q, dO, P and dS are read
      load_tile<T, D>(qs, S::kS, q + bq * sq * D, i0, kBT, sq);
      load_tile<T, D>(dos, S::kS, dout + bq * sq * D, i0, kBT, sq);
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
        float pa[4], sa[4], oc[kCols], qc[kCols];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          pa[a] = ps[r * S::kP + 4 * tr + a];
          sa[a] = dss[r * S::kP + 4 * tr + a];
        }
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          oc[c] = dos[r * S::kS + tc + 16 * c];
          qc[c] = qs[r * S::kS + tc + 16 * c];
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
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
  for (int a = 0; a < 4; ++a) {
    const int row = j0 + 4 * tr + a;
    if (row >= skv) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int64_t at = static_cast<int64_t>(row) * D + tc + 16 * c;
      dkb[at] = from_f32<T>(dk_acc[a][c] * scale);
      dvb[at] = from_f32<T>(dv_acc[a][c]);
    }
  }
}

template <typename T, int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* o,
                       const float* lse, const void* dout, void* dq, void* dk, void* dv,
                       float* delta, int batch, int hq, int hkv, int sq, int skv, float scale,
                       int causal, int window, cudaStream_t stream) {
  const size_t smem = BwdSmem<D>::kBytes;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(smem))) != cudaSuccess)
    return err;
  if ((err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, D>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(smem))) != cudaSuccess)
    return err;
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dop = static_cast<const T*>(dout);
  flash_bwd_dq_kernel<T, D><<<dim3((sq + kBT - 1) / kBT, hq, batch), kBwdThreads, smem, stream>>>(
      qp, kp, vp, static_cast<const T*>(o), lse, dop, static_cast<T*>(dq), delta, hq, hkv, sq,
      skv, scale, causal, window);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  flash_bwd_dkdv_kernel<T, D><<<dim3((skv + kBT - 1) / kBT, hkv, batch), kBwdThreads, smem,
                                stream>>>(qp, kp, vp, lse, delta, dop, static_cast<T*>(dk),
                                          static_cast<T*>(dv), hq, hkv, sq, skv, scale, causal,
                                          window);
  return cudaGetLastError();
}

}  // namespace repro_torch

// q, o, dout, dq (B, Hq, Sq, D); k, v, dk, dv (B, Hkv, Skv, D): contiguous,
// one dtype (code 0 f32, 3 bf16), D 64 or 128, Hq a multiple of Hkv; lse (the
// forward's) and delta (scratch, written here) (B, Hq, Sq) f32.
extern "C" int flash_attn_bwd_launch(const void* q, const void* k, const void* v,
                                     const void* o, const void* lse, const void* dout,
                                     void* dq, void* dk, void* dv, void* delta, int dtype,
                                     int batch, int hq, int hkv, int sq, int skv,
                                     int head_dim, float scale, int causal, int window,
                                     void* stream) {
  using namespace repro_torch;
  if (batch <= 0 || hq <= 0 || sq <= 0 || skv <= 0) return static_cast<int>(cudaGetLastError());
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* l = static_cast<const float*>(lse);
  auto* dl = static_cast<float*>(delta);
  if (dtype == kDtypeBF16 && head_dim == 64)
    return launch_bwd<bf16, 64>(q, k, v, o, l, dout, dq, dk, dv, dl, batch, hq, hkv, sq, skv,
                                scale, causal, window, st);
  if (dtype == kDtypeBF16 && head_dim == 128)
    return launch_bwd<bf16, 128>(q, k, v, o, l, dout, dq, dk, dv, dl, batch, hq, hkv, sq, skv,
                                 scale, causal, window, st);
  if (dtype == kDtypeF32 && head_dim == 64)
    return launch_bwd<float, 64>(q, k, v, o, l, dout, dq, dk, dv, dl, batch, hq, hkv, sq, skv,
                                 scale, causal, window, st);
  if (dtype == kDtypeF32 && head_dim == 128)
    return launch_bwd<float, 128>(q, k, v, o, l, dout, dq, dk, dv, dl, batch, hq, hkv, sq,
                                  skv, scale, causal, window, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_attn_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
