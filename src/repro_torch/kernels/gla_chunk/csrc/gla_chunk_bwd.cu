// gla_chunk_bwd: the gradients of chunked gated linear attention
// (S_t = diag(e^{g_t}) S_{t-1} + k_t v_t^T, o_t = S_t^T q_t, g clamped to
// [-8, 0]), CUDA C++ for sm_90a.
//
// The backward of gla_chunk.cu's forward.  The reference differentiates its
// XLA chunked form (src/repro/models/linear_attn.py gla_chunked_xla) with
// jax.value_and_grad and has no Pallas backward; the port's forward is the
// hand-written kernel that replaces src/repro/kernels/gla_chunk/kernel.py
// gla_chunked_kernel, so its gradient is a kernel too.  The math per chunk
// of 64 steps, with L the clamped cumulative decay (every exponent <= 0, as
// in the forward), S0 the state before the chunk (the forward scan's
// scratch, kept by the caller) and dH the gradient of the state after it:
//
//   dH_{c-1} = e^{L_C} dH_c + (q e^L)^T dO          (dH of the last: dstate)
//   B_ij = dO_i . v_j,  A_ij = sum_x q_ix k_jx e^{L_ix - L_jx}   (j <= i)
//   dq_i = e^{L_i} (S0 dO_i) + sum_{j<=i} B_ij e^{L_i - L_j} k_j
//   dk_j = sum_{i>=j} B_ij e^{L_i - L_j} q_i + e^{L_C - L_j} (dH v_j)
//   dv_j = sum_{i>=j} A_ij dO_i + (k_j e^{L_C - L_j})^T dH
//   dg_t = (sum_{s>=t} q_s dq_s - k_s dk_s + <S_T, dstate>) d clamp / dg
//
// with d clamp / dg the reference's jnp.clip gradient: 1 inside (-8, 0), 0
// outside, 0.5 on either bound (max and min split ties).  Four kernels on
// one stream, no atomics, so two launches are bitwise equal:
//   1. gla_bwd_contrib_kernel, grid (chunks, B*H): L, the chunk's
//      contribution (q e^L)^T dO and its decay e^{L_C}, to f32 scratch.
//   2. gla_bwd_scan_kernel, one thread per (b*h, x, y): walks the chunks
//      from the last, from dstate (zero when null), overwriting each
//      contribution with dH of that chunk.
//   3. gla_bwd_chunk_kernel, grid (chunks, B*H): B and A by 4 x 4 register
//      tiles, then dq, dk (the same (t, x) items, so q dq - k dk is formed in
//      registers) and dv; the within-chunk reverse sums of q dq - k dk and
//      the chunk's total go to f32 scratch.
//   4. gla_bwd_dg_kernel, grid (chunks, B*H): each chunk's suffix (the
//      dstate term, then every later chunk's total, last first), added to
//      the within-chunk sums and masked by the clamp's gradient.
// Steps past T read as zero q, k, v, dO and zero decay, as in the forward.
// Every product and sum is f32; the gradients are stored once in the inputs'
// dtypes.  The time index runs across a warp's lanes wherever a loop walks
// the other axis, so the (d, chunk) operands are stored transposed and the
// (chunk, d) ones by rows with one word of padding: every read is one bank
// per lane or a broadcast.
//
// What bounds it on the H100: bytes.  At hymba-1.5b's training shape (B 2,
// 25 heads, T 2048, dk 16, dv 64, bf16) a call reads q, k, g, v, dO and the
// chunk-start states and writes four gradients: 46 MB, 14 us at 3.35 TB/s,
// against ~2 GFLOP of f32 FMA and 0.2G exps.  This first version is simple
// and right; it makes the C^2 dk exps of the dif form (the forward's
// sub-block re-basing is later work).
#include <cuda_runtime.h>

#include <cstdint>

#include "../../csrc/float_io.cuh"
#include "../../csrc/gla_tiles.cuh"

namespace repro_torch {

constexpr int kRP = kChunk + 1;  // row stride of the (chunk, chunk) buffers

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <int DK, int DV>
struct ContribSmem {
  static constexpr int kQS = DK + 4;  // row stride of q, then q e^L
  static constexpr size_t kBytes = sizeof(float) * (DK * kTS + kChunk * kQS + kChunk * DV);
};

template <typename T, int DK, int DV>
__global__ void __launch_bounds__(kGlaThreads)
    gla_bwd_contrib_kernel(const T* __restrict__ q, const T* __restrict__ g,
                           const T* __restrict__ dout, float* __restrict__ dh,
                           float* __restrict__ decay, int t_len) {
  constexpr int QS = ContribSmem<DK, DV>::kQS;
  extern __shared__ float smem[];
  float* LT = smem;
  float* qe = LT + DK * kTS;
  float* dos = qe + kChunk * QS;
  const int c = blockIdx.x;
  const int64_t bh = blockIdx.y;
  const int64_t slot = bh * gridDim.x + c;
  const int t0 = c * kChunk;
  const int tid = threadIdx.x;

  load_tile<T, DK>(qe, QS, q + bh * t_len * DK, t0, kChunk, t_len);
  load_tile_t<T, DK>(LT, g + bh * t_len * DK, t0, t_len);
  load_tile<T, DV>(dos, DV, dout + bh * t_len * DV, t0, kChunk, t_len);
  __syncthreads();
  cumsum_decay<DK>(LT);
  __syncthreads();
  for (int idx = tid; idx < DK * kChunk; idx += kGlaThreads) {
    const int x = idx / kChunk, r = idx % kChunk;
    qe[r * QS + x] *= exp_le0(LT[x * kTS + r]);
  }
  if (tid < DK) decay[slot * DK + tid] = exp_le0(LT[tid * kTS + kChunk - 1]);
  __syncthreads();

  // (q e^L)^T dO by 4 x 4 tiles, one per thread (the first DK DV / 16)
  const int xb = tid / (DV / 4), yb = tid % (DV / 4);
  if (xb >= DK / 4) return;
  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[a][e] = 0.0f;
#pragma unroll 4
  for (int j = 0; j < kChunk; ++j) {
    const float4 qv = *reinterpret_cast<const float4*>(qe + j * QS + 4 * xb);
    const float4 w = *reinterpret_cast<const float4*>(dos + j * DV + 4 * yb);
    const float qr[4] = {qv.x, qv.y, qv.z, qv.w}, wr[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][e] = fmaf(qr[a], wr[e], acc[a][e]);
  }
  float* out = dh + slot * DK * DV;
#pragma unroll
  for (int a = 0; a < 4; ++a)
    *reinterpret_cast<float4*>(out + (4 * xb + a) * DV + 4 * yb) =
        make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
}

template <int DK, int DV>
__global__ void __launch_bounds__(kGlaThreads)
    gla_bwd_scan_kernel(float* __restrict__ dh, const float* __restrict__ decay,
                        const float* __restrict__ dstate, int bh_total, int nchunks) {
  constexpr int kElems = DK * DV;
  const int64_t gid = static_cast<int64_t>(blockIdx.x) * kGlaThreads + threadIdx.x;
  if (gid >= static_cast<int64_t>(bh_total) * kElems) return;
  const int64_t bh = gid / kElems;
  const int e = static_cast<int>(gid % kElems);
  float* d = dh + bh * nchunks * kElems + e;
  const float* f = decay + bh * nchunks * DK + e / DV;
  float s = dstate != nullptr ? dstate[gid] : 0.0f;
  for (int c0 = nchunks - 1; c0 >= 0; c0 -= kScanBatch) {
    float contrib[kScanBatch], dec[kScanBatch];
#pragma unroll
    for (int u = 0; u < kScanBatch; ++u) {
      if (c0 - u >= 0) {
        contrib[u] = d[static_cast<int64_t>(c0 - u) * kElems];
        dec[u] = f[static_cast<int64_t>(c0 - u) * DK];
      }
    }
#pragma unroll
    for (int u = 0; u < kScanBatch; ++u) {
      if (c0 - u >= 0) {
        d[static_cast<int64_t>(c0 - u) * kElems] = s;  // dH after chunk c
        s = fmaf(s, dec[u], contrib[u]);
      }
    }
  }
}

template <int DK, int DV>
struct ChunkSmem {
  // q, k, L and e^{L_C - L} transposed (DK, kTS); dO and v by rows (64, DV+1);
  // B and A (64, 65); S0 and dH (DK, DV); q dq - k dk transposed
  static constexpr size_t kBytes = sizeof(float) * (4 * DK * kTS + 2 * kChunk * (DV + 1) +
                                                    2 * kChunk * kRP + 2 * DK * DV + DK * kTS);
};

template <typename T, int DK, int DV>
__global__ void __launch_bounds__(kGlaThreads)
    gla_bwd_chunk_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ g,
                         const T* __restrict__ dout, const float* __restrict__ states,
                         const float* __restrict__ dh, T* __restrict__ dq, T* __restrict__ dk,
                         T* __restrict__ dv, float* __restrict__ rsum,
                         float* __restrict__ total, int t_len) {
  static_assert(DV == 64, "dv items map 64 steps x 4 columns per round onto 256 threads");
  constexpr int VS = DV + 1;
  extern __shared__ float smem[];
  float* qT = smem;
  float* kT = qT + DK * kTS;
  float* LT = kT + DK * kTS;
  float* ET = LT + DK * kTS;  // e^{L_C - L}
  float* dos = ET + DK * kTS;
  float* vs = dos + kChunk * VS;
  float* Bm = vs + kChunk * VS;
  float* Am = Bm + kChunk * kRP;
  float* S0 = Am + kChunk * kRP;
  float* dH = S0 + DK * DV;
  float* rT = dH + DK * DV;
  const int c = blockIdx.x;
  const int64_t bh = blockIdx.y;
  const int64_t slot = bh * gridDim.x + c;
  const int t0 = c * kChunk;
  const int tid = threadIdx.x;

  load_tile_t<T, DK>(qT, q + bh * t_len * DK, t0, t_len);
  load_tile_t<T, DK>(kT, k + bh * t_len * DK, t0, t_len);
  load_tile_t<T, DK>(LT, g + bh * t_len * DK, t0, t_len);
  load_tile<T, DV>(dos, VS, dout + bh * t_len * DV, t0, kChunk, t_len);
  load_tile<T, DV>(vs, VS, v + bh * t_len * DV, t0, kChunk, t_len);
  for (int i = tid; i < DK * DV; i += kGlaThreads) {
    S0[i] = states[slot * DK * DV + i];
    dH[i] = dh[slot * DK * DV + i];
  }
  __syncthreads();
  cumsum_decay<DK>(LT);
  __syncthreads();
  for (int idx = tid; idx < DK * kChunk; idx += kGlaThreads) {
    const int x = idx / kChunk, r = idx % kChunk;
    ET[x * kTS + r] = exp_le0(LT[x * kTS + kChunk - 1] - LT[x * kTS + r]);
  }

  // B and A, 4 x 4 tiles: thread (tr, tc) rows i = 4tr + a, columns
  // j = tc + 16e; zero above the diagonal
  {
    const int tr = tid / 16, tc = tid % 16;
    float bacc[4][4], aacc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int e = 0; e < 4; ++e) bacc[a][e] = aacc[a][e] = 0.0f;
#pragma unroll 4
    for (int y = 0; y < DV; ++y) {
      float oa[4], vc[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) oa[a] = dos[(4 * tr + a) * VS + y];
#pragma unroll
      for (int e = 0; e < 4; ++e) vc[e] = vs[(tc + 16 * e) * VS + y];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int e = 0; e < 4; ++e) bacc[a][e] = fmaf(oa[a], vc[e], bacc[a][e]);
    }
#pragma unroll 2
    for (int x = 0; x < DK; ++x) {
      float qa[4], la[4], kc[4], lc[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        qa[a] = qT[x * kTS + 4 * tr + a];
        la[a] = LT[x * kTS + 4 * tr + a];
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        kc[e] = kT[x * kTS + tc + 16 * e];
        lc[e] = LT[x * kTS + tc + 16 * e];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (tc + 16 * e <= 4 * tr + a)
            aacc[a][e] = fmaf(qa[a] * kc[e], exp_le0(la[a] - lc[e]), aacc[a][e]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * tr + a, j = tc + 16 * e;
        Bm[i * kRP + j] = j <= i ? bacc[a][e] : 0.0f;
        Am[i * kRP + j] = j <= i ? aacc[a][e] : 0.0f;
      }
  }
  __syncthreads();

  // dq and dk: items (t, x), t = tid % 64 across the lanes, x = tid / 64 + 4u
  const int t = tid % kChunk;
  T* dqb = dq + bh * t_len * DK;
  T* dkb = dk + bh * t_len * DK;
  for (int x = tid / kChunk; x < DK; x += kGlaThreads / kChunk) {
    const float* Lx = LT + x * kTS;
    const float* qx = qT + x * kTS;
    const float* kx = kT + x * kTS;
    const float Lt = Lx[t];
    float inter_q = 0.0f, inter_k = 0.0f;
#pragma unroll 8
    for (int y = 0; y < DV; ++y) {
      inter_q = fmaf(S0[x * DV + y], dos[t * VS + y], inter_q);
      inter_k = fmaf(dH[x * DV + y], vs[t * VS + y], inter_k);
    }
    float gq = exp_le0(Lt) * inter_q;
    float gk = ET[x * kTS + t] * inter_k;
    for (int j = 0; j <= t; ++j)  // dq_t: keys j <= t
      gq = fmaf(Bm[t * kRP + j] * exp_le0(Lt - Lx[j]), kx[j], gq);
    for (int i = t; i < kChunk; ++i)  // dk_t: queries i >= t
      gk = fmaf(Bm[i * kRP + t] * exp_le0(Lx[i] - Lt), qx[i], gk);
    rT[x * kTS + t] = qx[t] * gq - kx[t] * gk;
    if (t0 + t < t_len) {
      dqb[static_cast<int64_t>(t0 + t) * DK + x] = from_f32<T>(gq);
      dkb[static_cast<int64_t>(t0 + t) * DK + x] = from_f32<T>(gk);
    }
  }

  // dv: items (t, y), t across the lanes, y = tid / 64 + 4u
  T* dvb = dv + bh * t_len * DV;
  for (int y = tid / kChunk; y < DV; y += kGlaThreads / kChunk) {
    float acc = 0.0f;
    for (int i = t; i < kChunk; ++i) acc = fmaf(Am[i * kRP + t], dos[i * VS + y], acc);
#pragma unroll 4
    for (int x = 0; x < DK; ++x)
      acc = fmaf(kT[x * kTS + t] * ET[x * kTS + t], dH[x * DV + y], acc);
    if (t0 + t < t_len) dvb[static_cast<int64_t>(t0 + t) * DV + y] = from_f32<T>(acc);
  }
  __syncthreads();

  // within-chunk reverse sums of q dq - k dk, one thread a channel
  if (tid < DK) {
    float* rx = rT + tid * kTS;
    float acc = 0.0f;
    for (int i = kChunk - 1; i >= 0; --i) {
      acc += rx[i];
      rx[i] = acc;
    }
    total[slot * DK + tid] = acc;
  }
  __syncthreads();
  float* rs = rsum + (bh * gridDim.x + c) * kChunk * DK;
  for (int idx = tid; idx < kChunk * DK; idx += kGlaThreads)
    rs[idx] = rT[(idx % DK) * kTS + idx / DK];
}

template <typename T, int DK>
__global__ void __launch_bounds__(kGlaThreads)
    gla_bwd_dg_kernel(const T* __restrict__ g, const float* __restrict__ rsum,
                      const float* __restrict__ total, const float* __restrict__ state,
                      const float* __restrict__ dstate, T* __restrict__ dg, int dv,
                      int t_len) {
  __shared__ float suffix[DK];
  const int c = blockIdx.x;
  const int nchunks = gridDim.x;
  const int64_t bh = blockIdx.y;
  const int t0 = c * kChunk;
  const int tid = threadIdx.x;
  if (tid < DK) {
    float later = 0.0f;
    if (dstate != nullptr) {
      const float* s = state + (bh * DK + tid) * dv;
      const float* d = dstate + (bh * DK + tid) * dv;
      for (int y = 0; y < dv; ++y) later = fmaf(s[y], d[y], later);
    }
    for (int cc = nchunks - 1; cc > c; --cc) later += total[(bh * nchunks + cc) * DK + tid];
    suffix[tid] = later;
  }
  __syncthreads();
  const float* rs = rsum + (bh * nchunks + c) * kChunk * DK;
  for (int idx = tid; idx < kChunk * DK; idx += kGlaThreads) {
    const int r = idx / DK, x = idx % DK;
    if (t0 + r >= t_len) continue;
    const int64_t at = (bh * t_len + t0 + r) * DK + x;
    const float gv = to_f32(g[at]);
    const float dclamp = (gv > kGClamp && gv < 0.0f) ? 1.0f
                         : (gv == kGClamp || gv == 0.0f) ? 0.5f
                                                          : 0.0f;
    dg[at] = from_f32<T>((rs[idx] + suffix[x]) * dclamp);
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int DK, int DV>
cudaError_t launch_gla_bwd(const void* q, const void* k, const void* v, const void* g,
                           const float* states, const float* state, const void* dout,
                           const float* dstate, void* dq, void* dk, void* dv, void* dg,
                           float* dh, float* decay, float* rsum, float* total, int bh,
                           int t_len, cudaStream_t stream) {
  const int nchunks = (t_len + kChunk - 1) / kChunk;
  if (nchunks == 0) return cudaGetLastError();
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* gp = static_cast<const T*>(g);
  const T* dop = static_cast<const T*>(dout);
  const dim3 grid(nchunks, bh);
  cudaError_t err;
  constexpr size_t contrib_smem = ContribSmem<DK, DV>::kBytes;
  if ((err = allow_smem(gla_bwd_contrib_kernel<T, DK, DV>, contrib_smem)) != cudaSuccess)
    return err;
  gla_bwd_contrib_kernel<T, DK, DV><<<grid, kGlaThreads, contrib_smem, stream>>>(
      qp, gp, dop, dh, decay, t_len);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int64_t elems = static_cast<int64_t>(bh) * DK * DV;
  gla_bwd_scan_kernel<DK, DV>
      <<<static_cast<unsigned>((elems + kGlaThreads - 1) / kGlaThreads), kGlaThreads, 0,
         stream>>>(dh, decay, dstate, bh, nchunks);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  constexpr size_t chunk_smem = ChunkSmem<DK, DV>::kBytes;
  if ((err = allow_smem(gla_bwd_chunk_kernel<T, DK, DV>, chunk_smem)) != cudaSuccess) return err;
  gla_bwd_chunk_kernel<T, DK, DV><<<grid, kGlaThreads, chunk_smem, stream>>>(
      qp, kp, vp, gp, dop, states, dh, static_cast<T*>(dq), static_cast<T*>(dk),
      static_cast<T*>(dv), rsum, total, t_len);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  gla_bwd_dg_kernel<T, DK><<<grid, kGlaThreads, 0, stream>>>(
      gp, rsum, total, state, dstate, static_cast<T*>(dg), DV, t_len);
  return cudaGetLastError();
}

}  // namespace repro_torch

// q, k, g, dq, dk, dg (B*H, T, dk) and v, dout, dv (B*H, T, dv) contiguous in
// one dtype (code 0 f32, 3 bf16); states (B*H, chunks, dk, dv) f32, the state
// before each chunk (the forward scan's scratch); state (B*H, dk, dv) f32,
// the final state; dstate like it or null (zero); scratch dh (B*H, chunks,
// dk, dv), decay and total (B*H, chunks, dk), rsum (B*H, chunks * 64, dk),
// all f32, chunks = ceil(T / 64).  (dk, dv) is (16, 64) or (64, 64); B*H <=
// 65,535.
extern "C" int gla_chunk_bwd_launch(const void* q, const void* k, const void* v,
                                    const void* g, const void* states, const void* state,
                                    const void* dout, const void* dstate, void* dq, void* dk,
                                    void* dv, void* dg, void* dh, void* decay, void* rsum,
                                    void* total, int dtype, int bh, int t_len, int dkdim,
                                    int dvdim, void* stream) {
  using namespace repro_torch;
  if (bh <= 0) return static_cast<int>(cudaGetLastError());
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* sts = static_cast<const float*>(states);
  const auto* st = static_cast<const float*>(state);
  const auto* ds = static_cast<const float*>(dstate);
  auto* dhp = static_cast<float*>(dh);
  auto* decp = static_cast<float*>(decay);
  auto* rsp = static_cast<float*>(rsum);
  auto* totp = static_cast<float*>(total);
#define GLA_BWD(T, DK)                                                                      \
  return launch_gla_bwd<T, DK, 64>(q, k, v, g, sts, st, dout, ds, dq, dk, dv, dg, dhp, decp, \
                                   rsp, totp, bh, t_len, s)
  if (dvdim == 64 && dkdim == 16 && dtype == kDtypeBF16) GLA_BWD(bf16, 16);
  if (dvdim == 64 && dkdim == 64 && dtype == kDtypeBF16) GLA_BWD(bf16, 64);
  if (dvdim == 64 && dkdim == 16 && dtype == kDtypeF32) GLA_BWD(float, 16);
  if (dvdim == 64 && dkdim == 64 && dtype == kDtypeF32) GLA_BWD(float, 64);
#undef GLA_BWD
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* gla_chunk_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
