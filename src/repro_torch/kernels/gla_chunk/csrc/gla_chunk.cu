// gla_chunk: chunked gated linear attention (the RWKV-6 / SSM recurrence
// S_t = diag(e^{g_t}) S_{t-1} + k_t v_t^T, o_t = S_t^T q_t), CUDA C++ for
// sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/gla_chunk/kernel.py
// gla_chunked_kernel (body _gla_kernel, :31), with the same chunked math:
// chunks of 64 steps, L = cumsum(g) within a chunk, the inter-chunk term
// (q e^L) S0, the intra-chunk term by the two-level SUB = 16 scheme with
// every exponent <= 0 (diagonal sub-blocks take e^{L_i - L_j} for j <= i
// only, masked before exp; off-diagonal pairs are re-based at the column
// sub-block's last step), and the state update S0 e^{L_C} +
// (k e^{L_C - L})^T v.  g is clamped to [-8, 0] here (the wrappers' clamp),
// and steps past T read as zero q, k, v and zero decay (the wrappers'
// padding), so the caller needs no padded or clamped copy.  Returns o in the
// input's dtype and the final (dk, dv) f32 state.
//
// What bounds it on the H100: bytes.  At hymba-1.5b's eval shape (B 2, 25
// heads, T 2048, dk 16, dv 64, bf16) a call reads q, k, g and v once and
// writes o and the state: 36 MB, 10.8 us at 3.35 TB/s, against ~1 GFLOP of
// f32 FMA (14 us even at f32's 67 TFLOP/s spread over every SM).  What it
// needs is parallelism: the Pallas grid walks the chunks of a head in
// order, and a CTA per head would fill 50 of the 132 SMs.
//
// Design: the recurrence is split so that the work that does not depend on
// the carried state runs on every (chunk, head) pair at once, three kernels
// on one stream per call:
//   1. gla_chunk_state_kernel, grid (chunks, B*H): L by a warp scan per
//      channel, the chunk's own contribution dS_c = (k e^{L_C - L})^T v and
//      its decay e^{L_C}, both to f32 scratch that the wrapper allocates.
//   2. gla_chunk_scan_kernel, one thread per (b*h, x, y) state element:
//      walks the chunks in order, overwrites dS_c with the state before
//      chunk c, then S = S e^{L_C}[x] + dS_c[x, y]; writes the final state.
//   3. gla_chunk_out_kernel, grid (chunks, B*H): the exponent-safe factors,
//      the (64, 64) lower-triangular intra-chunk matrix A, and
//      o = (q e^L) S_before + A v, written once in the input's dtype.
// 1,600 (chunk, head) pairs at hymba's shape, 2,048 at an rwkv6 point (64
// heads, dk = dv = 64).  Everything is f32 FMA from shared memory, and what
// holds the passes back on this card is shared memory's 128 bytes per cycle
// per SM, not the FMA rate: a product that reads one word per FMA runs at a
// quarter of the SM's 128 FMAs per cycle.  So every product is tiled in registers (dS and A's
// off-diagonal pairs 4 x 4 per thread, A's diagonal pairs 2 x 2, the output
// 4 x 4), and the (d, chunk) operands are stored transposed, so that a
// thread reads its tile's neighbouring rows as one float2 / float4.  The
// exps (8,704 per chunk in A's diagonal pairs at dk 16) go through ex2.approx
// rather than expf's longer sequence.  No atomics: a launch is bitwise
// repeatable.
#include <cuda_runtime.h>

#include <cstdint>

#include "../../csrc/float_io.cuh"
#include "../../csrc/gla_tiles.cuh"

namespace repro_torch {

constexpr int kSub = 16;
constexpr int kNumSub = kChunk / kSub;

template <int DK, int DV>
struct StateSmem {
  static constexpr int kKS = DK + 4;  // row stride of k, then k e^{L_C - L}
  // L transposed; k by rows; v
  static constexpr size_t kBytes = sizeof(float) * (DK * kTS + kChunk * kKS + kChunk * DV);
};

template <typename T, int DK, int DV>
__global__ void __launch_bounds__(kGlaThreads)
    gla_chunk_state_kernel(const T* __restrict__ k, const T* __restrict__ v,
                           const T* __restrict__ g, float* __restrict__ ds,
                           float* __restrict__ decay, int t_len) {
  constexpr int KS = StateSmem<DK, DV>::kKS;
  extern __shared__ float smem[];
  float* LT = smem;
  float* kc = LT + DK * kTS;
  float* vs = kc + kChunk * KS;
  const int c = blockIdx.x;
  const int nchunks = gridDim.x;
  const int64_t bh = blockIdx.y;
  const int t0 = c * kChunk;
  const int tid = threadIdx.x;

  load_tile<T, DK>(kc, KS, k + bh * t_len * DK, t0, kChunk, t_len);
  load_tile_t<T, DK>(LT, g + bh * t_len * DK, t0, t_len);
  load_tile<T, DV>(vs, DV, v + bh * t_len * DV, t0, kChunk, t_len);
  __syncthreads();
  cumsum_decay<DK>(LT);
  __syncthreads();

  const int64_t slot = bh * nchunks + c;
  for (int idx = tid; idx < DK * kChunk; idx += kGlaThreads) {
    const int x = idx / kChunk, r = idx % kChunk;
    kc[r * KS + x] *= exp_le0(LT[x * kTS + kChunk - 1] - LT[x * kTS + r]);
  }
  if (tid < DK) decay[slot * DK + tid] = exp_le0(LT[tid * kTS + kChunk - 1]);
  __syncthreads();

  // dS = (k e^{L_C - L})^T v by 4 x 4 tiles, one per thread (the first
  // DK DV / 16 threads), summed over the chunk's steps in order: two float4
  // reads of shared memory feed 16 FMAs
  const int xb = tid / (DV / 4), yb = tid % (DV / 4);
  if (xb >= DK / 4) return;
  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[a][e] = 0.0f;
#pragma unroll 4
  for (int j = 0; j < kChunk; ++j) {
    const float4 kv = *reinterpret_cast<const float4*>(kc + j * KS + 4 * xb);
    const float4 w = *reinterpret_cast<const float4*>(vs + j * DV + 4 * yb);
    const float kr[4] = {kv.x, kv.y, kv.z, kv.w}, wr[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][e] = fmaf(kr[a], wr[e], acc[a][e]);
  }
  float* out = ds + slot * DK * DV;
#pragma unroll
  for (int a = 0; a < 4; ++a)
    *reinterpret_cast<float4*>(out + (4 * xb + a) * DV + 4 * yb) =
        make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
}

template <int DK, int DV>
__global__ void __launch_bounds__(kGlaThreads)
    gla_chunk_scan_kernel(float* __restrict__ ds, const float* __restrict__ decay,
                          float* __restrict__ state, int bh_total, int nchunks) {
  constexpr int kElems = DK * DV;
  const int64_t gid = static_cast<int64_t>(blockIdx.x) * kGlaThreads + threadIdx.x;
  if (gid >= static_cast<int64_t>(bh_total) * kElems) return;
  const int64_t bh = gid / kElems;
  const int e = static_cast<int>(gid % kElems);
  float* d = ds + bh * nchunks * kElems + e;
  const float* f = decay + bh * nchunks * DK + e / DV;
  float s = 0.0f;
  for (int c0 = 0; c0 < nchunks; c0 += kScanBatch) {
    float delta[kScanBatch], dec[kScanBatch];
#pragma unroll
    for (int u = 0; u < kScanBatch; ++u) {
      if (c0 + u < nchunks) {
        delta[u] = d[static_cast<int64_t>(c0 + u) * kElems];
        dec[u] = f[static_cast<int64_t>(c0 + u) * DK];
      }
    }
#pragma unroll
    for (int u = 0; u < kScanBatch; ++u) {
      if (c0 + u < nchunks) {
        d[static_cast<int64_t>(c0 + u) * kElems] = s;  // the state before chunk c
        s = fmaf(s, dec[u], delta[u]);
      }
    }
  }
  state[gid] = s;
}

template <int DK, int DV>
struct OutSmem {
  // q, k, L, q e^L, k e^{base - L} and the re-based q of each off-diagonal
  // column sub-block, all transposed; v; A transposed; the state before
  static constexpr size_t kBytes =
      sizeof(float) * ((5 + kNumSub - 1) * DK * kTS + kChunk * DV + kChunk * kTS + DK * DV);
};

template <typename T, int DK, int DV>
__global__ void __launch_bounds__(kGlaThreads)
    gla_chunk_out_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ g,
                         const float* __restrict__ s_before, T* __restrict__ o,
                         int t_len) {
  static_assert(DV % 16 == 0 && DV <= 64, "the output phase maps 4 x 4 tiles onto 64 x DV");
  extern __shared__ float smem[];
  constexpr int kD = DK * kTS;
  float* qT = smem;
  float* kT = qT + kD;
  float* LT = kT + kD;
  float* qeT = LT + kD;  // q e^{L}
  float* kbT = qeT + kD;  // k e^{base - L}, base the step's sub-block's last L
  float* qqT = kbT + kD;  // [cb] q e^{L - base_cb}
  float* vs = qqT + (kNumSub - 1) * kD;
  float* At = vs + kChunk * DV;  // At[j][i] = A[i][j]
  float* Ss = At + kChunk * kTS;
  const int c = blockIdx.x;
  const int64_t bh = blockIdx.y;
  const int64_t slot = bh * gridDim.x + c;
  const int t0 = c * kChunk;
  const int tid = threadIdx.x;

  load_tile_t<T, DK>(qT, q + bh * t_len * DK, t0, t_len);
  load_tile_t<T, DK>(kT, k + bh * t_len * DK, t0, t_len);
  load_tile_t<T, DK>(LT, g + bh * t_len * DK, t0, t_len);
  load_tile<T, DV>(vs, DV, v + bh * t_len * DV, t0, kChunk, t_len);
  {
    const float4* src = reinterpret_cast<const float4*>(s_before + slot * DK * DV);
    for (int i = tid; i < DK * DV / 4; i += kGlaThreads)
      reinterpret_cast<float4*>(Ss)[i] = src[i];
  }
  __syncthreads();
  cumsum_decay<DK>(LT);
  __syncthreads();

  // exponent-safe factors, every exponent <= 0
  for (int idx = tid; idx < DK * kChunk; idx += kGlaThreads) {
    const int x = idx / kChunk, r = idx % kChunk;
    const float* Lx = LT + x * kTS;
    const float L = Lx[r];
    const float qv = qT[x * kTS + r];
    qeT[x * kTS + r] = qv * exp_le0(L);
    kbT[x * kTS + r] = kT[x * kTS + r] * exp_le0(Lx[(r / kSub) * kSub + kSub - 1] - L);
#pragma unroll
    for (int cb = 0; cb < kNumSub - 1; ++cb)
      if (r >= (cb + 1) * kSub)
        qqT[cb * kD + x * kTS + r] = qv * exp_le0(L - Lx[(cb + 1) * kSub - 1]);
  }
  __syncthreads();

  // A[i][j] = sum_x a_ijx over the 10 sub-block pairs (r, cb <= r), one tile
  // per thread, each read of shared memory feeding several FMAs.  Threads
  // 0..95: the 6 off-diagonal pairs by 4 x 4 tiles, a_ijx = qq[i] kb[j].
  // Threads 96..239: the 4 diagonal pairs by the 36 2 x 2 tiles on or below
  // their diagonal, a_ijx = q_i k_j e^{L_i - L_j} for j <= i (masked before
  // exp) and 0 above it.  Threads 240..255: zeros in the 2 x 2 tiles just
  // above that diagonal, which the product below reads.
  if (tid < 96) {
    const int pair = tid / 16;  // (r, cb) = (1,0) (2,0) (2,1) (3,0) (3,1) (3,2)
    const int r = pair < 1 ? 1 : pair < 3 ? 2 : 3;
    const int cb = pair - r * (r - 1) / 2;
    const int i0 = r * kSub + 4 * ((tid % 16) / 4), j0 = cb * kSub + 4 * (tid % 4);
    const float* qq = qqT + cb * kD;
    float acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = 0.0f;
#pragma unroll 4
    for (int x = 0; x < DK; ++x) {
      const float4 qv = *reinterpret_cast<const float4*>(qq + x * kTS + i0);
      const float4 kv = *reinterpret_cast<const float4*>(kbT + x * kTS + j0);
      const float qr[4] = {qv.x, qv.y, qv.z, qv.w}, kr[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(qr[a], kr[b], acc[a][b]);
    }
#pragma unroll
    for (int b = 0; b < 4; ++b)
      *reinterpret_cast<float4*>(At + (j0 + b) * kTS + i0) =
          make_float4(acc[0][b], acc[1][b], acc[2][b], acc[3][b]);
  } else if (tid < 240) {
    const int d = tid - 96;
    const int r = d / 36, k = d % 36;
    int ti = 0;
    while ((ti + 1) * (ti + 2) / 2 <= k) ++ti;
    const int tj = k - ti * (ti + 1) / 2;
    const int i0 = r * kSub + 2 * ti, j0 = r * kSub + 2 * tj;
    float acc[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
#pragma unroll 4
    for (int x = 0; x < DK; ++x) {
      const float2 qv = *reinterpret_cast<const float2*>(qT + x * kTS + i0);
      const float2 kv = *reinterpret_cast<const float2*>(kT + x * kTS + j0);
      const float2 li = *reinterpret_cast<const float2*>(LT + x * kTS + i0);
      const float2 lj = *reinterpret_cast<const float2*>(LT + x * kTS + j0);
      acc[0][0] = fmaf(qv.x * kv.x, exp_le0(li.x - lj.x), acc[0][0]);
      acc[1][0] = fmaf(qv.y * kv.x, exp_le0(li.y - lj.x), acc[1][0]);
      acc[1][1] = fmaf(qv.y * kv.y, exp_le0(li.y - lj.y), acc[1][1]);
      if (tj < ti) acc[0][1] = fmaf(qv.x * kv.y, exp_le0(li.x - lj.y), acc[0][1]);
    }
    *reinterpret_cast<float2*>(At + j0 * kTS + i0) = make_float2(acc[0][0], acc[1][0]);
    *reinterpret_cast<float2*>(At + (j0 + 1) * kTS + i0) = make_float2(acc[0][1], acc[1][1]);
  } else {
    const int z = tid - 240;
    const int i0 = (z / 4) * kSub + 4 * (z % 4), j0 = i0 + 2;
    *reinterpret_cast<float2*>(At + j0 * kTS + i0) = make_float2(0.0f, 0.0f);
    *reinterpret_cast<float2*>(At + (j0 + 1) * kTS + i0) = make_float2(0.0f, 0.0f);
  }
  __syncthreads();

  // o = (q e^L) S_before + A v: thread owns rows 4 tr .. 4 tr + 3 and
  // columns 4 tc .. 4 tc + 3 (the first 4 DV threads; all of them at DV 64)
  const int tr = tid / (DV / 4), tc = tid % (DV / 4);
  if (tr >= kChunk / 4) return;
  float inter[4][4], intra[4][4];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii)
#pragma unroll
    for (int e = 0; e < 4; ++e) inter[ii][e] = intra[ii][e] = 0.0f;
#pragma unroll 4
  for (int x = 0; x < DK; ++x) {
    const float4 a = *reinterpret_cast<const float4*>(qeT + x * kTS + 4 * tr);
    const float4 s = *reinterpret_cast<const float4*>(Ss + x * DV + 4 * tc);
    const float av[4] = {a.x, a.y, a.z, a.w}, sv[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int e = 0; e < 4; ++e) inter[ii][e] = fmaf(av[ii], sv[e], inter[ii][e]);
  }
  for (int j = 0; j < 4 * tr + 4; ++j) {
    const float4 a = *reinterpret_cast<const float4*>(At + j * kTS + 4 * tr);
    const float4 w = *reinterpret_cast<const float4*>(vs + j * DV + 4 * tc);
    const float av[4] = {a.x, a.y, a.z, a.w}, wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int e = 0; e < 4; ++e) intra[ii][e] = fmaf(av[ii], wv[e], intra[ii][e]);
  }
  T* ob = o + bh * t_len * DV;
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int t = t0 + 4 * tr + ii;
    if (t >= t_len) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      ob[static_cast<int64_t>(t) * DV + 4 * tc + e] = from_f32<T>(inter[ii][e] + intra[ii][e]);
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int DK, int DV>
cudaError_t launch_gla(const void* q, const void* k, const void* v, const void* g,
                       void* o, void* state, void* ds, void* decay, int bh, int t_len,
                       cudaStream_t stream) {
  const int nchunks = (t_len + kChunk - 1) / kChunk;
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* gp = static_cast<const T*>(g);
  float* dsp = static_cast<float*>(ds);
  float* decp = static_cast<float*>(decay);
  cudaError_t err;
  const dim3 grid(nchunks, bh);
  if (nchunks > 0) {
    constexpr size_t smem = StateSmem<DK, DV>::kBytes;
    if ((err = allow_smem(gla_chunk_state_kernel<T, DK, DV>, smem)) != cudaSuccess) return err;
    gla_chunk_state_kernel<T, DK, DV><<<grid, kGlaThreads, smem, stream>>>(kp, vp, gp, dsp,
                                                                           decp, t_len);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const int64_t elems = static_cast<int64_t>(bh) * DK * DV;
  gla_chunk_scan_kernel<DK, DV>
      <<<static_cast<unsigned>((elems + kGlaThreads - 1) / kGlaThreads), kGlaThreads, 0,
         stream>>>(dsp, decp, static_cast<float*>(state), bh, nchunks);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (nchunks > 0) {
    constexpr size_t smem = OutSmem<DK, DV>::kBytes;
    if ((err = allow_smem(gla_chunk_out_kernel<T, DK, DV>, smem)) != cudaSuccess) return err;
    gla_chunk_out_kernel<T, DK, DV><<<grid, kGlaThreads, smem, stream>>>(
        qp, kp, vp, gp, dsp, static_cast<T*>(o), t_len);
  }
  return cudaGetLastError();
}

}  // namespace repro_torch

// q, k, g (B*H, T, dk) and v (B*H, T, dv) contiguous in one dtype (code 0
// f32, 3 bf16); o (B*H, T, dv) in that dtype, state (B*H, dk, dv) f32;
// scratch ds (B*H, chunks, dk, dv) and decay (B*H, chunks, dk) f32, chunks =
// ceil(T / 64).  (dk, dv) is (16, 64) or (64, 64), and (8, 16) in f32 (the
// reduced configs'); B*H <= 65,535.
extern "C" int gla_chunk_launch(const void* q, const void* k, const void* v,
                                const void* g, void* o, void* state, void* ds,
                                void* decay, int dtype, int bh, int t_len, int dk,
                                int dv, void* stream) {
  using namespace repro_torch;
  if (bh <= 0) return static_cast<int>(cudaGetLastError());
  const auto s = static_cast<cudaStream_t>(stream);
  if (dv == 64 && dk == 16 && dtype == kDtypeBF16)
    return launch_gla<bf16, 16, 64>(q, k, v, g, o, state, ds, decay, bh, t_len, s);
  if (dv == 64 && dk == 64 && dtype == kDtypeBF16)
    return launch_gla<bf16, 64, 64>(q, k, v, g, o, state, ds, decay, bh, t_len, s);
  if (dv == 64 && dk == 16 && dtype == kDtypeF32)
    return launch_gla<float, 16, 64>(q, k, v, g, o, state, ds, decay, bh, t_len, s);
  if (dv == 64 && dk == 64 && dtype == kDtypeF32)
    return launch_gla<float, 64, 64>(q, k, v, g, o, state, ds, decay, bh, t_len, s);
  if (dv == 16 && dk == 8 && dtype == kDtypeF32)
    return launch_gla<float, 8, 16>(q, k, v, g, o, state, ds, decay, bh, t_len, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* gla_chunk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
