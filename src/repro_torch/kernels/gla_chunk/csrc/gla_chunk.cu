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
// writes o and the state: ~31 MB, ~9.4 us at 3.35 TB/s, against ~0.5
// GFLOP.  It is latency-bound in practice: the chunks of a head are
// sequential.
//
// Design, simple first: one CTA of 256 threads per (batch, head) walks the
// head's chunks in order and carries the state in shared memory (16 x 64
// f32 for hymba, 64 x 64 for rwkv6).  Per chunk: load and widen q, k, g, v
// to f32; cumsum g by a warp scan; the exponent-safe factors q e^L, the
// re-based q and k of each sub-block pair; the (64, 64) intra-chunk matrix
// A; then o = (q e^L) S0 + A v, and the state update.  Everything is scalar
// f32 from shared memory, no atomics: a launch is bitwise repeatable.
// Occupancy: hymba's eval shard gives 2 x 25 = 50 CTAs for 132 SMs.
#include <cuda_runtime.h>

#include <cstdint>

#include "../../csrc/float_io.cuh"

namespace repro_torch {

constexpr int kChunk = 64;
constexpr int kSub = 16;
constexpr int kNumSub = kChunk / kSub;
constexpr int kGlaThreads = 256;
constexpr int kGlaWarps = kGlaThreads / 32;
constexpr float kGClamp = -8.0f;

template <int DK, int DV>
struct GlaSmem {
  static constexpr int kKS = DK + 1;     // row stride of (chunk, dk) buffers
  static constexpr int kAS = kChunk + 1;  // row stride of A
  static constexpr int kRows = kChunk * kKS;
  // q, k, L, q e^L, k re-based (later k e^{L_C - L}), and the re-based q of
  // each off-diagonal column sub-block; v; A; the state
  static constexpr size_t kBytes =
      sizeof(float) * (5 * kRows + (kNumSub - 1) * kRows + kChunk * DV +
                       kChunk * kAS + DK * DV);
};

template <typename T, int DK, int DV>
__global__ void __launch_bounds__(kGlaThreads)
    gla_chunk_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ g,
                     T* __restrict__ o, float* __restrict__ state, int t_len) {
  using S = GlaSmem<DK, DV>;
  constexpr int KS = S::kKS;
  constexpr int AS = S::kAS;
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + S::kRows;
  float* Ls = ks + S::kRows;
  float* qe = Ls + S::kRows;   // q e^{L}
  float* kk = qe + S::kRows;   // k e^{base - L}, then k e^{L_C - L}
  float* qq = kk + S::kRows;   // [cb] q e^{L - base_cb}
  float* vs = qq + (kNumSub - 1) * S::kRows;
  float* A = vs + kChunk * DV;
  float* st = A + kChunk * AS;

  const int64_t bh = blockIdx.x;
  const T* qb = q + bh * t_len * DK;
  const T* kb = k + bh * t_len * DK;
  const T* gb = g + bh * t_len * DK;
  const T* vb = v + bh * t_len * DV;
  T* ob = o + bh * t_len * DV;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  for (int i = tid; i < DK * DV; i += kGlaThreads) st[i] = 0.0f;

  const int nchunks = (t_len + kChunk - 1) / kChunk;
  for (int c = 0; c < nchunks; ++c) {
    const int t0 = c * kChunk;
    __syncthreads();  // the previous chunk is done with every buffer
    load_tile<T, DK>(qs, KS, qb, t0, kChunk, t_len);
    load_tile<T, DK>(ks, KS, kb, t0, kChunk, t_len);
    load_tile<T, DK>(Ls, KS, gb, t0, kChunk, t_len);
    load_tile<T, DV>(vs, DV, vb, t0, kChunk, t_len);
    __syncthreads();

    // L = cumsum(clamp(g, -8, 0)) down each channel: lane l holds steps 2l
    // and 2l+1, then an inclusive warp scan
    for (int ch = warp; ch < DK; ch += kGlaWarps) {
      const float a = fminf(fmaxf(Ls[(2 * lane) * KS + ch], kGClamp), 0.0f);
      const float b = a + fminf(fmaxf(Ls[(2 * lane + 1) * KS + ch], kGClamp), 0.0f);
      float scan = b;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, scan, off);
        if (lane >= off) scan += up;
      }
      const float excl = scan - b;
      Ls[(2 * lane) * KS + ch] = excl + a;
      Ls[(2 * lane + 1) * KS + ch] = scan;
    }
    __syncthreads();

    // exponent-safe factors, every exponent <= 0
    for (int idx = tid; idx < kChunk * DK; idx += kGlaThreads) {
      const int r = idx / DK, x = idx % DK;
      const float L = Ls[r * KS + x];
      qe[r * KS + x] = qs[r * KS + x] * expf(L);
      const float base = Ls[((r / kSub) * kSub + kSub - 1) * KS + x];
      kk[r * KS + x] = ks[r * KS + x] * expf(base - L);
#pragma unroll
      for (int cb = 0; cb < kNumSub - 1; ++cb) {
        if (r >= (cb + 1) * kSub) {
          const float bc = Ls[((cb + 1) * kSub - 1) * KS + x];
          qq[cb * S::kRows + r * KS + x] = qs[r * KS + x] * expf(L - bc);
        }
      }
    }
    __syncthreads();

    // A[i][j], j <= i, over the 10 sub-block pairs (r, cb <= r)
    for (int idx = tid; idx < kNumSub * (kNumSub + 1) / 2 * kSub * kSub;
         idx += kGlaThreads) {
      const int pair = idx / (kSub * kSub);
      const int r = pair < 1 ? 0 : pair < 3 ? 1 : pair < 6 ? 2 : 3;
      const int cb = pair - r * (r + 1) / 2;
      const int ii = (idx / kSub) % kSub, jj = idx % kSub;
      const int i = r * kSub + ii, j = cb * kSub + jj;
      float a = 0.0f;
      if (cb < r) {
        const float* qr = qq + cb * S::kRows + i * KS;
#pragma unroll
        for (int x = 0; x < DK; ++x) a = fmaf(qr[x], kk[j * KS + x], a);
      } else if (jj <= ii) {  // diagonal: mask before exp
#pragma unroll
        for (int x = 0; x < DK; ++x)
          a = fmaf(qs[i * KS + x] * ks[j * KS + x],
                   expf(Ls[i * KS + x] - Ls[j * KS + x]), a);
      } else {
        continue;  // above the diagonal: never read
      }
      A[i * AS + j] = a;
    }
    __syncthreads();

    // o = (q e^L) S0 + A v; and k e^{L_C - L} for the state update
    for (int idx = tid; idx < kChunk * DV; idx += kGlaThreads) {
      const int i = idx / DV, y = idx % DV;
      float inter = 0.0f;
#pragma unroll
      for (int x = 0; x < DK; ++x) inter = fmaf(qe[i * KS + x], st[x * DV + y], inter);
      float intra = 0.0f;
      for (int j = 0; j <= i; ++j) intra = fmaf(A[i * AS + j], vs[j * DV + y], intra);
      if (t0 + i < t_len)
        ob[static_cast<int64_t>(t0 + i) * DV + y] = from_f32<T>(inter + intra);
    }
    for (int idx = tid; idx < kChunk * DK; idx += kGlaThreads) {
      const int r = idx / DK, x = idx % DK;
      kk[r * KS + x] = ks[r * KS + x] * expf(Ls[(kChunk - 1) * KS + x] - Ls[r * KS + x]);
    }
    __syncthreads();

    // S = S0 e^{L_C} + (k e^{L_C - L})^T v
    for (int idx = tid; idx < DK * DV; idx += kGlaThreads) {
      const int x = idx / DV, y = idx % DV;
      float carry = 0.0f;
      for (int j = 0; j < kChunk; ++j) carry = fmaf(kk[j * KS + x], vs[j * DV + y], carry);
      st[idx] = st[idx] * expf(Ls[(kChunk - 1) * KS + x]) + carry;
    }
  }
  __syncthreads();
  float* sb = state + bh * DK * DV;
  for (int i = tid; i < DK * DV; i += kGlaThreads) sb[i] = st[i];
}

template <typename T, int DK, int DV>
cudaError_t launch_gla(const void* q, const void* k, const void* v,
                       const void* g, void* o, void* state, int bh, int t_len,
                       cudaStream_t stream) {
  const size_t smem = GlaSmem<DK, DV>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      gla_chunk_kernel<T, DK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  gla_chunk_kernel<T, DK, DV><<<bh, kGlaThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g), static_cast<T*>(o),
      static_cast<float*>(state), t_len);
  return cudaGetLastError();
}

}  // namespace repro_torch

// q, k, g (B*H, T, dk) and v (B*H, T, dv) contiguous in one dtype (code 0
// f32, 3 bf16); o (B*H, T, dv) in that dtype, state (B*H, dk, dv) f32.
// (dk, dv) is (16, 64) or (64, 64).
extern "C" int gla_chunk_launch(const void* q, const void* k, const void* v,
                                const void* g, void* o, void* state, int dtype,
                                int bh, int t_len, int dk, int dv,
                                void* stream) {
  using namespace repro_torch;
  if (bh <= 0) return static_cast<int>(cudaGetLastError());
  const auto s = static_cast<cudaStream_t>(stream);
  if (dv == 64 && dk == 16 && dtype == kDtypeBF16)
    return launch_gla<bf16, 16, 64>(q, k, v, g, o, state, bh, t_len, s);
  if (dv == 64 && dk == 64 && dtype == kDtypeBF16)
    return launch_gla<bf16, 64, 64>(q, k, v, g, o, state, bh, t_len, s);
  if (dv == 64 && dk == 16 && dtype == kDtypeF32)
    return launch_gla<float, 16, 64>(q, k, v, g, o, state, bh, t_len, s);
  if (dv == 64 && dk == 64 && dtype == kDtypeF32)
    return launch_gla<float, 64, 64>(q, k, v, g, o, state, bh, t_len, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* gla_chunk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
