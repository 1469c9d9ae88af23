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
// in the forward), S0 the state before the chunk and S1 the state after it
// (the forward scan's scratch and final state, kept by the caller) and dH the
// gradient of the state after it:
//
//   dH_{c-1} = e^{L_C} dH_c + (q e^L)^T dO          (dH of the last: dstate)
//   B_ij = dO_i . v_j,  A_ij = sum_x q_ix k_jx e^{L_ix - L_jx}   (j <= i)
//   dq_i = e^{L_i} (S0 dO_i) + sum_{j<=i} B_ij e^{L_i - L_j} k_j
//   dk_j = sum_{i>=j} B_ij e^{L_i - L_j} q_i + e^{L_C - L_j} (dH v_j)
//   dv_j = sum_{i>=j} A_ij dO_i + (k_j e^{L_C - L_j})^T dH
//   dg_t = (sum_{s>=t in the chunk} q_s dq_s - k_s dk_s + <S1, dH>_x) d clamp / dg
//
// The last term is the sum of q dq - k dk over every later step and of
// <S_T, dstate>: the gradient of the decays after the chunk is the state
// after it times the gradient that reaches it, row by row (dg_{t+1} =
// <S_t, e^{g_{t+1}} dS_{t+1}>), so no chunk waits for another's totals.
// d clamp / dg is the reference's jnp.clip gradient: 1 inside (-8, 0), 0
// outside, 0.5 on either bound (max and min split ties).  Three kernels on
// one stream, no atomics, so two launches are bitwise equal:
//   1. gla_bwd_contrib_kernel, grid (chunks, B*H): L, the chunk's
//      contribution (q e^L)^T dO (4 x 4 register tiles, the chunk's steps
//      split over the CTA's threads and summed in a fixed order) and its
//      decay e^{L_C}, to f32 scratch.
//   2. gla_bwd_scan_kernel, one thread per (b*h, x, y): walks the chunks
//      from the last, from dstate (zero when null), overwriting each
//      contribution with dH of that chunk.
//   3. gla_bwd_chunk_kernel, grid (chunks, B*H): every gradient of the chunk.
//      B once (4 x 4 tiles of the lower triangle); then, slab by slab of 16
//      key channels, L, the re-based factors and A's partial sums, dq and dk
//      (each a 4 x 4 tile of (steps, channels)), dg and dv's inter term;
//      then dv's intra term from A.  Below one slab of key channels (dk 8,
//      dv 16: the reduced configs) gla_bwd_chunk_small_kernel takes its
//      place, the same math in the direct form, one element a thread.
// The intra-chunk sums take the forward's sub-block re-basing (SUB = 16):
// exps per FMA only on the diagonal 16 x 16 sub-blocks, every off-diagonal
// pair re-based at a sub-block's last step b, so that each exponent stays
// <= 0: A_ij = (q_i e^{L_i - L_b}) . (k_j e^{L_b - L_j}) with b ending j's
// sub-block (the forward's qq and kb); dq's off-diagonal part e^{L_i - L_a}
// sum_{j <= a} B_ij (k_j e^{L_a - L_j}) with a ending the sub-block before
// i's; dk's e^{L_b - L_j} sum_{i > b} B_ij (q_i e^{L_i - L_b}).  That leaves
// O(C dk) exps per sub-block for the factors and ~26k exps a chunk on the
// diagonal sub-blocks at dk 16, against ~100k in the dif form.  Every product
// is register-tiled from shared memory, operands read as float4 along the
// tile; the within-chunk reverse sums of q dq - k dk are a warp's suffix scan
// in a fixed order.  Steps past T read as zero q, k, v, dO and zero decay, as
// in the forward.  Every product and sum is f32; the gradients are stored
// once in the inputs' dtypes.
//
// What bounds it on the H100: bytes.  At hymba-1.5b's training shape (B 2,
// 25 heads, T 2048, dk 16, dv 64, bf16) a call reads q, k, g, v, dO and the
// chunk-start states and writes four gradients: 46 MB, 14 us at 3.35 TB/s,
// against ~2 GFLOP of f32 FMA (29 us at the f32 67 TFLOP/s; shared memory's
// 128 bytes a cycle feed about half of that).
#include <cuda_runtime.h>

#include <cstdint>

#include "../../csrc/float_io.cuh"
#include "../../csrc/gla_tiles.cuh"

namespace repro_torch {

constexpr int kSubB = 16;              // steps of a sub-block
constexpr int kXS = 16;                // key channels of a slab
constexpr int kSS = kXS + 4;           // row stride of a (steps, slab) buffer
constexpr int kRS = kChunk + 4;        // row stride of a (rows, 64) buffer

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ float at(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// Eight consecutive elements as they lie in device memory (one 16-byte load
// of bf16, two of f32), widened to f32 only when stored, so that a thread
// issues every load of a tile before it waits on any.
template <typename T>
struct Raw8;
template <>
struct Raw8<bf16> {
  uint4 u;
  __device__ __forceinline__ void fetch(const bf16* p) { u = *reinterpret_cast<const uint4*>(p); }
  __device__ __forceinline__ void zero() { u = make_uint4(0, 0, 0, 0); }
  __device__ __forceinline__ void widen(float (&x)[8]) const {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
};
template <>
struct Raw8<float> {
  float4 a, b;
  __device__ __forceinline__ void fetch(const float* p) {
    a = ld4(p);
    b = ld4(p + 4);
  }
  __device__ __forceinline__ void zero() { a = b = make_float4(0.0f, 0.0f, 0.0f, 0.0f); }
  __device__ __forceinline__ void widen(float (&x)[8]) const {
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
  }
};

// The thread's share of columns [x0, x0 + W8) of steps [t0, t0 + 64) of a
// row-major (T, W) matrix: item idx = tid + 256 u is step idx % 64, columns
// x0 + 8 (idx / 64) .. + 7; steps at or past T read as zeros.  fetch issues
// the loads; store_t writes them transposed, dst[(c + e) kTS + step], and
// store_rows by rows, dst[step * stride + c + e], both as f32.
template <typename T, int W, int W8>
struct ChunkTile {
  static constexpr int kItems = kChunk * W8 / 8;
  static constexpr int kPer = (kItems + kGlaThreads - 1) / kGlaThreads;
  Raw8<T> raw[kPer];
  __device__ __forceinline__ void fetch(const T* src, int t0, int t_len, int x0) {
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int idx = threadIdx.x + u * kGlaThreads;
      const int r = idx % kChunk, c = (idx / kChunk) * 8;
      if (idx < kItems && t0 + r < t_len)
        raw[u].fetch(src + static_cast<int64_t>(t0 + r) * W + x0 + c);
      else
        raw[u].zero();
    }
  }
  __device__ __forceinline__ void store_t(float* dst) const {
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int idx = threadIdx.x + u * kGlaThreads;
      if (idx >= kItems) continue;
      const int r = idx % kChunk, c = (idx / kChunk) * 8;
      float x[8];
      raw[u].widen(x);
#pragma unroll
      for (int e = 0; e < 8; ++e) dst[(c + e) * kTS + r] = x[e];
    }
  }
  __device__ __forceinline__ void store_rows(float* dst, int stride) const {
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int idx = threadIdx.x + u * kGlaThreads;
      if (idx >= kItems) continue;
      const int r = idx % kChunk, c = (idx / kChunk) * 8;
      float x[8];
      raw[u].widen(x);
      st4(dst + r * stride + c, x[0], x[1], x[2], x[3]);
      st4(dst + r * stride + c + 4, x[4], x[5], x[6], x[7]);
    }
  }
};

template <int DK, int DV>
struct ContribSmem {
  static constexpr int kQS = DK + 4;  // row stride of q, then q e^L
  static constexpr int kOS = DV + 4;  // row stride of dO
  static constexpr int kTiles = DK * DV / 16;
  static constexpr int kParts = kGlaThreads / kTiles;  // thread groups over the steps
  static constexpr size_t kBytes =
      sizeof(float) * (DK * kTS + kChunk * kQS + kChunk * kOS + (kParts - 1) * DK * DV);
};

template <typename T, int DK, int DV>
__global__ void __launch_bounds__(kGlaThreads)
    gla_bwd_contrib_kernel(const T* __restrict__ q, const T* __restrict__ g,
                           const T* __restrict__ dout, float* __restrict__ dh,
                           float* __restrict__ decay, int t_len) {
  using S = ContribSmem<DK, DV>;
  constexpr int QS = S::kQS, OS = S::kOS;
  extern __shared__ float smem[];
  float* LT = smem;
  float* qe = LT + DK * kTS;
  float* dos = qe + kChunk * QS;
  float* part = dos + kChunk * OS;  // partial tiles of groups 1..kParts-1
  const int c = blockIdx.x;
  const int64_t bh = blockIdx.y;
  const int64_t slot = bh * gridDim.x + c;
  const int t0 = c * kChunk;
  const int tid = threadIdx.x;

  {
    ChunkTile<T, DK, DK> qt, gt;
    ChunkTile<T, DV, DV> ot;
    qt.fetch(q + bh * t_len * DK, t0, t_len, 0);
    gt.fetch(g + bh * t_len * DK, t0, t_len, 0);
    ot.fetch(dout + bh * t_len * DV, t0, t_len, 0);
    qt.store_rows(qe, QS);
    gt.store_t(LT);
    ot.store_rows(dos, OS);
  }
  __syncthreads();
  cumsum_decay<DK>(LT);
  __syncthreads();
  for (int idx = tid; idx < DK * kChunk; idx += kGlaThreads) {
    const int x = idx / kChunk, r = idx % kChunk;
    qe[r * QS + x] *= exp_le0(LT[x * kTS + r]);
  }
  if (tid < DK) decay[slot * DK + tid] = exp_le0(LT[tid * kTS + kChunk - 1]);
  __syncthreads();

  // (q e^L)^T dO by 4 x 4 tiles; group p sums steps [p C / parts, (p + 1) C /
  // parts) in order, then group 0 adds the others' partials in group order
  const int tile = tid % S::kTiles, grp = tid / S::kTiles;
  const int xb = tile / (DV / 4), yb = tile % (DV / 4);
  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[a][e] = 0.0f;
  constexpr int kSteps = kChunk / S::kParts;
#pragma unroll 4
  for (int j = grp * kSteps; j < (grp + 1) * kSteps; ++j) {
    const float4 qv = ld4(qe + j * QS + 4 * xb);
    const float4 w = ld4(dos + j * OS + 4 * yb);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][e] = fmaf(at(qv, a), at(w, e), acc[a][e]);
  }
  if (grp > 0) {
    float* mine = part + (grp - 1) * DK * DV;
#pragma unroll
    for (int a = 0; a < 4; ++a)
      st4(mine + (4 * xb + a) * DV + 4 * yb, acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
  }
  __syncthreads();
  if (grp > 0) return;
  for (int p = 1; p < S::kParts; ++p) {
    const float* other = part + (p - 1) * DK * DV;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float4 o = ld4(other + (4 * xb + a) * DV + 4 * yb);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][e] += at(o, e);
    }
  }
  float* out = dh + slot * DK * DV;
#pragma unroll
  for (int a = 0; a < 4; ++a)
    st4(out + (4 * xb + a) * DV + 4 * yb, acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
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

// Shared memory of the chunk kernel, offsets in floats (each a multiple of
// 4, so every float4 read is aligned).  Whole-chunk buffers: dO and v
// transposed (dv, steps), B by rows (then A).  Slab buffers, 16 key
// channels, by rows (steps, channels): q, k, L; qq_cb = q e^{L - L_b(cb)}
// for the steps after sub-block cb (cb 0..2: 48 + 32 + 16 rows); kr_cb =
// k e^{L_b(cb) - L} for the steps up to the end of sub-block cb (16 + 32 +
// 48 rows); kb = k e^{L_b - L} with b ending the step's sub-block; then S0
// and dH transposed (dv, channels), dH by rows (channels, dv), q dq and
// k dk transposed (channels, steps), the decays e^{L_C - L_b(cb)} (4,
// channels) and <S1, dH> per channel.  After the last slab dO by rows takes
// the slab buffers' place.  111,680 bytes, so two CTAs fit an SM.
template <int DV>
struct ChunkSmem {
  static constexpr int kDOT = 0;
  static constexpr int kVT = kDOT + DV * kRS;
  static constexpr int kB = kVT + DV * kRS;
  static constexpr int kQ = kB + kChunk * kRS;
  static constexpr int kK = kQ + kChunk * kSS;
  static constexpr int kL = kK + kChunk * kSS;
  static constexpr int kQQ = kL + kChunk * kSS;
  static constexpr int kKR = kQQ + 96 * kSS;
  static constexpr int kKB = kKR + 96 * kSS;
  static constexpr int kS0T = kKB + kChunk * kSS;
  static constexpr int kDHT = kS0T + DV * kSS;
  static constexpr int kDH = kDHT + DV * kSS;
  static constexpr int kRQ = kDH + kXS * kRS;
  static constexpr int kRK = kRQ + kXS * kRS;
  static constexpr int kH = kRK + kXS * kRS;
  static constexpr int kSuf = kH + 4 * kXS;
  static constexpr int kFloats = kSuf + kXS;
  static constexpr int kDOr = kQ;  // after the slabs
  static_assert(kDOr + kChunk * kRS <= kFloats, "dO by rows fits the slab buffers");
  static constexpr size_t kBytes = sizeof(float) * kFloats;
};

// first row of qq_cb (its rows are the steps 16 (cb + 1) .. 63) and of kr_cb
// (the steps 0 .. 16 cb + 15) in their packed buffers
__device__ __forceinline__ int qq_row0(int cb) { return cb == 0 ? 0 : cb == 1 ? 48 : 80; }
__device__ __forceinline__ int kr_row0(int cb) { return cb == 0 ? 0 : cb == 1 ? 16 : 48; }

// four consecutive outputs, one 8- or 16-byte store
__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  st4(p, a, b, c, d);
}
__device__ __forceinline__ void store4(bf16* p, float a, float b, float c, float d) {
  __nv_bfloat162 h[2] = {__floats2bfloat162_rn(a, b), __floats2bfloat162_rn(c, d)};
  *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(h);
}

// two CTAs an SM at dk 16 (116 registers); at dk 64 the slab loop needs
// more than the 128 that two CTAs leave, so one
template <typename T, int DK, int DV>
__global__ void __launch_bounds__(kGlaThreads, DK == 16 ? 2 : 1)
    gla_bwd_chunk_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ g,
                         const T* __restrict__ dout, const float* __restrict__ states,
                         const float* __restrict__ state, const float* __restrict__ dh,
                         T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv,
                         T* __restrict__ dg, int t_len) {
  static_assert(DV == 64, "dO, v, B and A are (64, 64) tiles of 4 x 4 per thread");
  static_assert(DK % kXS == 0, "whole slabs of 16 key channels");
  using S = ChunkSmem<DV>;
  extern __shared__ float smem[];
  float* dOT = smem + S::kDOT;
  float* vT = smem + S::kVT;
  float* Bm = smem + S::kB;
  float* qs = smem + S::kQ;
  float* ks = smem + S::kK;
  float* Ls = smem + S::kL;
  float* qq = smem + S::kQQ;
  float* kr = smem + S::kKR;
  float* kb = smem + S::kKB;
  float* S0T = smem + S::kS0T;
  float* dHT = smem + S::kDHT;
  float* dHs = smem + S::kDH;
  float* rq = smem + S::kRQ;
  float* rk = smem + S::kRK;
  float* Hd = smem + S::kH;
  float* suf = smem + S::kSuf;
  const int c = blockIdx.x;
  const int nchunks = gridDim.x;
  const int64_t bh = blockIdx.y;
  const int64_t slot = bh * nchunks + c;
  const int t0 = c * kChunk;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;

  // every load of the first slab is issued before any is waited on
  ChunkTile<T, DV, DV> ot, vt;
  ot.fetch(dout + bh * t_len * DV, t0, t_len, 0);
  vt.fetch(v + bh * t_len * DV, t0, t_len, 0);

  // A's partial sums over the slabs, in registers: threads 0..95 one 4 x 4
  // tile of an off-diagonal sub-block pair (r, cb), threads 96..239 one 2 x 2
  // tile on or below the diagonal of a diagonal sub-block (the forward's
  // gla_chunk_out_kernel layout)
  float aacc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) aacc[a][b] = 0.0f;
  int a_i0 = 0, a_j0 = 0, a_cb = 0, a_ti = 0, a_tj = 0;
  if (tid < 96) {
    const int pair = tid / 16;  // (r, cb) = (1,0) (2,0) (2,1) (3,0) (3,1) (3,2)
    const int r = pair < 1 ? 1 : pair < 3 ? 2 : 3;
    a_cb = pair - r * (r - 1) / 2;
    a_i0 = r * kSubB + 4 * ((tid % 16) / 4);
    a_j0 = a_cb * kSubB + 4 * (tid % 4);
  } else if (tid < 240) {
    const int d = tid - 96;
    const int r = d / 36, kk = d % 36;
    while ((a_ti + 1) * (a_ti + 2) / 2 <= kk) ++a_ti;
    a_tj = kk - a_ti * (a_ti + 1) / 2;
    a_i0 = r * kSubB + 2 * a_ti;
    a_j0 = r * kSubB + 2 * a_tj;
  }
  // dv's tile: rows (steps) jv..jv+3, columns yv..yv+3
  const int jv = 4 * (tid / 16), yv = 4 * (tid % 16);
  float vacc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) vacc[a][b] = 0.0f;
  // dq (threads 0..127) and dk (128..255): a 2 x 4 tile of steps r0, r0 + 1
  // and the slab's channels xs..xs+3
  const bool is_q = tid < 128;
  const int r0 = 2 * ((tid % 128) / 4), xs = 4 * (tid % 4), blk = r0 / kSubB;

  const float* s0 = states + slot * DK * DV;
  const float* s1 = c + 1 < nchunks ? states + (slot + 1) * DK * DV : state + bh * DK * DV;
  const float* dhc = dh + slot * DK * DV;
  for (int x0 = 0; x0 < DK; x0 += kXS) {
    if (x0 > 0) __syncthreads();  // the last slab's buffers are read
    ChunkTile<T, DK, kXS> qt, kt, gt;
    qt.fetch(q + bh * t_len * DK, t0, t_len, x0);
    kt.fetch(k + bh * t_len * DK, t0, t_len, x0);
    gt.fetch(g + bh * t_len * DK, t0, t_len, x0);
    // S0, dH and S1 of the slab's channels: thread (x, y4)
    const int sx = tid / 16, sy = 4 * (tid % 16);
    const float4 s0v = ld4(s0 + (x0 + sx) * DV + sy);
    const float4 dhv = ld4(dhc + (x0 + sx) * DV + sy);
    const float4 s1v = ld4(s1 + (x0 + sx) * DV + sy);
    // the decays dg's clamp gradient reads: channels warp + 8 j, steps
    // 2 lane + i
    T gdg[kXS / kGlaWarps][2];
#pragma unroll
    for (int j = 0; j < kXS / kGlaWarps; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int t = t0 + 2 * lane + i;
        gdg[j][i] = t < t_len ? g[(bh * t_len + t) * DK + x0 + warp + j * kGlaWarps]
                              : from_f32<T>(0.0f);
      }
    if (x0 == 0) {
      ot.store_t(dOT);
      vt.store_t(vT);
    }
    qt.store_rows(qs, kSS);
    kt.store_rows(ks, kSS);
    gt.store_rows(Ls, kSS);
    {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        S0T[(sy + e) * kSS + sx] = at(s0v, e);
        dHT[(sy + e) * kSS + sx] = at(dhv, e);
      }
      st4(dHs + sx * kRS + sy, dhv.x, dhv.y, dhv.z, dhv.w);
      // <S1, dH> of channel sx: 4 products in order, then the 16 lanes of
      // the channel in a fixed butterfly (every lane ends with one value)
      float d = fmaf(s1v.x, dhv.x, 0.0f);
      d = fmaf(s1v.y, dhv.y, d);
      d = fmaf(s1v.z, dhv.z, d);
      d = fmaf(s1v.w, dhv.w, d);
#pragma unroll
      for (int off = 8; off >= 1; off >>= 1) d += __shfl_xor_sync(0xffffffffu, d, off);
      if (tid % 16 == 0) suf[sx] = d;
    }
    __syncthreads();

    // L = cumsum(clamp(g)) per channel: lane l holds steps 2l and 2l + 1,
    // then an inclusive warp scan (gla_tiles.cuh cumsum_decay, by rows)
    for (int x = warp; x < kXS; x += kGlaWarps) {
      const float ga = Ls[(2 * lane) * kSS + x], gb = Ls[(2 * lane + 1) * kSS + x];
      const float a = fminf(fmaxf(ga, kGClamp), 0.0f);
      const float b = a + fminf(fmaxf(gb, kGClamp), 0.0f);
      float scan = b;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, scan, off);
        if (lane >= off) scan += up;
      }
      Ls[(2 * lane) * kSS + x] = scan - b + a;
      Ls[(2 * lane + 1) * kSS + x] = scan;
    }
    __syncthreads();

    // B = dO v^T on the 136 4 x 4 tiles on or below the diagonal (threads
    // 0..135, the first slab only; the entries above the diagonal inside a
    // diagonal tile are stored too, and every reader masks them), beside
    // the re-based factors of the slab (every exponent <= 0; b(cb) = 16 cb
    // + 15 ends sub-block cb) on the other threads
    const int first = x0 == 0 ? 136 : 0;
    if (tid < first) {
      int ti = 0;
      while ((ti + 1) * (ti + 2) / 2 <= tid) ++ti;
      const int tj = tid - ti * (ti + 1) / 2;
      float acc[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = 0.0f;
#pragma unroll 4
      for (int y = 0; y < DV; ++y) {
        const float4 o = ld4(dOT + y * kRS + 4 * ti);
        const float4 w = ld4(vT + y * kRS + 4 * tj);
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(at(o, a), at(w, b), acc[a][b]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
        st4(Bm + (4 * ti + a) * kRS + 4 * tj, acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
    } else {
      for (int idx = tid - first; idx < kChunk * kXS; idx += kGlaThreads - first) {
        const int t = idx / kXS, x = idx % kXS, r = t / kSubB;
        const float L = Ls[t * kSS + x];
        const float qv = qs[t * kSS + x], kv = ks[t * kSS + x];
#pragma unroll
        for (int cb = 0; cb < 3; ++cb) {
          const float Lb = Ls[(cb * kSubB + kSubB - 1) * kSS + x];
          if (r > cb) qq[(qq_row0(cb) + t - (cb + 1) * kSubB) * kSS + x] = qv * exp_le0(L - Lb);
          if (r <= cb) kr[(kr_row0(cb) + t) * kSS + x] = kv * exp_le0(Lb - L);
        }
        kb[t * kSS + x] = kv * exp_le0(Ls[(r * kSubB + kSubB - 1) * kSS + x] - L);
        if (idx < 4 * kXS) {
          const int cb = idx / kXS, xx = idx % kXS;
          Hd[cb * kXS + xx] =
              exp_le0(Ls[(kChunk - 1) * kSS + xx] - Ls[(cb * kSubB + kSubB - 1) * kSS + xx]);
        }
      }
    }
    __syncthreads();

    // A's slab terms
    if (tid < 96) {
      const float* qqc = qq + (qq_row0(a_cb) - (a_cb + 1) * kSubB) * kSS;
#pragma unroll
      for (int x = 0; x < kXS; x += 4) {
        float4 qv[4], kv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          qv[a] = ld4(qqc + (a_i0 + a) * kSS + x);
          kv[a] = ld4(kb + (a_j0 + a) * kSS + x);
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b)
#pragma unroll
            for (int e = 0; e < 4; ++e) aacc[a][b] = fmaf(at(qv[a], e), at(kv[b], e), aacc[a][b]);
      }
    } else if (tid < 240) {
#pragma unroll
      for (int x = 0; x < kXS; x += 4) {
        float4 qv[2], kv[2], li[2], lj[2];
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          qv[a] = ld4(qs + (a_i0 + a) * kSS + x);
          li[a] = ld4(Ls + (a_i0 + a) * kSS + x);
          kv[a] = ld4(ks + (a_j0 + a) * kSS + x);
          lj[a] = ld4(Ls + (a_j0 + a) * kSS + x);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          aacc[0][0] = fmaf(at(qv[0], e) * at(kv[0], e), exp_le0(at(li[0], e) - at(lj[0], e)),
                            aacc[0][0]);
          aacc[1][0] = fmaf(at(qv[1], e) * at(kv[0], e), exp_le0(at(li[1], e) - at(lj[0], e)),
                            aacc[1][0]);
          aacc[1][1] = fmaf(at(qv[1], e) * at(kv[1], e), exp_le0(at(li[1], e) - at(lj[1], e)),
                            aacc[1][1]);
          if (a_tj < a_ti)
            aacc[0][1] = fmaf(at(qv[0], e) * at(kv[1], e),
                              exp_le0(at(li[0], e) - at(lj[1], e)), aacc[0][1]);
        }
      }
    }

    // dq and dk of the slab
    {
      float Lr[2][4];
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const float4 l4 = ld4(Ls + (r0 + a) * kSS + xs);
#pragma unroll
        for (int e = 0; e < 4; ++e) Lr[a][e] = at(l4, e);
      }
      float inter[2][4], off[2][4], diag[2][4];
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int e = 0; e < 4; ++e) inter[a][e] = off[a][e] = diag[a][e] = 0.0f;
      // inter: dq S0 dO_i, dk dH v_j (sums over dv)
      const float* rows = is_q ? dOT : vT;
      const float* cols = is_q ? S0T : dHT;
#pragma unroll 4
      for (int y = 0; y < DV; ++y) {
        const float2 o = *reinterpret_cast<const float2*>(rows + y * kRS + r0);
        const float4 w = ld4(cols + y * kSS + xs);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          inter[0][e] = fmaf(o.x, at(w, e), inter[0][e]);
          inter[1][e] = fmaf(o.y, at(w, e), inter[1][e]);
        }
      }
      if (is_q) {
        // off-diagonal: sum_{j <= a} B_ij kr_{blk-1}[j], a = 16 blk - 1
        const float* krr = kr + kr_row0(max(blk - 1, 0)) * kSS;
        for (int j = 0; j < blk * kSubB; j += 4) {
          float4 bv[2], kv[4];
#pragma unroll
          for (int a = 0; a < 2; ++a) bv[a] = ld4(Bm + (r0 + a) * kRS + j);
#pragma unroll
          for (int u = 0; u < 4; ++u) kv[u] = ld4(krr + (j + u) * kSS + xs);
#pragma unroll
          for (int a = 0; a < 2; ++a)
#pragma unroll
            for (int u = 0; u < 4; ++u)
#pragma unroll
              for (int e = 0; e < 4; ++e) off[a][e] = fmaf(at(bv[a], u), at(kv[u], e), off[a][e]);
        }
        // diagonal: j in the row's sub-block, j <= i
        for (int j = blk * kSubB; j <= r0 + 1; j += 4) {
          float4 bv[2], kv[4], lv[4];
#pragma unroll
          for (int a = 0; a < 2; ++a) bv[a] = ld4(Bm + (r0 + a) * kRS + j);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            kv[u] = ld4(ks + (j + u) * kSS + xs);
            lv[u] = ld4(Ls + (j + u) * kSS + xs);
          }
#pragma unroll
          for (int a = 0; a < 2; ++a)
#pragma unroll
            for (int u = 0; u < 4; ++u)
              if (j + u <= r0 + a) {
#pragma unroll
                for (int e = 0; e < 4; ++e)
                  diag[a][e] = fmaf(at(bv[a], u) * at(kv[u], e),
                                    exp_le0(Lr[a][e] - at(lv[u], e)), diag[a][e]);
              }
        }
      } else {
        // off-diagonal: sum_{i > b} B_ij qq_blk[i], b = 16 blk + 15
        if (blk < 3) {
          const float* qqc = qq + (qq_row0(blk) - (blk + 1) * kSubB) * kSS;
#pragma unroll 4
          for (int i = (blk + 1) * kSubB; i < kChunk; ++i) {
            const float2 bv = *reinterpret_cast<const float2*>(Bm + i * kRS + r0);
            const float4 qv = ld4(qqc + i * kSS + xs);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              off[0][e] = fmaf(bv.x, at(qv, e), off[0][e]);
              off[1][e] = fmaf(bv.y, at(qv, e), off[1][e]);
            }
          }
        }
        // diagonal: i in the column's sub-block, i >= j
        for (int i = r0; i < (blk + 1) * kSubB; ++i) {
          const float2 bv = *reinterpret_cast<const float2*>(Bm + i * kRS + r0);
          const float4 qv = ld4(qs + i * kSS + xs);
          const float4 lv = ld4(Ls + i * kSS + xs);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            diag[0][e] = fmaf(bv.x * at(qv, e), exp_le0(at(lv, e) - Lr[0][e]), diag[0][e]);
          if (i > r0) {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              diag[1][e] = fmaf(bv.y * at(qv, e), exp_le0(at(lv, e) - Lr[1][e]), diag[1][e]);
          }
        }
      }
      // the factors: dq e^{L_i} inter + e^{L_i - L_a} off; dk e^{L_C - L_j}
      // inter + e^{L_b - L_j} off
      const int base = is_q ? blk * kSubB - 1 : blk * kSubB + kSubB - 1;
      float* rT = is_q ? rq : rk;
      const float* own = is_q ? qs : ks;
      T* out = (is_q ? dq : dk) + bh * t_len * DK;
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const float4 ov = ld4(own + (r0 + a) * kSS + xs);
        float gv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float L = Lr[a][e];
          const float Lc = Ls[(kChunk - 1) * kSS + xs + e];
          const float Lb = base >= 0 ? Ls[base * kSS + xs + e] : 0.0f;
          gv[e] = is_q ? fmaf(inter[a][e], exp_le0(L), fmaf(off[a][e], exp_le0(L - Lb), diag[a][e]))
                       : fmaf(inter[a][e], exp_le0(Lc - L),
                              fmaf(off[a][e], exp_le0(Lb - L), diag[a][e]));
          rT[(xs + e) * kRS + r0 + a] = at(ov, e) * gv[e];
        }
        if (t0 + r0 + a < t_len)
          store4(out + static_cast<int64_t>(t0 + r0 + a) * DK + x0 + xs, gv[0], gv[1], gv[2],
                 gv[3]);
      }
    }
    __syncthreads();

    // dv's inter term, (k e^{L_C - L})^T dH over the slab's channels, with
    // k e^{L_C - L_j} = kb_j e^{L_C - L_b}
    {
      const int cb = jv / kSubB;
#pragma unroll
      for (int x = 0; x < kXS; x += 4) {
        const float4 h4 = ld4(Hd + cb * kXS + x);
        float4 kv[4], dv4[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          kv[a] = ld4(kb + (jv + a) * kSS + x);
          dv4[a] = ld4(dHs + (x + a) * kRS + yv);
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float ke = at(kv[a], u) * at(h4, u);
#pragma unroll
            for (int e = 0; e < 4; ++e) vacc[a][e] = fmaf(ke, at(dv4[u], e), vacc[a][e]);
          }
      }
    }
    // dg of the slab's channels: warp w channels 2w, 2w + 1; lane l steps
    // 2l, 2l + 1; the reverse sums of q dq - k dk by a suffix scan over the
    // lanes in a fixed order, plus <S1, dH>, times the clamp's gradient
#pragma unroll
    for (int j = 0; j < kXS / kGlaWarps; ++j) {
      const int x = warp + j * kGlaWarps;
      const float2 pq = *reinterpret_cast<const float2*>(rq + x * kRS + 2 * lane);
      const float2 pk = *reinterpret_cast<const float2*>(rk + x * kRS + 2 * lane);
      const float ra = pq.x - pk.x, rb = pq.y - pk.y;
      float incl = ra + rb;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float down = __shfl_down_sync(0xffffffffu, incl, off);
        if (lane + off < 32) incl += down;
      }
      float later = __shfl_down_sync(0xffffffffu, incl, 1);
      if (lane == 31) later = 0.0f;
      later += suf[x];
      const float sb = rb + later, sa = ra + sb;
      T* dgb = dg + bh * t_len * DK;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = t0 + 2 * lane + h;
        if (t >= t_len) continue;
        const int64_t at_ = static_cast<int64_t>(t) * DK + x0 + x;
        const float gv = to_f32(gdg[j][h]);
        const float dclamp = (gv > kGClamp && gv < 0.0f) ? 1.0f
                             : (gv == kGClamp || gv == 0.0f) ? 0.5f
                                                              : 0.0f;
        dgb[at_] = from_f32<T>((h == 0 ? sa : sb) * dclamp);
      }
    }
  }
  __syncthreads();  // B and the slab buffers are read

  // A by rows in B's place, zero above the diagonal where dv's tiles read
  // it: the (0, 1) entry of a diagonal 2 x 2 tile, and the 2 x 2 tiles just
  // above the diagonal (threads 240..255), as in the forward; dO by rows,
  // from its transpose, in the slab buffers' place
  float* Am = Bm;
  float* dOr = smem + S::kDOr;
  if (tid < 96) {
#pragma unroll
    for (int a = 0; a < 4; ++a)
      st4(Am + (a_i0 + a) * kRS + a_j0, aacc[a][0], aacc[a][1], aacc[a][2], aacc[a][3]);
  } else if (tid < 240) {
    *reinterpret_cast<float2*>(Am + a_i0 * kRS + a_j0) = make_float2(aacc[0][0], aacc[0][1]);
    *reinterpret_cast<float2*>(Am + (a_i0 + 1) * kRS + a_j0) =
        make_float2(aacc[1][0], aacc[1][1]);
  } else {
    const int z = tid - 240;
    const int i0 = (z / 4) * kSubB + 4 * (z % 4), j0 = i0 + 2;
    *reinterpret_cast<float2*>(Am + i0 * kRS + j0) = make_float2(0.0f, 0.0f);
    *reinterpret_cast<float2*>(Am + (i0 + 1) * kRS + j0) = make_float2(0.0f, 0.0f);
  }
  for (int idx = tid; idx < kChunk * DV / 4; idx += kGlaThreads) {
    const int i = idx % kChunk, y = 4 * (idx / kChunk);
    st4(dOr + i * kRS + y, dOT[y * kRS + i], dOT[(y + 1) * kRS + i], dOT[(y + 2) * kRS + i],
        dOT[(y + 3) * kRS + i]);
  }
  __syncthreads();

  // dv's intra term, sum_{i >= j} A_ij dO_i
  for (int i = jv; i < kChunk; ++i) {
    const float4 a4 = ld4(Am + i * kRS + jv);
    const float4 o4 = ld4(dOr + i * kRS + yv);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int e = 0; e < 4; ++e) vacc[a][e] = fmaf(at(a4, a), at(o4, e), vacc[a][e]);
  }
  T* dvb = dv + bh * t_len * DV;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int t = t0 + jv + a;
    if (t < t_len)
      store4(dvb + static_cast<int64_t>(t) * DV + yv, vacc[a][0], vacc[a][1], vacc[a][2],
             vacc[a][3]);
  }
}

// The chunk pass at key dims below one slab (dk 8 with dv 16: the reduced
// configs'), where the slab kernel's 16-channel slabs and (64, 64) tiles do
// not apply: every gradient of the chunk in the direct form, every exponent
// a difference of the clamped cumulative decay that is <= 0 (e^{L_i - L_j}
// for j <= i, e^{L_t}, e^{L_C - L_t}), one output element a thread, sums in
// a fixed order.  The math is the slab kernel's (the header's equations);
// at these widths a chunk is ~50k FMAs and ~16k exps, so the simple form
// costs nothing the launch does not.
template <int DK, int DV>
struct SmallSmem {
  static constexpr int kKP = DK + 1;  // row stride of q and k (steps, dk)
  static constexpr int kVP = DV + 1;  // row stride of v and dO (steps, dv)
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kChunk * kKP;
  static constexpr int kL = kK + kChunk * kKP;      // L transposed (dk, kTS)
  static constexpr int kV = kL + DK * kTS;
  static constexpr int kO = kV + kChunk * kVP;      // dO
  static constexpr int kS0 = kO + kChunk * kVP;     // S0 (dk, dv)
  static constexpr int kDH = kS0 + DK * DV;         // dH (dk, dv)
  static constexpr int kB = kDH + DK * DV;          // B (steps, steps)
  static constexpr int kA = kB + kChunk * kRS;      // A (steps, steps)
  static constexpr int kRQ = kA + kChunk * kRS;     // q dq transposed (dk, steps)
  static constexpr int kRK = kRQ + DK * kRS;        // k dk transposed
  static constexpr int kSuf = kRK + DK * kRS;       // <S1, dH> per channel
  static constexpr size_t kBytes = sizeof(float) * (kSuf + DK);
};

template <typename T, int DK, int DV>
__global__ void __launch_bounds__(kGlaThreads)
    gla_bwd_chunk_small_kernel(const T* __restrict__ q, const T* __restrict__ k,
                               const T* __restrict__ v, const T* __restrict__ g,
                               const T* __restrict__ dout, const float* __restrict__ states,
                               const float* __restrict__ state, const float* __restrict__ dh,
                               T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv,
                               T* __restrict__ dg, int t_len) {
  using S = SmallSmem<DK, DV>;
  constexpr int KP = S::kKP, VP = S::kVP;
  extern __shared__ float smem[];
  float* qs = smem + S::kQ;
  float* ks = smem + S::kK;
  float* LT = smem + S::kL;
  float* vs = smem + S::kV;
  float* os = smem + S::kO;
  float* S0 = smem + S::kS0;
  float* dH = smem + S::kDH;
  float* Bm = smem + S::kB;
  float* Am = smem + S::kA;
  float* rq = smem + S::kRQ;
  float* rk = smem + S::kRK;
  float* suf = smem + S::kSuf;
  const int c = blockIdx.x;
  const int nchunks = gridDim.x;
  const int64_t bh = blockIdx.y;
  const int64_t slot = bh * nchunks + c;
  const int t0 = c * kChunk;
  const int tid = threadIdx.x;

  load_tile<T, DK>(qs, KP, q + bh * t_len * DK, t0, kChunk, t_len);
  load_tile<T, DK>(ks, KP, k + bh * t_len * DK, t0, kChunk, t_len);
  load_tile_t<T, DK>(LT, g + bh * t_len * DK, t0, t_len);
  load_tile<T, DV>(vs, VP, v + bh * t_len * DV, t0, kChunk, t_len);
  load_tile<T, DV>(os, VP, dout + bh * t_len * DV, t0, kChunk, t_len);
  const float* s0 = states + slot * DK * DV;
  const float* s1 = c + 1 < nchunks ? states + (slot + 1) * DK * DV : state + bh * DK * DV;
  const float* dhc = dh + slot * DK * DV;
  for (int i = tid; i < DK * DV; i += kGlaThreads) {
    S0[i] = s0[i];
    dH[i] = dhc[i];
  }
  if (tid < DK) {
    float d = 0.0f;
    for (int y = 0; y < DV; ++y) d = fmaf(s1[tid * DV + y], dhc[tid * DV + y], d);
    suf[tid] = d;
  }
  __syncthreads();
  cumsum_decay<DK>(LT);
  __syncthreads();

  // B_ij = dO_i . v_j and A_ij = sum_x q_ix k_jx e^{L_ix - L_jx} on and below
  // the diagonal, 0 above it
  for (int idx = tid; idx < kChunk * kChunk; idx += kGlaThreads) {
    const int i = idx / kChunk, j = idx % kChunk;
    float b = 0.0f, a = 0.0f;
    if (j <= i) {
      for (int y = 0; y < DV; ++y) b = fmaf(os[i * VP + y], vs[j * VP + y], b);
      for (int x = 0; x < DK; ++x)
        a = fmaf(qs[i * KP + x] * ks[j * KP + x], exp_le0(LT[x * kTS + i] - LT[x * kTS + j]), a);
    }
    Bm[i * kRS + j] = b;
    Am[i * kRS + j] = a;
  }
  __syncthreads();

  // dq_tx = e^{L_t} (S0 dO_t)_x + sum_{j<=t} B_tj e^{L_t - L_j} k_jx and
  // dk_tx = sum_{i>=t} B_it e^{L_i - L_t} q_ix + e^{L_C - L_t} (dH v_t)_x
  for (int idx = tid; idx < kChunk * DK; idx += kGlaThreads) {
    const int t = idx / DK, x = idx % DK;
    const float* Lx = LT + x * kTS;
    const float Lt = Lx[t];
    float inter_q = 0.0f, inter_k = 0.0f;
    for (int y = 0; y < DV; ++y) {
      inter_q = fmaf(S0[x * DV + y], os[t * VP + y], inter_q);
      inter_k = fmaf(dH[x * DV + y], vs[t * VP + y], inter_k);
    }
    float intra_q = 0.0f, intra_k = 0.0f;
    for (int j = 0; j <= t; ++j)
      intra_q = fmaf(Bm[t * kRS + j] * ks[j * KP + x], exp_le0(Lt - Lx[j]), intra_q);
    for (int i = t; i < kChunk; ++i)
      intra_k = fmaf(Bm[i * kRS + t] * qs[i * KP + x], exp_le0(Lx[i] - Lt), intra_k);
    const float gq = fmaf(inter_q, exp_le0(Lt), intra_q);
    const float gk = fmaf(inter_k, exp_le0(Lx[kChunk - 1] - Lt), intra_k);
    rq[x * kRS + t] = qs[t * KP + x] * gq;
    rk[x * kRS + t] = ks[t * KP + x] * gk;
    if (t0 + t < t_len) {
      const int64_t at_ = (bh * t_len + t0 + t) * DK + x;
      dq[at_] = from_f32<T>(gq);
      dk[at_] = from_f32<T>(gk);
    }
  }
  // dv_ty = sum_{i>=t} A_it dO_iy + sum_x k_tx e^{L_C - L_t} dH_xy
  for (int idx = tid; idx < kChunk * DV; idx += kGlaThreads) {
    const int t = idx / DV, y = idx % DV;
    float acc = 0.0f;
    for (int i = t; i < kChunk; ++i) acc = fmaf(Am[i * kRS + t], os[i * VP + y], acc);
    for (int x = 0; x < DK; ++x)
      acc = fmaf(ks[t * KP + x] * exp_le0(LT[x * kTS + kChunk - 1] - LT[x * kTS + t]),
                 dH[x * DV + y], acc);
    if (t0 + t < t_len) dv[(bh * t_len + t0 + t) * DV + y] = from_f32<T>(acc);
  }
  __syncthreads();

  // dg of each channel: the reverse sums of q dq - k dk from the chunk's
  // last step, plus <S1, dH>, times the clamp's gradient
  if (tid < DK) {
    float later = suf[tid];
    for (int t = kChunk - 1; t >= 0; --t) {
      later += rq[tid * kRS + t] - rk[tid * kRS + t];
      if (t0 + t >= t_len) continue;
      const int64_t at_ = (bh * t_len + t0 + t) * DK + tid;
      const float gv = to_f32(g[at_]);
      const float dclamp = (gv > kGClamp && gv < 0.0f) ? 1.0f
                           : (gv == kGClamp || gv == 0.0f) ? 0.5f
                                                            : 0.0f;
      dg[at_] = from_f32<T>(later * dclamp);
    }
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
                           float* dh, float* decay, int bh, int t_len, cudaStream_t stream) {
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
  if constexpr (DK < kXS) {
    constexpr size_t small_smem = SmallSmem<DK, DV>::kBytes;
    if ((err = allow_smem(gla_bwd_chunk_small_kernel<T, DK, DV>, small_smem)) != cudaSuccess)
      return err;
    gla_bwd_chunk_small_kernel<T, DK, DV><<<grid, kGlaThreads, small_smem, stream>>>(
        qp, kp, vp, gp, dop, states, state, dh, static_cast<T*>(dq), static_cast<T*>(dk),
        static_cast<T*>(dv), static_cast<T*>(dg), t_len);
  } else {
    constexpr size_t chunk_smem = ChunkSmem<DV>::kBytes;
    if ((err = allow_smem(gla_bwd_chunk_kernel<T, DK, DV>, chunk_smem)) != cudaSuccess)
      return err;
    if ((err = cudaFuncSetAttribute(gla_bwd_chunk_kernel<T, DK, DV>,
                                    cudaFuncAttributePreferredSharedMemoryCarveout,
                                    cudaSharedmemCarveoutMaxShared)) != cudaSuccess)
      return err;
    gla_bwd_chunk_kernel<T, DK, DV><<<grid, kGlaThreads, chunk_smem, stream>>>(
        qp, kp, vp, gp, dop, states, state, dh, static_cast<T*>(dq), static_cast<T*>(dk),
        static_cast<T*>(dv), static_cast<T*>(dg), t_len);
  }
  return cudaGetLastError();
}

}  // namespace repro_torch

// q, k, g, dq, dk, dg (B*H, T, dk) and v, dout, dv (B*H, T, dv) contiguous in
// one dtype (code 0 f32, 3 bf16), 16-byte aligned; states (B*H, chunks, dk,
// dv) f32, the state before each chunk (the forward scan's scratch); state
// (B*H, dk, dv) f32, the final state; dstate like it or null (zero); scratch
// dh (B*H, chunks, dk, dv) and decay (B*H, chunks, dk) f32, chunks = ceil(T /
// 64).  (dk, dv) is (16, 64) or (64, 64), and (8, 16) in f32 (the reduced
// configs'); B*H <= 65,535.
extern "C" int gla_chunk_bwd_launch(const void* q, const void* k, const void* v,
                                    const void* g, const void* states, const void* state,
                                    const void* dout, const void* dstate, void* dq, void* dk,
                                    void* dv, void* dg, void* dh, void* decay, int dtype,
                                    int bh, int t_len, int dkdim, int dvdim, void* stream) {
  using namespace repro_torch;
  if (bh <= 0) return static_cast<int>(cudaGetLastError());
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* sts = static_cast<const float*>(states);
  const auto* st = static_cast<const float*>(state);
  const auto* ds = static_cast<const float*>(dstate);
  auto* dhp = static_cast<float*>(dh);
  auto* decp = static_cast<float*>(decay);
#define GLA_BWD(T, DK, DV)                                                                  \
  return launch_gla_bwd<T, DK, DV>(q, k, v, g, sts, st, dout, ds, dq, dk, dv, dg, dhp, decp, \
                                   bh, t_len, s)
  if (dvdim == 64 && dkdim == 16 && dtype == kDtypeBF16) GLA_BWD(bf16, 16, 64);
  if (dvdim == 64 && dkdim == 64 && dtype == kDtypeBF16) GLA_BWD(bf16, 64, 64);
  if (dvdim == 64 && dkdim == 16 && dtype == kDtypeF32) GLA_BWD(float, 16, 64);
  if (dvdim == 64 && dkdim == 64 && dtype == kDtypeF32) GLA_BWD(float, 64, 64);
  if (dvdim == 16 && dkdim == 8 && dtype == kDtypeF32) GLA_BWD(float, 8, 16);
#undef GLA_BWD
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* gla_chunk_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
