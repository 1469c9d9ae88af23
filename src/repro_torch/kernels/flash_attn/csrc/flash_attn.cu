// flash_attn: blockwise online-softmax attention with GQA, a causal mask and
// a sliding window, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/flash_attn/kernel.py
// flash_attention_kernel (body _attn_kernel, :24).  The same arithmetic:
// f32 scores s = (q . k) * scale, masked entries set to NEG_INF = -1e30 (not
// -inf, so a tile in which a row sees no key gives no NaN), running max m,
// denominator l and accumulator acc carried across kv tiles, and the output
// acc / l with l > 0 guarded, stored in q's dtype.  Beyond the Pallas mask
// (col < kv_len; col <= row when causal) it takes the sliding window of
// the models' mea_attention (col > row - window when window > 0), and
// skips every kv tile wholly outside the causal triangle or the window band
// of a 64-row group of queries, as the Pallas kernel skips tiles above the
// diagonal.  GQA maps q head h to kv head h / (Hq / Hkv) in the kernel, so K
// and V are never repeated.  No atomics, no split over kv: a launch is
// bitwise repeatable.
//
// What bounds it on the H100: operations.  At hymba-1.5b's eval shape
// (B 2, 25 q heads over 5 kv heads, S 2048, d 64, window 1024) the masks
// keep 1.57M (q, k) pairs per head, 20.1 GFLOP in all (20.4 us at 989
// TFLOP/s), against 31.5 MB of q, k, v and o (9.4 us at 3.35 TB/s).
//
// bf16 inputs: flash_attn_wgmma_kernel, on the tensor cores.  One CTA of two
// consumer warpgroups per (batch, q head, 128 q rows); each warpgroup owns 64
// rows, the M of wgmma.  The Q tile comes in once by TMA; 64-row K and V
// tiles come in by TMA into a ring of two stages, each guarded by an
// mbarrier that counts the copy's bytes, and thread 0 issues tile j + 1
// before the warpgroups start on tile j, so the copy overlaps the compute.
// S = Q K^T is wgmma m64n64k16 with Q and K both K-major from 128-byte
// swizzled shared memory (hopper.cuh); the mask and the online softmax work
// on the f32 accumulator fragments, whose (row, col) follow from the wgmma
// layout; P, as bf16 pairs in registers, is the register A operand of
// O += P V (the accumulator layout of one m64n64k16 is the A-fragment
// layout of the next), with V read as the transposed (MN-major)
// B operand straight from its TMA tile.  O accumulates in f32 registers and
// is rounded once to bf16.  The softmax runs in base 2: the scores carry
// scale * log2(e) and ex2.approx (2 ulp, subnormals flushed) takes the place
// of expf.  Only a tile on an edge of a warpgroup's band (the diagonal, the
// window's lower edge, Skv) is masked.
// P goes in as two bf16 parts, P_hi = bf16(p) and P_lo = bf16(p - P_hi),
// two register-A products on the same V tile: P rounded once to bf16 is off
// by up to 2^-8 p, which puts an output over n keys off by ~2^-8 |v| /
// sqrt(3n) (~7e-5 at 1024 keys) and fails the bf16 limit the kernel is held
// to (rtol 1e-2, atol 1e-4) wherever |o| is small: 3 % of the outputs at a
// reduced eval shape (tests/test_torch_models.py); the two parts carry 16
// bits of p and fail none, for 1.5x the tensor-core work.  l sums the f32 p.
// Ragged Sq and Skv: TMA fills rows past the end with zeros, the col < skv
// mask drops their scores, and rows >= Sq are not stored.  Head dims 64,
// 128 and 256 (gemma-7b), each as D / 64 pieces of 64 columns: at D 256 a
// CTA holds Q as four 16 KB pieces and two stages of K and V at 64 KB each
// (193 KB of shared memory, one CTA an SM), and a thread's O accumulator is
// 128 f32 registers beside S's 32.
//
// When the caller passes an lse buffer (B, Hq, Sq) f32 (the autograd
// Function does, when a gradient will be asked for), each row's
// log-sum-exp of its scaled scores is written beside o, in natural units:
// m + log(l) (the bf16 kernel's base-2 m and l: (m + log2 l) ln 2), so that
// o = sum exp(s scale - lse) v.  It is read back from the finished m and l
// after the kv loop and touches nothing o is computed from: with a null
// pointer a launch does exactly what it did before the backward existed.
//
// f32 inputs (head dims 16, 64 and 128; 16 is the reduced configs'):
// flash_attn_kernel<float, D>, the scalar kernel, kept because
// wgmma on f32 is TF32 (about three digits), looser than the f32 checks
// (the kernel at 2e-3, a full-width f32 forward's logits at 1e-3).  One CTA
// of 128 threads per (batch, q head, 64-row q tile); q, K and V tiles
// widened to f32 in shared memory; thread (tr, tc) owns rows 4tr..4tr+3 and
// score columns tc + 8j, so each row's softmax reductions are a 3-step
// shuffle among 8 lanes of one warp; QK^T and PV are f32 FMAs.
#include <cuda_runtime.h>

#include <cstdint>

#include "../../csrc/float_io.cuh"
#include "../../csrc/hopper.cuh"
#include "../../csrc/tma_map.cuh"

namespace repro_torch {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kFlashThreads = 128;
constexpr float kNegInf = -1e30f;

// the kv tiles [lo, hi] that query rows [r0, r_end) visit: none wholly past
// the diagonal of row r_end - 1 (causal) or wholly before the window of row r0
__device__ __forceinline__ void kv_tiles(int r0, int r_end, int skv, int causal,
                                         int window, int& lo, int& hi) {
  int last_col = skv - 1;
  if (causal) last_col = min(last_col, r_end - 1);
  hi = last_col >= 0 ? last_col / kBK : -1;
  lo = window > 0 ? max(0, r0 - window + 1) / kBK : 0;
}

template <int D>
struct FlashSmem {
  static constexpr int kQStride = D + 1;  // read down columns: pad a bank
  static constexpr int kKStride = D + 1;
  static constexpr int kVStride = D;      // read along rows
  static constexpr int kPStride = kBK + 1;
  static constexpr size_t kBytes =
      sizeof(float) * (kBQ * kQStride + kBK * kKStride + kBK * kVStride +
                       kBQ * kPStride);
};

template <typename T, int D>
__global__ void __launch_bounds__(kFlashThreads)
    flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o,
                      float* __restrict__ lse, int hq, int hkv, int sq, int skv,
                      float scale, int causal, int window) {
  using S = FlashSmem<D>;
  constexpr int kCols = D / 8;  // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kBQ * S::kQStride;
  float* vs = ks + kBK * S::kKStride;
  float* ps = vs + kBK * S::kVStride;

  const int i0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const T* qb = q + static_cast<int64_t>(b * hq + h) * sq * D;
  const T* kb = k + static_cast<int64_t>(b * hkv + hk) * skv * D;
  const T* vb = v + static_cast<int64_t>(b * hkv + hk) * skv * D;
  T* ob = o + static_cast<int64_t>(b * hq + h) * sq * D;
  const int tr = threadIdx.x / 8;  // rows 4tr .. 4tr+3 of the tile
  const int tc = threadIdx.x % 8;  // columns tc, tc+8, ...

  load_tile<T, D>(qs, S::kQStride, qb, i0, kBQ, sq);

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    m[ii] = kNegInf;
    l[ii] = 0.0f;
#pragma unroll
    for (int jj = 0; jj < kCols; ++jj) acc[ii][jj] = 0.0f;
  }

  int j_lo, j_hi;
  kv_tiles(i0, i0 + kBQ, skv, causal, window, j_lo, j_hi);

  for (int jt = j_lo; jt <= j_hi; ++jt) {
    const int j0 = jt * kBK;
    __syncthreads();  // the previous tile's K and V are no longer read
    load_tile<T, D>(ks, S::kKStride, kb, j0, kBK, skv);
    load_tile<T, D>(vs, S::kVStride, vb, j0, kBK, skv);
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) s[ii][jj] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], c[8];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) a[ii] = qs[(4 * tr + ii) * S::kQStride + d];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) c[jj] = ks[(tc + 8 * jj) * S::kKStride + d];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) s[ii][jj] = fmaf(a[ii], c[jj], s[ii][jj]);
    }

#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const int row = i0 + 4 * tr + ii;
      float mc = kNegInf;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int col = j0 + tc + 8 * jj;
        bool keep = col < skv;
        if (causal) keep = keep && col <= row;
        if (window > 0) keep = keep && col > row - window;
        s[ii][jj] = keep ? s[ii][jj] * scale : kNegInf;
        mc = fmaxf(mc, s[ii][jj]);
      }
      // the row's 64 columns live on 8 neighbouring lanes
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, off));
      const float m_new = fmaxf(m[ii], mc);
      float rs = 0.0f;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float p = expf(s[ii][jj] - m_new);
        ps[(4 * tr + ii) * S::kPStride + tc + 8 * jj] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float alpha = expf(m[ii] - m_new);
      l[ii] = l[ii] * alpha + rs;
      m[ii] = m_new;
#pragma unroll
      for (int jj = 0; jj < kCols; ++jj) acc[ii][jj] *= alpha;
    }
    __syncwarp();  // P rows are written and read by the same warp

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float p[4], w[kCols];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) p[ii] = ps[(4 * tr + ii) * S::kPStride + c];
#pragma unroll
      for (int jj = 0; jj < kCols; ++jj) w[jj] = vs[c * S::kVStride + tc + 8 * jj];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < kCols; ++jj) acc[ii][jj] = fmaf(p[ii], w[jj], acc[ii][jj]);
    }
    __syncwarp();  // P is read before the next tile overwrites it
  }

#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int row = i0 + 4 * tr + ii;
    if (row >= sq) continue;
    const float den = l[ii] > 0.0f ? l[ii] : 1.0f;
#pragma unroll
    for (int jj = 0; jj < kCols; ++jj)
      ob[static_cast<int64_t>(row) * D + tc + 8 * jj] = from_f32<T>(acc[ii][jj] / den);
  }
  if (lse != nullptr && tc == 0) {
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const int row = i0 + 4 * tr + ii;
      if (row < sq)
        lse[static_cast<int64_t>(b * hq + h) * sq + row] = m[ii] + logf(l[ii] > 0.0f ? l[ii] : 1.0f);
    }
  }
}

template <typename T, int D>
cudaError_t launch_flash(const void* q, const void* k, const void* v, void* o,
                         float* lse, int batch, int hq, int hkv, int sq, int skv,
                         float scale, int causal, int window,
                         cudaStream_t stream) {
  const size_t smem = FlashSmem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kBQ - 1) / kBQ, hq, batch);
  flash_attn_kernel<T, D><<<grid, kFlashThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, hq, hkv, sq, skv, scale,
      causal, window);
  return cudaGetLastError();
}

// ---- bf16: the tensor-core kernel -------------------------------------------

constexpr int kWgRows = 64;                    // q rows per warpgroup (wgmma M)
constexpr int kWgBQ = 2 * kWgRows;             // q rows per CTA
constexpr int kWgThreads = 256;                // two consumer warpgroups
constexpr int kStages = 2;                     // K/V ring depth
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of one CTA, in bytes from a 1024-aligned base: Q as D / 64
// pieces of 128 rows x 64 columns, then per stage K and V as D / 64 pieces
// of 64 rows x 64 columns each, then the mbarriers (Q, then one per stage).
template <int D>
struct WgSmem {
  static constexpr int kPieces = D / 64;
  static constexpr int kQPiece = kWgBQ * 128;
  static constexpr int kKVPiece = kBK * 128;
  static constexpr int kQ = kPieces * kQPiece;
  static constexpr int kStage = 2 * kPieces * kKVPiece;
  static constexpr int kBars = kQ + kStages * kStage;
  static constexpr size_t kBytes = kBars + 8 * (1 + kStages) + 1024;  // + alignment
};

// (a, b) as bf16 pairs hi = round(a, b) and lo = round((a, b) - hi): hi + lo
// carries 16 significant bits of each
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// thread 0: K and V tile ``jt`` of kv head ``bkv`` into the stage of the
// ring's n-th tile, counted on that stage's barrier
template <int D>
__device__ __forceinline__ void load_kv(uint8_t* smem, uint64_t* bars, const CUtensorMap* tk,
                                        const CUtensorMap* tv, int n, int jt, int bkv) {
  using S = WgSmem<D>;
  uint8_t* st = smem + S::kQ + (n % kStages) * S::kStage;
  uint64_t* bar = &bars[1 + n % kStages];
  hopper::mbar_arrive_expect_tx(bar, S::kStage);
#pragma unroll
  for (int p = 0; p < S::kPieces; ++p) {
    hopper::tma_load_3d(st + p * S::kKVPiece, tk, bar, 64 * p, jt * kBK, bkv);
    hopper::tma_load_3d(st + (S::kPieces + p) * S::kKVPiece, tv, bar, 64 * p, jt * kBK, bkv);
  }
}

template <int D>
__global__ void __launch_bounds__(kWgThreads, D == 64 ? 2 : 1)
    flash_attn_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            bf16* __restrict__ o, float* __restrict__ lse, int hq,
                            int hkv, int sq, int skv, float scale_log2, int causal,
                            int window) {
  using S = WgSmem<D>;
  constexpr int P = S::kPieces;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  uint8_t* qs = smem;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + S::kBars);

  const int i0 = blockIdx.x * kWgBQ;
  const int bq = blockIdx.z * hq + blockIdx.y;
  const int bkv = blockIdx.z * hkv + blockIdx.y / (hq / hkv);
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;

  // the CTA loads the tiles any of its rows below sq can see; each
  // warpgroup computes on the tiles its own 64 rows can see
  const int r_wg = i0 + wg * kWgRows;
  const bool wg_rows = r_wg < sq;
  int lo, hi, my_lo, my_hi;
  kv_tiles(i0, min(i0 + kWgBQ, sq), skv, causal, window, lo, hi);
  kv_tiles(r_wg, min(r_wg + kWgRows, sq), skv, causal, window, my_lo, my_hi);
  const int n_tiles = hi - lo + 1;

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 1 + kStages; ++i) hopper::mbar_init(&bars[i], 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    hopper::mbar_arrive_expect_tx(&bars[0], S::kQ);
#pragma unroll
    for (int p = 0; p < P; ++p)
      hopper::tma_load_3d(qs + p * S::kQPiece, &tq, &bars[0], 64 * p, i0, bq);
    for (int n = 0; n < kStages - 1 && n < n_tiles; ++n)
      load_kv<D>(smem, bars, &tk, &tv, n, lo + n, bkv);
  }
  __syncwarp();

  // accumulator fragment (i, c, e) of register 4c + 2i + e: row
  // 16 warp + lane / 4 + 8i of the warpgroup's 64, column 8c + 2 (lane % 4) + e
  float oacc[P][32];
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int r = 0; r < 32; ++r) oacc[p][r] = 0.0f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};
  const int row0 = r_wg + warp * 16 + lane / 4;
  const int col0 = 2 * (lane % 4);
  hopper::mbar_wait(&bars[0], 0);

  for (int n = 0; n < n_tiles; ++n) {
    // the stage tile n + 1 goes into held tile n - 1, which every thread
    // finished with before the barrier that closed the last iteration
    if (tid == 0 && n + kStages - 1 < n_tiles)
      load_kv<D>(smem, bars, &tk, &tv, n + kStages - 1, lo + n + kStages - 1, bkv);
    __syncwarp();
    hopper::mbar_wait(&bars[1 + n % kStages], (n / kStages) & 1);
    const int jt = lo + n;
    if (wg_rows && jt >= my_lo && jt <= my_hi) {
      const uint8_t* ks = smem + S::kQ + (n % kStages) * S::kStage;
      const uint8_t* vs = ks + P * S::kKVPiece;

      // S = Q K^T over D / 16 k16 steps, 4 per 64-column piece
      float sacc[32];
#pragma unroll
      for (int r = 0; r < 32; ++r) sacc[r] = 0.0f;
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint64_t da = hopper::desc_sw128(qs + (kk / 4) * S::kQPiece +
                                               wg * kWgRows * 128 + (kk % 4) * 32);
        const uint64_t db = hopper::desc_sw128(ks + (kk / 4) * S::kKVPiece + (kk % 4) * 32);
        hopper::wgmma_m64n64k16_ss(sacc, da, db);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
      hopper::fence_regs(sacc);

      // mask (a tile inside the band of all 64 rows needs none), then the
      // online softmax of each of the thread's two rows; a row's 64 columns
      // live on the 4 lanes of one quad
      const int j0 = jt * kBK;
      float mc[2] = {kNegInf, kNegInf};
      const bool inside = j0 + kBK <= skv && (!causal || j0 + kBK - 1 <= r_wg) &&
                          (window <= 0 || j0 > r_wg + kWgRows - 1 - window);
      if (inside) {
#pragma unroll
        for (int r = 0; r < 32; ++r) {
          sacc[r] *= scale_log2;
          mc[(r / 2) % 2] = fmaxf(mc[(r / 2) % 2], sacc[r]);
        }
      } else {
#pragma unroll
        for (int c = 0; c < 8; ++c)
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int row = row0 + 8 * i;
              const int col = j0 + 8 * c + col0 + e;
              bool keep = col < skv;
              if (causal) keep = keep && col <= row;
              if (window > 0) keep = keep && col > row - window;
              float& x = sacc[4 * c + 2 * i + e];
              x = keep ? x * scale_log2 : kNegInf;
              mc[i] = fmaxf(mc[i], x);
            }
      }
      float alpha[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mc[i] = fmaxf(mc[i], __shfl_xor_sync(0xffffffffu, mc[i], 1));
        mc[i] = fmaxf(mc[i], __shfl_xor_sync(0xffffffffu, mc[i], 2));
        const float m_new = fmaxf(m[i], mc[i]);
        alpha[i] = ex2(m[i] - m_new);
        m[i] = m_new;
      }
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        sacc[r] = ex2(sacc[r] - m[(r / 2) % 2]);
        rs[(r / 2) % 2] += sacc[r];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
        rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
        l[i] = l[i] * alpha[i] + rs[i];
      }
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int r = 0; r < 32; ++r) oacc[p][r] *= alpha[(r / 2) % 2];

      // O += P V with P = P_hi + P_lo, two bf16 parts: k16 step kk takes P's
      // columns 16kk..16kk+15, which are the registers 8kk..8kk+7 of the
      // score fragments, in order
      uint32_t p_hi[4][4], p_lo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          split_bf16(sacc[8 * kk + 2 * r], sacc[8 * kk + 2 * r + 1], p_hi[kk][r],
                     p_lo[kk][r]);
#pragma unroll
      for (int p = 0; p < P; ++p) hopper::fence_regs(oacc[p]);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const uint64_t dv = hopper::desc_sw128(vs + p * S::kKVPiece + kk * 16 * 128);
          hopper::wgmma_m64n64k16_rs_tb(oacc[p], p_hi[kk], dv);
          hopper::wgmma_m64n64k16_rs_tb(oacc[p], p_lo[kk], dv);
        }
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
#pragma unroll
      for (int p = 0; p < P; ++p) hopper::fence_regs(oacc[p]);
    }
    __syncthreads();  // both warpgroups are done with this stage
  }

  if (!wg_rows) return;
  bf16* ob = o + static_cast<int64_t>(bq) * sq * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= sq) continue;
    const float den = l[i] > 0.0f ? l[i] : 1.0f;
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const __nv_bfloat162 v2 = __floats2bfloat162_rn(oacc[p][4 * c + 2 * i] / den,
                                                        oacc[p][4 * c + 2 * i + 1] / den);
        *reinterpret_cast<__nv_bfloat162*>(ob + static_cast<int64_t>(row) * D + 64 * p +
                                           8 * c + col0) = v2;
      }
  }
  if (lse != nullptr && lane % 4 == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;
      if (row < sq)
        lse[static_cast<int64_t>(bq) * sq + row] =
            (m[i] + log2f(l[i] > 0.0f ? l[i] : 1.0f)) * 0.6931471805599453f;
    }
  }
}

template <int D>
cudaError_t launch_flash_wgmma(const void* q, const void* k, const void* v, void* o,
                               float* lse, int batch, int hq, int hkv, int sq, int skv, float scale,
                               int causal, int window, cudaStream_t stream) {
  // the runtime call first: it makes the thread's context current, which
  // the driver's tensor-map encoding needs (a thread's first CUDA work, as
  // on autograd's worker thread, has none before it)
  const size_t smem = WgSmem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(flash_attn_wgmma_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, batch * hq, sq, D, kWgBQ) ||
      !make_map(&tk, k, batch * hkv, skv, D, kBK) ||
      !make_map(&tv, v, batch * hkv, skv, D, kBK))
    return cudaErrorInvalidValue;
  const dim3 grid((sq + kWgBQ - 1) / kWgBQ, hq, batch);
  flash_attn_wgmma_kernel<D><<<grid, kWgThreads, smem, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), lse, hq, hkv, sq, skv, scale * kLog2e, causal,
      window);
  return cudaGetLastError();
}

}  // namespace repro_torch

// q (B, Hq, Sq, D), k and v (B, Hkv, Skv, D), o like q: contiguous, one
// dtype (code 0 f32, 3 bf16), D 64, 128 or 256 in bf16 and 16, 64 or 128 in
// f32, Hq a multiple of Hkv; lse (B, Hq, Sq) f32 or null.
extern "C" int flash_attn_launch(const void* q, const void* k, const void* v,
                                 void* o, void* lse_out, int dtype, int batch, int hq,
                                 int hkv, int sq, int skv, int head_dim,
                                 float scale, int causal, int window,
                                 void* stream) {
  using namespace repro_torch;
  if (batch <= 0 || hq <= 0 || sq <= 0) return static_cast<int>(cudaGetLastError());
  const auto st = static_cast<cudaStream_t>(stream);
  float* lse = static_cast<float*>(lse_out);
  if (dtype == kDtypeBF16 && head_dim == 64)
    return launch_flash_wgmma<64>(q, k, v, o, lse, batch, hq, hkv, sq, skv, scale, causal, window, st);
  if (dtype == kDtypeBF16 && head_dim == 128)
    return launch_flash_wgmma<128>(q, k, v, o, lse, batch, hq, hkv, sq, skv, scale, causal, window, st);
  if (dtype == kDtypeBF16 && head_dim == 256)
    return launch_flash_wgmma<256>(q, k, v, o, lse, batch, hq, hkv, sq, skv, scale, causal, window, st);
  if (dtype == kDtypeF32 && head_dim == 16)
    return launch_flash<float, 16>(q, k, v, o, lse, batch, hq, hkv, sq, skv, scale, causal, window, st);
  if (dtype == kDtypeF32 && head_dim == 64)
    return launch_flash<float, 64>(q, k, v, o, lse, batch, hq, hkv, sq, skv, scale, causal, window, st);
  if (dtype == kDtypeF32 && head_dim == 128)
    return launch_flash<float, 128>(q, k, v, o, lse, batch, hq, hkv, sq, skv, scale, causal, window, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_attn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
