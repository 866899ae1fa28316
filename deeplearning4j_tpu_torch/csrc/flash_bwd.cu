// Flash-attention backward for Hopper, sm_90a: dQ (K2) and dK/dV (K3).
//
// Replaces the Pallas TPU kernels deeplearning4j_tpu/attention/flash_pallas.py
// `_bwd_dq_kernel` (:312) and `_bwd_dkv_kernel` (:375), both launched by
// `_flash_backward` (:439). With P rebuilt from the forward's saved row
// log-sum-exp instead of stored:
//
//   S  = Q K^T * scale * log2(e)        (float32 accumulation; scale 1/sqrt(d))
//   P  = exp2(S - lse * log2(e))        (0 where masked)
//   dP = dO V^T
//   dS = P * (dP - D)                   (D = rowsum(dO * O) - g_lse, given)
//   dQ = sum over key tiles of  round(dS) K * scale          (K2)
//   dV = sum over query tiles of round(P)^T dO               (K3)
//   dK = (sum over query tiles of round(dS)^T Q) * scale     (K3)
//
// where round() is the cast to the inputs' dtype that the TPU kernels make
// before each second product (:357-359, :413-416, :420-422). Causal masking
// is bottom-right aligned (query i sees keys up to i + Tk - Tq); a row whose
// lse is the +1e30 sentinel (it saw no key) gets P = 0 and so exactly zero
// gradient.
//
// What bounds it on the H100: at the training shape (B*H 64, T 1024, hd 128,
// causal, bf16) K2 moves q, k, v, dO, dQ (bf16) and lse, D (float32) once,
// 84 MB, 25 us at 3.35 TB/s, and does 6*hd operations per visible pair,
// 26 GFLOP, 26 us at 989 TFLOP/s; K3 writes dK and dV as well and does 8*hd
// per pair (100.7 MB, 30 us; 34.4 GFLOP, 35 us). Both sit at the ridge, so
// every product has to run on the tensor cores, with the tile stream
// overlapping them.
//
// K2, bf16 (`flash_bwd_dq_kernel_wgmma`): K3's tools with the roles of Q
// and K/V swapped. A block of kDqWgs consumer warpgroups, each 64 query
// rows with its Q and dO tiles resident in shared memory and its rows'
// lse*log2(e) and D in registers; blocks start with the last rows, which
// walk the most key tiles under causal masking. kDqWgs is 1: at the
// training shape (B*H 64, T 1024, hd 128, causal) one warpgroup a block
// (96 KB of shared memory, 196 registers, so two blocks share an SM and
// one's softmax overlaps the other's products) ran 0.148 ms against
// 0.159 ms for K1's two warpgroups sharing each K/V tile (one block an
// SM), measured in one chip_smoke.py call on one H100. Per 64-key tile:
// - S = Q K^T and dP = dO V^T: wgmma m64n64k16, both operands K-major in
//   shared memory (K1's pairing);
// - P and dS on the accumulators in registers (`p_and_ds`); the rows of
//   the accumulator are query rows and its columns keys, so dS rounded
//   to bf16 pairwise is already the register A operand of
// - dQ += round(dS) K: wgmma m64n{hd}k16, K read MN-major (the layout K3
//   reads dO with for dV += P^T dO);
// - K and V of the next tile land by cp.async in a 2-stage ring while
//   this one is multiplied;
// - scale is applied to dQ once at the end, as the plain version does
//   (attention/flash.py), where the scalar float32 kernel scales each
//   tile's part before adding it. Only the rounding point differs, well
//   inside the bf16 tolerance. dQ leaves through the warpgroup's Q tile
//   as coalesced
//   16-byte stores.
// At hd 128 a thread holds dQ (64 registers), S and dP (64) and the dS
// fragment (16), no spill.
//
// K3, bf16 (`flash_bwd_dkv_kernel_wgmma`): one warpgroup per 64 keys (its
// K/V tile resident in shared memory), walking 64-row Q tiles from the
// first one that can see its keys. Every product is transposed so that its
// A operand is K or V in shared memory or a tile already in registers, and
// nothing is transposed through shared memory:
// - S^T = K Q^T and dP^T = V dO^T: wgmma m64n64k16, both operands K-major
//   in shared memory (hopper.cuh's swizzled tiles);
// - P^T and dS^T on the accumulators in registers, with the
//   __fmul_rn/__fsub_rn order of `p_and_ds`;
// - dV += round(P^T) dO and dK += round(dS^T) Q: wgmma m64n{hd}k16 with A
//   in registers (the accumulator fragment, rounded to bf16 pairwise) and
//   B the dO or Q tile read MN-major (the transpose bit);
// - Q, dO, lse and D of the next Q tile land by cp.async in a 2-stage ring
//   while this one is multiplied;
// - scale is applied to dK once at the end, as the plain version does
//   (attention/flash.py), not per tile; dK and dV leave through shared
//   memory as coalesced 16-byte stores.
// The dK and dV accumulators take 128 registers a thread at hd 128, S^T
// and dP^T 64 more, so one warpgroup holds 64 keys and the block stays at
// 128 threads. Left for later: TMA loads, warp specialisation (a producer
// warp, the consumers' registers raised), persistent blocks.
//
// The float32 lanes of K2 (`flash_bwd_dq_kernel`) and K3
// (`flash_bwd_dkv_kernel`) are the scalar first versions: every product
// as float32 FMAs on the CUDA cores, float32 tiles in shared memory padded
// by one word so the column-strided reads of the score phase hit distinct
// banks (149 KB for K2 and 166 KB for K3 at hd 128). Tensor cores would
// mean TF32 for float32, too coarse for the float32 parity checks.
//
// Shared by every version:
// - K2: one block per (batch*head, 64-row Q tile), looping over 64-row
//   K/V tiles up to the diagonal; K3: one block per (batch*head, 64-row K/V
//   tile), looping over Q tiles from the first one that can see it. The
//   loop takes the place of the TPU's sequential grid axis. Two kernels, so
//   dQ needs no atomics and both outputs are the same run to run;
// - only tiles that cross the diagonal or a ragged T edge compute a mask,
//   so every Tq and Tk runs here (the TPU sent T without a 128-aligned tile
//   to the blockwise vjp).
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace dl4j;
namespace hw = dl4j::hopper;

constexpr int kBlockM = 64;  // query rows per Q tile
constexpr int kBlockN = 64;  // key rows per K/V tile
constexpr int kThreads = 256;
constexpr int kSS = kBlockN + 1;  // padded row stride of a P or dS tile

template <int HD>
constexpr size_t dq_smem_bytes() {  // Q, dO, K, V tiles; dS; lse2, D
  return sizeof(float) * (2 * kBlockM * (HD + 1) + 2 * kBlockN * (HD + 1) +
                          kBlockM * kSS + 2 * kBlockM);
}

template <int HD>
constexpr size_t dkv_smem_bytes() {  // K, V, Q, dO tiles; P, dS; lse2, D
  return sizeof(float) * (2 * kBlockM * (HD + 1) + 2 * kBlockN * (HD + 1) +
                          2 * kBlockM * kSS + 2 * kBlockM);
}

// rows [r0, r0 + 64) of a (n, HD) matrix into a float tile of row stride
// HD + 1, zeros past row n
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0,
                                          int n) {
  for (int i = threadIdx.x; i < 64 * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    dst[r * (HD + 1) + d] =
        (r0 + r < n) ? to_f32(src[(size_t)(r0 + r) * HD + d]) : 0.f;
  }
}

// lse * log2(e) and D of query rows [q0, q0 + 64); rows past tq are masked
// by the caller and get zeros
__device__ __forceinline__ void load_rows(float* lse2_s, float* dd_s,
                                          const float* lse, const float* dd,
                                          int q0, int tq) {
  for (int r = threadIdx.x; r < kBlockM; r += kThreads) {
    const bool in = q0 + r < tq;
    lse2_s[r] = in ? lse[q0 + r] * kLog2e : 0.f;
    dd_s[r] = in ? dd[q0 + r] : 0.f;
  }
}

// S = Q K^T and dP = dO V^T for the 64 x 64 tile pair: a 16 x 16 thread
// grid, each thread 4 query rows (ty*4 + i) x 4 key rows (tx + 16*j), key
// rows strided by 16 so a warp's K and V reads spread over the banks
template <int HD>
__device__ __forceinline__ void scores_and_dp(const float* qs,
                                              const float* dos,
                                              const float* ks,
                                              const float* vs, int ty, int tx,
                                              float s[4][4], float dp[4][4]) {
  constexpr int QS = HD + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float a[4], b[4], c[4], e[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = qs[(ty * 4 + i) * QS + d];
      c[i] = dos[(ty * 4 + i) * QS + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      b[j] = ks[(tx + 16 * j) * QS + d];
      e[j] = vs[(tx + 16 * j) * QS + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(a[i], b[j], s[i][j]);
        dp[i][j] = fmaf(c[i], e[j], dp[i][j]);
      }
  }
}

// P and dS of one score; `ok` false gives P = dS = 0. The products are
// rounded one at a time (no FMA contraction), as the TPU kernel computes
// s * (scale * log2e) - lse * log2e.
__device__ __forceinline__ void p_and_ds(float s, float dp, float lse2,
                                         float dd, float scale2, bool ok,
                                         float* p, float* ds) {
  *p = ok ? exp2f(__fsub_rn(__fmul_rn(s, scale2), lse2)) : 0.f;
  *ds = *p * (dp - dd);
}

// true where the tile pair (q0, k0) needs a mask: it crosses the ragged
// edge of Q or K, or the causal diagonal
__device__ __forceinline__ bool tile_masked(int q0, int k0, int tq, int tk,
                                            int causal, int offset) {
  return (q0 + kBlockM > tq) || (k0 + kBlockN > tk) ||
         (causal && k0 + kBlockN - 1 > q0 + offset);
}

__device__ __forceinline__ bool visible(int qp, int kp, int tq, int tk,
                                        int causal, int offset) {
  return qp < tq && kp < tk && (!causal || kp <= qp + offset);
}

// ------------------------------------------------------------ K2: dQ
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ dd, T* __restrict__ dq,
                        int tq, int tk, int causal, float scale,
                        float scale2) {
  constexpr int QS = HD + 1;
  constexpr int NACC = HD / 4;  // dQ columns per thread
  extern __shared__ float smem[];
  float* qs = smem;               // kBlockM x QS
  float* dos = qs + kBlockM * QS;  // kBlockM x QS
  float* ks = dos + kBlockM * QS;  // kBlockN x QS
  float* vs = ks + kBlockN * QS;   // kBlockN x QS
  float* dss = vs + kBlockN * QS;  // kBlockM x kSS, dS rounded to T
  float* lse2_s = dss + kBlockM * kSS;
  float* dd_s = lse2_s + kBlockM;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBlockM;
  const int tid = threadIdx.x;
  const int offset = tk - tq;  // causal offset, bottom-right alignment
  const T* kb = k + (size_t)bh * tk * HD;
  const T* vb = v + (size_t)bh * tk * HD;

  load_tile<T, HD>(qs, q + (size_t)bh * tq * HD, q0, tq);
  load_tile<T, HD>(dos, dout + (size_t)bh * tq * HD, q0, tq);
  load_rows(lse2_s, dd_s, lse + (size_t)bh * tq, dd + (size_t)bh * tq, q0,
            tq);

  const int ty = tid / 16, tx = tid % 16;   // score phase
  const int row = tid / 4, sub = tid % 4;   // dQ phase: 4 threads a row
  float acc[NACC];
#pragma unroll
  for (int j = 0; j < NACC; ++j) acc[j] = 0.f;

  // key tiles wholly above the diagonal are skipped
  const int k_end = causal ? min(tk, q0 + kBlockM + offset) : tk;
  for (int k0 = 0; k0 < k_end; k0 += kBlockN) {
    __syncthreads();  // the previous tile's reads of ks, vs and dss are done
    load_tile<T, HD>(ks, kb, k0, tk);
    load_tile<T, HD>(vs, vb, k0, tk);
    __syncthreads();

    float s[4][4], dp[4][4];
    scores_and_dp<HD>(qs, dos, ks, vs, ty, tx, s, dp);
    const bool masked = tile_masked(q0, k0, tq, tk, causal, offset);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty * 4 + i, c = tx + 16 * j;
        const bool ok =
            !masked || visible(q0 + r, k0 + c, tq, tk, causal, offset);
        float p, ds;
        p_and_ds(s[i][j], dp[i][j], lse2_s[r], dd_s[r], scale2, ok, &p, &ds);
        dss[r * kSS + c] = round_to<T>(ds);
      }
    }
    __syncthreads();

    float part[NACC];
#pragma unroll
    for (int j = 0; j < NACC; ++j) part[j] = 0.f;
    for (int n = 0; n < kBlockN; ++n) {
      const float g = dss[row * kSS + n];
      const float* kr = ks + n * QS + sub;
#pragma unroll
      for (int j = 0; j < NACC; ++j) part[j] = fmaf(g, kr[4 * j], part[j]);
    }
#pragma unroll
    for (int j = 0; j < NACC; ++j)
      acc[j] = __fadd_rn(acc[j], __fmul_rn(part[j], scale));
  }

  if (q0 + row < tq) {
    T* orow = dq + ((size_t)bh * tq + q0 + row) * HD + sub;
#pragma unroll
    for (int j = 0; j < NACC; ++j) orow[4 * j] = from_f32<T>(acc[j]);
  }
}

// ---------------------------------------------- K2 bf16: dQ on wgmma
constexpr int kDqWgs = 1;                 // consumer warpgroups per block
constexpr int kDqThreads = 128 * kDqWgs;
constexpr int kDqRows = kBlockM * kDqWgs;  // query rows per block

template <int HD>
constexpr size_t dq_wgmma_smem_bytes() {
  // Q and dO of each warpgroup; 2 stages of (K, V); alignment slack
  return (2 * kDqWgs + 4) * hw::tile_bytes<HD>() + 1024;
}

template <int HD>
__global__ void __launch_bounds__(kDqThreads, 1)
    flash_bwd_dq_kernel_wgmma(
        const hw::bf16* __restrict__ q, const hw::bf16* __restrict__ k,
        const hw::bf16* __restrict__ v, const hw::bf16* __restrict__ dout,
        const float* __restrict__ lse, const float* __restrict__ dd,
        hw::bf16* __restrict__ dq, int tq, int tk, int causal, float scale,
        float scale2) {
  constexpr uint32_t kTile = hw::tile_bytes<HD>();
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hw::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);  // generic pointer to `base`
  const uint32_t sq = base;                    // warpgroup w's Q: + w * kTile
  const uint32_t sdo = base + kDqWgs * kTile;  // w's dO: + w * kTile
  // ring stage s: K at + 2s tiles, V at + 2s + 1
  const uint32_t skv = base + 2 * kDqWgs * kTile;

  const int tid = threadIdx.x;
  const int wg = tid / 128, wtid = tid % 128;
  const int warp = wtid / 32, lane = tid % 32;
  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kDqRows;
  const int q0w = q0 + wg * kBlockM;  // this warpgroup's first row
  const int offset = tk - tq;         // causal offset, bottom-right
  const hw::bf16* qb = q + (size_t)bh * tq * HD;
  const hw::bf16* dob = dout + (size_t)bh * tq * HD;
  const hw::bf16* kb = k + (size_t)bh * tk * HD;
  const hw::bf16* vb = v + (size_t)bh * tk * HD;

  // keys the block may see, and this warpgroup's share of them (none for
  // a warpgroup wholly past Tq); key tiles wholly above the diagonal are
  // skipped, and a block whose rows see no key (causal Tq > Tk) runs no
  // tile and stores zeros
  const int k_end = causal ? min(tk, q0 + kDqRows + offset) : tk;
  const int n_tiles = k_end > 0 ? (k_end + kBlockN - 1) / kBlockN : 0;
  const int wg_end =
      q0w >= tq ? 0 : causal ? min(tk, q0w + kBlockM + offset) : tk;

#pragma unroll
  for (int w = 0; w < kDqWgs; ++w) {
    hw::load_tile<HD, kDqThreads>(sq + w * kTile, qb, q0 + w * kBlockM, tq,
                                  tid);
    hw::load_tile<HD, kDqThreads>(sdo + w * kTile, dob, q0 + w * kBlockM,
                                  tq, tid);
  }
  if (n_tiles > 0) {
    hw::load_tile<HD, kDqThreads>(skv, kb, 0, tk, tid);
    hw::load_tile<HD, kDqThreads>(skv + kTile, vb, 0, tk, tid);
  }
  hw::cp_async_commit();

  // rows r_a = q0w + 16 warp + lane/4 (h 0) and r_a + 8 (h 1), the
  // accumulator's rows; their lse * log2(e) and D once, 0 past Tq (those
  // rows are masked by `visible`, not by the sentinel)
  const int r_a = q0w + warp * 16 + lane / 4;
  const int col = 2 * (lane % 4);
  const float* lseb = lse + (size_t)bh * tq;
  const float* ddb = dd + (size_t)bh * tq;
  float lse2[2], d_row[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r_a + 8 * h;
    lse2[h] = r < tq ? __fmul_rn(lseb[r], kLog2e) : 0.f;
    d_row[h] = r < tq ? ddb[r] : 0.f;
  }
  float dqa[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dqa[i] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kBlockN;
    const uint32_t sk = skv + (it & 1) * 2 * kTile, sv = sk + kTile;
    if (it + 1 < n_tiles) {  // the next tile into the other stage
      const uint32_t nk = skv + ((it + 1) & 1) * 2 * kTile;
      hw::load_tile<HD, kDqThreads>(nk, kb, k0 + kBlockN, tk, tid);
      hw::load_tile<HD, kDqThreads>(nk + kTile, vb, k0 + kBlockN, tk, tid);
      hw::cp_async_commit();
      hw::cp_async_wait<1>();
    } else {
      hw::cp_async_wait<0>();
    }
    __syncthreads();

    if (k0 < wg_end) {
      float s[32] = {}, dp[32] = {};
      hw::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        hw::wgmma_ss_m64n64(s, hw::desc_k(sq + wg * kTile, kk),
                            hw::desc_k(sk, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        hw::wgmma_ss_m64n64(dp, hw::desc_k(sdo + wg * kTile, kk),
                            hw::desc_k(sv, kk), kk > 0);
      hw::wgmma_commit();
      hw::wgmma_wait<0>();
      hw::fence_regs(s);
      hw::fence_regs(dp);

      const bool masked = tile_masked(q0w, k0, tq, tk, causal, offset);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * h + e;
            const bool ok =
                !masked || visible(r_a + 8 * h, k0 + 8 * j + col + e, tq,
                                   tk, causal, offset);
            p_and_ds(s[i], dp[i], lse2[h], d_row[h], scale2, ok, &s[i],
                     &dp[i]);
          }
      uint32_t da[4][4];  // dS rounded to bf16, the A operand of dS K
      hw::to_a(dp, da);
      hw::fence_regs(dqa);
      hw::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hw::wgmma_rs<HD>(dqa, da[kk], hw::desc_mn(sk, kk));
      hw::wgmma_commit();
      hw::wgmma_wait<0>();
      hw::fence_regs(dqa);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) hw::fence_regs(da[kk]);
    }
    __syncthreads();  // every read of this stage is done before its refill
  }
  hw::cp_async_wait<0>();  // Q/dO copies still in flight when n_tiles == 0
  __syncthreads();

#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dqa[i] *= scale;
  // this warpgroup's Q tile is free once its last product is done
  hw::store_tile<HD>(dqa, smem + wg * kTile,
                     dq + ((size_t)bh * tq + q0w) * HD, tq - q0w, wtid, wg);
}

// ------------------------------------------- K3 bf16: dK, dV on wgmma
constexpr int kDkvThreads = 128;  // one warpgroup per 64 keys

template <int HD>
constexpr size_t dkv_wgmma_smem_bytes() {
  // K, V; 2 stages of (Q, dO); 2 stages of (lse, D) rows; alignment slack
  return 6 * hw::tile_bytes<HD>() + 2 * 2 * kBlockM * sizeof(float) + 1024;
}

template <int HD>
__global__ void __launch_bounds__(kDkvThreads, 1)
    flash_bwd_dkv_kernel_wgmma(
        const hw::bf16* __restrict__ q, const hw::bf16* __restrict__ k,
        const hw::bf16* __restrict__ v, const hw::bf16* __restrict__ dout,
        const float* __restrict__ lse, const float* __restrict__ dd,
        hw::bf16* __restrict__ dk, hw::bf16* __restrict__ dv, int tq, int tk,
        int causal, float scale, float scale2) {
  constexpr uint32_t kTile = hw::tile_bytes<HD>();
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hw::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);  // generic pointer to `base`
  const uint32_t sk = base, sv = base + kTile;
  const uint32_t sqd = base + 2 * kTile;  // stage s: Q + 2s, dO + 2s + 1
  // stage s: lse at rows + 2s * kBlockM, D at rows + (2s + 1) * kBlockM
  const uint32_t srows = base + 6 * kTile;
  const float* rows = reinterpret_cast<const float*>(smem + 6 * kTile);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kBlockN;
  const int offset = tk - tq;
  const hw::bf16* qb = q + (size_t)bh * tq * HD;
  const hw::bf16* dob = dout + (size_t)bh * tq * HD;
  const float* lseb = lse + (size_t)bh * tq;
  const float* ddb = dd + (size_t)bh * tq;

  // the first query row that sees key k0 is k0 - offset: Q tiles before
  // its tile see none of this K/V tile and are skipped
  const int q_begin = causal ? max(0, k0 - offset) / kBlockM * kBlockM : 0;
  const int n_tiles = q_begin < tq ? (tq - q_begin + kBlockM - 1) / kBlockM
                                   : 0;
  // Q, dO, lse and D of the query rows [q0, q0 + 64) into stage `st`
  auto load_q_tile = [&](int st, int q0) {
    hw::load_tile<HD, kDkvThreads>(sqd + 2 * st * kTile, qb, q0, tq, tid);
    hw::load_tile<HD, kDkvThreads>(sqd + (2 * st + 1) * kTile, dob, q0, tq,
                                   tid);
    const int r = tid % kBlockM, which = tid / kBlockM;  // 0 lse, 1 D
    const bool in = q0 + r < tq;
    hw::cp_async4(srows + ((2 * st + which) * kBlockM + r) * 4,
                  (which ? ddb : lseb) + (in ? q0 + r : 0), in);
  };

  hw::load_tile<HD, kDkvThreads>(sk, k + (size_t)bh * tk * HD, k0, tk, tid);
  hw::load_tile<HD, kDkvThreads>(sv, v + (size_t)bh * tk * HD, k0, tk, tid);
  if (n_tiles > 0) load_q_tile(0, q_begin);
  hw::cp_async_commit();

  // key rows kr (h 0) and kr + 8 (h 1); query columns 8j + col + e
  const int kr = k0 + warp * 16 + lane / 4;
  const int col = 2 * (lane % 4);
  float dka[HD / 2], dva[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dka[i] = dva[i] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int q0 = q_begin + it * kBlockM;
    const int st = it & 1;
    if (it + 1 < n_tiles) {  // the next Q tile into the other stage
      load_q_tile(st ^ 1, q0 + kBlockM);
      hw::cp_async_commit();
      hw::cp_async_wait<1>();
    } else {
      hw::cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t sq = sqd + 2 * st * kTile, sdo = sq + kTile;
    const float* lse_s = rows + 2 * st * kBlockM;
    const float* dd_s = lse_s + kBlockM;

    float s[32] = {}, dp[32] = {};
    hw::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      hw::wgmma_ss_m64n64(s, hw::desc_k(sk, kk), hw::desc_k(sq, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      hw::wgmma_ss_m64n64(dp, hw::desc_k(sv, kk), hw::desc_k(sdo, kk),
                          kk > 0);
    hw::wgmma_commit();
    hw::wgmma_wait<0>();
    hw::fence_regs(s);
    hw::fence_regs(dp);

    const bool masked = tile_masked(q0, k0, tq, tk, causal, offset);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * h + e, c = 8 * j + col + e;
          const bool ok =
              !masked || visible(q0 + c, kr + 8 * h, tq, tk, causal, offset);
          p_and_ds(s[i], dp[i], __fmul_rn(lse_s[c], kLog2e), dd_s[c], scale2,
                   ok, &s[i], &dp[i]);
        }
    uint32_t pa[4][4], da[4][4];  // P^T and dS^T rounded to bf16
    hw::to_a(s, pa);
    hw::to_a(dp, da);
    hw::fence_regs(dva);
    hw::fence_regs(dka);
    hw::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hw::wgmma_rs<HD>(dva, pa[kk], hw::desc_mn(sdo, kk));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hw::wgmma_rs<HD>(dka, da[kk], hw::desc_mn(sq, kk));
    hw::wgmma_commit();
    hw::wgmma_wait<0>();
    hw::fence_regs(dva);
    hw::fence_regs(dka);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      hw::fence_regs(pa[kk]);
      hw::fence_regs(da[kk]);
    }
    __syncthreads();  // every read of this stage is done before its refill
  }
  hw::cp_async_wait<0>();  // K/V copies still in flight when n_tiles == 0
  __syncthreads();

#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dka[i] *= scale;
  // stage 0's Q and dO tiles are free: dK and dV leave through them
  const size_t o = ((size_t)bh * tk + k0) * HD;
  hw::store_tile<HD>(dka, smem + 2 * kTile, dk + o, tk - k0, tid, 0);
  hw::store_tile<HD>(dva, smem + 3 * kTile, dv + o, tk - k0, tid, 0);
}

// ------------------------------------------- K3 float32: dK, dV
template <int HD>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ dd, float* __restrict__ dk,
                         float* __restrict__ dv, int tq, int tk, int causal,
                         float scale, float scale2) {
  constexpr int QS = HD + 1;
  constexpr int NACC = HD / 4;  // dK and dV columns per thread
  extern __shared__ float smem[];
  float* ks = smem;                // kBlockN x QS
  float* vs = ks + kBlockN * QS;   // kBlockN x QS
  float* qs = vs + kBlockN * QS;   // kBlockM x QS
  float* dos = qs + kBlockM * QS;  // kBlockM x QS
  float* ps = dos + kBlockM * QS;  // kBlockM x kSS, P
  float* dss = ps + kBlockM * kSS;  // kBlockM x kSS, dS
  float* lse2_s = dss + kBlockM * kSS;
  float* dd_s = lse2_s + kBlockM;

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kBlockN;
  const int tid = threadIdx.x;
  const int offset = tk - tq;
  const float* qb = q + (size_t)bh * tq * HD;
  const float* dob = dout + (size_t)bh * tq * HD;
  const float* lseb = lse + (size_t)bh * tq;
  const float* ddb = dd + (size_t)bh * tq;

  load_tile<float, HD>(ks, k + (size_t)bh * tk * HD, k0, tk);
  load_tile<float, HD>(vs, v + (size_t)bh * tk * HD, k0, tk);

  const int ty = tid / 16, tx = tid % 16;  // score phase
  const int kr = tid / 4, sub = tid % 4;   // dK/dV phase: 4 threads a key
  float dk_acc[NACC], dv_acc[NACC];
#pragma unroll
  for (int j = 0; j < NACC; ++j) dk_acc[j] = dv_acc[j] = 0.f;

  // the first query row that sees key k0 is k0 - offset: Q tiles before
  // its tile see none of this K/V tile and are skipped
  const int q_begin = causal ? max(0, k0 - offset) / kBlockM * kBlockM : 0;
  for (int q0 = q_begin; q0 < tq; q0 += kBlockM) {
    __syncthreads();  // the previous tile's reads of qs, dos, ps, dss done
    load_tile<float, HD>(qs, qb, q0, tq);
    load_tile<float, HD>(dos, dob, q0, tq);
    load_rows(lse2_s, dd_s, lseb, ddb, q0, tq);
    __syncthreads();

    float s[4][4], dp[4][4];
    scores_and_dp<HD>(qs, dos, ks, vs, ty, tx, s, dp);
    const bool masked = tile_masked(q0, k0, tq, tk, causal, offset);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty * 4 + i, c = tx + 16 * j;
        const bool ok =
            !masked || visible(q0 + r, k0 + c, tq, tk, causal, offset);
        float p, ds;
        p_and_ds(s[i][j], dp[i][j], lse2_s[r], dd_s[r], scale2, ok, &p, &ds);
        ps[r * kSS + c] = p;
        dss[r * kSS + c] = ds;
      }
    }
    __syncthreads();

    float part[NACC];
#pragma unroll
    for (int j = 0; j < NACC; ++j) part[j] = 0.f;
    for (int r = 0; r < kBlockM; ++r) {
      const float p = ps[r * kSS + kr];
      const float g = dss[r * kSS + kr];
      const float* dor = dos + r * QS + sub;
      const float* qr = qs + r * QS + sub;
#pragma unroll
      for (int j = 0; j < NACC; ++j) {
        dv_acc[j] = fmaf(p, dor[4 * j], dv_acc[j]);
        part[j] = fmaf(g, qr[4 * j], part[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < NACC; ++j)
      dk_acc[j] = __fadd_rn(dk_acc[j], __fmul_rn(part[j], scale));
  }

  if (k0 + kr < tk) {
    const size_t o = ((size_t)bh * tk + k0 + kr) * HD + sub;
#pragma unroll
    for (int j = 0; j < NACC; ++j) {
      dk[o + 4 * j] = dk_acc[j];
      dv[o + 4 * j] = dv_acc[j];
    }
  }
}

// scale = 1/sqrt(d) and scale * log2(e), each rounded to float32 as the
// TPU kernel (and the plain version) computes them
inline void scales(int hd, float* scale, float* scale2) {
  *scale = 1.f / sqrtf((float)hd);
  *scale2 = *scale * kLog2e;
}

template <typename T, int HD>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* dd,
                      void* dq, int bh, int tq, int tk, int causal,
                      cudaStream_t stream) {
  const size_t smem = dq_smem_bytes<HD>();
  auto kern = flash_bwd_dq_kernel<T, HD>;
  static std::atomic<unsigned long long> smem_set{0};
  cudaError_t err = set_max_smem_once(kern, (int)smem, smem_set);
  if (err != cudaSuccess) return err;
  float scale, scale2;
  scales(HD, &scale, &scale2);
  const dim3 grid((tq + kBlockM - 1) / kBlockM, bh);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dd),
      static_cast<T*>(dq), tq, tk, causal, scale, scale2);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dq_wgmma(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse, const void* dd,
                            void* dq, int bh, int tq, int tk, int causal,
                            cudaStream_t stream) {
  const size_t smem = dq_wgmma_smem_bytes<HD>();
  auto kern = flash_bwd_dq_kernel_wgmma<HD>;
  static std::atomic<unsigned long long> smem_set{0};
  cudaError_t err = set_max_smem_once(kern, (int)smem, smem_set);
  if (err != cudaSuccess) return err;
  float scale, scale2;
  scales(HD, &scale, &scale2);
  const dim3 grid((tq + kDqRows - 1) / kDqRows, bh);
  kern<<<grid, kDqThreads, smem, stream>>>(
      static_cast<const hw::bf16*>(q), static_cast<const hw::bf16*>(k),
      static_cast<const hw::bf16*>(v), static_cast<const hw::bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dd),
      static_cast<hw::bf16*>(dq), tq, tk, causal, scale, scale2);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* dd,
                       void* dk, void* dv, int bh, int tq, int tk, int causal,
                       cudaStream_t stream) {
  const size_t smem = dkv_smem_bytes<HD>();
  auto kern = flash_bwd_dkv_kernel<HD>;
  static std::atomic<unsigned long long> smem_set{0};
  cudaError_t err = set_max_smem_once(kern, (int)smem, smem_set);
  if (err != cudaSuccess) return err;
  float scale, scale2;
  scales(HD, &scale, &scale2);
  const dim3 grid((tk + kBlockN - 1) / kBlockN, bh);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dd),
      static_cast<float*>(dk), static_cast<float*>(dv), tq, tk, causal,
      scale, scale2);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dkv_wgmma(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* dd, void* dk, void* dv, int bh,
                             int tq, int tk, int causal,
                             cudaStream_t stream) {
  const size_t smem = dkv_wgmma_smem_bytes<HD>();
  auto kern = flash_bwd_dkv_kernel_wgmma<HD>;
  static std::atomic<unsigned long long> smem_set{0};
  cudaError_t err = set_max_smem_once(kern, (int)smem, smem_set);
  if (err != cudaSuccess) return err;
  float scale, scale2;
  scales(HD, &scale, &scale2);
  const dim3 grid((tk + kBlockN - 1) / kBlockN, bh);
  kern<<<grid, kDkvThreads, smem, stream>>>(
      static_cast<const hw::bf16*>(q), static_cast<const hw::bf16*>(k),
      static_cast<const hw::bf16*>(v), static_cast<const hw::bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dd),
      static_cast<hw::bf16*>(dk), static_cast<hw::bf16*>(dv), tq, tk, causal,
      scale, scale2);
  return cudaGetLastError();
}

}  // namespace

// q, dout, dq (bh, tq, hd); k, v (bh, tk, hd); lse, dd (bh, tq) float32;
// all contiguous. Returns the launch's cudaError_t.
extern "C" int dl4j_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* dd, void* dq, int bh, int tq,
                                 int tk, int hd, int dtype, int causal,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32 && hd == 64)
    return launch_dq<float, 64>(q, k, v, dout, lse, dd, dq, bh, tq, tk,
                                causal, st);
  if (dtype == kFloat32 && hd == 128)
    return launch_dq<float, 128>(q, k, v, dout, lse, dd, dq, bh, tq, tk,
                                 causal, st);
  if (dtype == kBFloat16 && hd == 64)
    return launch_dq_wgmma<64>(q, k, v, dout, lse, dd, dq, bh, tq, tk, causal,
                               st);
  if (dtype == kBFloat16 && hd == 128)
    return launch_dq_wgmma<128>(q, k, v, dout, lse, dd, dq, bh, tq, tk,
                                causal, st);
  return cudaErrorInvalidValue;
}

// as above, with dk, dv (bh, tk, hd) as the outputs; bf16 ones 16-byte
// aligned
extern "C" int dl4j_flash_bwd_dkv(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* dd, void* dk,
                                  void* dv, int bh, int tq, int tk, int hd,
                                  int dtype, int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32 && hd == 64)
    return launch_dkv<64>(q, k, v, dout, lse, dd, dk, dv, bh, tq, tk, causal,
                          st);
  if (dtype == kFloat32 && hd == 128)
    return launch_dkv<128>(q, k, v, dout, lse, dd, dk, dv, bh, tq, tk, causal,
                           st);
  if (dtype == kBFloat16 && hd == 64)
    return launch_dkv_wgmma<64>(q, k, v, dout, lse, dd, dk, dv, bh, tq, tk,
                                causal, st);
  if (dtype == kBFloat16 && hd == 128)
    return launch_dkv_wgmma<128>(q, k, v, dout, lse, dd, dk, dv, bh, tq, tk,
                                 causal, st);
  return cudaErrorInvalidValue;
}
