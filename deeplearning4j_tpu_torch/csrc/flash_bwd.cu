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
//   dK = sum over query tiles of round(dS)^T Q * scale       (K3)
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
// per pair (about 35 us). Both sit at the ridge. This first version does
// every product as float32 FMAs on the CUDA cores (no mma/wgmma, no TMA), so
// it runs far below either limit: its design only keeps the score matrices
// out of device memory, does no work above the causal diagonal, and needs
// no float atomics. The next design moves the four products to wgmma on
// bf16 tiles and stages Q/dO (K3) or K/V (K2) tiles with TMA, double
// buffered.
//
// Design:
// - K2: one block per (batch*head, 64-row Q tile), looping over 64-row K/V
//   tiles up to the diagonal; K3: one block per (batch*head, 64-row K/V
//   tile), looping over Q tiles from the first one that can see it. The
//   loop takes the place of the TPU's sequential grid axis. Two kernels, so
//   dQ needs no atomics and both outputs are the same run to run;
// - only tiles that cross the diagonal or a ragged T edge compute a mask,
//   so every Tq and Tk runs here (the TPU sent T without a 128-aligned tile
//   to the blockwise vjp);
// - tiles are float32 in shared memory, rows padded by one word so the
//   column-strided reads of the score phase hit distinct banks: 149 KB
//   (K2) and 166 KB (K3) at hd 128, above the 48 KB static limit, so the
//   launch asks for dynamic shared memory with cudaFuncSetAttribute.
#include <stdint.h>

#include "common.cuh"

namespace {

using namespace dl4j;

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

// --------------------------------------------------------- K3: dK, dV
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ dd, T* __restrict__ dk,
                         T* __restrict__ dv, int tq, int tk, int causal,
                         float scale, float scale2) {
  constexpr int QS = HD + 1;
  constexpr int NACC = HD / 4;  // dK and dV columns per thread
  extern __shared__ float smem[];
  float* ks = smem;                // kBlockN x QS
  float* vs = ks + kBlockN * QS;   // kBlockN x QS
  float* qs = vs + kBlockN * QS;   // kBlockM x QS
  float* dos = qs + kBlockM * QS;  // kBlockM x QS
  float* ps = dos + kBlockM * QS;  // kBlockM x kSS, P rounded to T
  float* dss = ps + kBlockM * kSS;  // kBlockM x kSS, dS rounded to T
  float* lse2_s = dss + kBlockM * kSS;
  float* dd_s = lse2_s + kBlockM;

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kBlockN;
  const int tid = threadIdx.x;
  const int offset = tk - tq;
  const T* qb = q + (size_t)bh * tq * HD;
  const T* dob = dout + (size_t)bh * tq * HD;
  const float* lseb = lse + (size_t)bh * tq;
  const float* ddb = dd + (size_t)bh * tq;

  load_tile<T, HD>(ks, k + (size_t)bh * tk * HD, k0, tk);
  load_tile<T, HD>(vs, v + (size_t)bh * tk * HD, k0, tk);

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
    load_tile<T, HD>(qs, qb, q0, tq);
    load_tile<T, HD>(dos, dob, q0, tq);
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
        ps[r * kSS + c] = round_to<T>(p);
        dss[r * kSS + c] = round_to<T>(ds);
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
      dk[o + 4 * j] = from_f32<T>(dk_acc[j]);
      dv[o + 4 * j] = from_f32<T>(dv_acc[j]);
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
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
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

template <typename T, int HD>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* dd,
                       void* dk, void* dv, int bh, int tq, int tk, int causal,
                       cudaStream_t stream) {
  const size_t smem = dkv_smem_bytes<HD>();
  auto kern = flash_bwd_dkv_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  float scale, scale2;
  scales(HD, &scale, &scale2);
  const dim3 grid((tk + kBlockN - 1) / kBlockN, bh);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dd),
      static_cast<T*>(dk), static_cast<T*>(dv), tq, tk, causal, scale,
      scale2);
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
    return launch_dq<__nv_bfloat16, 64>(q, k, v, dout, lse, dd, dq, bh, tq,
                                        tk, causal, st);
  if (dtype == kBFloat16 && hd == 128)
    return launch_dq<__nv_bfloat16, 128>(q, k, v, dout, lse, dd, dq, bh, tq,
                                         tk, causal, st);
  return cudaErrorInvalidValue;
}

// as above, with dk, dv (bh, tk, hd) as the outputs
extern "C" int dl4j_flash_bwd_dkv(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* dd, void* dk,
                                  void* dv, int bh, int tq, int tk, int hd,
                                  int dtype, int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32 && hd == 64)
    return launch_dkv<float, 64>(q, k, v, dout, lse, dd, dk, dv, bh, tq, tk,
                                 causal, st);
  if (dtype == kFloat32 && hd == 128)
    return launch_dkv<float, 128>(q, k, v, dout, lse, dd, dk, dv, bh, tq, tk,
                                  causal, st);
  if (dtype == kBFloat16 && hd == 64)
    return launch_dkv<__nv_bfloat16, 64>(q, k, v, dout, lse, dd, dk, dv, bh,
                                         tq, tk, causal, st);
  if (dtype == kBFloat16 && hd == 128)
    return launch_dkv<__nv_bfloat16, 128>(q, k, v, dout, lse, dd, dk, dv, bh,
                                          tq, tk, causal, st);
  return cudaErrorInvalidValue;
}
