// Flash-attention forward (K1) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel deeplearning4j_tpu/attention/flash_pallas.py
// `_kernel` (:92, launched by `_flash_forward` :192). Computes
// softmax(Q K^T / sqrt(d)) V per (batch*head) row with an online base-2
// softmax (scores prescaled by log2(e)/sqrt(d), exp2) and float32 m, l and
// acc. Causal masking is bottom-right aligned (query i sees keys up to
// i + Tk - Tq). A row that sees no key gives out = 0 and lse = +1e30.
//
// What bounds it on the H100: at the prefill shapes (hd 128, causal, bf16,
// T up to 1024) K1 sits at the ridge. At B*H 32 and T 1024 the bytes (Q,
// K, V read once, O written once, 33.5 MB) take 10.0 us at 3.35 TB/s and
// the operations (4*hd per visible pair, 8.6 GFLOP) 8.7 us at 989 TFLOP/s
// of bf16 tensor cores; longer T tips it to operations. Both products
// therefore have to run on the tensor cores, and the K/V stream has to
// overlap them.
//
// bf16 design (`flash_fwd_kernel_wgmma`):
// - one block of two consumer warpgroups per 128 query rows, each
//   warpgroup 64 rows (wgmma's M); the block walks 64-key K/V tiles, a
//   loop that takes the place of the TPU's sequential grid axis. Blocks
//   are launched in reverse row order, so under causal masking the rows
//   with the most keys start first and the short ones fill the tail;
// - Q is copied once; K/V tiles go through a 2-stage ring of cp.async
//   16-byte copies (zero-filled past Tk) into the 128-byte-swizzled layout
//   that wgmma descriptors read (hopper.cuh), so tile j+1 lands while tile
//   j is multiplied;
// - S = Q K^T is wgmma m64n64k16 with both operands in shared memory; the
//   online softmax runs on its f32 accumulator in registers (a row lives
//   in the 4 threads of a quad: two shuffles per max or sum); P is rounded
//   to bf16 pairwise into the register A operand of P V (wgmma
//   m64n{hd}k16, V read MN-major), so P never touches shared memory;
// - only tiles that cross the diagonal or the ragged Tk edge compute a
//   mask; a masked entry gets P = 0 explicitly (a zero-padded key scores 0,
//   not -1e30), and tiles wholly above a warpgroup's diagonal are skipped;
// - the epilogue divides by max(l, 1e-30) and stages O as bf16 through
//   the warpgroup's Q tile for coalesced 16-byte stores.
// Left for later: TMA loads with mbarriers in place of cp.async, a
// producer warp with the consumers' registers raised (warp
// specialisation), and persistent blocks that overlap one tile's epilogue
// with the next one's loads.
//
// float32 keeps its own scalar kernel (`flash_fwd_kernel`): tensor cores
// would mean TF32, too coarse for the float32 parity checks. It holds
// float32 tiles in shared memory (rows padded by one word) and does both
// products as FMAs on the CUDA cores.
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace dl4j;
namespace hw = dl4j::hopper;

// ------------------------------------------------ bf16: tensor cores
constexpr int kWgRows = 64;       // query rows per consumer warpgroup
constexpr int kKeys = 64;         // keys per K/V tile
constexpr int kWgThreads = 256;   // two consumer warpgroups
constexpr int kRows = 2 * kWgRows;

template <int HD>
constexpr size_t wgmma_smem_bytes() {  // Q (2 tiles), 2 stages of K and V
  return 6 * hw::tile_bytes<HD>() + 1024;  // + alignment slack
}

template <int HD>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_fwd_kernel_wgmma(const hw::bf16* __restrict__ q,
                           const hw::bf16* __restrict__ k,
                           const hw::bf16* __restrict__ v,
                           hw::bf16* __restrict__ out,
                           float* __restrict__ lse, int tq, int tk,
                           int causal, float scale2) {
  constexpr uint32_t kTile = hw::tile_bytes<HD>();
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hw::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);  // generic pointer to `base`
  const uint32_t sq = base;                 // warpgroup w's Q: + w * kTile
  const uint32_t skv = base + 2 * kTile;    // stage s: K + 2s, V + 2s + 1

  const int tid = threadIdx.x;
  const int wg = tid / 128, wtid = tid % 128;
  const int warp = wtid / 32, lane = tid % 32;
  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int q0w = q0 + wg * kWgRows;  // this warpgroup's first row
  const int offset = tk - tq;         // causal offset, bottom-right
  const hw::bf16* qb = q + (size_t)bh * tq * HD;
  const hw::bf16* kb = k + (size_t)bh * tk * HD;
  const hw::bf16* vb = v + (size_t)bh * tk * HD;

  // keys the block may see, and this warpgroup's share of them
  const int k_end = causal ? min(tk, q0 + kRows + offset) : tk;
  const int n_tiles = k_end > 0 ? (k_end + kKeys - 1) / kKeys : 0;
  const int wg_end = causal ? min(tk, q0w + kWgRows + offset) : tk;

  hw::load_tile<HD, kWgThreads>(sq, qb, q0, tq, tid);
  hw::load_tile<HD, kWgThreads>(sq + kTile, qb, q0 + kWgRows, tq, tid);
  if (n_tiles > 0) {
    hw::load_tile<HD, kWgThreads>(skv, kb, 0, tk, tid);
    hw::load_tile<HD, kWgThreads>(skv + kTile, vb, 0, tk, tid);
  }
  hw::cp_async_commit();

  // rows r_a = q0w + 16 warp + lane/4 (h 0) and r_a + 8 (h 1)
  const int r_a = q0w + warp * 16 + lane / 4;
  const int col = 2 * (lane % 4);
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kKeys;
    const uint32_t sk = skv + (it & 1) * 2 * kTile;
    if (it + 1 < n_tiles) {  // the next tile into the other stage
      const uint32_t nk = skv + ((it + 1) & 1) * 2 * kTile;
      hw::load_tile<HD, kWgThreads>(nk, kb, k0 + kKeys, tk, tid);
      hw::load_tile<HD, kWgThreads>(nk + kTile, vb, k0 + kKeys, tk, tid);
      hw::cp_async_commit();
      hw::cp_async_wait<1>();
    } else {
      hw::cp_async_wait<0>();
    }
    __syncthreads();

    if (k0 < wg_end) {  // else the tile is wholly above this warpgroup's
                        // diagonal
      float s[32] = {};
      hw::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        hw::wgmma_ss_m64n64(s, hw::desc_k(sq + wg * kTile, kk),
                            hw::desc_k(sk, kk), kk > 0);
      hw::wgmma_commit();
      hw::wgmma_wait<0>();
      hw::fence_regs(s);

      // only tiles crossing the ragged edge or the diagonal are masked
      const bool masked = (k0 + kKeys > tk) ||
                          (causal && k0 + kKeys - 1 > q0w + offset);
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[4 * j + 2 * h + e];
            x *= scale2;
            if (masked) {
              const int kp = k0 + 8 * j + col + e;
              if (kp >= tk || (causal && kp > r_a + 8 * h + offset))
                x = kNegInf;
            }
            mx[h] = fmaxf(mx[h], x);
          }
      float alpha[2], m_new[2], psum[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        m_new[h] = fmaxf(m[h], mx[h]);
        alpha[h] = exp2f(m[h] - m_new[h]);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[4 * j + 2 * h + e];
            // explicit zero: a row masked so far has m_new == -1e30 and
            // exp2(score - m_new) would be 1 on its masked lanes
            bool ok = true;
            if (masked) {
              const int kp = k0 + 8 * j + col + e;
              ok = kp < tk && (!causal || kp <= r_a + 8 * h + offset);
            }
            x = ok ? exp2f(x - m_new[h]) : 0.f;
            psum[h] += x;
          }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        psum[h] += __shfl_xor_sync(0xffffffffu, psum[h], 1);
        psum[h] += __shfl_xor_sync(0xffffffffu, psum[h], 2);
        l[h] = l[h] * alpha[h] + psum[h];
        m[h] = m_new[h];
      }
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) o[i] *= alpha[(i / 2) % 2];

      uint32_t pa[4][4];  // P rounded to bf16, the A operand of P V
      hw::to_a(s, pa);
      hw::fence_regs(o);
      hw::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hw::wgmma_rs<HD>(o, pa[kk], hw::desc_mn(sk + kTile, kk));
      hw::wgmma_commit();
      hw::wgmma_wait<0>();
      hw::fence_regs(o);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) hw::fence_regs(pa[kk]);
    }
    __syncthreads();  // every read of this stage is done before its refill
  }
  hw::cp_async_wait<0>();  // Q copies still in flight when n_tiles == 0
  __syncthreads();

  float denom[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) denom[h] = fmaxf(l[h], 1e-30f);
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = o[i] / denom[(i / 2) % 2];
  // this warpgroup's Q tile is free once its last product is done
  hw::store_tile<HD>(o, smem + wg * kTile,
                     out + ((size_t)bh * tq + q0w) * HD, tq - q0w, wtid, wg);
  if (lse != nullptr && lane % 4 == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (r_a + 8 * h < tq)
        lse[(size_t)bh * tq + r_a + 8 * h] =
            l[h] > 0.f ? kLn2 * m[h] + logf(fmaxf(l[h], 1e-30f)) : -kNegInf;
  }
}

template <int HD>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         void* out, void* lse, int bh, int tq, int tk,
                         int causal, cudaStream_t stream) {
  const size_t smem = wgmma_smem_bytes<HD>();
  auto kern = flash_fwd_kernel_wgmma<HD>;
  static std::atomic<unsigned long long> smem_set{0};
  cudaError_t err = set_max_smem_once(kern, (int)smem, smem_set);
  if (err != cudaSuccess) return err;
  const float scale2 = kLog2e / sqrtf((float)HD);
  const dim3 grid((tq + kRows - 1) / kRows, bh);
  kern<<<grid, kWgThreads, smem, stream>>>(
      static_cast<const hw::bf16*>(q), static_cast<const hw::bf16*>(k),
      static_cast<const hw::bf16*>(v), static_cast<hw::bf16*>(out),
      static_cast<float*>(lse), tq, tk, causal, scale2);
  return cudaGetLastError();
}

// --------------------------------------------- float32: CUDA cores
constexpr int kBlockM = 64;   // query rows per block
constexpr int kBlockN = 64;   // key rows per K/V tile
constexpr int kThreads = 256;

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBlockM * (HD + 1) + kBlockN * (HD + 1) +
                          kBlockN * HD + kBlockM * (kBlockN + 1));
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, int tq, int tk, int causal,
                     float scale2) {
  constexpr int QS = HD + 1;       // padded row stride of the Q and K tiles
  constexpr int SS = kBlockN + 1;  // padded row stride of the score tile
  constexpr int NACC = HD / 4;     // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                // kBlockM x QS
  float* ks = qs + kBlockM * QS;   // kBlockN x QS
  float* vs = ks + kBlockN * QS;   // kBlockN x HD
  float* ss = vs + kBlockN * HD;   // kBlockM x SS: scores, then P

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBlockM;
  const int tid = threadIdx.x;
  const int offset = tk - tq;  // causal offset, bottom-right alignment
  const float* qb = q + (size_t)bh * tq * HD;
  const float* kb = k + (size_t)bh * tk * HD;
  const float* vb = v + (size_t)bh * tk * HD;

  for (int i = tid; i < kBlockM * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    qs[r * QS + d] = (q0 + r < tq) ? qb[(size_t)(q0 + r) * HD + d] : 0.f;
  }

  // score phase: a 16 x 16 thread grid, each thread 4 rows x 4 columns
  // (columns strided by 16 so a warp's K reads spread over the banks)
  const int ty = tid / 16, tx = tid % 16;
  // softmax and P.V phase: 4 threads per query row, each owning every
  // 4th output column
  const int row = tid / 4, sub = tid % 4;
  const int qpos = q0 + row;
  float m = kNegInf, l = 0.f;
  float acc[NACC];
#pragma unroll
  for (int j = 0; j < NACC; ++j) acc[j] = 0.f;

  // keys this tile may see: all of them, or up to the diagonal of its
  // last row (tiles wholly above the diagonal are skipped)
  const int k_end = causal ? min(tk, q0 + kBlockM + offset) : tk;
  for (int k0 = 0; k0 < k_end; k0 += kBlockN) {
    __syncthreads();  // the previous tile's reads of ks, vs and ss are done
    for (int i = tid; i < kBlockN * HD; i += kThreads) {
      const int r = i / HD, d = i % HD;
      const bool in = k0 + r < tk;
      const size_t g = (size_t)(k0 + r) * HD + d;
      ks[r * QS + d] = in ? kb[g] : 0.f;
      vs[r * HD + d] = in ? vb[g] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty * 4 + i) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ks[(tx + 16 * j) * QS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }
    // only tiles crossing the ragged edge or the diagonal are masked
    const bool masked = (k0 + kBlockN > tk) ||
                        (causal && k0 + kBlockN - 1 > q0 + offset);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty * 4 + i, c = tx + 16 * j;
        float val = s[i][j] * scale2;
        if (masked) {
          const int kp = k0 + c;
          if (kp >= tk || (causal && kp > q0 + r + offset)) val = kNegInf;
        }
        ss[r * SS + c] = val;
      }
    }
    __syncthreads();

    // online softmax over this tile for query row `row`
    float mx = kNegInf;
    for (int c = sub * 16; c < sub * 16 + 16; ++c)
      mx = fmaxf(mx, ss[row * SS + c]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float alpha = exp2f(m - m_new);
    float psum = 0.f;
    for (int c = sub * 16; c < sub * 16 + 16; ++c) {
      const int kp = k0 + c;
      // explicit zero: a row masked so far has m_new == -1e30 and
      // exp2(score - m_new) would be 1 on its masked lanes
      const bool ok = kp < tk && (!causal || kp <= qpos + offset);
      const float p = ok ? exp2f(ss[row * SS + c] - m_new) : 0.f;
      psum += p;
      ss[row * SS + c] = p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();  // the row's 4 threads (one warp) wrote all of its P

#pragma unroll
    for (int j = 0; j < NACC; ++j) acc[j] *= alpha;
    for (int n = 0; n < kBlockN; ++n) {
      const float p = ss[row * SS + n];
      const float* vr = vs + n * HD + sub;
#pragma unroll
      for (int j = 0; j < NACC; ++j) acc[j] = fmaf(p, vr[4 * j], acc[j]);
    }
  }

  if (qpos < tq) {
    const float denom = fmaxf(l, 1e-30f);
    float* orow = out + ((size_t)bh * tq + qpos) * HD + sub;
#pragma unroll
    for (int j = 0; j < NACC; ++j) orow[4 * j] = acc[j] / denom;
    if (lse != nullptr && sub == 0)
      lse[(size_t)bh * tq + qpos] =
          l > 0.f ? kLn2 * m + logf(fmaxf(l, 1e-30f)) : -kNegInf;
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* lse, int bh, int tq, int tk, int causal,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<HD>();
  auto kern = flash_fwd_kernel<HD>;
  static std::atomic<unsigned long long> smem_set{0};
  cudaError_t err = set_max_smem_once(kern, (int)smem, smem_set);
  if (err != cudaSuccess) return err;
  const float scale2 = kLog2e / sqrtf((float)HD);
  const dim3 grid((tq + kBlockM - 1) / kBlockM, bh);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out),
      static_cast<float*>(lse), tq, tk, causal, scale2);
  return cudaGetLastError();
}

}  // namespace

// q (bh, tq, hd), k/v (bh, tk, hd), out like q, lse (bh, tq) float32 or
// NULL; all contiguous, bf16 ones 16-byte aligned. Returns the launch's
// cudaError_t.
extern "C" int dl4j_flash_fwd(const void* q, const void* k, const void* v,
                              void* out, void* lse, int bh, int tq, int tk,
                              int hd, int dtype, int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32 && hd == 64)
    return launch<64>(q, k, v, out, lse, bh, tq, tk, causal, st);
  if (dtype == kFloat32 && hd == 128)
    return launch<128>(q, k, v, out, lse, bh, tq, tk, causal, st);
  if (dtype == kBFloat16 && hd == 64)
    return launch_wgmma<64>(q, k, v, out, lse, bh, tq, tk, causal, st);
  if (dtype == kBFloat16 && hd == 128)
    return launch_wgmma<128>(q, k, v, out, lse, bh, tq, tk, causal, st);
  return cudaErrorInvalidValue;
}
