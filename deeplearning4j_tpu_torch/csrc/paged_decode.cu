// Paged-attention decode (K4) for Hopper, sm_90a: split-page flash
// decoding, a split kernel and a combine kernel.
//
// Replaces the Pallas TPU kernel
// deeplearning4j_tpu/attention/paged_pallas.py `_decode_kernel` (:51,
// launched by `paged_attention` :108). Single-query attention per decode
// slot over that slot's pages of the block pool: the query at cursor `pos`
// sees key positions [0, pos] (inclusive), pages past the written frontier
// are never read, page 0 is always computed (an idle slot whose table is
// all trash reads the trash page's first position), a cursor at or past
// the window reads every page of the table, the softmax is in base 2 with
// float32 m, l and acc, P is rounded to V's dtype before the P.V product
// (as the TPU kernel casts before its MXU dot), the denominator is floored
// at 1e-30, and the output is in q's dtype.
//
// What bounds it on the H100: bytes. Each (slot, head) reads its written
// pages of K and V once and does 4 * hd operations per position on them,
// about one operation per byte, far below the ~295 operations per byte
// where the tensor cores would become the limit. So the design keeps
// enough 16-byte loads in flight on every SM, not tensor cores: one block
// per (slot, head) walking ~50 pages in turn leaves most of the 132 SMs
// idle and each block waiting on one page at a time.
//
// Split kernel (`paged_decode_split_kernel`), grid (heads, slots, splits):
// - a split is a fixed run of `pages_per_split` pages of one slot (64
//   positions at page_size 16); the number of splits comes from the table
//   width, never from the cursors, which live on the device (reading them
//   would add a host sync to every decode step). A block whose run starts
//   past its slot's last written page writes an empty partial (m = -1e30,
//   l = 0, acc = 0) and exits;
// - the block loads its run's table entries once, then streams its
//   positions in chunks of 16 through a 4-stage ring of cp.async 16-byte
//   copies (8 bf16 or 4 float32 a lane) into shared memory, so up to 64
//   positions of K and V are in flight before the first wait. Positions
//   past the cursor or the window are never read;
// - hd / (16 / sizeof(T)) neighbouring lanes (a row group) share one key
//   row: each thread copies, and later reads back, exactly its own
//   16-byte pieces, so the ring needs no barrier. q.k is a dot over the
//   lane's piece plus a shuffle reduction inside the row group;
// - each row group keeps its own online softmax (m, l, acc over its rows)
//   on its registers; at the end the block merges its row groups through
//   shared memory and writes the split's partial (m, l, acc[hd]) in
//   float32 to scratch.
// Combine kernel (`paged_decode_combine_kernel`), one block per (slot,
// head): reads the cursor, merges the partials of the splits that hold
// positions with the online-softmax rescale, floors l at 1e-30 and writes
// the output in q's dtype. A partial that saw no position has m = -1e30
// and gets weight exactly 0 (the guard of the JAX ring merge,
// deeplearning4j_tpu/attention/ring.py:153-154), so no -inf - -inf NaN.
//
// P is rounded to bf16 relative to its row group's running max rather than
// the whole row's max. The TPU kernel's online softmax also rounds
// relative to a running max; the difference is of that kind and stays
// inside the bf16 tolerance.
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace dl4j;
namespace hw = dl4j::hopper;

constexpr int kThreads = 128;
constexpr int kChunk = 16;        // positions a ring stage holds
constexpr int kStages = 4;        // ring stages
constexpr int kMaxRunPages = 64;  // pages_per_split <= this

template <typename T, int HD>
struct Shape {
  static constexpr int kVec = 16 / sizeof(T);      // values a 16-byte copy
  static constexpr int kGroup = HD / kVec;         // lanes a key row
  static constexpr int kRowGroups = kThreads / kGroup;
  static constexpr int kRowsEach = kChunk / kRowGroups;  // rows a chunk
  static_assert(kGroup <= 32 && 32 % kGroup == 0, "row group in a warp");
  static_assert(kChunk % kRowGroups == 0, "uneven chunk");
  static constexpr size_t kStageElems = 2 * kChunk * HD;  // K, then V
  static constexpr size_t smem_bytes() {
    return kStages * kStageElems * sizeof(T);
  }
  static_assert(kStages * kStageElems * sizeof(T) >=
                    kRowGroups * HD * sizeof(float),
                "the merge reuses the ring");
};

// 16 bytes of T at `p` (global or shared, 16-byte aligned) as floats
template <typename T, int N>
__device__ __forceinline__ void load_vec(const T* p, float (&x)[N]) {
  static_assert(N * sizeof(T) == 16, "one 16-byte vector");
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* t = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int e = 0; e < N; ++e) x[e] = to_f32(t[e]);
}

// index of the last page a cursor reaches: pages [0, last] are read
__device__ __forceinline__ int last_page(int pos, int page_size,
                                         int table_width) {
  return max(0, min(pos / page_size, table_width - 1));
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    paged_decode_split_kernel(const T* __restrict__ q,
                              const T* __restrict__ k_pool,
                              const T* __restrict__ v_pool,
                              const int* __restrict__ page_table,
                              const int* __restrict__ lengths,
                              float* __restrict__ partial, int heads,
                              int page_size, int table_width,
                              int pages_per_split, float scale2) {
  using S = Shape<T, HD>;
  constexpr int V = S::kVec, G = S::kGroup, R = S::kRowGroups;
  constexpr int NU = S::kRowsEach;
  extern __shared__ uint4 smem_v[];
  T* ring = reinterpret_cast<T*>(smem_v);
  __shared__ int tab[kMaxRunPages];
  __shared__ float ms[R], ls[R];

  const int h = blockIdx.x, s = blockIdx.y, sp = blockIdx.z;
  const int tid = threadIdx.x, gi = tid / G, li = tid % G;
  const int pos = lengths[s];
  const int last = last_page(pos, page_size, table_width);
  const int j0 = sp * pages_per_split;
  float* part =
      partial + (((size_t)s * heads + h) * gridDim.z + sp) * (HD + 2);
  if (j0 > last) {  // nothing of this slot lies in the run
    for (int d = tid; d < HD + 2; d += kThreads)
      part[d] = d == HD ? kNegInf : 0.f;
    return;
  }
  const int j1 = min(j0 + pages_per_split, last + 1);  // pages [j0, j1)
  const int p_begin = j0 * page_size;
  const int p_end = min(pos + 1, j1 * page_size);  // positions visible
  const int n_chunks = (p_end - p_begin + kChunk - 1) / kChunk;
  for (int j = tid; j < j1 - j0; j += kThreads)
    tab[j] = page_table[(size_t)s * table_width + j0 + j];
  __syncthreads();

  // chunk c's rows gi + R u of this thread into ring stage c % kStages
  auto load_chunk = [&](int c) {
    T* st = ring + (c % kStages) * S::kStageElems;
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      const int row = gi + R * u;
      const int p = p_begin + c * kChunk + row;
      const bool in = p < p_end;
      const size_t off =
          in ? (((size_t)tab[p / page_size - j0] * heads + h) * page_size +
                p % page_size) * HD + li * V
             : 0;
      hw::cp_async16(hw::smem_u32(st + row * HD + li * V), k_pool + off, in);
      hw::cp_async16(hw::smem_u32(st + (kChunk + row) * HD + li * V),
                     v_pool + off, in);
    }
  };
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < n_chunks) load_chunk(c);
    hw::cp_async_commit();  // one group a chunk, empty ones too
  }

  float qv[V];
  load_vec<T, V>(q + ((size_t)s * heads + h) * HD + li * V, qv);
  float m = kNegInf, l = 0.f, acc[V];
#pragma unroll
  for (int e = 0; e < V; ++e) acc[e] = 0.f;

  for (int c = 0; c < n_chunks; ++c) {
    // the stage refilled here was read by this same thread last chunk
    if (c + kStages - 1 < n_chunks) load_chunk(c + kStages - 1);
    hw::cp_async_commit();
    hw::cp_async_wait<kStages - 1>();  // chunk c has landed
    const T* st = ring + (c % kStages) * S::kStageElems;
    float sc[NU];
    float mx = m;
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      const int row = gi + R * u;
      float kv[V];
      load_vec<T, V>(st + row * HD + li * V, kv);
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < V; ++e) dot = fmaf(qv[e], kv[e], dot);
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      sc[u] = p_begin + c * kChunk + row < p_end ? dot * scale2 : kNegInf;
      mx = fmaxf(mx, sc[u]);
    }
    const float alpha = exp2f(m - mx);
    l *= alpha;
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] *= alpha;
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      const int row = gi + R * u;
      // explicit zero: a row group masked so far has mx == -1e30
      const float p =
          p_begin + c * kChunk + row < p_end ? exp2f(sc[u] - mx) : 0.f;
      l += p;
      const float pr = round_to<T>(p);
      float vv[V];
      load_vec<T, V>(st + (kChunk + row) * HD + li * V, vv);
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] = fmaf(pr, vv[e], acc[e]);
    }
    m = mx;
  }
  hw::cp_async_wait<0>();
  __syncthreads();  // the ring is free: it holds the row groups' acc now

  float* accs = reinterpret_cast<float*>(smem_v);
  if (li == 0) {
    ms[gi] = m;
    ls[gi] = l;
  }
#pragma unroll
  for (int e = 0; e < V; ++e) accs[gi * HD + li * V + e] = acc[e];
  __syncthreads();
  for (int d = tid; d < HD; d += kThreads) {
    float mm = kNegInf;
#pragma unroll
    for (int g = 0; g < R; ++g) mm = fmaxf(mm, ms[g]);
    float ll = 0.f, a = 0.f;
#pragma unroll
    for (int g = 0; g < R; ++g) {
      const float w = ms[g] <= kNegInf / 2 ? 0.f : exp2f(ms[g] - mm);
      ll += w * ls[g];
      a += w * accs[g * HD + d];
    }
    part[d] = a;
    if (d == 0) {
      part[HD] = mm;
      part[HD + 1] = ll;
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    paged_decode_combine_kernel(const float* __restrict__ partial,
                                const int* __restrict__ lengths,
                                T* __restrict__ out, int heads,
                                int page_size, int table_width,
                                int pages_per_split, int n_splits) {
  const int h = blockIdx.x, s = blockIdx.y;
  // splits past the cursor's last page hold empty partials: skipped
  const int n_used =
      last_page(lengths[s], page_size, table_width) / pages_per_split + 1;
  const float* pb = partial + ((size_t)s * heads + h) * n_splits * (HD + 2);
  for (int d = threadIdx.x; d < HD; d += kThreads) {
    float mm = kNegInf;
    for (int i = 0; i < n_used; ++i) mm = fmaxf(mm, pb[i * (HD + 2) + HD]);
    float ll = 0.f, a = 0.f;
    for (int i = 0; i < n_used; ++i) {
      const float* p = pb + i * (HD + 2);
      const float w = p[HD] <= kNegInf / 2 ? 0.f : exp2f(p[HD] - mm);
      ll += w * p[HD + 1];
      a += w * p[d];
    }
    out[((size_t)s * heads + h) * HD + d] =
        from_f32<T>(a / fmaxf(ll, 1e-30f));
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* page_table, const void* lengths, void* out,
                   void* partial, int slots, int heads, int page_size,
                   int table_width, int pages_per_split,
                   cudaStream_t stream) {
  const size_t smem = Shape<T, HD>::smem_bytes();
  auto split = paged_decode_split_kernel<T, HD>;
  static std::atomic<unsigned long long> smem_set{0};
  cudaError_t err = set_max_smem_once(split, (int)smem, smem_set);
  if (err != cudaSuccess) return err;
  const float scale2 = kLog2e / sqrtf((float)HD);
  const int n_splits = (table_width + pages_per_split - 1) / pages_per_split;
  split<<<dim3(heads, slots, n_splits), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(page_table),
      static_cast<const int*>(lengths), static_cast<float*>(partial), heads,
      page_size, table_width, pages_per_split, scale2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  paged_decode_combine_kernel<T, HD><<<dim3(heads, slots), kThreads, 0,
                                       stream>>>(
      static_cast<const float*>(partial), static_cast<const int*>(lengths),
      static_cast<T*>(out), heads, page_size, table_width, pages_per_split,
      n_splits);
  return cudaGetLastError();
}

}  // namespace

// q (slots, heads, hd); k_pool/v_pool (n_pages + 1, heads, page_size, hd);
// page_table (slots, table_width) int32; lengths (slots,) int32; out like
// q; partial (slots, heads, n_splits, hd + 2) float32 scratch, n_splits =
// ceil(table_width / pages_per_split); all contiguous, q and the pools
// 16-byte aligned. Returns the launches' cudaError_t.
extern "C" int dl4j_paged_decode(const void* q, const void* k_pool,
                                 const void* v_pool, const void* page_table,
                                 const void* lengths, void* out,
                                 void* partial, int slots, int heads,
                                 int page_size, int table_width,
                                 int pages_per_split, int hd, int dtype,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pages_per_split < 1 || pages_per_split > kMaxRunPages)
    return cudaErrorInvalidValue;
  if (dtype == kFloat32 && hd == 64)
    return launch<float, 64>(q, k_pool, v_pool, page_table, lengths, out,
                             partial, slots, heads, page_size, table_width,
                             pages_per_split, st);
  if (dtype == kFloat32 && hd == 128)
    return launch<float, 128>(q, k_pool, v_pool, page_table, lengths, out,
                              partial, slots, heads, page_size, table_width,
                              pages_per_split, st);
  if (dtype == kBFloat16 && hd == 64)
    return launch<__nv_bfloat16, 64>(q, k_pool, v_pool, page_table, lengths,
                                     out, partial, slots, heads, page_size,
                                     table_width, pages_per_split, st);
  if (dtype == kBFloat16 && hd == 128)
    return launch<__nv_bfloat16, 128>(q, k_pool, v_pool, page_table,
                                      lengths, out, partial, slots, heads,
                                      page_size, table_width,
                                      pages_per_split, st);
  return cudaErrorInvalidValue;
}
