// Hopper (sm_90a) building blocks of the port's tensor-core kernels:
// cp.async staging into the 128-byte-swizzled tile layout that wgmma
// reads, the wgmma shared-memory descriptors, and the wgmma wrappers.
//
// Tile layout. A tile of 64 rows x HD bf16 values (HD 64 or 128) is kept
// as HD / 64 column blocks, each 64 rows x 64 values (128 bytes a row,
// 8 KB a block); inside a block the 16-byte chunk c of row r sits at
// chunk c ^ (r % 8). That is wgmma's SWIZZLE_128B canonical layout both
// ways round:
// - K-major, when the tile's rows index M or N and HD is the reduction
//   (S = Q K^T reads Q and K so): 8-row groups 1024 bytes apart (SBO);
//   a k16 step moves 32 bytes inside a 128-byte row, and every 4th step
//   moves on to the next column block.
// - MN-major, when the rows are the reduction and HD is N (P V reads V
//   so, with the transpose bit): 8-row groups 1024 bytes apart (SBO),
//   column blocks 8 KB apart (LBO); a k16 step moves 16 rows, 2 KB.
// Tiles start 1024-byte aligned, so the swizzle phase of a descriptor's
// start address is 0 and its base-offset field stays 0.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace dl4j {
namespace hopper {

using bf16 = __nv_bfloat16;

constexpr int kTileRows = 64;                      // wgmma's M
constexpr uint32_t kBlockBytes = kTileRows * 128;  // one column block

template <int HD>
__host__ __device__ constexpr uint32_t tile_bytes() {
  return kTileRows * HD * 2;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset, inside a tile, of the 16-byte chunk holding values
// [8c, 8c + 8) of row r
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (c >> 3) * kBlockBytes + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// 16 bytes global -> shared, or 16 zero bytes when `in` is false
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared, or 4 zero bytes when `in` is false
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight, then make
// what landed visible to wgmma (the async proxy); a barrier follows
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// rows [r0, r0 + 64) of a contiguous (n, HD) bf16 matrix into the tile at
// shared address `dst`, zero-filled past row n; all NT threads take part.
// Neighbouring threads copy neighbouring 16-byte chunks of a row.
template <int HD, int NT>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src,
                                          int r0, int n, int tid) {
  constexpr int kChunks = HD / 8;
  static_assert(kTileRows * kChunks % NT == 0, "uneven tile copy");
#pragma unroll
  for (int it = 0; it < kTileRows * kChunks / NT; ++it) {
    const int i = tid + it * NT;
    const int r = i / kChunks, c = i % kChunks;
    const bool in = r0 + r < n;
    cp_async16(dst + swz(r, c), src + (size_t)(in ? r0 + r : 0) * HD + c * 8,
               in);
  }
}

// a SWIZZLE_128B wgmma descriptor: start address, leading and stride byte
// offsets (LBO, SBO)
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// the k16 step `kk` of a tile read K-major (LBO unused by the hardware)
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  return desc(tile + (kk >> 2) * kBlockBytes + (kk & 3) * 32, 16, 1024);
}

// the k16 step `kk` (16 rows) of a tile read MN-major
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return desc(tile + kk * 16 * 128, kBlockBytes, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of wgmma accumulators
// (or register operands) across the asynchronous product
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// barrier of the 128 threads of one warpgroup (ids 1.. leave 0 to
// __syncthreads)
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The m64nNk16 f32 accumulator of a warpgroup: warp w holds rows
// 16w + lane/4 (h = 0) and 16w + lane/4 + 8 (h = 1); element
// d[4j + 2h + e] is column 8j + 2 * (lane % 4) + e. For a 64 x 64 tile,
// the k16 step kk of the same values as a bf16 register A operand is
// {d[8kk..8kk+1], d[8kk+2..+3], d[8kk+4..+5], d[8kk+6..+7]}, each pair
// packed; `to_a` rounds them so.
__device__ __forceinline__ void to_a(const float (&d)[32],
                                     uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[kk][i] = pack_bf16(d[8 * kk + 2 * i], d[8 * kk + 2 * i + 1]);
}

// d(64 x 64, f32) = a(64 x 16) . b(64 x 16)^T (+ d if `accumulate`),
// a and b K-major bf16 in shared memory, given by their descriptors
__device__ __forceinline__ void wgmma_ss_m64n64(float (&d)[32], uint64_t da,
                                               uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d(64 x 64, f32) = a(64 x 16) . b(16 x 64) (+ d if `accumulate`), a
// bf16 in registers (the m16k16 fragment of each warp's 16 rows), b
// MN-major bf16 in shared memory (transpose bit set)
__device__ __forceinline__ void wgmma_rs_m64n64(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// d(64 x 128, f32) = a(64 x 16) . b(16 x 128) (+ d if `accumulate`), a
// bf16 in registers (the m16k16 fragment of each warp's 16 rows), b
// MN-major bf16 in shared memory (transpose bit set)
__device__ __forceinline__ void wgmma_rs_m64n128(float (&d)[64],
                                                const uint32_t (&a)[4],
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// d(64 x HD) += a(64 x 16) . b(16 x HD): m64n64k16 or m64n128k16
template <int HD>
__device__ __forceinline__ void wgmma_rs(float (&d)[HD / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (HD == 64)
    wgmma_rs_m64n64(d, a, db, 1);
  else
    wgmma_rs_m64n128(d, a, db, 1);
}

// Stage a warpgroup's 64 x HD f32 accumulator as bf16 into the tile at
// `tile` (a generic pointer into shared memory), then copy its rows below
// `n_rows` to dst (row stride HD) with 16-byte stores: a quad's values of
// one row go into one 16-byte chunk, and the swizzle puts the 8 rows of
// a warp's store into 8 different chunk columns, so neither side has a
// bank conflict.
template <int HD>
__device__ __forceinline__ void store_tile(const float (&d)[HD / 2],
                                           uint8_t* tile, bf16* dst,
                                           int n_rows, int wtid, int wg) {
  const int warp = wtid / 32, lane = wtid % 32;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = warp * 16 + lane / 4 + 8 * h;
      *reinterpret_cast<uint32_t*>(tile + swz(r, j) + (lane % 4) * 4) =
          pack_bf16(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
    }
  warpgroup_sync(wg);
  constexpr int kChunks = HD / 8;
#pragma unroll
  for (int it = 0; it < kTileRows * kChunks / 128; ++it) {
    const int i = wtid + it * 128;
    const int r = i / kChunks, c = i % kChunks;
    if (r < n_rows)
      *reinterpret_cast<uint4*>(dst + (size_t)r * HD + c * 8) =
          *reinterpret_cast<const uint4*>(tile + swz(r, c));
  }
}

}  // namespace hopper
}  // namespace dl4j
