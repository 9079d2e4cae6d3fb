// Hopper (sm_90a) tensor-core helpers shared by the bf16 kernels of
// flash_attention.cu (K2, K3, K4), paged_attention.cu (K1) and
// blockwise_moe.cu (K5-K8): cp.async into tiles in the 128-byte swizzle
// (from a strided slab, or row by row through a gather), wgmma
// shared-memory descriptors, the wgmma products with fp32 accumulators in
// registers, the accumulator fragment's coordinates, and the online
// softmax of the attention kernels on those fragments.
//
// A tile is R rows x C bf16 columns (C a multiple of 64): 64-column atoms
// R * 128 bytes apart, row r of an atom at r * 128, its 16-byte chunk c at
// ((c ^ (r % 8)) * 16), as TMA's SWIZZLE_128B lays it out. Tiles start
// 1024-aligned. A tile is read K-major when its columns are the sum of the
// product (desc_k: 64 columns, any multiple of 8 rows) and MN-major when
// its rows are (desc_mn: 64 rows, C columns the M or N of the product,
// read through the instruction's transpose bit).
//
// Everything sits in the including file's anonymous namespace, so each
// library keeps its own copy.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {
namespace tc {

typedef __nv_bfloat16 bf16;

constexpr int kRows = 64;                 // rows of every tile
constexpr int kWarpgroup = 128;           // threads of a warpgroup
constexpr uint32_t kAtom = kRows * 128;   // bytes of one 64-column atom

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (4) bytes from global to shared memory, zeros where !valid.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// This thread's copies have landed and are visible to wgmma (the async
// proxy); a __syncthreads() after it makes every thread's so.
__device__ __forceinline__ void cp_async_wait_for_wgmma() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// As cp_async_wait_for_wgmma, for all but this thread's `Pending` most
// recently committed groups.
template <int Pending>
__device__ __forceinline__ void cp_async_wait_group_for_wgmma() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Rows [r0, r0 + R) x columns [c0, c0 + C) of a row-major bf16 matrix
// with `ld` columns into the R x C tile at `dst`, by the NT threads of the
// CTA; rows at or past `rend` and columns at or past `ncols` load as
// zeros and read nothing. Needs 16-byte aligned rows and c0, ncols
// multiples of 8.
template <int R, int C, int NT>
__device__ __forceinline__ void load_tile_rc(uint32_t dst, const bf16* src,
                                             size_t ld, int r0, int rend,
                                             int c0, int ncols) {
  constexpr int kChunks = C / 8;          // 16-byte chunks of a row
  static_assert(C % 64 == 0 && R % 8 == 0 && R * kChunks % NT == 0,
                "whole atoms, whole passes of the threads");
#pragma unroll
  for (int i = 0; i < R * kChunks / NT; ++i) {
    const int id = threadIdx.x + i * NT;
    const int r = id / kChunks, c = id % kChunks;
    const int row = r0 + r, col = c0 + 8 * c;
    const bool ok = row < rend && col < ncols;
    cp_async16(dst + (c / 8) * (R * 128) + r * 128 +
                   (((c % 8) ^ (r % 8)) << 4),
               ok ? src + (size_t)row * ld + col : src, ok);
  }
}

// NTL tiles of R x C gathered row by row at one offset: row r of tile j
// from base[j] + off(r) (elements), or zeros where off(r) is negative
// (nothing is read). By the NT threads of the CTA; off(r) is computed once
// for all the tiles; rows need 16-byte alignment.
template <int R, int C, int NT, int NTL, typename Off>
__device__ __forceinline__ void load_rows(const uint32_t (&dst)[NTL],
                                          const bf16* const (&base)[NTL],
                                          Off off) {
  constexpr int kChunks = C / 8;          // 16-byte chunks of a row
  static_assert(C % 64 == 0 && R % 8 == 0 && R * kChunks % NT == 0,
                "whole atoms, whole passes of the threads");
#pragma unroll
  for (int i = 0; i < R * kChunks / NT; ++i) {
    const int id = threadIdx.x + i * NT;
    const int r = id / kChunks, c = id % kChunks;
    const long long o = off(r);
    const uint32_t at = (c / 8) * (R * 128) + r * 128 +
                        (((c % 8) ^ (r % 8)) << 4);
#pragma unroll
    for (int j = 0; j < NTL; ++j)
      cp_async16(dst[j] + at, base[j] + (o < 0 ? 0 : o + 8 * c), o >= 0);
  }
}

// wgmma shared-memory descriptor, 128-byte swizzle; offsets in bytes.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// A tile read K-major (its D columns are the sum), k-step kk of 16
// columns: 32 bytes into the row of atom kk / 4; 8-row groups 1024 B apart.
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  return make_desc(tile + (kk / 4) * kAtom + (kk % 4) * 32, 16, 1024);
}

// A tile read MN-major (its 64 rows are the sum, its D columns the M or N
// of the product), k-step kk of 16 rows; the 64-column atoms kAtom apart.
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return make_desc(tile + kk * 16 * 128, kAtom, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Tie registers that a wgmma reads or writes to this point of the
// program, so the compiler neither reads an accumulator before the wait
// nor reuses an operand register while the wgmma may still read it.
template <int N>
__device__ __forceinline__ void hold(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void hold(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// d[64 x 64] (+)= A . B^T: A and B in shared memory, each K-major or, with
// its transpose bit TA / TB set, MN-major.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate), "n"(TA), "n"(TB));
}

// d[64 x 128] (+)= A . B^T, as above.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
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
      : "l"(a), "l"(b), "r"(accumulate), "n"(TA), "n"(TB));
}

// d[64 x 64] (+)= A . B: A in registers, B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

// d[64 x 128] (+)= A . B: A in registers, B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

// acc[64 x 64] = A[64 x D] . B[64 x D]^T over two K-major tiles.
template <int D>
__device__ __forceinline__ void mma_ss(float (&acc)[32], uint32_t a,
                                       uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<0, 0>(acc, desc_k(a, kk), desc_k(b, kk), kk > 0);
}

// acc[64 x D] += A[64 x 64] . B[64 x D]: A in registers (four k16 steps),
// B a tile read MN-major.
__device__ __forceinline__ void mma_rs(float (&acc)[32],
                                       const uint32_t (&a)[4][4],
                                       uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs_n64(acc, a[kk], desc_mn(b, kk), 1);
}

__device__ __forceinline__ void mma_rs(float (&acc)[64],
                                       const uint32_t (&a)[4][4],
                                       uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs_n128(acc, a[kk], desc_mn(b, kk), 1);
}

// Element i of an m64nN fp32 accumulator held by thread `lane` of warp
// `warp` of the warpgroup: row 16 warp + lane / 4 (+ 8 for i % 4 >= 2),
// column 8 (i / 4) + 2 (lane % 4) (+ 1 for odd i).
__device__ __forceinline__ int frag_row(int warp, int lane, int i) {
  return 16 * warp + lane / 4 + 8 * ((i >> 1) & 1);
}

__device__ __forceinline__ int frag_col(int lane, int i) {
  return 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A 64 x 64 fp32 accumulator as the bf16 A operand of four k16 steps: the
// A fragment of step kk holds columns 16 kk .. 16 kk + 15 of the same rows
// in the same threads, so no data moves between threads.
__device__ __forceinline__ void to_operand(const float (&x)[32],
                                           uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = pack_bf16(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

// The four lanes of a quad hold one accumulator row between them.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// One online-softmax step over a 64 x 64 score tile held as an m64n64 fp32
// accumulator, in log2 units, masked entries -inf. Element i of s and of
// the output accumulator acc (any width) belongs to this thread's row
// (i >> 1) & 1. Updates the rows' running max m (log2 units) and this
// thread's share l of their running sums (the quad's shares add up: every
// lane applies the same rescale), rescales acc, and leaves p = exp2(s - m)
// in s. A row whose entries are all masked keeps m, l and acc bit for bit.
template <int NA>
__device__ __forceinline__ void online_softmax(float (&s)[32], float (&m)[2],
                                               float (&l)[2],
                                               float (&acc)[NA]) {
  float mx[2] = {-INFINITY, -INFINITY}, base[2], corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const float m_new = fmaxf(m[e], quad_max(mx[e]));
    base[e] = m_new == -INFINITY ? 0.f : m_new;
    corr[e] = m[e] == -INFINITY ? 0.f : exp2f(m[e] - base[e]);
    m[e] = m_new;
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    s[i] = exp2f(s[i] - base[(i >> 1) & 1]);
    sum[(i >> 1) & 1] += s[i];
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) l[e] = l[e] * corr[e] + sum[e];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] *= corr[(i >> 1) & 1];
}

}  // namespace tc
}  // namespace
