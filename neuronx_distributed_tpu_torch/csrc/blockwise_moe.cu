// Grouped GLU of the dropless MoE for Hopper (sm_90a): the forward, K5 for
// the packed step and K6 for decode, and the backward, K7 (dx) and K8 (dW).
//
// Replaces the Pallas TPU kernels of neuronx_distributed_tpu/ops/
// blockwise_moe.py: `_glu_fwd_kernel` (:64, launched at :198 by
// `_grouped_glu_pallas`), `_glu_fwd_decode_kernel` (:208, launched at :257
// by `_grouped_glu_decode_pallas`), `_glu_dx_kernel` (:91, launched at :293)
// and `_glu_dw_kernel` (:123, launched at :315), the last two by
// `_grouped_glu_pallas_bwd`. The forward computes, over the blocks of the
// expert-sorted rows xs [P, H],
//     ys[b] = (silu(x_b Wg_e) * (x_b Wu_e)) Wd_e,   e = block_expert[b],
// with gate_up [E, H, 2, I] (gate at index 0, up at 1, I contiguous) read in
// place and down [E, I, H]. A block with block_expert[b] >= E is a sentinel:
// its rows are exact zeros and it reads no weight byte.
//
// Bound. At the packed step (P = 1536 rows in 24 blocks of 64, E = 8,
// H = 4096, I = 14336) K5 does 541 GFLOP against 2.8 GB of bf16 weights:
// about 190 FLOP per byte, so the bound is the bytes (0.85 ms at 3.35 TB/s)
// with the operations close behind (0.55 ms at 989 TFLOP/s). In the train
// step's forward (P = 8704 rows in 136 live blocks) K5 is bound by
// operations: 6 H I FLOP per row, 3.07 TFLOP, 3.10 ms. K6 at decode (9
// blocks of 64, 6 live with 1-2 real rows each) does the same work per hit
// block over far fewer blocks; its bound is the bytes of the experts the
// step's tokens hit (2.1 GB, 0.63 ms). The backward at the train
// step (P = 8704 rows in 136 live blocks) is bound by operations: K7 does
// 10 H I FLOP per row (g, u, da, dx: 5.11 TFLOP, 5.17 ms at 989 TFLOP/s),
// K8 12 H I (g, u, da and three dW products: 6.20 ms), the pair 16 H I
// (8.27 ms); their bytes (2.8 GB of weights, 2.8 GB of dW) take 1.7 ms.
//
// Two designs of every kernel, chosen by the input type (the entries'
// dtype argument): bf16 runs on the tensor cores (namespace tc), fp32 on
// the CUDA cores, since TF32 would not hold the fp32 limit of 1e-4.
//
// CUDA-core kernels (fp32):
//  * Forward, two passes. Pass A gives a = silu(g) * u for each (row tile,
//    I tile) into an fp32 scratch act [P, I]; pass B gives y = a Wd for each
//    (row tile, H tile), summing over all of I in fp32 and rounding once.
//    The TPU kernel fused both and accumulated y over I tiles in VMEM; on
//    the card a fused kernel would recompute g and u once per H tile. The
//    TPU decode kernel wrote fp32 partials [num_ib, P, H] and summed them
//    outside; here the sum over I stays in registers, one rounding, the
//    same result.
//  * Backward, three passes that share the first, as K6 shares K5's.
//    Pass 1 gives, for each (row tile, I tile), g, u and da = dy Wd^T, then
//    dg = da u silu'(g), du = da silu(g) and (for K8) a = silu(g) u, into
//    scratch [P, I] each. Pass 2 (K7) gives dx = dg Wg^T + du Wu^T for
//    each (row tile, H tile), summing over all of I in fp32 and rounding
//    once, where the TPU kernel rounded each I tile's partial into dx.
//    Pass 3 (K8) replaces the TPU's sequential grid (ib, b), which summed an
//    expert's dW over consecutive blocks in VMEM: one CTA per (expert, dW
//    tile) finds that expert's blocks in the int32 table itself (never
//    assuming it sorted), loops over them in ascending order summing in
//    registers, and writes its tile once, in the weights' type. No atomics,
//    so the sum is deterministic; sentinel blocks add nothing, and an expert
//    that owns no block gets exact zeros, as every tile is written.
//    K7 runs passes 1-2, K8 passes 1 and 3, the pair (the autograd
//    backward) passes 1-3.
//  * Tiles are staged in shared memory as fp32 and multiplied with fp32
//    FMAs on the CUDA cores: 256 threads, each owning 4 rows x 4 columns
//    (64 x 64 tiles) or 4 rows x 8 columns (64 x 128 tiles), over reduction
//    chunks of 16. Every sum in fp32, outputs in the input type, fp32
//    scratch. Ragged H, I and block tails load as zeros and are not stored.
//  * One CTA per (64-row tile of a block, column tile), row tiles fastest,
//    in passes A, B, 1 and 2. Each live CTA reads its expert's weight tile;
//    the CTAs of one expert's run on a column tile are numbered side by
//    side, so they run together and share that tile through L2. Sentinel
//    CTAs read no weight byte: they return (passes A, 1) or store zeros
//    (passes B, 2). On decode metadata with at most 64-row blocks (each hit
//    expert holds one block) every run is one row tile, so each hit
//    expert's weights are read exactly once. In pass 3 the H tiles are
//    numbered fastest, so neighbouring CTAs share the scratch columns of
//    one I tile, and one expert's x and dy rows stay in L2.
//
// bf16 K7 and K8 (tc::glu_bwd_act_wgmma, glu_bwd_dx_wgmma,
// glu_bwd_dw_wgmma): the same three passes, every product a wgmma of bf16
// with fp32 accumulators in registers (helpers in hopper_tc.cuh).
//  * Two warpgroups (256 threads) a CTA, one CTA an SM. Tiles stay bf16 in
//    shared memory in the 128-byte swizzle; cp.async fills a ring of stages
//    (k_loop) so the next tiles' copies run under this tile's products;
//    ragged H, I and block tails are zero-filled by the copy and not
//    stored. Rows of H and I must be 16-byte multiples.
//  * Passes 1 and 2 give each warpgroup one 64-row tile and pair the two
//    tiles of a CTA (consecutive tiles, so mostly one expert's): the weight
//    tiles, which dominate the traffic, are read once for 128 rows. A pair
//    that straddles two experts runs its loops once per expert, each
//    warpgroup multiplying only under its own. Grids walk groups of 8 pairs
//    fastest, so the CTAs in flight share weight columns and rows in L2.
//  * Pass 1 (128 I columns a CTA): da = dy Wd^T (down's [I][H] rows read
//    K-major) in a first loop over H, parked in shared memory as fp32; then
//    g = x Wg and u = x Wu (gate_up's [H][2][I] rows read MN-major) in a
//    second, so two m64n128 accumulators a thread are live, not three.
//    The epilogue works on the fragments and writes dg and du rounded to
//    bf16, and where the dW pass follows also a, each as a bf16 value plus
//    the bf16 remainder of that rounding, in [2, P, I] scratch.
//  * dx pass (256 H columns a CTA, two m64n128 accumulators): K = 2I over
//    the values of dg and du, gate_up's rows K-major.
//  * dW pass: one CTA per (expert, 128 x 128 dWg/dWu tile or 128 x 256 dWd
//    tile), as the CUDA-core pass 3 but 64 rows a stage and 16 a k-step:
//    A = x^T or a^T and B = dg, du or dy are all read MN-major (the A
//    operand through its transpose bit); dWg and dWu share x. Value and
//    remainder both enter each sum (twice the products), because one bf16
//    rounding of dg, du and a put dW past the 1e-2 card limit (0.0107 at
//    the train shape, 0.0123 on a narrow card test).
//  * The new rounding: dx takes dg and du rounded once to bf16, where the
//    Pallas kernels keep them in fp32 (bounded on the CPU by
//    tests/test_torch_moe.py).
//
// bf16 K5 and K6 (tc::glu_act_wgmma, glu_down_wgmma): the forward's two
// passes on wgmma, with the backward's tiles, swizzle and cp.async rings.
//  * Pass A (128 I columns a CTA): g = x Wg and u = x Wu over all of H
//    (gate_up's rows read MN-major), then act = silu(g) u rounded once to
//    bf16 into scratch [P, I], where the CUDA-core pass keeps it in fp32:
//    half the bytes between the passes, and the A operand of pass B.
//  * Pass B: y = act Wd over all of I (act K-major, down's [I][H] rows
//    MN-major), rounded once; sentinel rows store zeros.
//  * K5 pairs two row tiles a CTA, one a warpgroup, so each weight tile
//    serves 128 rows (pass B 256 H columns a CTA). K6 runs on decode
//    metadata, where each hit expert holds one block of 1-2 real rows: a
//    pair would straddle two experts in nearly every CTA and run its loops
//    twice with one warpgroup idle. So K6 gives a CTA one row tile and each
//    warpgroup half its columns (pass B 128 H columns a CTA, two CTAs an
//    SM): every hit expert's weights are still read once, by twice as many
//    CTAs as pairs would give, to keep the SMs streaming them.
//  * The new rounding of act is bounded on the CPU by tests/
//    test_torch_moe.py, within the 1e-2 card limit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_tc.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTM = 64;            // rows per tile
constexpr int kTN = 64;            // pass A: I columns per tile
constexpr int kTH = 128;           // pass B: H columns per tile
constexpr int kTK = 16;            // reduction chunk
constexpr int kLdM = kTM + 4;      // row stride of a transposed row chunk
constexpr int kSmem = kTK * kLdM + 2 * kTK * kTN;  // floats, both passes
static_assert(kTK * kTH == 2 * kTK * kTN, "passes share one smem layout");

enum DType { kF32 = 0, kBF16 = 1 };

// The CUDA-core kernels below are instantiated for fp32 only (bf16 runs on
// the tensor cores, namespace tc).
__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}

__device__ __forceinline__ float silu(float g) {
  return g * (1.f / (1.f + expf(-g)));
}

// Stage rows [r0, r0 + nrows) x columns [k0, k0 + kTK) of a row-major
// matrix with `ld` columns (`ncols` valid) into sh[k][r] as fp32.
template <typename T>
__device__ __forceinline__ void load_rows_t(float* sh, const T* src,
                                            size_t ld, int r0, int nrows,
                                            int k0, int ncols) {
  for (int e = threadIdx.x; e < kTM * kTK; e += kThreads) {
    const int r = e / kTK, k = e % kTK;
    float v = 0.f;
    if (r < nrows && k0 + k < ncols)
      v = to_f32(src[(size_t)(r0 + r) * ld + k0 + k]);
    sh[k * kLdM + r] = v;
  }
}

// Pass A for one tile: act[r0 + r][i0 + c] = silu(g) * u over r < nrows,
// c < kTN, with g and u the products of the rows with expert e's gate and
// up columns.
template <typename T>
__device__ void act_tile(const T* __restrict__ xs,
                         const T* __restrict__ gate_up,
                         float* __restrict__ act, int r0, int nrows, int e,
                         int i0, int H, int I, float* sh) {
  float* x_sh = sh;                      // [kTK][kLdM]
  float* g_sh = x_sh + kTK * kLdM;       // [kTK][kTN]
  float* u_sh = g_sh + kTK * kTN;        // [kTK][kTN]
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const T* w = gate_up + (size_t)e * H * 2 * I;   // [H][2][I]
  float g[4][4], u[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) g[i][j] = u[i][j] = 0.f;
  for (int k0 = 0; k0 < H; k0 += kTK) {
    __syncthreads();                     // the last chunk's reads are done
    load_rows_t<T>(x_sh, xs, H, r0, nrows, k0, H);
    for (int q = threadIdx.x; q < kTK * kTN; q += kThreads) {
      const int k = q / kTN, c = q % kTN;
      float gv = 0.f, uv = 0.f;
      if (k0 + k < H && i0 + c < I) {
        const T* row = w + (size_t)(k0 + k) * 2 * I + i0 + c;
        gv = to_f32(row[0]);
        uv = to_f32(row[I]);
      }
      g_sh[q] = gv;
      u_sh[q] = uv;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kTK; ++k) {
      const float4 xv = *reinterpret_cast<const float4*>(x_sh + k * kLdM +
                                                         4 * ty);
      const float4 gv = *reinterpret_cast<const float4*>(g_sh + k * kTN +
                                                         4 * tx);
      const float4 uv = *reinterpret_cast<const float4*>(u_sh + k * kTN +
                                                         4 * tx);
      const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
      const float ga[4] = {gv.x, gv.y, gv.z, gv.w};
      const float ua[4] = {uv.x, uv.y, uv.z, uv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          g[i][j] = fmaf(xa[i], ga[j], g[i][j]);
          u[i][j] = fmaf(xa[i], ua[j], u[i][j]);
        }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    if (r >= nrows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = i0 + 4 * tx + j;
      if (c < I) act[(size_t)(r0 + r) * I + c] = silu(g[i][j]) * u[i][j];
    }
  }
}

// Pass B for one tile: ys[r0 + r][h0 + c] = sum_i act[r0 + r][i] down[e][i]
// [h0 + c], summed in fp32 over all of I and rounded once.
template <typename T>
__device__ void down_tile(const float* __restrict__ act,
                          const T* __restrict__ down, T* __restrict__ ys,
                          int r0, int nrows, int e, int h0, int H, int I,
                          float* sh) {
  float* a_sh = sh;                      // [kTK][kLdM]
  float* d_sh = a_sh + kTK * kLdM;       // [kTK][kTH]
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const T* w = down + (size_t)e * I * H;          // [I][H]
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < I; k0 += kTK) {
    __syncthreads();
    load_rows_t<float>(a_sh, act, I, r0, nrows, k0, I);
    for (int q = threadIdx.x; q < kTK * kTH; q += kThreads) {
      const int k = q / kTH, c = q % kTH;
      d_sh[q] = (k0 + k < I && h0 + c < H)
                    ? to_f32(w[(size_t)(k0 + k) * H + h0 + c])
                    : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kTK; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(a_sh + k * kLdM +
                                                         4 * ty);
      const float4 d0 = *reinterpret_cast<const float4*>(d_sh + k * kTH +
                                                         4 * tx);
      const float4 d1 = *reinterpret_cast<const float4*>(d_sh + k * kTH +
                                                         64 + 4 * tx);
      const float aa[4] = {av.x, av.y, av.z, av.w};
      const float da[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(aa[i], da[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    if (r >= nrows) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = h0 + (j < 4 ? 4 * tx + j : 64 + 4 * tx + j - 4);
      if (c < H) ys[(size_t)(r0 + r) * H + c] = from_f32<T>(acc[i][j]);
    }
  }
}

// Zero rows [r0, r0 + nrows) x columns [h0, h0 + W) of ys.
template <typename T, int W>
__device__ void zero_tile(T* __restrict__ ys, int r0, int nrows, int h0,
                          int H) {
  for (int q = threadIdx.x; q < kTM * W; q += kThreads) {
    const int r = q / W, c = h0 + q % W;
    if (r < nrows && c < H) ys[(size_t)(r0 + r) * H + c] = from_f32<T>(0.f);
  }
}

// ---------------------------------------------------------------------------
// K5 and K6: grid (blocks x row tiles per block, column tiles)
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads) glu_act_kernel(
    const T* __restrict__ xs, const T* __restrict__ gate_up,
    const int* __restrict__ block_expert, float* __restrict__ act, int H,
    int I, int E, int BS) {
  __shared__ __align__(16) float sh[kSmem];
  const int tiles = (BS + kTM - 1) / kTM;
  const int b = blockIdx.x / tiles, t = blockIdx.x % tiles;
  const int e = block_expert[b];
  if (e >= E) return;                    // sentinel: no weight, no work
  act_tile<T>(xs, gate_up, act, b * BS + t * kTM, min(kTM, BS - t * kTM), e,
              blockIdx.y * kTN, H, I, sh);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) glu_down_kernel(
    const float* __restrict__ act, const T* __restrict__ down,
    const int* __restrict__ block_expert, T* __restrict__ ys, int H, int I,
    int E, int BS) {
  __shared__ __align__(16) float sh[kSmem];
  const int tiles = (BS + kTM - 1) / kTM;
  const int b = blockIdx.x / tiles, t = blockIdx.x % tiles;
  const int r0 = b * BS + t * kTM, nrows = min(kTM, BS - t * kTM);
  const int e = block_expert[b];
  if (e >= E)
    zero_tile<T, kTH>(ys, r0, nrows, blockIdx.y * kTH, H);
  else
    down_tile<T>(act, down, ys, r0, nrows, e, blockIdx.y * kTH, H, I, sh);
}

template <typename T>
cudaError_t launch(const void* xs, const void* gate_up, const void* down,
                   const int* be, float* act, void* ys, int P, int H, int I,
                   int E, int BS, cudaStream_t stream) {
  const T* x = static_cast<const T*>(xs);
  const T* gu = static_cast<const T*>(gate_up);
  const T* dn = static_cast<const T*>(down);
  T* y = static_cast<T*>(ys);
  const int row_tiles = P / BS * ((BS + kTM - 1) / kTM);
  glu_act_kernel<T><<<dim3(row_tiles, (I + kTN - 1) / kTN), kThreads, 0,
                      stream>>>(x, gu, be, act, H, I, E, BS);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  glu_down_kernel<T><<<dim3(row_tiles, (H + kTH - 1) / kTH), kThreads, 0,
                       stream>>>(act, dn, be, y, H, I, E, BS);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K7 and K8: the backward, three passes
// ---------------------------------------------------------------------------
constexpr int kSmemBwd = 3 * kTK * kLdM + 2 * kTK * kTN;  // floats, pass 1

// Stage rows [r0, r0 + nrows) x columns [c0, c0 + W) of a row-major matrix
// with `ld` columns (`ncols` valid) into sh[r][c] as fp32, for pass 3, whose
// reduction runs over the rows (the tokens).
template <typename T, int W>
__device__ __forceinline__ void load_cols(float* sh, const T* src, size_t ld,
                                          int r0, int nrows, int c0,
                                          int ncols) {
  for (int q = threadIdx.x; q < kTK * W; q += kThreads) {
    const int r = q / W, c = q % W;
    float v = 0.f;
    if (r < nrows && c0 + c < ncols)
      v = to_f32(src[(size_t)(r0 + r) * ld + c0 + c]);
    sh[q] = v;
  }
}

// Pass 1 for one tile: with g = x Wg, u = x Wu and da = dy Wd^T over the
// tile's I columns, dg = da u silu'(g), du = da silu(g) and, where `a` is
// given, a = silu(g) u, into the fp32 scratches [P, I].
template <typename T>
__device__ void bwd_act_tile(const T* __restrict__ xs,
                             const T* __restrict__ dy,
                             const T* __restrict__ gate_up,
                             const T* __restrict__ down, float* __restrict__ a,
                             float* __restrict__ dg, float* __restrict__ du,
                             int r0, int nrows, int e, int i0, int H, int I,
                             float* sh) {
  float* x_sh = sh;                      // [kTK][kLdM] rows of xs
  float* y_sh = x_sh + kTK * kLdM;       // [kTK][kLdM] rows of dy
  float* d_sh = y_sh + kTK * kLdM;       // [kTK][kLdM] rows i0.. of Wd
  float* g_sh = d_sh + kTK * kLdM;       // [kTK][kTN]
  float* u_sh = g_sh + kTK * kTN;        // [kTK][kTN]
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const T* w = gate_up + (size_t)e * H * 2 * I;   // [H][2][I]
  const T* wd = down + (size_t)e * I * H;         // [I][H]
  const int ni = min(kTN, I - i0);
  float g[4][4], u[4][4], da[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) g[i][j] = u[i][j] = da[i][j] = 0.f;
  for (int k0 = 0; k0 < H; k0 += kTK) {
    __syncthreads();                     // the last chunk's reads are done
    load_rows_t<T>(x_sh, xs, H, r0, nrows, k0, H);
    load_rows_t<T>(y_sh, dy, H, r0, nrows, k0, H);
    load_rows_t<T>(d_sh, wd, H, i0, ni, k0, H);
    for (int q = threadIdx.x; q < kTK * kTN; q += kThreads) {
      const int k = q / kTN, c = q % kTN;
      float gv = 0.f, uv = 0.f;
      if (k0 + k < H && i0 + c < I) {
        const T* row = w + (size_t)(k0 + k) * 2 * I + i0 + c;
        gv = to_f32(row[0]);
        uv = to_f32(row[I]);
      }
      g_sh[q] = gv;
      u_sh[q] = uv;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kTK; ++k) {
      const float4 xv = *reinterpret_cast<const float4*>(x_sh + k * kLdM +
                                                         4 * ty);
      const float4 yv = *reinterpret_cast<const float4*>(y_sh + k * kLdM +
                                                         4 * ty);
      const float4 gv = *reinterpret_cast<const float4*>(g_sh + k * kTN +
                                                         4 * tx);
      const float4 uv = *reinterpret_cast<const float4*>(u_sh + k * kTN +
                                                         4 * tx);
      const float4 dv = *reinterpret_cast<const float4*>(d_sh + k * kLdM +
                                                         4 * tx);
      const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
      const float ya[4] = {yv.x, yv.y, yv.z, yv.w};
      const float ga[4] = {gv.x, gv.y, gv.z, gv.w};
      const float ua[4] = {uv.x, uv.y, uv.z, uv.w};
      const float wa[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          g[i][j] = fmaf(xa[i], ga[j], g[i][j]);
          u[i][j] = fmaf(xa[i], ua[j], u[i][j]);
          da[i][j] = fmaf(ya[i], wa[j], da[i][j]);
        }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    if (r >= nrows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = i0 + 4 * tx + j;
      if (c >= I) continue;
      const float s = 1.f / (1.f + expf(-g[i][j]));
      const float sg = g[i][j] * s;
      const size_t o = (size_t)(r0 + r) * I + c;
      dg[o] = da[i][j] * u[i][j] * (s * (1.f + g[i][j] * (1.f - s)));
      du[o] = da[i][j] * sg;
      if (a != nullptr) a[o] = sg * u[i][j];
    }
  }
}

// Pass 2 (K7) for one tile: dx[r0 + r][h0 + c] = sum_i dg[r][i] Wg[h][i] +
// du[r][i] Wu[h][i], summed in fp32 over all of I and rounded once.
template <typename T>
__device__ void bwd_dx_tile(const float* __restrict__ dg,
                            const float* __restrict__ du,
                            const T* __restrict__ gate_up, T* __restrict__ dx,
                            int r0, int nrows, int e, int h0, int H, int I,
                            float* sh) {
  float* g_sh = sh;                      // [kTK][kLdM] rows of dg
  float* u_sh = g_sh + kTK * kLdM;       // [kTK][kLdM] rows of du
  float* wg_sh = u_sh + kTK * kLdM;      // [kTK][kLdM] rows h0.. of Wg
  float* wu_sh = wg_sh + kTK * kLdM;     // [kTK][kLdM] rows h0.. of Wu
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const T* w = gate_up + (size_t)e * H * 2 * I;   // [H][2][I]
  const int nh = min(kTM, H - h0);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < I; k0 += kTK) {
    __syncthreads();
    load_rows_t<float>(g_sh, dg, I, r0, nrows, k0, I);
    load_rows_t<float>(u_sh, du, I, r0, nrows, k0, I);
    load_rows_t<T>(wg_sh, w, 2 * (size_t)I, h0, nh, k0, I);
    load_rows_t<T>(wu_sh, w + I, 2 * (size_t)I, h0, nh, k0, I);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kTK; ++k) {
      const float4 gv = *reinterpret_cast<const float4*>(g_sh + k * kLdM +
                                                         4 * ty);
      const float4 uv = *reinterpret_cast<const float4*>(u_sh + k * kLdM +
                                                         4 * ty);
      const float4 wg = *reinterpret_cast<const float4*>(wg_sh + k * kLdM +
                                                         4 * tx);
      const float4 wu = *reinterpret_cast<const float4*>(wu_sh + k * kLdM +
                                                         4 * tx);
      const float ga[4] = {gv.x, gv.y, gv.z, gv.w};
      const float ua[4] = {uv.x, uv.y, uv.z, uv.w};
      const float wga[4] = {wg.x, wg.y, wg.z, wg.w};
      const float wua[4] = {wu.x, wu.y, wu.z, wu.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = fmaf(ua[i], wua[j], fmaf(ga[i], wga[j], acc[i][j]));
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    if (r >= nrows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = h0 + 4 * tx + j;
      if (c < H) dx[(size_t)(r0 + r) * H + c] = from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) glu_bwd_act_kernel(
    const T* __restrict__ xs, const T* __restrict__ dy,
    const T* __restrict__ gate_up, const T* __restrict__ down,
    const int* __restrict__ block_expert, float* __restrict__ a,
    float* __restrict__ dg, float* __restrict__ du, int H, int I, int E,
    int BS) {
  __shared__ __align__(16) float sh[kSmemBwd];
  const int tiles = (BS + kTM - 1) / kTM;
  const int b = blockIdx.x / tiles, t = blockIdx.x % tiles;
  const int e = block_expert[b];
  if (e >= E) return;                    // sentinel: nothing reads its rows
  bwd_act_tile<T>(xs, dy, gate_up, down, a, dg, du, b * BS + t * kTM,
                  min(kTM, BS - t * kTM), e, blockIdx.y * kTN, H, I, sh);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) glu_bwd_dx_kernel(
    const float* __restrict__ dg, const float* __restrict__ du,
    const T* __restrict__ gate_up, const int* __restrict__ block_expert,
    T* __restrict__ dx, int H, int I, int E, int BS) {
  __shared__ __align__(16) float sh[4 * kTK * kLdM];
  const int tiles = (BS + kTM - 1) / kTM;
  const int b = blockIdx.x / tiles, t = blockIdx.x % tiles;
  const int r0 = b * BS + t * kTM, nrows = min(kTM, BS - t * kTM);
  const int e = block_expert[b];
  if (e >= E)
    zero_tile<T, kTM>(dx, r0, nrows, blockIdx.y * kTM, H);
  else
    bwd_dx_tile<T>(dg, du, gate_up, dx, r0, nrows, e, blockIdx.y * kTM, H,
                   I, sh);
}

// Pass 3 (K8): grid (dW tiles, E). Tiles [0, n_gu) are 64 (H) x 64 (I)
// tiles of both dWg and dWu, which read the same x rows; the rest are
// 64 (I) x 128 (H) tiles of dWd. H tiles are numbered fastest.
template <typename T>
__global__ void __launch_bounds__(kThreads) glu_bwd_dw_kernel(
    const T* __restrict__ xs, const T* __restrict__ dy,
    const float* __restrict__ a, const float* __restrict__ dg,
    const float* __restrict__ du, const int* __restrict__ block_expert,
    T* __restrict__ dgu, T* __restrict__ ddn, int nb, int H, int I, int BS) {
  __shared__ __align__(16) float sh[kTK * (kTN + kTH)];
  const int e = blockIdx.y;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int nh = (H + kTM - 1) / kTM, n_gu = nh * ((I + kTN - 1) / kTN);
  if ((int)blockIdx.x < n_gu) {
    const int h0 = blockIdx.x % nh * kTM, i0 = blockIdx.x / nh * kTN;
    float* x_sh = sh;                    // [kTK][kTM] x rows, H columns
    float* g_sh = x_sh + kTK * kTM;      // [kTK][kTN] dg rows, I columns
    float* u_sh = g_sh + kTK * kTN;      // [kTK][kTN] du rows, I columns
    float wg[4][4], wu[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) wg[i][j] = wu[i][j] = 0.f;
    for (int b = 0; b < nb; ++b) {
      if (block_expert[b] != e) continue;  // other expert, or a sentinel
      for (int r0 = b * BS; r0 < (b + 1) * BS; r0 += kTK) {
        const int nr = min(kTK, (b + 1) * BS - r0);
        __syncthreads();
        load_cols<T, kTM>(x_sh, xs, H, r0, nr, h0, H);
        load_cols<float, kTN>(g_sh, dg, I, r0, nr, i0, I);
        load_cols<float, kTN>(u_sh, du, I, r0, nr, i0, I);
        __syncthreads();
#pragma unroll
        for (int k = 0; k < kTK; ++k) {
          const float4 xv = *reinterpret_cast<const float4*>(x_sh + k * kTM +
                                                             4 * ty);
          const float4 gv = *reinterpret_cast<const float4*>(g_sh + k * kTN +
                                                             4 * tx);
          const float4 uv = *reinterpret_cast<const float4*>(u_sh + k * kTN +
                                                             4 * tx);
          const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
          const float ga[4] = {gv.x, gv.y, gv.z, gv.w};
          const float ua[4] = {uv.x, uv.y, uv.z, uv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              wg[i][j] = fmaf(xa[i], ga[j], wg[i][j]);
              wu[i][j] = fmaf(xa[i], ua[j], wu[i][j]);
            }
        }
      }
    }
    T* out = dgu + (size_t)e * H * 2 * I;         // [H][2][I]
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int h = h0 + 4 * ty + i;
      if (h >= H) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = i0 + 4 * tx + j;
        if (c >= I) continue;
        out[(size_t)h * 2 * I + c] = from_f32<T>(wg[i][j]);
        out[(size_t)h * 2 * I + I + c] = from_f32<T>(wu[i][j]);
      }
    }
  } else {
    const int t = blockIdx.x - n_gu, nh2 = (H + kTH - 1) / kTH;
    const int h0 = t % nh2 * kTH, i0 = t / nh2 * kTN;
    float* a_sh = sh;                    // [kTK][kTN] a rows, I columns
    float* y_sh = a_sh + kTK * kTN;      // [kTK][kTH] dy rows, H columns
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    for (int b = 0; b < nb; ++b) {
      if (block_expert[b] != e) continue;
      for (int r0 = b * BS; r0 < (b + 1) * BS; r0 += kTK) {
        const int nr = min(kTK, (b + 1) * BS - r0);
        __syncthreads();
        load_cols<float, kTN>(a_sh, a, I, r0, nr, i0, I);
        load_cols<T, kTH>(y_sh, dy, H, r0, nr, h0, H);
        __syncthreads();
#pragma unroll
        for (int k = 0; k < kTK; ++k) {
          const float4 av = *reinterpret_cast<const float4*>(a_sh + k * kTN +
                                                             4 * ty);
          const float4 d0 = *reinterpret_cast<const float4*>(y_sh + k * kTH +
                                                             4 * tx);
          const float4 d1 = *reinterpret_cast<const float4*>(y_sh + k * kTH +
                                                             64 + 4 * tx);
          const float aa[4] = {av.x, av.y, av.z, av.w};
          const float ya[8] = {d0.x, d0.y, d0.z, d0.w,
                               d1.x, d1.y, d1.z, d1.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j)
              acc[i][j] = fmaf(aa[i], ya[j], acc[i][j]);
        }
      }
    }
    T* out = ddn + (size_t)e * I * H;             // [I][H]
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = i0 + 4 * ty + i;
      if (r >= I) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = h0 + (j < 4 ? 4 * tx + j : 64 + 4 * tx + j - 4);
        if (c < H) out[(size_t)r * H + c] = from_f32<T>(acc[i][j]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K7 and K8 in bf16 on the tensor cores (wgmma): two warpgroups a CTA, tiles
// in the 128-byte swizzle (hopper_tc.cuh), a ring of cp.async stages.
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kThreads2 = 2 * kWarpgroup;  // two warpgroups a CTA
constexpr uint32_t kT = kAtom;             // bytes of a 64 x 64 bf16 tile
constexpr int kPairGroup = 8;              // row-tile pairs a raster group

// Each pass's stage, in 64 x 64 tiles, and its ring of stages. Pass 1:
// x of two row tiles, Wg and Wu (64 H x 128 I); its da loop uses dy of
// two row tiles and Wd (128 I x 64 H) of the same stage. dx pass: dg or
// du of two row tiles, Wg or Wu (256 H x 64 I). dW pass: five 64-row x
// 128-column tiles (x, then dg and du as value and remainder; or a as value
// and remainder, then dy's two column halves).
constexpr uint32_t kActStage = 6 * kT;
constexpr int kActStages = 3;
constexpr uint32_t kActPark = kThreads2 * 64 * 4;   // da, fp32, 64 a thread
constexpr uint32_t kDxStage = 6 * kT;
constexpr int kDxStages = 4;
constexpr uint32_t kDwStage = 10 * kT;
constexpr int kDwStages = 2;

// dynamic shared memory of a ring, with 1024 bytes to align the first tile
__host__ __device__ constexpr uint32_t ring_bytes(uint32_t stage,
                                                  int stages) {
  return stage * stages + 1024;
}

// Row tile t of the blocks: rows [r0, rend) of one block, whose expert is
// e; a tile past the last has no rows and expert E (none).
struct RowTile {
  int r0, rend, e;
};

__device__ __forceinline__ RowTile row_tile(const int* be, int t, int n_rt,
                                            int BS, int E) {
  if (t >= n_rt) return {0, 0, E};
  const int per = (BS + kRows - 1) / kRows, b = t / per, s = t % per;
  const int r0 = b * BS + s * kRows;
  return {r0, r0 + min(kRows, BS - s * kRows), be[b]};
}

// This CTA's (row-tile pair, column tile) of a 1-D grid that walks groups
// of kPairGroup pairs, pairs fastest: the CTAs that run together share the
// weight columns of their experts and their own rows through L2.
__device__ __forceinline__ void raster(int n_pairs, int n_cols, int& pair,
                                       int& col) {
  const int per = kPairGroup * n_cols, g = blockIdx.x / per;
  const int first = g * kPairGroup, size = min(kPairGroup, n_pairs - first);
  const int rem = blockIdx.x - g * per;
  pair = first + rem % size;
  col = rem / size;
}

__device__ __forceinline__ void store2(bf16* dst, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
}

// v0, v1 rounded to bf16 at hi and, where lo is given, the bf16 of what
// that rounding left out at lo: hi + lo holds v to about 2^-16.
__device__ __forceinline__ void store2_split(bf16* hi, bf16* lo, float v0,
                                             float v1) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  *reinterpret_cast<__nv_bfloat162*>(hi) = h;
  if (lo == nullptr) return;
  const float2 f = __bfloat1622float2(h);
  *reinterpret_cast<__nv_bfloat162*>(lo) =
      __floats2bfloat162_rn(v0 - f.x, v1 - f.y);
}

// A K loop of n steps over a ring of S stages `stage` bytes apart from
// sh: load(k, st) issues step k's copies into stage st, and mma(st) runs
// the products on stage st once it is in. Every thread of the CTA takes
// part; the ring is free again when it returns.
template <int S, typename Load, typename Mma>
__device__ __forceinline__ void k_loop(uint32_t sh, uint32_t stage, int n,
                                       Load load, Mma mma) {
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < n) load(s, sh + s * stage);
    cp_async_commit();
  }
  for (int k = 0; k < n; ++k) {
    cp_async_wait_group_for_wgmma<S - 2>();
    __syncthreads();                     // step k is in; k - 1's stage free
    if (k + S - 1 < n) load(k + S - 1, sh + (k + S - 1) % S * stage);
    cp_async_commit();
    mma(sh + k % S * stage);
  }
  __syncthreads();
}

// Pass 1: for two row tiles (one a warpgroup) and 128 I columns, g = x Wg,
// u = x Wu and da = dy Wd^T over all of H, then dg = da u silu'(g) and
// du = da silu(g), rounded to bf16. Where `a` is given (the dW pass
// follows), also a = silu(g) u, and each of dg, du and a is [2][P][I]: the
// bf16 value, then the bf16 of what its rounding left out (`plane` = P I
// apart). A pair whose tiles belong to two experts runs its loop once per
// expert, each warpgroup multiplying only under its own; sentinel tiles
// compute and store nothing.
__global__ void __launch_bounds__(kThreads2, 1) glu_bwd_act_wgmma(
    const bf16* __restrict__ xs, const bf16* __restrict__ dy,
    const bf16* __restrict__ gate_up, const bf16* __restrict__ down,
    const int* __restrict__ block_expert, bf16* __restrict__ a,
    bf16* __restrict__ dg, bf16* __restrict__ du, size_t plane, int n_rt,
    int H, int I, int E, int BS) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sh = (smem_u32(smem_raw) + 1023) & ~1023u;
  int pair, col;
  raster((n_rt + 1) / 2, (I + 127) / 128, pair, col);
  const RowTile t0 = row_tile(block_expert, 2 * pair, n_rt, BS, E);
  const RowTile t1 = row_tile(block_expert, 2 * pair + 1, n_rt, BS, E);
  const int wg = threadIdx.x / kWarpgroup;
  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const RowTile mine = wg ? t1 : t0;
  const int i0 = col * 128, nk = (H + 63) / 64;
  const size_t ldw = 2 * (size_t)I;
  // da parked in shared memory between the two loops, [64][256] fp32:
  // each thread's own fragment, conflict-free
  float* park = reinterpret_cast<float*>(
      smem_raw + (sh - smem_u32(smem_raw)) + kActStages * kActStage);
  for (int pass = 0; pass < 2; ++pass) {
    const int e = pass ? t1.e : t0.e;
    if (e >= E || (pass && t1.e == t0.e)) continue;
    const bf16* w = gate_up + (size_t)e * H * ldw;      // [H][2][I]
    const bf16* wd = down + (size_t)e * I * H;          // [I][H]
    const bool active = mine.e == e;
    // da = dy Wd^T over all of H, then g = x Wg and u = x Wu: two loops,
    // so that two m64n128 accumulators a thread are live at a time
    float g[64], u[64];
    zero(g);
    k_loop<kActStages>(
        sh, kActStage, nk,
        [&](int k, uint32_t st) {
          const int h0 = k * 64;
          load_tile_rc<64, 64, kThreads2>(st, dy, H, t0.r0, t0.rend, h0, H);
          load_tile_rc<64, 64, kThreads2>(st + kT, dy, H, t1.r0, t1.rend,
                                          h0, H);
          load_tile_rc<128, 64, kThreads2>(st + 2 * kT, wd, H, i0, I, h0, H);
        },
        [&](uint32_t st) {
          if (!active) return;
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss<0, 0>(g, desc_k(st + wg * kT, kk),
                           desc_k(st + 2 * kT, kk), 1);
          wgmma_commit();
          wgmma_wait();
          hold(g);
        });
#pragma unroll
    for (int i = 0; i < 64; ++i) park[i * kThreads2 + threadIdx.x] = g[i];
    zero(g);
    zero(u);
    k_loop<kActStages>(
        sh, kActStage, nk,
        [&](int k, uint32_t st) {
          const int h0 = k * 64;
          load_tile_rc<64, 64, kThreads2>(st, xs, H, t0.r0, t0.rend, h0, H);
          load_tile_rc<64, 64, kThreads2>(st + kT, xs, H, t1.r0, t1.rend,
                                          h0, H);
          load_tile_rc<64, 128, kThreads2>(st + 2 * kT, w, ldw, h0, H, i0, I);
          load_tile_rc<64, 128, kThreads2>(st + 4 * kT, w + I, ldw, h0, H,
                                           i0, I);
        },
        [&](uint32_t st) {
          if (!active) return;
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint64_t x = desc_k(st + wg * kT, kk);
            wgmma_ss<0, 1>(g, x, desc_mn(st + 2 * kT, kk), 1);   // x Wg
            wgmma_ss<0, 1>(u, x, desc_mn(st + 4 * kT, kk), 1);   // x Wu
          }
          wgmma_commit();
          wgmma_wait();
          hold(g);
          hold(u);
        });
    if (!active) continue;
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int r = mine.r0 + frag_row(warp, lane, i);
      const int c = i0 + frag_col(lane, i);
      if (r >= mine.rend || c >= I) continue;
      float o_dg[2], o_du[2], o_a[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float gv = g[i + j], uv = u[i + j];
        const float dv = park[(i + j) * kThreads2 + threadIdx.x];
        const float s = 1.f / (1.f + expf(-gv));
        const float sg = gv * s;
        o_dg[j] = dv * uv * (s * (1.f + gv * (1.f - s)));
        o_du[j] = dv * sg;
        o_a[j] = sg * uv;
      }
      const size_t o = (size_t)r * I + c;
      const bool split = a != nullptr;
      store2_split(dg + o, split ? dg + plane + o : nullptr, o_dg[0],
                   o_dg[1]);
      store2_split(du + o, split ? du + plane + o : nullptr, o_du[0],
                   o_du[1]);
      if (split) store2_split(a + o, a + plane + o, o_a[0], o_a[1]);
    }
  }
}

// K7's dx pass: for two row tiles (one a warpgroup) and 256 H columns, dx
// = [dg | du] [Wg | Wu]^T from the bf16 values of dg and du, summed over
// all of 2I in fp32 and rounded once;
// pairs of two experts as in pass 1. Sentinel rows get zeros and read no
// weight byte.
__global__ void __launch_bounds__(kThreads2, 1) glu_bwd_dx_wgmma(
    const bf16* __restrict__ dg, const bf16* __restrict__ du,
    const bf16* __restrict__ gate_up, const int* __restrict__ block_expert,
    bf16* __restrict__ dx, int n_rt, int H, int I, int E, int BS) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sh = (smem_u32(smem_raw) + 1023) & ~1023u;
  int pair, col;
  raster((n_rt + 1) / 2, (H + 255) / 256, pair, col);
  const RowTile t0 = row_tile(block_expert, 2 * pair, n_rt, BS, E);
  const RowTile t1 = row_tile(block_expert, 2 * pair + 1, n_rt, BS, E);
  const int wg = threadIdx.x / kWarpgroup;
  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const RowTile mine = wg ? t1 : t0;
  const int h0 = col * 256, nki = (I + 63) / 64, nk = 2 * nki;
  const size_t ldw = 2 * (size_t)I;
  for (int pass = 0; pass < 2; ++pass) {
    const int e = pass ? t1.e : t0.e;
    if (e >= E || (pass && t1.e == t0.e)) continue;
    const bf16* w = gate_up + (size_t)e * H * ldw;      // [H][2][I]
    // step k < nki: dg's columns 64 k.. and Wg's; then du's and Wu's
    auto load = [&](int k, uint32_t st) {
      const int part = k >= nki, c0 = (k - part * nki) * 64;
      const bf16* src = part ? du : dg;
      load_tile_rc<64, 64, kThreads2>(st, src, I, t0.r0, t0.rend, c0, I);
      load_tile_rc<64, 64, kThreads2>(st + kT, src, I, t1.r0, t1.rend, c0, I);
      load_tile_rc<256, 64, kThreads2>(st + 2 * kT, w + part * I, ldw, h0, H,
                                       c0, I);
    };
    const bool active = mine.e == e;
    float acc0[64], acc1[64];                // H columns h0.., h0 + 128..
    zero(acc0);
    zero(acc1);
    k_loop<kDxStages>(sh, kDxStage, nk, load, [&](uint32_t st) {
      if (!active) return;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t x = desc_k(st + wg * kT, kk);
        wgmma_ss<0, 0>(acc0, x, desc_k(st + 2 * kT, kk), 1);
        wgmma_ss<0, 0>(acc1, x, desc_k(st + 4 * kT, kk), 1);
      }
      wgmma_commit();
      wgmma_wait();
      hold(acc0);
      hold(acc1);
    });
    if (!active) continue;
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int r = mine.r0 + frag_row(warp, lane, i);
      const int c = h0 + frag_col(lane, i);
      if (r >= mine.rend) continue;
      bf16* out = dx + (size_t)r * H;
      if (c < H) store2(out + c, acc0[i], acc0[i + 1]);
      if (c + 128 < H) store2(out + c + 128, acc1[i], acc1[i + 1]);
    }
  }
  if (mine.e < E) return;
  for (int q = threadIdx.x % kWarpgroup; q < kRows * 128; q += kWarpgroup) {
    const int r = mine.r0 + q / 128, c = h0 + 2 * (q % 128);
    if (r < mine.rend && c < H) store2(dx + (size_t)r * H + c, 0.f, 0.f);
  }
}

// K8's dW pass: grid (dW tiles, E). Tiles [0, n_gu) are 128 (H) x 128 (I)
// tiles of both dWg = x^T dg and dWu = x^T du, which share x; the rest are
// 128 (I) x 256 (H) tiles of dWd = a^T dy. Warpgroup w computes rows
// 64 w.. of the tile. dg, du and a enter as both their bf16 planes (value
// and remainder, staged together with x or dy), so the sums see them to
// about 2^-16, as the fp32 versions do. The CTA finds its expert's blocks in
// the table (never assuming it sorted) and adds them in ascending order,
// 64 rows a stage, 16 a wgmma k-step, both operands read MN-major (x^T and
// a^T through the A operand's transpose bit). No atomics: the same bits on
// every launch; sentinel blocks add nothing; an expert that owns no block
// gets exact zeros, as every tile is written.
__global__ void __launch_bounds__(kThreads2, 1) glu_bwd_dw_wgmma(
    const bf16* __restrict__ xs, const bf16* __restrict__ dy,
    const bf16* __restrict__ a, const bf16* __restrict__ dg,
    const bf16* __restrict__ du, const int* __restrict__ block_expert,
    bf16* __restrict__ dgu, bf16* __restrict__ ddn, size_t plane, int nb,
    int H, int I, int BS) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sh = (smem_u32(smem_raw) + 1023) & ~1023u;
  const int e = blockIdx.y;
  const int wg = threadIdx.x / kWarpgroup;
  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int nh = (H + 127) / 128, n_gu = nh * ((I + 127) / 128);
  const bool gu = (int)blockIdx.x < n_gu;
  // gu: rows x columns [m0, m0 + 128) of H (x), columns [n0, n0 + 128) of
  // I (dg, du); dd: columns [m0, m0 + 128) of I (a), [n0, n0 + 256) of H
  // (dy)
  int m0, n0;
  if (gu) {
    m0 = blockIdx.x % nh * 128;
    n0 = blockIdx.x / nh * 128;
  } else {
    const int t = blockIdx.x - n_gu, nh2 = (H + 255) / 256;
    n0 = t % nh2 * 256;
    m0 = t / nh2 * 128;
  }
  const int per = (BS + 63) / 64;        // 64-row chunks a block
  int n = 0;
  for (int b = 0; b < nb; ++b) n += block_expert[b] == e ? per : 0;
  int lb = 0, lc = 0;                    // the next chunk to load
  while (lb < nb && block_expert[lb] != e) ++lb;
  auto load = [&](int, uint32_t st) {
    const int r0 = lb * BS + lc * 64, rend = min(r0 + 64, (lb + 1) * BS);
    if (gu) {
      load_tile_rc<64, 128, kThreads2>(st, xs, H, r0, rend, m0, H);
      load_tile_rc<64, 128, kThreads2>(st + 2 * kT, dg, I, r0, rend, n0, I);
      load_tile_rc<64, 128, kThreads2>(st + 4 * kT, dg + plane, I, r0, rend,
                                       n0, I);
      load_tile_rc<64, 128, kThreads2>(st + 6 * kT, du, I, r0, rend, n0, I);
      load_tile_rc<64, 128, kThreads2>(st + 8 * kT, du + plane, I, r0, rend,
                                       n0, I);
    } else {
      load_tile_rc<64, 128, kThreads2>(st, a, I, r0, rend, m0, I);
      load_tile_rc<64, 128, kThreads2>(st + 2 * kT, a + plane, I, r0, rend,
                                       m0, I);
      load_tile_rc<64, 128, kThreads2>(st + 4 * kT, dy, H, r0, rend, n0, H);
      load_tile_rc<64, 128, kThreads2>(st + 6 * kT, dy, H, r0, rend,
                                       n0 + 128, H);
    }
    if (++lc == per) {
      lc = 0;
      do ++lb; while (lb < nb && block_expert[lb] != e);
    }
  };
  float acc0[64], acc1[64];
  zero(acc0);
  zero(acc1);
  k_loop<kDwStages>(sh, kDwStage, n, load, [&](uint32_t st) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (gu) {                          // x^T (value + remainder)
        const uint64_t xt = desc_mn(st + wg * kT, kk);
        wgmma_ss<1, 1>(acc0, xt, desc_mn(st + 2 * kT, kk), 1);
        wgmma_ss<1, 1>(acc0, xt, desc_mn(st + 4 * kT, kk), 1);
        wgmma_ss<1, 1>(acc1, xt, desc_mn(st + 6 * kT, kk), 1);
        wgmma_ss<1, 1>(acc1, xt, desc_mn(st + 8 * kT, kk), 1);
      } else {                           // (value + remainder)^T dy
        const uint64_t hi = desc_mn(st + wg * kT, kk);
        const uint64_t lo = desc_mn(st + (2 + wg) * kT, kk);
        const uint64_t y0 = desc_mn(st + 4 * kT, kk);
        const uint64_t y1 = desc_mn(st + 6 * kT, kk);
        wgmma_ss<1, 1>(acc0, hi, y0, 1);
        wgmma_ss<1, 1>(acc0, lo, y0, 1);
        wgmma_ss<1, 1>(acc1, hi, y1, 1);
        wgmma_ss<1, 1>(acc1, lo, y1, 1);
      }
    }
    wgmma_commit();
    wgmma_wait();
    hold(acc0);
    hold(acc1);
  });
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    const int m = m0 + 64 * wg + frag_row(warp, lane, i);
    const int c = frag_col(lane, i);
    if (gu) {
      if (m >= H || n0 + c >= I) continue;
      bf16* out = dgu + ((size_t)e * H + m) * 2 * I + n0 + c;   // [H][2][I]
      store2(out, acc0[i], acc0[i + 1]);
      store2(out + I, acc1[i], acc1[i + 1]);
    } else {
      if (m >= I) continue;
      bf16* out = ddn + ((size_t)e * I + m) * H;                 // [I][H]
      if (n0 + c < H) store2(out + n0 + c, acc0[i], acc0[i + 1]);
      if (n0 + 128 + c < H)
        store2(out + n0 + 128 + c, acc1[i], acc1[i + 1]);
    }
  }
}

template <typename K>
cudaError_t set_smem(K kernel, uint32_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// Pass 1, then the dx pass where dx is given and the dW pass where dgu is.
cudaError_t launch_bwd(const void* xs, const void* gate_up, const void* down,
                       const int* be, const void* dy, void* a, void* dg,
                       void* du, void* dx, void* dgu, void* ddn, int P, int H,
                       int I, int E, int BS, cudaStream_t stream) {
  const bf16* x = static_cast<const bf16*>(xs);
  const bf16* gu = static_cast<const bf16*>(gate_up);
  const bf16* g = static_cast<const bf16*>(dy);
  bf16* ab = static_cast<bf16*>(a);
  bf16* gb = static_cast<bf16*>(dg);
  bf16* ub = static_cast<bf16*>(du);
  const int n_rt = P / BS * ((BS + kRows - 1) / kRows);
  const int n_pairs = (n_rt + 1) / 2;
  constexpr uint32_t act_smem = ring_bytes(kActStage, kActStages) + kActPark;
  cudaError_t err = set_smem(glu_bwd_act_wgmma, act_smem);
  if (err != cudaSuccess) return err;
  const size_t plane = (size_t)P * I;
  glu_bwd_act_wgmma<<<n_pairs * ((I + 127) / 128), kThreads2, act_smem,
                      stream>>>(x, g, gu, static_cast<const bf16*>(down), be,
                                ab, gb, ub, plane, n_rt, H, I, E, BS);
  err = cudaGetLastError();
  if (err == cudaSuccess && dx != nullptr) {
    constexpr uint32_t dx_smem = ring_bytes(kDxStage, kDxStages);
    err = set_smem(glu_bwd_dx_wgmma, dx_smem);
    if (err != cudaSuccess) return err;
    glu_bwd_dx_wgmma<<<n_pairs * ((H + 255) / 256), kThreads2, dx_smem,
                       stream>>>(gb, ub, gu, be, static_cast<bf16*>(dx), n_rt,
                                 H, I, E, BS);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess || dgu == nullptr) return err;
  constexpr uint32_t dw_smem = ring_bytes(kDwStage, kDwStages);
  err = set_smem(glu_bwd_dw_wgmma, dw_smem);
  if (err != cudaSuccess) return err;
  const int tiles = (H + 127) / 128 * ((I + 127) / 128) +
                    (H + 255) / 256 * ((I + 127) / 128);
  glu_bwd_dw_wgmma<<<dim3(tiles, E), kThreads2, dw_smem, stream>>>(
      x, g, ab, gb, ub, be, static_cast<bf16*>(dgu), static_cast<bf16*>(ddn),
      plane, P / BS, H, I, BS);
  return cudaGetLastError();
}


// K5 and K6: the forward's two passes. Pairs (Split false, K5): each
// warpgroup owns one 64-row tile of a pair and the weight tiles serve both,
// as in pass 1 and the dx pass. Split (K6): one row tile a CTA and each
// warpgroup half of its columns, since on decode metadata each hit expert
// holds one block and a pair would nearly always straddle two experts,
// running its loops twice with one warpgroup idle. Stages, in 64 x 64
// tiles: pass A, x of each row tile, then Wg and Wu (64 H x 128 I); pass
// B, act of each row tile, then Wd (64 I x 256 H for pairs, 128 for Split).
constexpr int kFwdStages = 4;

__host__ __device__ constexpr uint32_t act_stage(bool split) {
  return (split ? 5 : 6) * kT;
}

__host__ __device__ constexpr uint32_t down_stage(bool split) {
  return (split ? 3 : 6) * kT;
}

// Pass A: for 128 I columns of one row tile (Split) or of each tile of a
// pair, act = silu(x Wg) * (x Wu), summed over all of H in fp32 and
// rounded once to bf16. gate_up's [H][2][I] rows are read MN-major. A pair
// whose tiles belong to two experts runs its loop once per expert, each
// warpgroup multiplying only under its own; sentinel tiles compute and
// store nothing.
template <bool Split>
__global__ void __launch_bounds__(kThreads2, 1) glu_act_wgmma(
    const bf16* __restrict__ xs, const bf16* __restrict__ gate_up,
    const int* __restrict__ block_expert, bf16* __restrict__ act, int n_rt,
    int H, int I, int E, int BS) {
  constexpr int kN = Split ? 64 : 128;         // I columns a warpgroup
  constexpr uint32_t kStage = act_stage(Split);
  constexpr uint32_t kW = (Split ? 1 : 2) * kT;  // Wg's tile in a stage
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sh = (smem_u32(smem_raw) + 1023) & ~1023u;
  int unit, col;
  raster(Split ? n_rt : (n_rt + 1) / 2, (I + 127) / 128, unit, col);
  const RowTile t0 = row_tile(block_expert, Split ? unit : 2 * unit, n_rt,
                              BS, E);
  const RowTile t1 =
      Split ? t0 : row_tile(block_expert, 2 * unit + 1, n_rt, BS, E);
  const int wg = threadIdx.x / kWarpgroup;
  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const RowTile mine = wg ? t1 : t0;
  const int i0 = col * 128, nk = (H + 63) / 64;
  const int c0 = i0 + (Split ? 64 * wg : 0);   // this warpgroup's columns
  const uint32_t xo = Split ? 0 : wg * kT;     // its x tile, its Wg atoms
  const uint32_t wo = kW + (Split ? wg * kT : 0);
  const size_t ldw = 2 * (size_t)I;
  for (int pass = 0; pass < 2; ++pass) {
    const int e = pass ? t1.e : t0.e;
    if (e >= E || (pass && t1.e == t0.e)) continue;
    const bf16* w = gate_up + (size_t)e * H * ldw;      // [H][2][I]
    const bool active = mine.e == e;
    float g[kN / 2], u[kN / 2];
    zero(g);
    zero(u);
    k_loop<kFwdStages>(
        sh, kStage, nk,
        [&](int k, uint32_t st) {
          const int h0 = k * 64;
          load_tile_rc<64, 64, kThreads2>(st, xs, H, t0.r0, t0.rend, h0, H);
          if (!Split)
            load_tile_rc<64, 64, kThreads2>(st + kT, xs, H, t1.r0, t1.rend,
                                            h0, H);
          load_tile_rc<64, 128, kThreads2>(st + kW, w, ldw, h0, H, i0, I);
          load_tile_rc<64, 128, kThreads2>(st + kW + 2 * kT, w + I, ldw, h0,
                                           H, i0, I);
        },
        [&](uint32_t st) {
          if (!active) return;
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint64_t x = desc_k(st + xo, kk);
            wgmma_ss<0, 1>(g, x, desc_mn(st + wo, kk), 1);            // x Wg
            wgmma_ss<0, 1>(u, x, desc_mn(st + wo + 2 * kT, kk), 1);   // x Wu
          }
          wgmma_commit();
          wgmma_wait();
          hold(g);
          hold(u);
        });
    if (!active) continue;
#pragma unroll
    for (int i = 0; i < kN / 2; i += 2) {
      const int r = mine.r0 + frag_row(warp, lane, i);
      const int c = c0 + frag_col(lane, i);
      if (r < mine.rend && c < I)
        store2(act + (size_t)r * I + c, silu(g[i]) * u[i],
               silu(g[i + 1]) * u[i + 1]);
    }
  }
}

// Pass B: for one row tile (Split: 128 H columns a CTA, 64 a warpgroup) or
// each tile of a pair (256 H columns, two m64n128 accumulators a thread),
// ys = act Wd, summed over all of I in fp32 and rounded once. down's
// [I][H] rows are read MN-major; pairs of two experts as in pass A.
// Sentinel rows get zeros and read no weight byte.
template <bool Split>
__global__ void __launch_bounds__(kThreads2, Split ? 2 : 1) glu_down_wgmma(
    const bf16* __restrict__ act, const bf16* __restrict__ down,
    const int* __restrict__ block_expert, bf16* __restrict__ ys, int n_rt,
    int H, int I, int E, int BS) {
  constexpr int kCols = Split ? 128 : 256;     // H columns a CTA
  constexpr int kAcc = Split ? 1 : 2;          // accumulators a thread
  constexpr int kN = Split ? 64 : 128;         // H columns an accumulator
  constexpr uint32_t kStage = down_stage(Split);
  constexpr uint32_t kW = (Split ? 1 : 2) * kT;  // Wd's tile in a stage
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sh = (smem_u32(smem_raw) + 1023) & ~1023u;
  int unit, col;
  raster(Split ? n_rt : (n_rt + 1) / 2, (H + kCols - 1) / kCols, unit, col);
  const RowTile t0 = row_tile(block_expert, Split ? unit : 2 * unit, n_rt,
                              BS, E);
  const RowTile t1 =
      Split ? t0 : row_tile(block_expert, 2 * unit + 1, n_rt, BS, E);
  const int wg = threadIdx.x / kWarpgroup;
  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const RowTile mine = wg ? t1 : t0;
  const int h0 = col * kCols, nk = (I + 63) / 64;
  const int hw = h0 + (Split ? 64 * wg : 0);   // this warpgroup's columns
  const uint32_t ao = Split ? 0 : wg * kT;     // its act tile, its Wd atoms
  const uint32_t wo = kW + (Split ? wg * kT : 0);
  for (int pass = 0; pass < 2; ++pass) {
    const int e = pass ? t1.e : t0.e;
    if (e >= E || (pass && t1.e == t0.e)) continue;
    const bf16* wd = down + (size_t)e * I * H;          // [I][H]
    const bool active = mine.e == e;
    float acc[kAcc][kN / 2];
#pragma unroll
    for (int j = 0; j < kAcc; ++j) zero(acc[j]);
    k_loop<kFwdStages>(
        sh, kStage, nk,
        [&](int k, uint32_t st) {
          const int i0 = k * 64;
          load_tile_rc<64, 64, kThreads2>(st, act, I, t0.r0, t0.rend, i0, I);
          if (!Split)
            load_tile_rc<64, 64, kThreads2>(st + kT, act, I, t1.r0, t1.rend,
                                            i0, I);
          load_tile_rc<64, kCols, kThreads2>(st + kW, wd, H, i0, I, h0, H);
        },
        [&](uint32_t st) {
          if (!active) return;
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint64_t a = desc_k(st + ao, kk);
#pragma unroll
            for (int j = 0; j < kAcc; ++j)
              wgmma_ss<0, 1>(acc[j], a, desc_mn(st + wo + 2 * j * kT, kk), 1);
          }
          wgmma_commit();
          wgmma_wait();
#pragma unroll
          for (int j = 0; j < kAcc; ++j) hold(acc[j]);
        });
    if (!active) continue;
#pragma unroll
    for (int i = 0; i < kN / 2; i += 2) {
      const int r = mine.r0 + frag_row(warp, lane, i);
      if (r >= mine.rend) continue;
#pragma unroll
      for (int j = 0; j < kAcc; ++j) {
        const int c = hw + j * 128 + frag_col(lane, i);
        if (c < H) store2(ys + (size_t)r * H + c, acc[j][i], acc[j][i + 1]);
      }
    }
  }
  if (mine.e < E) return;
  constexpr int kHalf = (Split ? 64 : 256) / 2;  // column pairs a warpgroup
  for (int q = threadIdx.x % kWarpgroup; q < kRows * kHalf; q += kWarpgroup) {
    const int r = mine.r0 + q / kHalf, c = hw + 2 * (q % kHalf);
    if (r < mine.rend && c < H) store2(ys + (size_t)r * H + c, 0.f, 0.f);
  }
}

// Pass A into the bf16 scratch act [P, I], then pass B.
template <bool Split>
cudaError_t launch_fwd(const void* xs, const void* gate_up, const void* down,
                       const int* be, void* act, void* ys, int P, int H,
                       int I, int E, int BS, cudaStream_t stream) {
  const int n_rt = P / BS * ((BS + kRows - 1) / kRows);
  const int units = Split ? n_rt : (n_rt + 1) / 2;
  bf16* a = static_cast<bf16*>(act);
  constexpr uint32_t act_smem = ring_bytes(act_stage(Split), kFwdStages);
  cudaError_t err = set_smem(glu_act_wgmma<Split>, act_smem);
  if (err != cudaSuccess) return err;
  glu_act_wgmma<Split><<<units * ((I + 127) / 128), kThreads2, act_smem,
                         stream>>>(static_cast<const bf16*>(xs),
                                   static_cast<const bf16*>(gate_up), be, a,
                                   n_rt, H, I, E, BS);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr int cols = Split ? 128 : 256;
  constexpr uint32_t down_smem = ring_bytes(down_stage(Split), kFwdStages);
  err = set_smem(glu_down_wgmma<Split>, down_smem);
  if (err != cudaSuccess) return err;
  glu_down_wgmma<Split><<<units * ((H + cols - 1) / cols), kThreads2,
                          down_smem, stream>>>(
      a, static_cast<const bf16*>(down), be, static_cast<bf16*>(ys), n_rt, H,
      I, E, BS);
  return cudaGetLastError();
}

}  // namespace tc

// The forward: fp32 on the CUDA cores; bf16 on the tensor cores, row tiles
// in pairs for K5 and split by columns for K6 (`decode`).
int run(bool decode, int dtype, const void* xs, const void* gate_up,
        const void* down, const void* block_expert, void* act, void* ys,
        int P, int H, int I, int E, int BS, void* stream) {
  if (P <= 0 || H <= 0 || I <= 0 || E <= 0 || BS <= 0 || P % BS != 0 ||
      (I + kTN - 1) / kTN > 65535 || (H + kTH - 1) / kTH > 65535)
    return cudaErrorInvalidValue;
  const int* be = static_cast<const int*>(block_expert);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch<float>(xs, gate_up, down, be, static_cast<float*>(act),
                           ys, P, H, I, E, BS, s);
    case kBF16:
      // cp.async moves 16-byte chunks: rows of H and I, and every tensor,
      // 16-byte aligned
      if (H % 8 != 0 || I % 8 != 0 ||
          ((uintptr_t)xs | (uintptr_t)gate_up | (uintptr_t)down |
           (uintptr_t)act | (uintptr_t)ys) & 15)
        return cudaErrorInvalidValue;
      return decode ? tc::launch_fwd<true>(xs, gate_up, down, be, act, ys, P,
                                           H, I, E, BS, s)
                    : tc::launch_fwd<false>(xs, gate_up, down, be, act, ys, P,
                                            H, I, E, BS, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_bwd(const void* xs, const void* gate_up, const void* down,
                       const int* be, const void* dy, float* a, float* dg,
                       float* du, void* dx, void* dgu, void* ddn, int P,
                       int H, int I, int E, int BS, cudaStream_t stream) {
  const T* x = static_cast<const T*>(xs);
  const T* gu = static_cast<const T*>(gate_up);
  const T* g = static_cast<const T*>(dy);
  const int row_tiles = P / BS * ((BS + kTM - 1) / kTM);
  glu_bwd_act_kernel<T><<<dim3(row_tiles, (I + kTN - 1) / kTN), kThreads, 0,
                          stream>>>(x, g, gu, static_cast<const T*>(down),
                                    be, a, dg, du, H, I, E, BS);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess && dx != nullptr) {
    glu_bwd_dx_kernel<T><<<dim3(row_tiles, (H + kTM - 1) / kTM), kThreads, 0,
                           stream>>>(dg, du, gu, be, static_cast<T*>(dx), H,
                                     I, E, BS);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess || dgu == nullptr) return err;
  const int tiles = (H + kTM - 1) / kTM * ((I + kTN - 1) / kTN) +
                    (H + kTH - 1) / kTH * ((I + kTN - 1) / kTN);
  glu_bwd_dw_kernel<T><<<dim3(tiles, E), kThreads, 0, stream>>>(
      x, g, a, dg, du, be, static_cast<T*>(dgu), static_cast<T*>(ddn), P / BS,
      H, I, BS);
  return cudaGetLastError();
}

// want_dx / want_dw: what the entry computes; the pointers of what it does
// not compute must be null, and those of what it does must not.
int run_bwd(bool want_dx, bool want_dw, int dtype, const void* xs,
            const void* gate_up, const void* down, const void* block_expert,
            const void* dy, void* a, void* dg, void* du, void* dx, void* dgu,
            void* ddn, int P, int H, int I, int E, int BS, void* stream) {
  if (P <= 0 || H <= 0 || I <= 0 || E <= 0 || BS <= 0 || P % BS != 0 ||
      (I + kTN - 1) / kTN > 65535 || (H + kTM - 1) / kTM > 65535 ||
      E > 65535 || dg == nullptr || du == nullptr ||
      want_dx != (dx != nullptr) || want_dw != (dgu != nullptr) ||
      want_dw != (ddn != nullptr) || want_dw != (a != nullptr))
    return cudaErrorInvalidValue;
  const int* be = static_cast<const int*>(block_expert);
  float* af = static_cast<float*>(a);
  float* gf = static_cast<float*>(dg);
  float* uf = static_cast<float*>(du);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch_bwd<float>(xs, gate_up, down, be, dy, af, gf, uf, dx, dgu,
                               ddn, P, H, I, E, BS, s);
    case kBF16:
      // cp.async moves 16-byte chunks: rows of H and I, and every tensor,
      // 16-byte aligned
      if (H % 8 != 0 || I % 8 != 0 ||
          ((uintptr_t)xs | (uintptr_t)gate_up | (uintptr_t)down |
           (uintptr_t)dy | (uintptr_t)a | (uintptr_t)dg | (uintptr_t)du |
           (uintptr_t)dx | (uintptr_t)dgu | (uintptr_t)ddn) & 15)
        return cudaErrorInvalidValue;
      return tc::launch_bwd(xs, gate_up, down, be, dy, a, dg, du, dx, dgu,
                            ddn, P, H, I, E, BS, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Each returns a cudaError_t: 0 on a clean launch of both passes. `act` is
// scratch [P, I]: fp32 for fp32 inputs, bf16 for bf16 ones (H and I
// multiples of 8); every pointer is contiguous device memory. In fp32 K5
// and K6 run the same two kernels; in bf16 K5 pairs row tiles and K6 splits
// one tile's columns between the warpgroups.
extern "C" int nxd_grouped_glu(int dtype, const void* xs, const void* gate_up,
                               const void* down, const void* block_expert,
                               void* act, void* ys, int P, int H, int I,
                               int E, int BS, void* stream) {
  return run(false, dtype, xs, gate_up, down, block_expert, act, ys, P, H, I,
             E, BS, stream);
}

extern "C" int nxd_grouped_glu_decode(int dtype, const void* xs,
                                      const void* gate_up, const void* down,
                                      const void* block_expert, void* act,
                                      void* ys, int P, int H, int I, int E,
                                      int BS, void* stream) {
  return run(true, dtype, xs, gate_up, down, block_expert, act, ys, P, H, I,
             E, BS, stream);
}

// The backward entries, each returning a cudaError_t: 0 on a clean launch of
// its passes. dg and du (and a, for dW) are scratch: fp32 [P, I] for fp32
// inputs; for bf16 inputs (H and I multiples of 8) bf16 [P, I], or
// [2, P, I] (value and remainder) where dW is computed; dy, dx are
// [P, H], dgu and ddn shaped and typed as gate_up and down; every pointer is
// contiguous device memory. K7 writes dx (a, dgu, ddn null), K8 dgu and ddn
// (dx null), the pair all three from one pass 1.
extern "C" int nxd_grouped_glu_dx(int dtype, const void* xs,
                                  const void* gate_up, const void* down,
                                  const void* block_expert, const void* dy,
                                  void* a, void* dg, void* du, void* dx,
                                  void* dgu, void* ddn, int P, int H, int I,
                                  int E, int BS, void* stream) {
  return run_bwd(true, false, dtype, xs, gate_up, down, block_expert, dy, a, dg,
                 du, dx, dgu, ddn, P, H, I, E, BS, stream);
}

extern "C" int nxd_grouped_glu_dw(int dtype, const void* xs,
                                  const void* gate_up, const void* down,
                                  const void* block_expert, const void* dy,
                                  void* a, void* dg, void* du, void* dx,
                                  void* dgu, void* ddn, int P, int H, int I,
                                  int E, int BS, void* stream) {
  return run_bwd(false, true, dtype, xs, gate_up, down, block_expert, dy, a, dg,
                 du, dx, dgu, ddn, P, H, I, E, BS, stream);
}

extern "C" int nxd_grouped_glu_bwd(int dtype, const void* xs,
                                   const void* gate_up, const void* down,
                                   const void* block_expert, const void* dy,
                                   void* a, void* dg, void* du, void* dx,
                                   void* dgu, void* ddn, int P, int H, int I,
                                   int E, int BS, void* stream) {
  return run_bwd(true, true, dtype, xs, gate_up, down, block_expert, dy, a, dg,
                 du, dx, dgu, ddn, P, H, I, E, BS, stream);
}
