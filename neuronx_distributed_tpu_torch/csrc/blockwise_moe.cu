// Grouped GLU of the dropless MoE, forward, for Hopper (sm_90a): K5 for the
// packed step and K6 for decode.
//
// Replaces the Pallas TPU kernels of neuronx_distributed_tpu/ops/
// blockwise_moe.py: `_glu_fwd_kernel` (:64, launched at :198 by
// `_grouped_glu_pallas`) and `_glu_fwd_decode_kernel` (:208, launched at
// :257 by `_grouped_glu_decode_pallas`). Both compute, over the blocks of
// the expert-sorted rows xs [P, H],
//     ys[b] = (silu(x_b Wg_e) * (x_b Wu_e)) Wd_e,   e = block_expert[b],
// with gate_up [E, H, 2, I] (gate at index 0, up at 1, I contiguous) read in
// place and down [E, I, H]. A block with block_expert[b] >= E is a sentinel:
// its rows are exact zeros and it reads no weight byte.
//
// Bound. At the packed step (P = 1536 rows in 24 blocks of 64, E = 8,
// H = 4096, I = 14336) K5 does 541 GFLOP against 2.8 GB of bf16 weights:
// about 190 FLOP per byte, so the bound is the bytes (0.84 ms at 3.35 TB/s)
// with the operations close behind (0.55 ms at 989 TFLOP/s). K6 at decode
// does the same work per hit block over far fewer blocks; its bound is the
// bytes of the experts the step's tokens hit.
//
// Design (simple and correct first; tensor cores come later):
//  * Two passes. Pass A gives a = silu(g) * u for each (row tile, I tile)
//    into an fp32 scratch act [P, I]; pass B gives y = a Wd for each (row
//    tile, H tile), summing over all of I in fp32 and rounding once. The
//    TPU kernel fused both and accumulated y over I tiles in VMEM; on the
//    card a fused kernel would recompute g and u once per H tile. The TPU
//    decode kernel wrote fp32 partials [num_ib, P, H] and summed them
//    outside; here the sum over I stays in registers, one rounding, the
//    same result.
//  * Tiles are staged in shared memory as fp32 and multiplied with fp32
//    FMAs on the CUDA cores: 256 threads, each owning 4 rows x 4 columns of
//    both g and u (pass A, 64 x 64 tiles) or 4 rows x 8 columns of y (pass B,
//    64 x 128 tiles), over reduction chunks of 16. Inputs fp32 or bf16, every
//    sum in fp32, ys in the input type. Ragged H, I and block tails load as
//    zeros and are not stored.
//  * One CTA per (64-row tile of a block, column tile), row tiles fastest.
//    Each live CTA reads its expert's weight tile; the CTAs of one expert's
//    run on a column tile are numbered side by side, so they run together
//    and share that tile through L2. Sentinel CTAs read no weight byte: they
//    return (pass A) or store zeros (pass B). On decode metadata with at
//    most 64-row blocks (each hit expert holds one block) every run is one
//    row tile, so each hit expert's weights are read exactly once.
//  * K5 and K6 share these kernels and differ in entry point only.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
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

// Zero rows [r0, r0 + nrows) x columns [h0, h0 + kTH) of ys.
template <typename T>
__device__ void zero_tile(T* __restrict__ ys, int r0, int nrows, int h0,
                          int H) {
  for (int q = threadIdx.x; q < kTM * kTH; q += kThreads) {
    const int r = q / kTH, c = h0 + q % kTH;
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
    zero_tile<T>(ys, r0, nrows, blockIdx.y * kTH, H);
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

int run(int dtype, const void* xs, const void* gate_up, const void* down,
        const void* block_expert, void* act, void* ys, int P, int H, int I,
        int E, int BS, void* stream) {
  if (P <= 0 || H <= 0 || I <= 0 || E <= 0 || BS <= 0 || P % BS != 0 ||
      (I + kTN - 1) / kTN > 65535 || (H + kTH - 1) / kTH > 65535)
    return cudaErrorInvalidValue;
  const int* be = static_cast<const int*>(block_expert);
  float* a = static_cast<float*>(act);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch<float>(xs, gate_up, down, be, a, ys, P, H, I, E, BS, s);
    case kBF16:
      return launch<__nv_bfloat16>(xs, gate_up, down, be, a, ys, P, H, I, E,
                                   BS, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Each returns a cudaError_t: 0 on a clean launch of both passes. `act` is
// fp32 scratch [P, I]; every pointer is contiguous device memory. K5 and K6
// run the same two kernels; each has its own entry so that the port counts
// and checks them apart.
extern "C" int nxd_grouped_glu(int dtype, const void* xs, const void* gate_up,
                               const void* down, const void* block_expert,
                               void* act, void* ys, int P, int H, int I,
                               int E, int BS, void* stream) {
  return run(dtype, xs, gate_up, down, block_expert, act, ys, P, H, I, E, BS,
             stream);
}

extern "C" int nxd_grouped_glu_decode(int dtype, const void* xs,
                                      const void* gate_up, const void* down,
                                      const void* block_expert, void* act,
                                      void* ys, int P, int H, int I, int E,
                                      int BS, void* stream) {
  return run(dtype, xs, gate_up, down, block_expert, act, ys, P, H, I, E, BS,
             stream);
}
