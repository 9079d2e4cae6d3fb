// Flash attention, forward (K2) and backward (K3: dq, K4: dk/dv), for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of neuronx_distributed_tpu/ops/
// flash_attention.py: `_flash_fwd_kernel` (:229, launched at :322),
// `_flash_bwd_dq_kernel` (:426, :565) and `_flash_bwd_dkv_kernel` (:474,
// :586). Each computes what its TPU kernel computes:
//  * K2: out = softmax(scale * q k^T) v with an online softmax in fp32, and
//    lse = m + log(l) per query row. With dropout the normaliser l sums the
//    undropped p, only the PV accumulation sees the keep mask, and the
//    survivors are rescaled by 1/(1-p) once at the end.
//  * K3: dq = sum_k ds k with p = exp(s - lse), dp = g v^T (masked and
//    rescaled under dropout), ds = p (dp - delta) scale; delta = rowsum(g out)
//    comes in precomputed.
//  * K4: dv = sum_q p_dropped^T g, dk = sum_q ds^T q.
// The keep mask is the same counter hash as `dropout_keep_mask` (:43) on
// global (q, k) coordinates and the flat batch x query-head index of the
// global array (a rank's rows and heads placed by `Dropout::b_off`,
// `h_off` and `n_global`), so the kernels regenerate the plain version's
// mask bit for bit.
//
// Bound: operations. At B=1, S=4096, N=32, D=128, causal, K2 does about
// 137 GFLOP against 84 MB of traffic, over 1600 FLOP per byte, far above the
// H100's ~295 bf16 FLOP per byte; K3 and K4 add one and two more products
// (206 and 275 GFLOP: 0.21 and 0.28 ms at 989 bf16 TFLOP/s).
//
// Two designs, chosen by the input type (the C entries' dtype argument):
//
// bf16 K2, K3 and K4 (namespace tc, `flash_fwd_wgmma`,
// `flash_bwd_dq_wgmma`, `flash_bwd_dkv_wgmma`): only the tensor cores reach
// the bound, so every product is a wgmma of bf16 with fp32 accumulators in
// registers.
//  * One warpgroup (128 threads) per CTA and 64-row tiles, two CTAs an SM
//    (81, 97 and 99 KB of shared memory at D=128), so one CTA's
//    softmax-side work overlaps the other's products.
//  * Tiles stay bf16 in shared memory in the 128-byte swizzle the wgmma
//    descriptors read (two 64-column atoms a row at D=128). The streamed
//    operand (K and V in K2 and K3; Q, dO, lse and delta in K4) lands by
//    cp.async in a ring of two stages: the next tile's copy runs under this
//    tile's products; the ragged tail is zero-filled by the copy.
//  * S = Q K^T and dP = dO V^T read both operands from shared memory. P
//    (dropped: P_v) and dS are computed on the accumulator fragments, each
//    element's (query, key) position taken from the m64nNk16 accumulator
//    layout, so the causal mask, the ragged tail and the dropout hash see
//    the CUDA-core kernels' global coordinates. K2's online softmax runs
//    in fp32 on the fragments in log2 units (hopper_tc.cuh); its l sums the
//    undropped p. P and dS are rounded once to bf16 in registers, where
//    they already sit as the A operand of the second products (O += P_v V;
//    dQ += dS K; dV += P_v^T dO, dK += dS^T Q); the B operand is the same
//    shared tile read MN-major through the descriptor's transpose bit, so
//    nothing is transposed or written back.
//  * The cp.async, descriptor, wgmma and softmax helpers live in
//    hopper_tc.cuh, shared with paged_attention.cu and blockwise_moe.cu.
//  * K4 runs key-major (S^T = K Q^T, dP^T = V dO^T), so P^T and dS^T come
//    out as A operands; dK and dV stay in registers over the n_rep query
//    heads and their q-blocks and are written once: no atomics, the same
//    bits on every launch.
//  * Only diagonal and ragged tiles evaluate the mask. Grids run the
//    longest causal loops first (the launch order is blockIdx.x fastest).
//    K2 writes lse in fp32, [B*N, S], the layout K3 and K4 read.
// The new roundings: the Pallas kernels and the CUDA-core ones keep p and
// ds in fp32; these round them once to bf16 (bounded on the CPU by
// tests/test_torch_flash_attention.py).
//
// CUDA-core kernels (K2, K3 and K4 in fp32): fp32 on the
// tensor cores would be TF32, about three decimal digits, which the fp32
// card limit of 1e-4 and the fp32 train-step cross-checks would not hold;
// fp32 keeps exact fp32 FMAs at the CUDA cores' 67 TFLOP/s.
//  * 64 x 64 tiles, 256 threads. Thread t owns tile rows 4*(t/16)..+3 and
//    tile columns (t%16) + 16*j, j < 4; a row's 16 owners are 16 lanes of
//    one warp, so row max and row sum reduce with four shuffles.
//  * Tiles are staged in shared memory as fp32 (rows padded to D+1 floats,
//    so the column reads of a product hit distinct banks); products are
//    fp32 FMAs on the CUDA cores, every sum in fp32. Inputs, outputs and
//    lse are fp32.
//  * GQA is read natively: query head n reads kv head n / (N/KV) of
//    [B, S, KV, D] K/V, so repeat_kv is never materialised. K4 runs one CTA
//    per (batch, kv head, k-block) and loops over the n_rep query heads and
//    their q-blocks, so dk/dv sum inside the CTA and need no atomics.
//  * Causal work skipping: each CTA bounds its own loop. K2 and K3 stop at
//    the diagonal block; K4 starts its q loop at the diagonal block. The
//    heaviest CTAs are scheduled first. The ragged tail of a sequence that is
//    not a multiple of 64 loads as zeros and is masked.
//  * D is 64 or 128, a template parameter, in both designs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_tc.cuh"

namespace {

constexpr int kTile = 64;             // query rows and key rows per tile
constexpr int kThreads = 256;
constexpr int kLdP = kTile + 1;       // row stride of the 64 x 64 p/ds tile

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}

struct Dropout {
  int on;
  uint32_t threshold;   // keep iff hash >= round(p * 0xFFFFFFFF)
  uint32_t seed;
  float inv_keep;       // 1 / (1 - p)
  // where this call's heads sit in the global batch x query-head array:
  // the mask of local (b, n) is that of global (b + b_off, n + h_off)
  // among n_global heads, as the reference draws it over the whole array
  uint32_t b_off, n_global, h_off;
};

// The flat batch x query-head coordinate of local (b, n) in the global
// array: b * N + n when the call holds every head and row.
__device__ __forceinline__ uint32_t global_bh(const Dropout& drop, int b,
                                              int n) {
  return ((uint32_t)b + drop.b_off) * drop.n_global + (uint32_t)n +
         drop.h_off;
}

// The per-(seed, head) half of `dropout_keep_mask`.
__device__ __forceinline__ uint32_t head_seed(uint32_t seed, uint32_t bh) {
  uint32_t h = seed + bh * 0x9E3779B9u;
  return (h ^ (h >> 16)) * 0x21F0AAADu;
}

// The per-element half: counter q * sk + k, murmur3 finalizer.
__device__ __forceinline__ bool keep(uint32_t hseed, uint32_t qpos,
                                     uint32_t kpos, uint32_t sk,
                                     uint32_t threshold) {
  uint32_t x = (qpos * sk + kpos) ^ hseed;
  x = (x ^ (x >> 16)) * 0x85EBCA6Bu;
  x = (x ^ (x >> 13)) * 0xC2B2AE35u;
  x = x ^ (x >> 16);
  return x >= threshold;
}

// Reductions over the 16 lanes that own one tile row.
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Stage rows [row0, row0 + 64) of a slab whose rows are `stride` elements
// apart into sh[64][D + 1] as fp32; rows at or past S read as zeros.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* sh, const T* src,
                                          size_t stride, int row0, int S) {
  for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
    const int r = e / D;
    const int c = e % D;
    const int row = row0 + r;
    sh[r * (D + 1) + c] =
        row < S ? to_f32(src[(size_t)row * stride + c]) : 0.f;
  }
}

// out[i][j] = a[4 ty + i] . b[tx + 16 j] over D, both tiles [64][D + 1].
template <int D>
__device__ __forceinline__ void dot_tile(float (&out)[4][4], const float* a,
                                         const float* b, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) out[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(4 * ty + i) * (D + 1) + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) out[i][j] = fmaf(av[i], bv[j], out[i][j]);
  }
}

// acc[i][c] += sum_x p[4 ty + i][x] * m[x][tx + 16 c] over the 64 x of a
// [64][65] tile p and a [64][D + 1] tile m.
template <int D>
__device__ __forceinline__ void pv_tile(float (&acc)[4][D / 16],
                                        const float* p, const float* m,
                                        int ty, int tx) {
#pragma unroll 4
  for (int x = 0; x < kTile; ++x) {
    float pv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) pv[i] = p[(4 * ty + i) * kLdP + x];
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      const float mv = m[x * (D + 1) + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], mv, acc[i][c]);
    }
  }
}

// ---------------------------------------------------------------------------
// K2: forward. grid (q-blocks, B*N); q/out [B,S,N,D], k/v [B,S,KV,D],
// lse [B*N, S] fp32.
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, float* __restrict__ lse,
    int S, int N, int KV, float scale, int causal, Dropout drop) {
  extern __shared__ float smem[];
  constexpr int LD = D + 1;
  float* q_sh = smem;                    // [64][LD]
  float* kv_sh = q_sh + kTile * LD;      // [64][LD]: K, then V
  float* p_sh = kv_sh + kTile * LD;      // [64][65]
  const int nqb = (S + kTile - 1) / kTile;
  const int qb = nqb - 1 - blockIdx.x;   // long causal rows first
  const int bn = blockIdx.y;
  const int b = bn / N, n = bn % N, h = n / (N / KV);
  const int q0 = qb * kTile;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const size_t q_stride = (size_t)N * D, kv_stride = (size_t)KV * D;
  const T* q_base = q + ((size_t)b * S * N + n) * D;
  const T* k_base = k + ((size_t)b * S * KV + h) * D;
  const T* v_base = v + ((size_t)b * S * KV + h) * D;
  const uint32_t hseed =
      drop.on ? head_seed(drop.seed, global_bh(drop, b, n)) : 0u;

  load_tile<T, D>(q_sh, q_base, q_stride, q0, S);
  float m[4], l[4], acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[i][c] = 0.f;
  }
  const int nkb = (S + kTile - 1) / kTile;
  const int kb_end = causal ? min(nkb, (q0 + kTile - 1) / kTile + 1) : nkb;
  for (int kb = 0; kb < kb_end; ++kb) {
    const int k0 = kb * kTile;
    __syncthreads();                     // the last tile's V and p reads
    load_tile<T, D>(kv_sh, k_base, kv_stride, k0, S);
    __syncthreads();
    float s[4][4];
    dot_tile<D>(s, q_sh, kv_sh, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + 4 * ty + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool ok = kpos < S && (!causal || kpos <= qpos);
        s[i][j] = ok ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = row_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      const float corr = m[i] == -INFINITY ? 0.f : expf(m[i] - m_safe);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - m_safe);
        sum += p;
        const bool kept =
            !drop.on || keep(hseed, (uint32_t)qpos,
                             (uint32_t)(k0 + tx + 16 * j), (uint32_t)S,
                             drop.threshold);
        s[i][j] = kept ? p : 0.f;
      }
      // l is this thread's share of the row sum; every owner of the row
      // applies the same corr, so the shares add up at the end
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < D / 16; ++c) acc[i][c] *= corr;
    }
    __syncthreads();                     // K reads are done
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        p_sh[(4 * ty + i) * kLdP + tx + 16 * j] = s[i][j];
    load_tile<T, D>(kv_sh, v_base, kv_stride, k0, S);
    __syncthreads();
    pv_tile<D>(acc, p_sh, kv_sh, ty, tx);
  }
  const float inv_keep = drop.on ? drop.inv_keep : 1.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float lt = row_sum(l[i]);      // every lane takes part
    const int row = q0 + 4 * ty + i;
    if (row >= S) continue;
    const float lmax = fmaxf(lt, 1e-30f);
    T* o = out + (((size_t)b * S + row) * N + n) * D;
#pragma unroll
    for (int c = 0; c < D / 16; ++c)
      o[tx + 16 * c] = from_f32<T>(acc[i][c] * inv_keep / lmax);
    if (tx == 0)
      lse[(size_t)bn * S + row] = lt > 0.f ? m[i] + logf(lmax) : -INFINITY;
  }
}

// ---------------------------------------------------------------------------
// K3: dq. grid (q-blocks, B*N); g/dq like q; lse/delta [B*N, S] fp32.
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ g,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dq, int S, int N, int KV, float scale, int causal,
    Dropout drop) {
  extern __shared__ float smem[];
  constexpr int LD = D + 1;
  float* q_sh = smem;                    // [64][LD]
  float* g_sh = q_sh + kTile * LD;       // [64][LD]
  float* kv_sh = g_sh + kTile * LD;      // [64][LD]: V, then K
  float* ds_sh = kv_sh + kTile * LD;     // [64][65]
  const int nqb = (S + kTile - 1) / kTile;
  const int qb = nqb - 1 - blockIdx.x;
  const int bn = blockIdx.y;
  const int b = bn / N, n = bn % N, h = n / (N / KV);
  const int q0 = qb * kTile;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const size_t q_stride = (size_t)N * D, kv_stride = (size_t)KV * D;
  const size_t q_off = ((size_t)b * S * N + n) * D;
  const T* k_base = k + ((size_t)b * S * KV + h) * D;
  const T* v_base = v + ((size_t)b * S * KV + h) * D;
  const uint32_t hseed =
      drop.on ? head_seed(drop.seed, global_bh(drop, b, n)) : 0u;

  load_tile<T, D>(q_sh, q + q_off, q_stride, q0, S);
  load_tile<T, D>(g_sh, g + q_off, q_stride, q0, S);
  float lse_r[4], delta_r[4], acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    lse_r[i] = row < S ? lse[(size_t)bn * S + row] : 0.f;
    delta_r[i] = row < S ? delta[(size_t)bn * S + row] : 0.f;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[i][c] = 0.f;
  }
  const int nkb = (S + kTile - 1) / kTile;
  const int kb_end = causal ? min(nkb, (q0 + kTile - 1) / kTile + 1) : nkb;
  for (int kb = 0; kb < kb_end; ++kb) {
    const int k0 = kb * kTile;
    __syncthreads();                     // the last tile's K and ds reads
    load_tile<T, D>(kv_sh, v_base, kv_stride, k0, S);
    __syncthreads();
    float dp[4][4];
    dot_tile<D>(dp, g_sh, kv_sh, ty, tx);
    __syncthreads();                     // V reads are done
    load_tile<T, D>(kv_sh, k_base, kv_stride, k0, S);
    __syncthreads();
    float s[4][4];
    dot_tile<D>(s, q_sh, kv_sh, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool ok = kpos < S && (!causal || kpos <= qpos);
        const float p = ok ? expf(s[i][j] * scale - lse_r[i]) : 0.f;
        float d = dp[i][j];
        if (drop.on)
          d = keep(hseed, (uint32_t)qpos, (uint32_t)kpos, (uint32_t)S,
                   drop.threshold)
                  ? d * drop.inv_keep
                  : 0.f;
        ds_sh[(4 * ty + i) * kLdP + tx + 16 * j] =
            p * (d - delta_r[i]) * scale;
      }
    }
    __syncthreads();
    pv_tile<D>(acc, ds_sh, kv_sh, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= S) continue;
    T* o = dq + q_off + (size_t)row * q_stride;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) o[tx + 16 * c] = from_f32<T>(acc[i][c]);
  }
}

// ---------------------------------------------------------------------------
// K4: dk and dv. grid (k-blocks, B*KV); dk/dv like k.
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ g,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, int S, int N, int KV,
    float scale, int causal, Dropout drop) {
  extern __shared__ float smem[];
  constexpr int LD = D + 1;
  float* k_sh = smem;                    // [64][LD]
  float* v_sh = k_sh + kTile * LD;       // [64][LD]
  float* q_sh = v_sh + kTile * LD;       // [64][LD]
  float* g_sh = q_sh + kTile * LD;       // [64][LD]
  float* pt_sh = g_sh + kTile * LD;      // [64][65]: dropped p^T, then ds^T
  const int kb = blockIdx.x;             // short k (long causal loop) first
  const int bh = blockIdx.y;
  const int b = bh / KV, h = bh % KV;
  const int n_rep = N / KV;
  const int k0 = kb * kTile;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const size_t q_stride = (size_t)N * D, kv_stride = (size_t)KV * D;
  const size_t kv_off = ((size_t)b * S * KV + h) * D;

  load_tile<T, D>(k_sh, k + kv_off, kv_stride, k0, S);
  load_tile<T, D>(v_sh, v + kv_off, kv_stride, k0, S);
  float dk_acc[4][D / 16], dv_acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;
  const int nqb = (S + kTile - 1) / kTile;
  const int qb_begin = causal ? k0 / kTile : 0;
  for (int r = 0; r < n_rep; ++r) {
    const int n = h * n_rep + r;
    const int bn = b * N + n;
    const uint32_t hseed =
        drop.on ? head_seed(drop.seed, global_bh(drop, b, n)) : 0u;
    const size_t q_off = ((size_t)b * S * N + n) * D;
    for (int qb = qb_begin; qb < nqb; ++qb) {
      const int q0 = qb * kTile;
      __syncthreads();                   // the last tile's q, g, p^T reads
      load_tile<T, D>(q_sh, q + q_off, q_stride, q0, S);
      load_tile<T, D>(g_sh, g + q_off, q_stride, q0, S);
      __syncthreads();
      float lse_c[4], delta_c[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qpos = q0 + tx + 16 * j;
        lse_c[j] = qpos < S ? lse[(size_t)bn * S + qpos] : 0.f;
        delta_c[j] = qpos < S ? delta[(size_t)bn * S + qpos] : 0.f;
      }
      float s[4][4], dp[4][4];
      dot_tile<D>(s, k_sh, q_sh, ty, tx);    // s^T: [k row][q row]
      dot_tile<D>(dp, v_sh, g_sh, ty, tx);   // dp^T
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kpos = k0 + 4 * ty + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qpos = q0 + tx + 16 * j;
          const bool ok =
              kpos < S && qpos < S && (!causal || kpos <= qpos);
          const float p = ok ? expf(s[i][j] * scale - lse_c[j]) : 0.f;
          float p_v = p, d = dp[i][j];
          if (drop.on) {
            const bool kept = keep(hseed, (uint32_t)qpos, (uint32_t)kpos,
                                   (uint32_t)S, drop.threshold);
            p_v = kept ? p * drop.inv_keep : 0.f;
            d = kept ? d * drop.inv_keep : 0.f;
          }
          s[i][j] = p * (d - delta_c[j]) * scale;   // ds^T
          pt_sh[(4 * ty + i) * kLdP + tx + 16 * j] = p_v;
        }
      }
      __syncthreads();
      pv_tile<D>(dv_acc, pt_sh, g_sh, ty, tx);
      __syncthreads();                   // p^T reads are done
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          pt_sh[(4 * ty + i) * kLdP + tx + 16 * j] = s[i][j];
      __syncthreads();
      pv_tile<D>(dk_acc, pt_sh, q_sh, ty, tx);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + 4 * ty + i;
    if (row >= S) continue;
    const size_t off = kv_off + (size_t)row * kv_stride;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      dk[off + tx + 16 * c] = from_f32<T>(dk_acc[i][c]);
      dv[off + tx + 16 * c] = from_f32<T>(dv_acc[i][c]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 K3 and K4 on the tensor cores (wgmma). One warpgroup (128 threads)
// per CTA, 64-row tiles kept in bf16 in shared memory in the 128-byte
// swizzle that wgmma descriptors read.
// ---------------------------------------------------------------------------
namespace tc {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// bytes of a 64 x D bf16 tile: D / 64 atoms of 64 rows x 128 B
template <int D>
__host__ __device__ constexpr uint32_t tile_bytes() {
  return kRows * D * 2;
}

// K4's stage: Q, dO, then 64 lse and 64 delta, padded so the next stage's
// tiles start 1024-aligned, as the swizzle needs
template <int D>
__host__ __device__ constexpr uint32_t dkv_stage_bytes() {
  return 2 * tile_bytes<D>() + 1024;
}

// dynamic shared memory of K2 (Q, two stages of K and V), K3 (Q, dO, two
// stages of K and V) and K4 (K, V, two stages), with 1024 bytes to align
// the first tile
template <int D>
__host__ __device__ constexpr uint32_t fwd_smem_bytes() {
  return 5 * tile_bytes<D>() + 1024;
}

template <int D>
__host__ __device__ constexpr uint32_t dq_smem_bytes() {
  return 6 * tile_bytes<D>() + 1024;
}

template <int D>
__host__ __device__ constexpr uint32_t dkv_smem_bytes() {
  return 2 * tile_bytes<D>() + 2 * dkv_stage_bytes<D>() + 1024;
}

// Rows [row0, row0 + 64) of a bf16 slab whose rows are `stride` elements
// apart into the 64 x D tile at `dst`: 64-column atoms of 64 rows x 128 B,
// the 16-byte chunk c of row r at r * 128 + ((c ^ (r % 8)) * 16), as TMA's
// SWIZZLE_128B lays it out. Rows at or past S are zeros.
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src,
                                          size_t stride, int row0, int S) {
  constexpr int kChunks = D / 8;          // 16-byte chunks of a row
#pragma unroll
  for (int i = 0; i < kRows * kChunks / kWarpgroup; ++i) {
    const int id = threadIdx.x + i * kWarpgroup;
    const int r = id / kChunks, c = id % kChunks;
    const bool ok = row0 + r < S;
    cp_async16(dst + (c / 8) * kAtom + r * 128 + (((c % 8) ^ (r % 8)) << 4),
               src + (size_t)(ok ? row0 + r : 0) * stride + c * 8, ok);
  }
}

// p as two bf16 A operands of four k16 steps each (to_operand's layout):
// hi, its rounding, and lo, the rounding of what hi left, so hi + lo holds
// p to about 2^-16 of itself.
__device__ __forceinline__ void to_operands_hi_lo(const float (&x)[32],
                                                  uint32_t (&hi)[4][4],
                                                  uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float a = x[8 * kk + 2 * r], b = x[8 * kk + 2 * r + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
      const float2 hf = __bfloat1622float2(h);
      hi[kk][r] = *reinterpret_cast<const uint32_t*>(&h);
      lo[kk][r] = pack_bf16(a - hf.x, b - hf.y);
    }
}

// Rows [row0, row0 + 64) of a 64 x D accumulator out to bf16 rows
// `stride` elements apart, the rows at or past S left out.
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, size_t stride,
                                           const float (&acc)[D / 2],
                                           int row0, int S, int warp,
                                           int lane) {
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int row = row0 + frag_row(warp, lane, i);
    if (row < S)
      *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)row * stride +
                                         frag_col(lane, i)) =
          __floats2bfloat162_rn(acc[i], acc[i + 1]);
  }
}

// ---------------------------------------------------------------------------
// K2 (bf16): out and lse. grid (B*N, q-blocks), the longest causal rows
// first. Shared memory: Q, then K and V each in a ring of two slots. S =
// Q K^T from shared memory, the next tile's under this tile's softmax (and
// its K and the next V land under both); the online softmax on the
// accumulator fragments in fp32
// (log2 units); P, the dropped probabilities, as a bf16 value and the
// bf16 remainder of its rounding, each the register A operand of
// O += P V, V read MN-major. One rounding alone moved out, and with it the
// backward's delta = rowsum(dO out), enough to put dq past the card limit
// (tests/test_torch_flash_attention.py).
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kWarpgroup, 2) flash_fwd_wgmma(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ out,
    float* __restrict__ lse, int S, int N, int KV, float scale, int causal,
    Dropout drop) {
  extern __shared__ uint8_t smem_raw[];
  constexpr uint32_t T = tile_bytes<D>();
  const uint32_t q_sh = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t kv_sh = q_sh + T;
  const int nqb = (S + kRows - 1) / kRows;
  const int qb = nqb - 1 - blockIdx.y;
  const int bn = blockIdx.x;
  const int b = bn / N, n = bn % N, h = n / (N / KV);
  const int q0 = qb * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t q_stride = (size_t)N * D, kv_stride = (size_t)KV * D;
  const size_t q_off = ((size_t)b * S * N + n) * D;
  const bf16* k_base = k + ((size_t)b * S * KV + h) * D;
  const bf16* v_base = v + ((size_t)b * S * KV + h) * D;
  const uint32_t hseed =
      drop.on ? head_seed(drop.seed, global_bh(drop, b, n)) : 0u;
  const int nkb = (S + kRows - 1) / kRows;
  const int kb_end = causal ? min(nkb, qb + 1) : nkb;

  // K_j and V_j land in ring slot j % 2 each
  const uint32_t k_sh = kv_sh, v_sh = kv_sh + 2 * T;
  load_tile<D>(q_sh, q + q_off, q_stride, q0, S);
  load_tile<D>(k_sh, k_base, kv_stride, 0, S);
  load_tile<D>(v_sh, v_base, kv_stride, 0, S);
  if (kb_end > 1) load_tile<D>(k_sh + T, k_base, kv_stride, kRows, S);
  cp_async_commit();

  const float scale2 = scale * kLog2e;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[D / 2];
  zero(acc);
  cp_async_wait_for_wgmma();
  __syncthreads();
  float s[32];
  zero(s);
  wgmma_fence();
  mma_ss<D>(s, q_sh, k_sh);              // s = q k_0^T
  wgmma_commit();
  wgmma_wait();
  hold(s);
  for (int kb = 0; kb < kb_end; ++kb) {
    // in: s = q k_kb^T, K_{kb+1}, V_kb
    float sn[32];
    zero(sn);
    wgmma_fence();
    if (kb + 1 < kb_end)                 // runs under this tile's softmax
      mma_ss<D>(sn, q_sh, k_sh + ((kb + 1) & 1) * T);
    wgmma_commit();
    if (kb + 2 < kb_end)                 // into K_kb's slot: s is done
      load_tile<D>(k_sh + (kb & 1) * T, k_base, kv_stride, (kb + 2) * kRows,
                   S);
    if (kb + 1 < kb_end)                 // into V_{kb-1}'s: its PV is done
      load_tile<D>(v_sh + ((kb + 1) & 1) * T, v_base, kv_stride,
                   (kb + 1) * kRows, S);
    cp_async_commit();
    const int k0 = kb * kRows;
    const bool edge = (causal && kb == qb) || k0 + kRows > S;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int qpos = q0 + frag_row(warp, lane, i);
      const int kpos = k0 + frag_col(lane, i);
      s[i] = (edge && !(kpos < S && (!causal || kpos <= qpos)))
                 ? -INFINITY
                 : s[i] * scale2;
    }
    online_softmax(s, m, l, acc);        // l sums the undropped p
    if (drop.on) {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (!keep(hseed, (uint32_t)(q0 + frag_row(warp, lane, i)),
                  (uint32_t)(k0 + frag_col(lane, i)), (uint32_t)S,
                  drop.threshold))
          s[i] = 0.f;
    }
    uint32_t hi[4][4], lo[4][4];
    to_operands_hi_lo(s, hi, lo);
    const uint32_t vt = v_sh + (kb & 1) * T;
    wgmma_fence();
    mma_rs(acc, hi, vt);                 // o += p v, p as value
    mma_rs(acc, lo, vt);                 // and remainder
    wgmma_commit();
    wgmma_wait();                        // these and the next s
    hold(acc);
    hold(hi);
    hold(lo);
    hold(sn);
    cp_async_wait_for_wgmma();
    __syncthreads();                     // K_{kb+2}, V_{kb+1} are in
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = sn[i];
  }
  // survivors rescaled by 1/(1-p) once, here; lse in natural-log units
  const float inv_keep = drop.on ? drop.inv_keep : 1.f;
  float f[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const float lt = quad_sum(l[e]);
    const int row = q0 + frag_row(warp, lane, 2 * e);
    f[e] = inv_keep / fmaxf(lt, 1e-30f);
    if (row < S && lane % 4 == 0)
      lse[(size_t)bn * S + row] =
          lt > 0.f ? m[e] * kLn2 + logf(lt) : -INFINITY;
  }
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] *= f[(i >> 1) & 1];
  store_rows<D>(out + q_off, q_stride, acc, q0, S, warp, lane);
}

// ---------------------------------------------------------------------------
// K3 (bf16): dq. grid (B*N, q-blocks), the longest causal rows first.
// Shared memory: Q, dO, then two stages of (K, V).
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kWarpgroup, 2) flash_bwd_dq_wgmma(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ g,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dq, int S, int N, int KV, float scale, int causal,
    Dropout drop) {
  extern __shared__ uint8_t smem_raw[];
  constexpr uint32_t T = tile_bytes<D>();
  const uint32_t q_sh = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t g_sh = q_sh + T, kv_sh = q_sh + 2 * T;
  const int nqb = (S + kRows - 1) / kRows;
  const int qb = nqb - 1 - blockIdx.y;
  const int bn = blockIdx.x;
  const int b = bn / N, n = bn % N, h = n / (N / KV);
  const int q0 = qb * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t q_stride = (size_t)N * D, kv_stride = (size_t)KV * D;
  const size_t q_off = ((size_t)b * S * N + n) * D;
  const bf16* k_base = k + ((size_t)b * S * KV + h) * D;
  const bf16* v_base = v + ((size_t)b * S * KV + h) * D;
  const uint32_t hseed =
      drop.on ? head_seed(drop.seed, global_bh(drop, b, n)) : 0u;
  const int nkb = (S + kRows - 1) / kRows;
  const int kb_end = causal ? min(nkb, qb + 1) : nkb;

  load_tile<D>(q_sh, q + q_off, q_stride, q0, S);
  load_tile<D>(g_sh, g + q_off, q_stride, q0, S);
  load_tile<D>(kv_sh, k_base, kv_stride, 0, S);
  load_tile<D>(kv_sh + T, v_base, kv_stride, 0, S);
  cp_async_commit();

  // this thread's two rows: lse (in log2 units) and delta
  float lse2[2], dlt[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = q0 + frag_row(warp, lane, 2 * e);
    lse2[e] = row < S ? lse[(size_t)bn * S + row] * kLog2e : 0.f;
    dlt[e] = row < S ? delta[(size_t)bn * S + row] : 0.f;
  }
  const float scale2 = scale * kLog2e;
  float acc[D / 2];
  zero(acc);
  for (int kb = 0; kb < kb_end; ++kb) {
    const uint32_t k_sh = kv_sh + (kb & 1) * 2 * T, v_sh = k_sh + T;
    cp_async_wait_for_wgmma();
    __syncthreads();                     // tile kb is in; kb - 1 is free
    if (kb + 1 < kb_end) {
      const uint32_t next = kv_sh + ((kb + 1) & 1) * 2 * T;
      load_tile<D>(next, k_base, kv_stride, (kb + 1) * kRows, S);
      load_tile<D>(next + T, v_base, kv_stride, (kb + 1) * kRows, S);
    }
    cp_async_commit();
    float s[32], dp[32];
    zero(s);
    zero(dp);
    wgmma_fence();
    mma_ss<D>(s, q_sh, k_sh);            // s = q k^T
    mma_ss<D>(dp, g_sh, v_sh);           // dp = g v^T
    wgmma_commit();
    wgmma_wait();
    hold(s);
    hold(dp);
    const int k0 = kb * kRows;
    const bool edge = (causal && kb == qb) || k0 + kRows > S;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int qpos = q0 + frag_row(warp, lane, i);
      const int kpos = k0 + frag_col(lane, i);
      float p = exp2f(s[i] * scale2 - lse2[(i >> 1) & 1]);
      if (edge && !(kpos < S && (!causal || kpos <= qpos))) p = 0.f;
      float d = dp[i];
      if (drop.on)
        d = keep(hseed, (uint32_t)qpos, (uint32_t)kpos, (uint32_t)S,
                 drop.threshold)
                ? d * drop.inv_keep
                : 0.f;
      s[i] = p * (d - dlt[(i >> 1) & 1]) * scale;   // ds
    }
    uint32_t ds[4][4];
    to_operand(s, ds);
    wgmma_fence();
    mma_rs(acc, ds, k_sh);               // dq += ds k
    wgmma_commit();
    wgmma_wait();
    hold(acc);
    hold(ds);
  }
  store_rows<D>(dq + q_off, q_stride, acc, q0, S, warp, lane);
}

// ---------------------------------------------------------------------------
// K4 (bf16): dk and dv. grid (B*KV, k-blocks), the longest causal loops
// first. Shared memory: K, V, then two stages of (Q, dO, lse, delta),
// streamed over the n_rep query heads and their q-blocks. The products
// run key-major: s^T = k q^T and dp^T = v g^T, so p^T and ds^T are the A
// operands of dv += p_v^T g and dk += ds^T q.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kWarpgroup, 2) flash_bwd_dkv_wgmma(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ g,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int N, int KV,
    float scale, int causal, Dropout drop) {
  extern __shared__ uint8_t smem_raw[];
  constexpr uint32_t T = tile_bytes<D>();
  constexpr uint32_t kStage = dkv_stage_bytes<D>();
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t k_sh = (raw + 1023) & ~1023u;
  const uint32_t v_sh = k_sh + T, st_sh = k_sh + 2 * T;
  const int bh = blockIdx.x, kb = blockIdx.y;
  const int b = bh / KV, h = bh % KV;
  const int n_rep = N / KV;
  const int k0 = kb * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t q_stride = (size_t)N * D, kv_stride = (size_t)KV * D;
  const size_t kv_off = ((size_t)b * S * KV + h) * D;
  const int nqb = (S + kRows - 1) / kRows;
  const int qb_begin = causal ? kb : 0;
  const int nq = nqb - qb_begin;
  const int n_it = n_rep * nq;

  // iteration `it` reads query head h n_rep + it / nq, q-block
  // qb_begin + it % nq, into stage it % 2
  auto load_stage = [&](int it) {
    const int n = h * n_rep + it / nq;
    const int q0 = (qb_begin + it % nq) * kRows;
    const size_t q_off = ((size_t)b * S * N + n) * D;
    const uint32_t st = st_sh + (it & 1) * kStage;
    load_tile<D>(st, q + q_off, q_stride, q0, S);
    load_tile<D>(st + T, g + q_off, q_stride, q0, S);
    const int t = threadIdx.x % kRows;
    const float* stat = threadIdx.x < kRows ? lse : delta;
    const size_t row = (size_t)(b * N + n) * S;
    cp_async4(st + 2 * T + (threadIdx.x / kRows) * kRows * 4 + t * 4,
              stat + row + (q0 + t < S ? q0 + t : 0), q0 + t < S);
  };

  load_tile<D>(k_sh, k + kv_off, kv_stride, k0, S);
  load_tile<D>(v_sh, v + kv_off, kv_stride, k0, S);
  load_stage(0);
  cp_async_commit();

  const float scale2 = scale * kLog2e;
  float dk_acc[D / 2], dv_acc[D / 2];
  zero(dk_acc);
  zero(dv_acc);
  for (int it = 0; it < n_it; ++it) {
    const uint32_t st = st_sh + (it & 1) * kStage;
    const float* lse_sh =
        reinterpret_cast<const float*>(smem_raw + (st + 2 * T - raw));
    const float* delta_sh = lse_sh + kRows;
    cp_async_wait_for_wgmma();
    __syncthreads();                     // stage it is in; it - 1 is free
    if (it + 1 < n_it) load_stage(it + 1);
    cp_async_commit();
    const int n = h * n_rep + it / nq;
    const int qb = qb_begin + it % nq;
    const int q0 = qb * kRows;
    const uint32_t hseed =
        drop.on ? head_seed(drop.seed, global_bh(drop, b, n)) : 0u;
    float s[32], dp[32];
    zero(s);
    zero(dp);
    wgmma_fence();
    mma_ss<D>(s, k_sh, st);              // s^T = k q^T
    mma_ss<D>(dp, v_sh, st + T);         // dp^T = v g^T
    wgmma_commit();
    wgmma_wait();
    hold(s);
    hold(dp);
    const bool edge =
        (causal && qb == kb) || q0 + kRows > S || k0 + kRows > S;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int kpos = k0 + frag_row(warp, lane, i);
      const int col = frag_col(lane, i);
      const int qpos = q0 + col;
      float p = exp2f(s[i] * scale2 - lse_sh[col] * kLog2e);
      if (edge && !(kpos < S && qpos < S && (!causal || kpos <= qpos)))
        p = 0.f;
      float p_v = p, d = dp[i];
      if (drop.on) {
        const bool kept = keep(hseed, (uint32_t)qpos, (uint32_t)kpos,
                               (uint32_t)S, drop.threshold);
        p_v = kept ? p * drop.inv_keep : 0.f;
        d = kept ? d * drop.inv_keep : 0.f;
      }
      s[i] = p_v;                                    // p_v^T
      dp[i] = p * (d - delta_sh[col]) * scale;       // ds^T
    }
    uint32_t pa[4][4], da[4][4];
    to_operand(s, pa);
    to_operand(dp, da);
    wgmma_fence();
    mma_rs(dv_acc, pa, st + T);          // dv += p_v^T g
    mma_rs(dk_acc, da, st);              // dk += ds^T q
    wgmma_commit();
    wgmma_wait();
    hold(dv_acc);
    hold(dk_acc);
    hold(pa);
    hold(da);
  }
  store_rows<D>(dk + kv_off, kv_stride, dk_acc, k0, S, warp, lane);
  store_rows<D>(dv + kv_off, kv_stride, dv_acc, k0, S, warp, lane);
}

}  // namespace tc

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <int D>
constexpr size_t smem_bytes(int tiles) {
  return ((size_t)tiles * kTile * (D + 1) + (size_t)kTile * kLdP) *
         sizeof(float);
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// as set_smem, and all of L1 as shared memory, so two CTAs fit an SM
template <typename K>
cudaError_t set_smem_max(K kernel, size_t bytes) {
  cudaError_t err = set_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

bool bad_shape(int B, int S, int N, int KV, int D) {
  return B <= 0 || S <= 0 || N <= 0 || KV <= 0 || N % KV != 0 ||
         (D != 64 && D != 128) || (long long)B * N > 65535;
}

template <typename T, int D>
cudaError_t fwd(const void* q, const void* k, const void* v, void* out,
                void* lse, int B, int S, int N, int KV, float scale,
                int causal, Dropout drop, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, D>;
  const size_t smem = smem_bytes<D>(2);
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kTile - 1) / kTile, B * N);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), S, N, KV, scale, causal, drop);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t bwd_dq(const void* q, const void* k, const void* v,
                   const void* g, const void* lse, const void* delta,
                   void* dq, int B, int S, int N, int KV, float scale,
                   int causal, Dropout drop, cudaStream_t stream) {
  auto kernel = flash_bwd_dq_kernel<T, D>;
  const size_t smem = smem_bytes<D>(3);
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kTile - 1) / kTile, B * N);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), S, N, KV, scale, causal, drop);
  return cudaGetLastError();
}

// bf16 K2/K3/K4: 128 threads, two CTAs an SM (81, 97 and 99 KB of shared
// memory each at D=128).
template <int D>
cudaError_t fwd_bf16(const void* q, const void* k, const void* v, void* out,
                     void* lse, int B, int S, int N, int KV, float scale,
                     int causal, Dropout drop, cudaStream_t stream) {
  auto kernel = tc::flash_fwd_wgmma<D>;
  const size_t smem = tc::fwd_smem_bytes<D>();
  cudaError_t err = set_smem_max(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * N, (S + tc::kRows - 1) / tc::kRows);
  kernel<<<grid, tc::kWarpgroup, smem, stream>>>(
      static_cast<const tc::bf16*>(q), static_cast<const tc::bf16*>(k),
      static_cast<const tc::bf16*>(v), static_cast<tc::bf16*>(out),
      static_cast<float*>(lse), S, N, KV, scale, causal, drop);
  return cudaGetLastError();
}

template <int D>
cudaError_t bwd_dq_bf16(const void* q, const void* k, const void* v,
                        const void* g, const void* lse, const void* delta,
                        void* dq, int B, int S, int N, int KV, float scale,
                        int causal, Dropout drop, cudaStream_t stream) {
  auto kernel = tc::flash_bwd_dq_wgmma<D>;
  const size_t smem = tc::dq_smem_bytes<D>();
  cudaError_t err = set_smem_max(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * N, (S + tc::kRows - 1) / tc::kRows);
  kernel<<<grid, tc::kWarpgroup, smem, stream>>>(
      static_cast<const tc::bf16*>(q), static_cast<const tc::bf16*>(k),
      static_cast<const tc::bf16*>(v), static_cast<const tc::bf16*>(g),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<tc::bf16*>(dq), S, N, KV, scale, causal, drop);
  return cudaGetLastError();
}

template <int D>
cudaError_t bwd_dkv_bf16(const void* q, const void* k, const void* v,
                         const void* g, const void* lse, const void* delta,
                         void* dk, void* dv, int B, int S, int N, int KV,
                         float scale, int causal, Dropout drop,
                         cudaStream_t stream) {
  auto kernel = tc::flash_bwd_dkv_wgmma<D>;
  const size_t smem = tc::dkv_smem_bytes<D>();
  cudaError_t err = set_smem_max(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * KV, (S + tc::kRows - 1) / tc::kRows);
  kernel<<<grid, tc::kWarpgroup, smem, stream>>>(
      static_cast<const tc::bf16*>(q), static_cast<const tc::bf16*>(k),
      static_cast<const tc::bf16*>(v), static_cast<const tc::bf16*>(g),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<tc::bf16*>(dk), static_cast<tc::bf16*>(dv), S, N, KV,
      scale, causal, drop);
  return cudaGetLastError();
}

// cp.async reads 16-byte chunks
bool misaligned(const void* a, const void* b, const void* c,
                const void* d) {
  return ((uintptr_t)a | (uintptr_t)b | (uintptr_t)c | (uintptr_t)d) & 15;
}

template <typename T, int D>
cudaError_t bwd_dkv(const void* q, const void* k, const void* v,
                    const void* g, const void* lse, const void* delta,
                    void* dk, void* dv, int B, int S, int N, int KV,
                    float scale, int causal, Dropout drop,
                    cudaStream_t stream) {
  auto kernel = flash_bwd_dkv_kernel<T, D>;
  const size_t smem = smem_bytes<D>(4);
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kTile - 1) / kTile, B * KV);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), S, N, KV, scale, causal,
      drop);
  return cudaGetLastError();
}

}  // namespace

// Each entry point returns a cudaError_t: 0 on a clean launch, and
// cudaErrorInvalidValue for a shape or type the kernels do not take (the
// Python wrapper checks first). Pointers are to contiguous tensors: q, g,
// out, dq [B, S, N, D]; k, v, dk, dv [B, S, KV, D]; lse, delta [B, N, S]
// fp32. dtype 0 = fp32, 1 = bf16.

extern "C" int nxd_flash_fwd(int dtype, const void* q, const void* k,
                             const void* v, void* out, void* lse, int B,
                             int S, int N, int KV, int D, float scale,
                             int causal, int dropout, unsigned int threshold,
                             unsigned int seed, float inv_keep,
                             unsigned int b_off, unsigned int n_global,
                             unsigned int h_off, void* stream) {
  if (bad_shape(B, S, N, KV, D)) return cudaErrorInvalidValue;
  const Dropout drop{dropout, threshold, seed, inv_keep, b_off, n_global,
                     h_off};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return D == 64 ? fwd<float, 64>(q, k, v, out, lse, B, S, N, KV, scale,
                                    causal, drop, s)
                   : fwd<float, 128>(q, k, v, out, lse, B, S, N, KV, scale,
                                     causal, drop, s);
  if (dtype == kBF16) {
    if (misaligned(q, k, v, out)) return cudaErrorMisalignedAddress;
    return D == 64 ? fwd_bf16<64>(q, k, v, out, lse, B, S, N, KV, scale,
                                  causal, drop, s)
                   : fwd_bf16<128>(q, k, v, out, lse, B, S, N, KV, scale,
                                   causal, drop, s);
  }
  return cudaErrorInvalidValue;
}

extern "C" int nxd_flash_bwd_dq(int dtype, const void* q, const void* k,
                                const void* v, const void* g,
                                const void* lse, const void* delta, void* dq,
                                int B, int S, int N, int KV, int D,
                                float scale, int causal, int dropout,
                                unsigned int threshold, unsigned int seed,
                                float inv_keep, unsigned int b_off,
                                unsigned int n_global, unsigned int h_off,
                                void* stream) {
  if (bad_shape(B, S, N, KV, D)) return cudaErrorInvalidValue;
  const Dropout drop{dropout, threshold, seed, inv_keep, b_off, n_global,
                     h_off};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return D == 64 ? bwd_dq<float, 64>(q, k, v, g, lse, delta, dq, B, S, N,
                                       KV, scale, causal, drop, s)
                   : bwd_dq<float, 128>(q, k, v, g, lse, delta, dq, B, S, N,
                                        KV, scale, causal, drop, s);
  if (dtype == kBF16) {
    if (misaligned(q, k, v, g)) return cudaErrorMisalignedAddress;
    return D == 64 ? bwd_dq_bf16<64>(q, k, v, g, lse, delta, dq, B, S, N, KV,
                                     scale, causal, drop, s)
                   : bwd_dq_bf16<128>(q, k, v, g, lse, delta, dq, B, S, N,
                                      KV, scale, causal, drop, s);
  }
  return cudaErrorInvalidValue;
}

extern "C" int nxd_flash_bwd_dkv(int dtype, const void* q, const void* k,
                                 const void* v, const void* g,
                                 const void* lse, const void* delta,
                                 void* dk, void* dv, int B, int S, int N,
                                 int KV, int D, float scale, int causal,
                                 int dropout, unsigned int threshold,
                                 unsigned int seed, float inv_keep,
                                 unsigned int b_off, unsigned int n_global,
                                 unsigned int h_off, void* stream) {
  if (bad_shape(B, S, N, KV, D)) return cudaErrorInvalidValue;
  const Dropout drop{dropout, threshold, seed, inv_keep, b_off, n_global,
                     h_off};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return D == 64 ? bwd_dkv<float, 64>(q, k, v, g, lse, delta, dk, dv, B,
                                        S, N, KV, scale, causal, drop, s)
                   : bwd_dkv<float, 128>(q, k, v, g, lse, delta, dk, dv, B,
                                         S, N, KV, scale, causal, drop, s);
  if (dtype == kBF16) {
    if (misaligned(q, k, v, g)) return cudaErrorMisalignedAddress;
    return D == 64 ? bwd_dkv_bf16<64>(q, k, v, g, lse, delta, dk, dv, B, S,
                                      N, KV, scale, causal, drop, s)
                   : bwd_dkv_bf16<128>(q, k, v, g, lse, delta, dk, dv, B, S,
                                       N, KV, scale, causal, drop, s);
  }
  return cudaErrorInvalidValue;
}
