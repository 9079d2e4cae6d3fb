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
// global (q, k) coordinates and the flat batch x query-head index, so the
// kernels regenerate the plain version's mask bit for bit.
//
// Bound: operations. At B=1, S=4096, N=32, D=128, causal, K2 does about
// 137 GFLOP against 84 MB of traffic, over 1600 FLOP per byte, far above the
// H100's ~295 bf16 FLOP per byte; K3 and K4 add one and two more products.
//
// Design (simple and correct first; wgmma/TMA come later):
//  * 64 x 64 tiles, 256 threads. Thread t owns tile rows 4*(t/16)..+3 and
//    tile columns (t%16) + 16*j, j < 4; a row's 16 owners are 16 lanes of
//    one warp, so row max and row sum reduce with four shuffles.
//  * Tiles are staged in shared memory as fp32 (rows padded to D+1 floats,
//    so the column reads of a product hit distinct banks); products are
//    fp32 FMAs on the CUDA cores, every sum in fp32. Inputs are fp32 or
//    bf16, outputs in the input type, lse fp32.
//  * GQA is read natively: query head n reads kv head n / (N/KV) of
//    [B, S, KV, D] K/V, so repeat_kv is never materialised. K4 runs one CTA
//    per (batch, kv head, k-block) and loops over the n_rep query heads and
//    their q-blocks, so dk/dv sum inside the CTA and need no atomics.
//  * Causal work skipping: each CTA bounds its own loop. K2 and K3 stop at
//    the diagonal block; K4 starts its q loop at the diagonal block. The
//    heaviest CTAs are scheduled first. The ragged tail of a sequence that is
//    not a multiple of 64 loads as zeros and is masked.
//  * D is 64 or 128, a template parameter.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;             // query rows and key rows per tile
constexpr int kThreads = 256;
constexpr int kLdP = kTile + 1;       // row stride of the 64 x 64 p/ds tile

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

struct Dropout {
  int on;
  uint32_t threshold;   // keep iff hash >= round(p * 0xFFFFFFFF)
  uint32_t seed;
  float inv_keep;       // 1 / (1 - p)
};

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
  const uint32_t hseed = drop.on ? head_seed(drop.seed, (uint32_t)bn) : 0u;

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
  const uint32_t hseed = drop.on ? head_seed(drop.seed, (uint32_t)bn) : 0u;

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
        drop.on ? head_seed(drop.seed, (uint32_t)bn) : 0u;
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
                             void* stream) {
  if (bad_shape(B, S, N, KV, D)) return cudaErrorInvalidValue;
  const Dropout drop{dropout, threshold, seed, inv_keep};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return D == 64 ? fwd<float, 64>(q, k, v, out, lse, B, S, N, KV, scale,
                                    causal, drop, s)
                   : fwd<float, 128>(q, k, v, out, lse, B, S, N, KV, scale,
                                     causal, drop, s);
  if (dtype == kBF16)
    return D == 64 ? fwd<__nv_bfloat16, 64>(q, k, v, out, lse, B, S, N, KV,
                                            scale, causal, drop, s)
                   : fwd<__nv_bfloat16, 128>(q, k, v, out, lse, B, S, N, KV,
                                             scale, causal, drop, s);
  return cudaErrorInvalidValue;
}

extern "C" int nxd_flash_bwd_dq(int dtype, const void* q, const void* k,
                                const void* v, const void* g,
                                const void* lse, const void* delta, void* dq,
                                int B, int S, int N, int KV, int D,
                                float scale, int causal, int dropout,
                                unsigned int threshold, unsigned int seed,
                                float inv_keep, void* stream) {
  if (bad_shape(B, S, N, KV, D)) return cudaErrorInvalidValue;
  const Dropout drop{dropout, threshold, seed, inv_keep};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return D == 64 ? bwd_dq<float, 64>(q, k, v, g, lse, delta, dq, B, S, N,
                                       KV, scale, causal, drop, s)
                   : bwd_dq<float, 128>(q, k, v, g, lse, delta, dq, B, S, N,
                                        KV, scale, causal, drop, s);
  if (dtype == kBF16)
    return D == 64
               ? bwd_dq<__nv_bfloat16, 64>(q, k, v, g, lse, delta, dq, B, S,
                                           N, KV, scale, causal, drop, s)
               : bwd_dq<__nv_bfloat16, 128>(q, k, v, g, lse, delta, dq, B,
                                            S, N, KV, scale, causal, drop, s);
  return cudaErrorInvalidValue;
}

extern "C" int nxd_flash_bwd_dkv(int dtype, const void* q, const void* k,
                                 const void* v, const void* g,
                                 const void* lse, const void* delta,
                                 void* dk, void* dv, int B, int S, int N,
                                 int KV, int D, float scale, int causal,
                                 int dropout, unsigned int threshold,
                                 unsigned int seed, float inv_keep,
                                 void* stream) {
  if (bad_shape(B, S, N, KV, D)) return cudaErrorInvalidValue;
  const Dropout drop{dropout, threshold, seed, inv_keep};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return D == 64 ? bwd_dkv<float, 64>(q, k, v, g, lse, delta, dk, dv, B,
                                        S, N, KV, scale, causal, drop, s)
                   : bwd_dkv<float, 128>(q, k, v, g, lse, delta, dk, dv, B,
                                         S, N, KV, scale, causal, drop, s);
  if (dtype == kBF16)
    return D == 64 ? bwd_dkv<__nv_bfloat16, 64>(q, k, v, g, lse, delta, dk,
                                                dv, B, S, N, KV, scale,
                                                causal, drop, s)
                   : bwd_dkv<__nv_bfloat16, 128>(q, k, v, g, lse, delta, dk,
                                                 dv, B, S, N, KV, scale,
                                                 causal, drop, s);
  return cudaErrorInvalidValue;
}
