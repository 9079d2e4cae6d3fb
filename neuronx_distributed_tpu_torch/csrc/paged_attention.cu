// Paged decode attention over a shared KV block pool, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_paged_kernel`
// (neuronx_distributed_tpu/ops/paged_attention.py:95, launched by
// `_paged_attention_pallas`). It computes what that kernel computes: one
// query row per packed token attends the pool blocks named by the token's
// block table, with an online softmax in fp32, GQA expanded in the kernel,
// int8 pools dequantised with per-row scales, and the mask
// `q_pos >= stored_pos && table >= 0`. A row with no valid key gives zeros.
//
// Bound: the K/V bytes read. Each pool row is read once per (token, kv head)
// and used for n_rep query heads, about 1 FLOP per byte against the H100's
// roughly 295 bf16 FLOP/byte, so the kernel is memory-bound.
//
// Design (simple and correct first):
//  * grid (T, KV): one CTA per (token, kv head), D threads (64 or 128).
//    The CTA loads each K and V row of its kv head once and serves all
//    n_rep = N/KV query heads from it; the TPU kernel instead repeated K/V
//    per head (jnp.repeat).
//  * the CTA loops over the token's table entries, replacing the TPU's
//    sequential grid axis, and skips -1 entries without loading them (the
//    TPU kernel clamped them to block 0 and masked).
//  * scores: warp w takes slots w, w + D/32, ...; each lane holds D/32
//    elements of the K row (coalesced) and the dot products reduce by
//    warp shuffles. Softmax statistics m/l live in shared memory, the
//    accumulator in registers: thread d owns column d of every query head.
//  * block_size any value up to 256; n_rep up to 16.
// Later work: split-K over blocks, cp.async/TMA pipelining, and a
// tensor-core Q K^T over the n_rep x block_size tile.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxRep = 16;
constexpr int kMaxBlock = 256;

enum DType { kF32 = 0, kBF16 = 1, kF16 = 2, kI8 = 3 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
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
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// q [T, N, D]; k_pool/v_pool [NB, BS, KV, D]; k_scale/v_scale [NB, BS, KV]
// (int8 pools only, else null); pool_pos [NB, BS]; tables [T, MAXB];
// q_pos [T]; out [T, N, D]. All contiguous.
template <typename TQ, typename TP, int D>
__global__ void __launch_bounds__(D) paged_attention_kernel(
    const TQ* __restrict__ q, const TP* __restrict__ k_pool,
    const TP* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ pool_pos,
    const int* __restrict__ tables, const int* __restrict__ q_pos,
    TQ* __restrict__ out, int N, int KV, int BS, int MAXB, float scale) {
  constexpr int kWarps = D / 32;
  constexpr int kPerLane = D / 32;
  __shared__ float q_sh[kMaxRep * D];
  __shared__ float p_sh[kMaxRep * kMaxBlock];
  __shared__ float m_sh[kMaxRep];
  __shared__ float l_sh[kMaxRep];
  __shared__ float corr_sh[kMaxRep];

  const int t = blockIdx.x;
  const int h = blockIdx.y;
  const int n_rep = N / KV;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int qp = q_pos[t];

  // this kv head's n_rep query rows, pre-scaled, in fp32
  const TQ* q_t = q + ((size_t)t * N + (size_t)h * n_rep) * D;
  for (int e = tid; e < n_rep * D; e += D) q_sh[e] = to_f32(q_t[e]) * scale;
  if (tid < n_rep) {
    m_sh[tid] = -INFINITY;
    l_sh[tid] = 0.f;
  }
  float acc[kMaxRep];
#pragma unroll
  for (int r = 0; r < kMaxRep; ++r) acc[r] = 0.f;
  __syncthreads();

  for (int j = 0; j < MAXB; ++j) {
    const int blk = tables[(size_t)t * MAXB + j];
    if (blk < 0) continue;  // the same for every thread of the CTA
    const size_t base = (size_t)blk * BS;  // first pool row of the block

    // scores s[r][slot], -inf where masked
    for (int slot = warp; slot < BS; slot += kWarps) {
      const size_t row = base + slot;
      const size_t kv_row = row * KV + h;
      const TP* kr = k_pool + kv_row * D;
      const float ks = k_scale ? k_scale[kv_row] : 1.f;
      float kf[kPerLane];
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) kf[i] = to_f32(kr[lane + 32 * i]) * ks;
      const bool valid = qp >= pool_pos[row];
      for (int r = 0; r < n_rep; ++r) {
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < kPerLane; ++i)
          dot += q_sh[r * D + lane + 32 * i] * kf[i];
        dot = warp_sum(dot);
        if (lane == 0) p_sh[r * kMaxBlock + slot] = valid ? dot : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax statistics, one warp per query head
    for (int r = warp; r < n_rep; r += kWarps) {
      float* s = p_sh + r * kMaxBlock;
      float bmax = -INFINITY;
      for (int i = lane; i < BS; i += 32) bmax = fmaxf(bmax, s[i]);
      bmax = warp_max(bmax);
      const float m_prev = m_sh[r];
      const float m_new = fmaxf(m_prev, bmax);
      const float m_safe = (m_new == -INFINITY) ? 0.f : m_new;
      float sum = 0.f;
      for (int i = lane; i < BS; i += 32) {
        const float sv = s[i];
        const float p = (sv == -INFINITY) ? 0.f : expf(sv - m_safe);
        s[i] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = (m_prev == -INFINITY) ? 0.f : expf(m_prev - m_safe);
        corr_sh[r] = corr;
        l_sh[r] = l_sh[r] * corr + sum;
        m_sh[r] = m_new;
      }
    }
    __syncthreads();

    // acc[r] = acc[r] * corr[r] + sum_slot p[r][slot] * V[slot][tid]
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r)
      if (r < n_rep) acc[r] *= corr_sh[r];
    for (int slot = 0; slot < BS; ++slot) {
      const size_t kv_row = (base + slot) * KV + h;
      const float vs = v_scale ? v_scale[kv_row] : 1.f;
      const float vv = to_f32(v_pool[kv_row * D + tid]) * vs;
#pragma unroll
      for (int r = 0; r < kMaxRep; ++r)
        if (r < n_rep) acc[r] += p_sh[r * kMaxBlock + slot] * vv;
    }
    __syncthreads();  // p_sh and corr_sh are rewritten for the next block
  }

  TQ* o_t = out + ((size_t)t * N + (size_t)h * n_rep) * D;
#pragma unroll
  for (int r = 0; r < kMaxRep; ++r)
    if (r < n_rep) o_t[r * D + tid] = from_f32<TQ>(acc[r] / fmaxf(l_sh[r], 1e-30f));
}

template <typename TQ, typename TP>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const float* k_scale, const float* v_scale,
                   const int* pool_pos, const int* tables, const int* q_pos,
                   void* out, int T, int N, int KV, int D, int BS, int MAXB,
                   float scale, cudaStream_t stream) {
  const dim3 grid(T, KV);
  const TQ* qq = static_cast<const TQ*>(q);
  const TP* kp = static_cast<const TP*>(k_pool);
  const TP* vp = static_cast<const TP*>(v_pool);
  TQ* o = static_cast<TQ*>(out);
  if (D == 64)
    paged_attention_kernel<TQ, TP, 64><<<grid, 64, 0, stream>>>(
        qq, kp, vp, k_scale, v_scale, pool_pos, tables, q_pos, o, N, KV, BS,
        MAXB, scale);
  else
    paged_attention_kernel<TQ, TP, 128><<<grid, 128, 0, stream>>>(
        qq, kp, vp, k_scale, v_scale, pool_pos, tables, q_pos, o, N, KV, BS,
        MAXB, scale);
  return cudaGetLastError();
}

template <typename TQ>
cudaError_t launch_pool(int pool_dtype, const void* q, const void* k_pool,
                        const void* v_pool, const float* k_scale,
                        const float* v_scale, const int* pool_pos,
                        const int* tables, const int* q_pos, void* out, int T,
                        int N, int KV, int D, int BS, int MAXB, float scale,
                        cudaStream_t stream) {
  switch (pool_dtype) {
    case kF32:
      return launch<TQ, float>(q, k_pool, v_pool, k_scale, v_scale, pool_pos,
                               tables, q_pos, out, T, N, KV, D, BS, MAXB,
                               scale, stream);
    case kBF16:
      return launch<TQ, __nv_bfloat16>(q, k_pool, v_pool, k_scale, v_scale,
                                       pool_pos, tables, q_pos, out, T, N, KV,
                                       D, BS, MAXB, scale, stream);
    case kF16:
      return launch<TQ, __half>(q, k_pool, v_pool, k_scale, v_scale, pool_pos,
                                tables, q_pos, out, T, N, KV, D, BS, MAXB,
                                scale, stream);
    case kI8:
      return launch<TQ, int8_t>(q, k_pool, v_pool, k_scale, v_scale, pool_pos,
                                tables, q_pos, out, T, N, KV, D, BS, MAXB,
                                scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns a cudaError_t: 0 on a clean launch. Rejects shapes the kernel does
// not take with cudaErrorInvalidValue (the Python wrapper checks first).
extern "C" int nxd_paged_attention(int q_dtype, int pool_dtype, const void* q,
                                   const void* k_pool, const void* v_pool,
                                   const void* k_scale, const void* v_scale,
                                   const void* pool_pos, const void* tables,
                                   const void* q_pos, void* out, int T, int N,
                                   int KV, int D, int BS, int MAXB,
                                   float scale, void* stream) {
  if (T <= 0 || KV <= 0 || N % KV != 0 || N / KV > kMaxRep ||
      (D != 64 && D != 128) || BS <= 0 || BS > kMaxBlock || MAXB <= 0 ||
      KV > 65535 || ((pool_dtype == kI8) != (k_scale != nullptr)) ||
      ((k_scale == nullptr) != (v_scale == nullptr)))
    return cudaErrorInvalidValue;
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int* pp = static_cast<const int*>(pool_pos);
  const int* tb = static_cast<const int*>(tables);
  const int* qp = static_cast<const int*>(q_pos);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (q_dtype) {
    case kF32:
      return launch_pool<float>(pool_dtype, q, k_pool, v_pool, ks, vs, pp, tb,
                                qp, out, T, N, KV, D, BS, MAXB, scale, s);
    case kBF16:
      return launch_pool<__nv_bfloat16>(pool_dtype, q, k_pool, v_pool, ks, vs,
                                        pp, tb, qp, out, T, N, KV, D, BS, MAXB,
                                        scale, s);
    case kF16:
      return launch_pool<__half>(pool_dtype, q, k_pool, v_pool, ks, vs, pp, tb,
                                 qp, out, T, N, KV, D, BS, MAXB, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}
