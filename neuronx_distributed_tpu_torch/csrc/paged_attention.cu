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
// Bound: the K/V bytes read. Each distinct pool block is needed once per kv
// head and serves every token whose table names it and n_rep query heads,
// a few FLOP per byte against the H100's roughly 295 bf16 FLOP/byte, so
// the call is memory-bound.
//
// Two designs, chosen by the types (the entry's q_dtype and pool_dtype):
//
// bf16 q over a bf16 pool (namespace tc, `paged_attention_wgmma`): every
// product on the tensor cores (wgmma, bf16 operands, fp32 accumulators).
//  * A CTA takes one kv head and a tile of 64 / n_rep consecutive packed
//    tokens: 64 query rows (token-major, then the n_rep query heads of the
//    kv head), one m64 wgmma tile; spare rows (64 % n_rep) are masked.
//  * Packed rows share tables: a prefill chunk fills consecutive rows with
//    one sequence's table, and pad rows all carry the last slot's. So the
//    CTA walks each run of consecutive tokens of its tile whose table rows
//    are equal, and streams that table's K/V once for the whole run: the
//    valid entries are compacted in shared memory (-1 entries drop out),
//    their keys gathered row by row (any block size) through cp.async into
//    64-key tiles in the 128-byte swizzle, a ring of two stages (the next
//    tile lands under this tile's products); the ragged tail is
//    zero-filled and masked. S = Q K^T (fp32, scaled in fp32), the online
//    softmax on the accumulator fragments, P rounded once to bf16 as the
//    register A operand of O += P V, V read MN-major. Each
//    row's mask is its own token's q_pos against the tile's pool positions;
//    rows outside the run are masked and keep their state bit for bit, so
//    every row is updated only by its own run and written once at the end.
//  * Where tiles x kv heads fall short of the card, the wrapper asks for
//    `splits` CTAs per (tile, kv head): with c = ceil(MAXB / splits),
//    split z takes each run's valid entries of rank [z c, (z + 1) c) and
//    writes its rows' (m, l, acc) to fp32 scratch; `paged_combine` merges
//    the splits in a fixed order, so two launches give the same bits. The
//    split points follow the table's width, not its mapped length, so a
//    row gets the same bits through any table whose extra entries it
//    cannot see (as the reference, which walks every entry in order).
//  * The new rounding: P to bf16 before PV (the CUDA-core kernel and the
//    plain version keep it in fp32), bounded on the CPU by
//    tests/test_torch_paged_attention.py.
//
// Other types (fp32, fp16, int8 pools; `paged_attention_kernel`, the CUDA
// cores, simple and correct first):
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

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_tc.cuh"

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

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------
namespace tc {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kList = 256;       // table entries compacted per round
constexpr int kMaxSplits = 16;

template <int D>
__host__ __device__ constexpr uint32_t tile_bytes() {
  return kRows * D * 2;
}

// a stage: the K and V tiles, then the 64 keys' pool positions, padded so
// the next stage's tiles start 1024-aligned
template <int D>
__host__ __device__ constexpr uint32_t stage_bytes() {
  return 2 * tile_bytes<D>() + 1024;
}

// Q, two stages, and 1024 bytes to align the first tile
template <int D>
__host__ __device__ constexpr uint32_t smem_bytes() {
  return tile_bytes<D>() + 2 * stage_bytes<D>() + 1024;
}

// grid (KV, token tiles, splits); q [T, N, D], pools [NB, BS, KV, D],
// pool_pos [NB, BS], tables [T, MAXB], q_pos [T], out [T, N, D]. With
// splits > 1, split z writes part_acc [z][T * N][D] and part_ml [z][T * N]
// (m in log2 units, l) instead of out.
template <int D>
__global__ void __launch_bounds__(kWarpgroup, 2)
    paged_attention_wgmma(const bf16* __restrict__ q,
                          const bf16* __restrict__ k_pool,
                          const bf16* __restrict__ v_pool,
                          const int* __restrict__ pool_pos,
                          const int* __restrict__ tables,
                          const int* __restrict__ q_pos,
                          bf16* __restrict__ out, float* __restrict__ part_acc,
                          float2* __restrict__ part_ml, int T, int N, int KV,
                          int BS, int MAXB, float scale) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ int list[kList];      // this round's valid entries, in order
  __shared__ int starts[kRows];    // token i starts a run
  __shared__ int rows[2][kRows];   // pool rows of the next tiles' keys
  __shared__ int warp_count[kWarpgroup / 32];
  constexpr uint32_t Tb = tile_bytes<D>();
  constexpr uint32_t kStage = stage_bytes<D>();
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t q_sh = (raw + 1023) & ~1023u;
  const uint32_t st_sh = q_sh + Tb;
  const int h = blockIdx.x, split = blockIdx.z, splits = gridDim.z;
  const int n_rep = N / KV, per = kRows / n_rep;
  const int t0 = blockIdx.y * per, ntok = min(per, T - t0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int* tab = tables + (size_t)t0 * MAXB;
  const bool pow2 = (BS & (BS - 1)) == 0;  // e / BS as a shift
  const int bs_shift = __ffs(BS) - 1;

  // Q: row r is token t0 + r / n_rep, query head h n_rep + r % n_rep
  {
    const uint32_t dst[1] = {q_sh};
    const bf16* const base[1] = {q + ((size_t)t0 * N + (size_t)h * n_rep) * D};
    load_rows<kRows, D, kWarpgroup>(dst, base, [&](int r) -> long long {
      return r / n_rep < ntok ? ((long long)(r / n_rep) * N + r % n_rep) * D
                              : -1;
    });
  }
  cp_async_commit();

  // runs: token i starts one where its table row differs from token i - 1's
  for (int i = tid; i < kRows; i += kWarpgroup) starts[i] = i == 0;
  __syncthreads();
  for (int x = tid; x < (ntok - 1) * MAXB; x += kWarpgroup)
    if (tab[x + MAXB] != tab[x]) starts[x / MAXB + 1] = 1;

  // this thread's two rows: their token (-1 for a spare row) and q_pos
  int tok[2], qp[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = frag_row(warp, lane, 2 * e);
    tok[e] = row / n_rep < ntok ? row / n_rep : -1;
    qp[e] = tok[e] >= 0 ? q_pos[t0 + tok[e]] : 0;
  }
  const float scale2 = scale * kLog2e;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[D / 2];
  zero(acc);
  cp_async_wait_for_wgmma();
  __syncthreads();                       // Q and the run starts are in

  for (int a = 0, b; a < ntok; a = b) {
    for (b = a + 1; b < ntok && !starts[b]; ++b) {
    }
    const int* row = tab + (size_t)a * MAXB;
    const bool in[2] = {tok[0] >= a && tok[0] < b, tok[1] >= a && tok[1] < b};
    int nv = 0;                          // the run's valid entries
    for (int j0 = 0; j0 < MAXB; j0 += kWarpgroup)
      nv += __syncthreads_count(j0 + tid < MAXB && row[j0 + tid] >= 0);
    // split z takes the valid entries of rank [z c, (z + 1) c), c from
    // the table's width alone: rounds and tiles start at the same ranks
    // whatever nv is, so entries past a row's keys only add exact zeros
    // and a row's bits do not depend on how much of its table is mapped
    const int c = (MAXB + splits - 1) / splits;
    const int lo = min(split * c, nv);
    const int hi = min(lo + c, nv);
    for (int r0 = lo; r0 < hi; r0 += kList) {
      const int r1 = min(hi, r0 + kList);
      // compact the valid entries of rank [r0, r1) into list, in order
      __syncthreads();                   // the last round's reads are done
      for (int j0 = 0, rank = 0; j0 < MAXB && rank < r1; j0 += kWarpgroup) {
        const int j = j0 + tid;
        const int blk = j < MAXB ? row[j] : -1;
        const unsigned bal = __ballot_sync(0xffffffffu, blk >= 0);
        if (lane == 0) warp_count[warp] = __popc(bal);
        __syncthreads();
        int mine = rank + __popc(bal & ((1u << lane) - 1));
        for (int w = 0; w < warp; ++w) mine += warp_count[w];
        if (blk >= 0 && mine >= r0 && mine < r1) list[mine - r0] = blk;
        for (int w = 0; w < kWarpgroup / 32; ++w) rank += warp_count[w];
        __syncthreads();
      }
      const int nkeys = (r1 - r0) * BS;
      const int ntl = (nkeys + kRows - 1) / kRows;
      // the pool rows of tile j's 64 keys (-1 past the round), worked out
      // a tile ahead by 64 threads into rows[j % 2]: key e of the round is
      // pool row list[e / BS] BS + e % BS
      auto find_rows = [&](int it) {
        if (tid < kRows) {
          const int e = it * kRows + tid;
          int row = -1;
          if (e < nkeys) {
            const int blk = pow2 ? e >> bs_shift : e / BS;
            row = list[blk] * BS + (e - blk * BS);
          }
          rows[it & 1][tid] = row;
        }
      };
      // tile j (K, V, then its 64 pool positions) lands in slot j % 2
      auto load_stage = [&](int it) {
        const uint32_t st = st_sh + (it & 1) * kStage;
        const int* row = rows[it & 1];
        const uint32_t dst[2] = {st, st + Tb};
        const bf16* const base[2] = {k_pool + (size_t)h * D,
                                     v_pool + (size_t)h * D};
        load_rows<kRows, D, kWarpgroup>(dst, base, [&](int r) -> long long {
          return row[r] < 0 ? -1 : (long long)row[r] * KV * D;
        });
        if (tid < kRows)
          cp_async4(st + 2 * Tb + tid * 4,
                    pool_pos + (row[tid] < 0 ? 0 : row[tid]), row[tid] >= 0);
      };
      find_rows(0);
      if (ntl > 1) find_rows(1);
      __syncthreads();
      load_stage(0);
      cp_async_commit();
      for (int it = 0; it < ntl; ++it) {
        cp_async_wait_for_wgmma();
        __syncthreads();                 // tile it is in; it - 1 is free
        if (it + 1 < ntl) load_stage(it + 1);
        cp_async_commit();
        if (it + 2 < ntl) find_rows(it + 2);   // tile it's rows are used
        const uint32_t st = st_sh + (it & 1) * kStage;
        const int2* pos2 =
            reinterpret_cast<const int2*>(smem_raw + (st + 2 * Tb - raw));
        float s[32];
        zero(s);
        wgmma_fence();
        mma_ss<D>(s, q_sh, st);          // s = q k^T
        wgmma_commit();
        wgmma_wait();
        hold(s);
        // keys [0, kend) of the tile are real; this thread's columns come
        // in pairs 8 j + 2 (lane % 4) + {0, 1}
        const int kend = nkeys - it * kRows;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int2 pp = pos2[4 * j + lane % 4];
          const int col = 8 * j + 2 * (lane % 4);
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int i = 4 * j + x, e = x >> 1;
            const bool ok = in[e] && col + (x & 1) < kend &&
                            qp[e] >= ((x & 1) ? pp.y : pp.x);
            s[i] = ok ? s[i] * scale2 : -INFINITY;
          }
        }
        online_softmax(s, m, l, acc);
        uint32_t pa[4][4];
        to_operand(s, pa);
        wgmma_fence();
        mma_rs(acc, pa, st + Tb);        // o += p v
        wgmma_commit();
        wgmma_wait();
        hold(acc);
        hold(pa);
      }
    }
  }

  // rows out: row r is (token t0 + r / n_rep, query head h n_rep + r % n_rep)
  float lt[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) lt[e] = quad_sum(l[e]);
  const size_t head0 = (size_t)h * n_rep;
  if (splits == 1) {
    float f[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) f[e] = 1.f / fmaxf(lt[e], 1e-30f);
#pragma unroll
    for (int i = 0; i < D / 2; i += 2) {
      const int e = (i >> 1) & 1, r = frag_row(warp, lane, i);
      if (tok[e] < 0) continue;
      bf16* o = out + ((size_t)(t0 + tok[e]) * N + head0 + r % n_rep) * D +
                frag_col(lane, i);
      *reinterpret_cast<__nv_bfloat162*>(o) =
          __floats2bfloat162_rn(acc[i] * f[e], acc[i + 1] * f[e]);
    }
    return;
  }
  const size_t tn0 = (size_t)split * T * N;
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int e = (i >> 1) & 1, r = frag_row(warp, lane, i);
    if (tok[e] < 0) continue;
    const size_t tn = tn0 + (size_t)(t0 + tok[e]) * N + head0 + r % n_rep;
    *reinterpret_cast<float2*>(part_acc + tn * D + frag_col(lane, i)) =
        make_float2(acc[i], acc[i + 1]);
    if (i < 4 && lane % 4 == 0) part_ml[tn] = make_float2(m[e], lt[e]);
  }
}

// Merge the splits' (m, l, acc) of each (token, query head) in split
// order; grid T * N, D threads.
template <int D>
__global__ void __launch_bounds__(D) paged_combine(
    const float* __restrict__ part_acc, const float2* __restrict__ part_ml,
    bf16* __restrict__ out, int TN, int splits) {
  const size_t tn = blockIdx.x;
  float mx = -INFINITY;
  for (int z = 0; z < splits; ++z)
    mx = fmaxf(mx, part_ml[(size_t)z * TN + tn].x);
  float l = 0.f, acc = 0.f;
  for (int z = 0; z < splits; ++z) {
    const float2 ml = part_ml[(size_t)z * TN + tn];
    const float w = ml.x == -INFINITY ? 0.f : exp2f(ml.x - mx);
    l += ml.y * w;
    acc += part_acc[((size_t)z * TN + tn) * D + threadIdx.x] * w;
  }
  out[tn * D + threadIdx.x] = __float2bfloat16(acc / fmaxf(l, 1e-30f));
}

}  // namespace tc

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

// bf16 q over a bf16 pool: the tensor-core kernel, then the combine where
// the wrapper asked for splits.
template <int D>
cudaError_t launch_bf16(const void* q, const void* k_pool, const void* v_pool,
                        const int* pool_pos, const int* tables,
                        const int* q_pos, void* out, void* partial, int T,
                        int N, int KV, int BS, int MAXB, int splits,
                        float scale, cudaStream_t stream) {
  auto kernel = tc::paged_attention_wgmma<D>;
  const size_t smem = tc::smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const int per = tc::kRows / (N / KV);
  const size_t tn = (size_t)T * N;
  float* part_acc = static_cast<float*>(partial);
  float2* part_ml =
      reinterpret_cast<float2*>(part_acc + (size_t)splits * tn * D);
  tc::bf16* o = static_cast<tc::bf16*>(out);
  kernel<<<dim3(KV, (T + per - 1) / per, splits), tc::kWarpgroup, smem,
           stream>>>(static_cast<const tc::bf16*>(q),
                     static_cast<const tc::bf16*>(k_pool),
                     static_cast<const tc::bf16*>(v_pool), pool_pos, tables,
                     q_pos, o, part_acc, part_ml, T, N, KV, BS, MAXB, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  tc::paged_combine<D><<<(unsigned)tn, D, 0, stream>>>(part_acc, part_ml, o,
                                                       (int)tn, splits);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t: 0 on a clean launch. Rejects shapes the kernels do
// not take with cudaErrorInvalidValue (the Python wrapper checks first).
// bf16 q over a bf16 pool runs the tensor-core kernel in `splits` CTAs per
// (token tile, kv head); splits > 1 needs `partial`, fp32 scratch of
// splits * T * N * (D + 2) floats. Other types run the CUDA-core kernel and
// ignore both.
extern "C" int nxd_paged_attention(int q_dtype, int pool_dtype, const void* q,
                                   const void* k_pool, const void* v_pool,
                                   const void* k_scale, const void* v_scale,
                                   const void* pool_pos, const void* tables,
                                   const void* q_pos, void* out,
                                   void* partial, int T, int N, int KV, int D,
                                   int BS, int MAXB, int splits, float scale,
                                   void* stream) {
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
  if (q_dtype == kBF16 && pool_dtype == kBF16) {
    const int per = tc::kRows / (N / KV);
    if (splits < 1 || splits > tc::kMaxSplits || (splits > 1 && !partial) ||
        (T + per - 1) / per > 65535)
      return cudaErrorInvalidValue;
    if (((uintptr_t)q | (uintptr_t)k_pool | (uintptr_t)v_pool |
         (uintptr_t)out) & 15)
      return cudaErrorMisalignedAddress;   // cp.async reads 16-byte chunks
    return D == 64 ? launch_bf16<64>(q, k_pool, v_pool, pp, tb, qp, out,
                                     partial, T, N, KV, BS, MAXB, splits,
                                     scale, s)
                   : launch_bf16<128>(q, k_pool, v_pool, pp, tb, qp, out,
                                      partial, T, N, KV, BS, MAXB, splits,
                                      scale, s);
  }
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
