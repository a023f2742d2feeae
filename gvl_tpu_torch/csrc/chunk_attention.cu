// Chunk attention over a KV cache for Hopper (sm_90a): f32 or bf16 query,
// bf16 cache, head_dim 64 or 128, any number of query heads per KV head.
//
// Replaces the TPU kernel gvl_tpu/ops/decode_attention.py:chunk_attention
// (Pallas body _chunk_kernel): an S-token chunk already written into the
// cache at per-slot offset start[b] attends over the cached prefix plus its
// own causal part, so chunk row s of slot b sees keys 0 .. start[b] + s.
// With start 0 it is causal attention over the chunk.  It serves speculative
// verification, a session's delta ingest and every admission of the batching
// engine.
//
// Design.  The TPU kernel holds all S * G query rows of a (slot, KV head) in
// one VMEM block and so refuses S * G > 512.  Here the rows are tiled instead:
// one block per (row tile, KV head, slot) over the rows r = s * G + g of that
// KV head (s-major, as the TPU kernel orders them), so the G query heads that
// share a KV head share every K/V tile that is read.  The block loops over
// 32-key tiles up to the last key its last row may see; tiles past that are
// never read.  Inside, the layout is the flash kernel's: a row belongs to D/16
// neighbouring threads of one warp, K/V tiles are staged in shared memory as
// f32 (16-byte loads of the bf16 cache), scores are reduced with warp
// shuffles, and the online-softmax state stays in registers.  The softmax
// weights are rounded to bf16 before P @ V, as the TPU kernel rounds them to
// the cache type.
//
// Bound.  At a QA admission (10 heads, a 2048-token chunk, D 64) the work is
// 4 * D flops per live (row, key) pair, ~5.4 GFLOP per layer, against ~8 MB
// of traffic: operation-bound, on CUDA cores in f32.  A speculative verify
// (5 rows) reads the live prefix once for each KV head: memory-bound.
#include "common.cuh"

namespace gvl {
namespace {

constexpr int kThreads = 128;
constexpr int kBlockK = 32;  // keys per shared-memory tile

template <typename TQ, int D>
__global__ void __launch_bounds__(kThreads)
chunk_attention_kernel(const TQ* __restrict__ q,
                       const __nv_bfloat16* __restrict__ kc,
                       const __nv_bfloat16* __restrict__ vc,
                       const int* __restrict__ starts, TQ* __restrict__ out,
                       int hq, int hkv, int seq, int s_max, float scale) {
  constexpr int kTpr = D / 16;            // threads per query row
  constexpr int kRows = kThreads / kTpr;  // query rows per block
  constexpr int kChunks = D / 4 / kTpr;   // float4 chunks per thread (4)
  constexpr int kRowVecs = D / 8;         // 16-byte words per bf16 row
  __shared__ float4 ks[kBlockK][D / 4];
  __shared__ float4 vs[kBlockK][D / 4];

  const int group = hq / hkv;
  const int rows = seq * group;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int part = tid % kTpr;
  const int r = blockIdx.x * kRows + tid / kTpr;  // r = s * G + g
  const bool row_ok = r < rows;
  const int s = row_ok ? r / group : 0;
  const int h = kvh * group + (row_ok ? r % group : 0);
  const int start = max(starts[b], 0);
  const int row_end = min(start + s + 1, s_max);  // keys this row sees
  // keys the block's last row sees: the end of the key loop
  const int last_row = min((int)(blockIdx.x + 1) * kRows, rows) - 1;
  const int kend = min(start + last_row / group + 1, s_max);

  const size_t q_off = (((size_t)b * hq + h) * seq + s) * D;
  const size_t kv_off = ((size_t)b * hkv + kvh) * s_max * D;
  const __nv_bfloat16* kbase = kc + kv_off;
  const __nv_bfloat16* vbase = vc + kv_off;

  float4 qr[kChunks], acc[kChunks];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const size_t e = q_off + (size_t)(c * kTpr + part) * 4;
    qr[c] = make_float4(to_float(q[e]), to_float(q[e + 1]), to_float(q[e + 2]),
                        to_float(q[e + 3]));
    acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  float m = kNegInf, l = 0.f;
  float* ks_flat = reinterpret_cast<float*>(&ks[0][0]);
  float* vs_flat = reinterpret_cast<float*>(&vs[0][0]);
  for (int k0 = 0; k0 < kend; k0 += kBlockK) {
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < kBlockK * kRowVecs; i += kThreads) {
      const int j = i / kRowVecs, col = (i % kRowVecs) * 8;
      float kx[8], vx[8];
      if (k0 + j < kend) {
        const size_t off = (size_t)(k0 + j) * D + col;
        load_f32<__nv_bfloat16, 8>(kbase + off, kx);
        load_f32<__nv_bfloat16, 8>(vbase + off, vx);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) kx[e] = vx[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        ks_flat[j * D + col + e] = kx[e];
        vs_flat[j * D + col + e] = vx[e];
      }
    }
    __syncthreads();

    float sc[kBlockK];
    float tile_max = kNegInf;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const float4 kk = ks[j][c * kTpr + part];
        dot += qr[c].x * kk.x + qr[c].y * kk.y + qr[c].z * kk.z + qr[c].w * kk.w;
      }
#pragma unroll
      for (int off = kTpr / 2; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      sc[j] = k0 + j < row_end ? dot * scale : kNegInf;
      tile_max = fmaxf(tile_max, sc[j]);
    }

    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      acc[c].x *= alpha;
      acc[c].y *= alpha;
      acc[c].z *= alpha;
      acc[c].w *= alpha;
    }
    float p_sum = 0.f;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      // a masked key adds nothing (exp(-1e30 - m) is 0 for any live m)
      const float p = sc[j] == kNegInf ? 0.f : expf(sc[j] - m_new);
      p_sum += p;
      const float pv = round_to<__nv_bfloat16>(p);
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const float4 vv = vs[j][c * kTpr + part];
        acc[c].x += pv * vv.x;
        acc[c].y += pv * vv.y;
        acc[c].z += pv * vv.z;
        acc[c].w += pv * vv.w;
      }
    }
    l = l * alpha + p_sum;
    m = m_new;
  }

  if (row_ok) {
    const float denom = fmaxf(l, 1e-30f);
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const size_t e = q_off + (size_t)(c * kTpr + part) * 4;
      out[e] = from_float<TQ>(acc[c].x / denom);
      out[e + 1] = from_float<TQ>(acc[c].y / denom);
      out[e + 2] = from_float<TQ>(acc[c].z / denom);
      out[e + 3] = from_float<TQ>(acc[c].w / denom);
    }
  }
}

template <typename TQ, int D>
int launch(const void* q, const void* k_cache, const void* v_cache,
           const void* starts, void* out, int batch, int hq, int hkv, int seq,
           int s_max, float scale, cudaStream_t stream) {
  constexpr int kRows = kThreads / (D / 16);
  const int rows = seq * (hq / hkv);
  const dim3 grid((rows + kRows - 1) / kRows, hkv, batch);
  chunk_attention_kernel<TQ, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const TQ*>(q), static_cast<const __nv_bfloat16*>(k_cache),
      static_cast<const __nv_bfloat16*>(v_cache),
      static_cast<const int*>(starts), static_cast<TQ*>(out), hq, hkv, seq,
      s_max, scale);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace gvl

// q [B, Hq, S, D] (q_dtype: 0 f32, 1 bf16), k/v cache [B, Hkv, S_max, D] bf16
// holding the chunk at rows start[b] .. start[b] + S - 1, starts [B] int32,
// out [B, Hq, S, D] of q's type.  All contiguous.  Returns a cudaError_t.
extern "C" int gvl_chunk_attention(const void* q, const void* k_cache,
                                   const void* v_cache, const void* starts,
                                   void* out, int batch, int hq, int hkv,
                                   int seq, int s_max, int head_dim,
                                   float scale, int q_dtype, void* stream) {
  using namespace gvl;
  if (batch <= 0 || hq <= 0 || hkv <= 0 || hq % hkv || seq <= 0 || s_max <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == kF32 && head_dim == 64)
    return launch<float, 64>(q, k_cache, v_cache, starts, out, batch, hq, hkv, seq, s_max, scale, s);
  if (q_dtype == kF32 && head_dim == 128)
    return launch<float, 128>(q, k_cache, v_cache, starts, out, batch, hq, hkv, seq, s_max, scale, s);
  if (q_dtype == kBF16 && head_dim == 64)
    return launch<__nv_bfloat16, 64>(q, k_cache, v_cache, starts, out, batch, hq, hkv, seq, s_max, scale, s);
  if (q_dtype == kBF16 && head_dim == 128)
    return launch<__nv_bfloat16, 128>(q, k_cache, v_cache, starts, out, batch, hq, hkv, seq, s_max, scale, s);
  return (int)cudaErrorInvalidValue;
}
