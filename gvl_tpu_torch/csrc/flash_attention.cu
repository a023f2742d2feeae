// Flash-attention forward for Hopper (sm_90a), f32 or bf16, head_dim 64 or 128.
//
// Replaces the TPU kernel gvl_tpu/ops/attention.py:flash_attention (Pallas
// bodies _attn_kernel and _attn_single_kernel): softmax(q k^T * scale) v with
// an online softmax, grouped-query heads (KV head = h / group), a causal mask
// and a key-padding mask (keys >= kv_len).  One kernel covers both Pallas
// branches: a sequence whose keys fit one tile simply runs one loop step.
//
// Design.  One block of 128 threads per (q-tile, q-head, batch).  A query row
// belongs to D/16 neighbouring threads of one warp; each holds 16 elements of
// the row (float4 chunks interleaved across the threads, so that reads of a
// shared-memory key row are conflict-free broadcasts) and its share of the
// output accumulator.  K and V tiles of 32 keys are staged in shared memory as
// f32.  Scores are reduced across the row's threads with warp shuffles; the
// running max, normaliser and accumulator stay in registers and are rescaled
// once per tile.  Tiles wholly above the causal diagonal or past kv_len are
// never loaded.  All arithmetic is f32 FMA on the CUDA cores: the softmax
// weights are rounded to the input type before P @ V, as the TPU kernel does.
//
// Bound.  At the QA model's prefill (10 heads, 4096 tokens, D 64, f32) the
// work is ~21 GFLOP per layer against ~31 MB of traffic: operation-bound, and
// on CUDA cores (67 TFLOP/s f32 peak) rather than tensor cores.  The kernel
// issues one shared-memory load per 4 FMAs, which caps it well below that
// peak; wgmma/mma tiles are the next step for speed.
#include "common.cuh"

namespace gvl {
namespace {

constexpr int kThreads = 128;
constexpr int kBlockK = 32;  // keys per shared-memory tile

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int hq,
                       int hkv, int sq, int sk, int kv_len, int causal,
                       float scale) {
  constexpr int kTpr = D / 16;            // threads per query row
  constexpr int kRows = kThreads / kTpr;  // query rows per block
  constexpr int kChunks = D / 4 / kTpr;   // float4 chunks per thread (4)
  __shared__ float4 ks[kBlockK][D / 4];
  __shared__ float4 vs[kBlockK][D / 4];

  const int tid = threadIdx.x;
  const int part = tid % kTpr;
  const int row = blockIdx.x * kRows + tid / kTpr;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (hq / hkv);
  const bool row_ok = row < sq;

  const size_t q_off = (((size_t)b * hq + h) * sq + (row_ok ? row : 0)) * D;
  const T* kbase = k + ((size_t)b * hkv + kvh) * sk * D;
  const T* vbase = v + ((size_t)b * hkv + kvh) * sk * D;

  float4 qr[kChunks], acc[kChunks];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const size_t e = q_off + (size_t)(c * kTpr + part) * 4;
    qr[c] = make_float4(to_float(q[e]), to_float(q[e + 1]), to_float(q[e + 2]),
                        to_float(q[e + 3]));
    acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  // keys this block can see: the live ones, and under a causal mask only
  // those at or below the tile's last row
  int kend = min(sk, kv_len);
  if (causal) kend = min(kend, (int)(blockIdx.x + 1) * kRows);

  float m = kNegInf, l = 0.f;
  float* ks_flat = reinterpret_cast<float*>(&ks[0][0]);
  float* vs_flat = reinterpret_cast<float*>(&vs[0][0]);
  for (int k0 = 0; k0 < kend; k0 += kBlockK) {
    __syncthreads();  // the previous tile is consumed
    for (int idx = tid; idx < kBlockK * D; idx += kThreads) {
      const int key = k0 + idx / D;
      float kx = 0.f, vx = 0.f;
      if (key < kend) {
        const size_t off = (size_t)key * D + idx % D;
        kx = to_float(kbase[off]);
        vx = to_float(vbase[off]);
      }
      ks_flat[idx] = kx;
      vs_flat[idx] = vx;
    }
    __syncthreads();

    float s[kBlockK];
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
      const int key = k0 + j;
      const bool live = key < kend && (!causal || key <= row);
      s[j] = live ? dot * scale : kNegInf;
      tile_max = fmaxf(tile_max, s[j]);
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
      const float p = s[j] == kNegInf ? 0.f : expf(s[j] - m_new);
      p_sum += p;
      const float pv = round_to<T>(p);
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
      out[e] = from_float<T>(acc[c].x / denom);
      out[e + 1] = from_float<T>(acc[c].y / denom);
      out[e + 2] = from_float<T>(acc[c].z / denom);
      out[e + 3] = from_float<T>(acc[c].w / denom);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int batch,
           int hq, int hkv, int sq, int sk, int kv_len, int causal,
           float scale, cudaStream_t stream) {
  constexpr int kRows = kThreads / (D / 16);
  const dim3 grid((sq + kRows - 1) / kRows, hq, batch);
  flash_attention_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), hq, hkv, sq, sk, kv_len,
      causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace gvl

// q [B, Hq, Sq, D], k/v [B, Hkv, Sk, D], out [B, Hq, Sq, D], all contiguous
// and of one type (dtype: 0 f32, 1 bf16).  Returns a cudaError_t.
extern "C" int gvl_flash_attention(const void* q, const void* k, const void* v,
                                   void* out, int batch, int hq, int hkv,
                                   int sq, int sk, int head_dim, int kv_len,
                                   int causal, float scale, int dtype,
                                   void* stream) {
  using namespace gvl;
  if (batch <= 0 || hq <= 0 || hkv <= 0 || hq % hkv || sq <= 0 || sk <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32 && head_dim == 64)
    return launch<float, 64>(q, k, v, out, batch, hq, hkv, sq, sk, kv_len, causal, scale, s);
  if (dtype == kF32 && head_dim == 128)
    return launch<float, 128>(q, k, v, out, batch, hq, hkv, sq, sk, kv_len, causal, scale, s);
  if (dtype == kBF16 && head_dim == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, out, batch, hq, hkv, sq, sk, kv_len, causal, scale, s);
  if (dtype == kBF16 && head_dim == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, out, batch, hq, hkv, sq, sk, kv_len, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}
