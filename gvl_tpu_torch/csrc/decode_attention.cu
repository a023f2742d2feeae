// Single-token decode attention over the live prefix of a bf16 KV cache, for
// Hopper (sm_90a): f32 or bf16 query, head_dim 64 or 128, up to 8 query heads
// per KV head.
//
// Replaces the TPU kernels gvl_tpu/ops/decode_attention.py:decode_attention
// (Pallas body _decode_kernel) and :decode_attention_stacked (body
// _decode_kernel_stacked): out[b, h] = softmax(q[b, h] . k[b, h/G, :len])
// v[b, h/G, :len] with len = lengths[b]; keys at or past len are neither read
// nor computed.  The stacked form reads layer `layer` of an [L, B, Hkv, S_max,
// D] cache: the kernel adds the layer's offset to the cache pointers itself,
// so no layer is sliced out or copied (the TPU kernel's scalar-prefetched
// layer index in its block index map).
//
// Design.  The TPU kernel walks a (slot, KV head)'s blocks one after another.
// On Hopper that would leave most of the 132 SMs idle at batch 1, so the live
// prefix is split instead: one block per (256-key chunk, KV head, slot) scores
// its chunk for all G query heads of the KV head at once (each K row is read
// from memory once for the group), takes the chunk's own softmax max and sum,
// and writes the unnormalised P @ V with them to a scratch buffer.  A second
// kernel merges the chunks of each (slot, query head) by their maxima.  Blocks
// whose chunk starts at or past len return before reading anything.  The
// softmax weights are rounded to the cache type before P @ V, as the TPU kernel
// does.
//
// Bound.  Reading the live K and V rows is all the work (about one FMA per
// byte): memory-bound, 3.35 TB/s on an H100 SXM.  Scores use 8 lanes per key
// and 16-byte loads, so each warp reads four whole neighbouring rows at once.
#include "common.cuh"

namespace gvl {
namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 256;   // keys per block
constexpr int kMaxGroup = 8;  // query heads per KV head
constexpr int kLanesPerKey = 8;

template <typename TQ, int D>
__global__ void __launch_bounds__(kThreads)
decode_partial_kernel(const TQ* __restrict__ q,
                      const __nv_bfloat16* __restrict__ kc,
                      const __nv_bfloat16* __restrict__ vc,
                      const int* __restrict__ lengths,
                      float* __restrict__ part_acc, float* __restrict__ part_ml,
                      int layer, int hq, int hkv, int s_max, int n_chunks,
                      float scale) {
  constexpr int kPerLane = D / kLanesPerKey;
  constexpr int kKeysPerPass = kThreads / kLanesPerKey;
  __shared__ float qs[kMaxGroup][D];
  __shared__ float ps[kMaxGroup][kChunk];

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int group = hq / hkv;
  const int len = min(lengths[b], s_max);
  const int k0 = c * kChunk;
  if (k0 >= len) return;  // past the live prefix: nothing read, nothing done
  const int n = min(kChunk, len - k0);
  const int tid = threadIdx.x;

  const size_t head0 = (size_t)b * hq + (size_t)h * group;  // first q head
  for (int i = tid; i < group * D; i += kThreads)
    qs[i / D][i % D] = to_float(q[head0 * D + i]);
  __syncthreads();

  // layer `layer` of a cache stacked over layers (0 for one layer's cache);
  // the grid's z extent is the batch
  const size_t row0 = (((size_t)layer * gridDim.z + b) * hkv + h) * s_max + k0;
  const __nv_bfloat16* kbase = kc + row0 * D;
  const __nv_bfloat16* vbase = vc + row0 * D;

  // 1. scores: 8 lanes share a key, each with kPerLane consecutive elements
  const int lane = tid % kLanesPerKey;
  for (int j0 = 0; j0 < n; j0 += kKeysPerPass) {
    const int j = j0 + tid / kLanesPerKey;
    float kr[kPerLane];
    if (j < n) {
      load_f32<__nv_bfloat16, kPerLane>(kbase + (size_t)j * D + lane * kPerLane, kr);
    } else {
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) kr[i] = 0.f;
    }
    for (int g = 0; g < group; ++g) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) dot += kr[i] * qs[g][lane * kPerLane + i];
#pragma unroll
      for (int off = kLanesPerKey / 2; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      if (j < n && lane == 0) ps[g][j] = dot * scale;
    }
  }
  __syncthreads();

  // 2. the chunk's softmax statistics, one warp per query head
  const int warp = tid / 32, wl = tid % 32;
  for (int g = warp; g < group; g += kThreads / 32) {
    float m = kNegInf;
    for (int j = wl; j < n; j += 32) m = fmaxf(m, ps[g][j]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float l = 0.f;
    for (int j = wl; j < n; j += 32) {
      const float p = expf(ps[g][j] - m);
      l += p;
      ps[g][j] = round_to<__nv_bfloat16>(p);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      l += __shfl_xor_sync(0xffffffffu, l, off);
    if (wl == 0) {
      float* ml = part_ml + ((head0 + g) * n_chunks + c) * 2;
      ml[0] = m;
      ml[1] = l;
    }
  }
  __syncthreads();

  // 3. unnormalised P @ V of the chunk, one thread per (query head, element)
  for (int o = tid; o < group * D; o += kThreads) {
    const int g = o / D, d = o % D;
    const float* p = ps[g];
    const __nv_bfloat16* vcol = vbase + d;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
    int j = 0;
    for (; j + 4 <= n; j += 4) {
      a0 += p[j] * to_float(vcol[(size_t)j * D]);
      a1 += p[j + 1] * to_float(vcol[(size_t)(j + 1) * D]);
      a2 += p[j + 2] * to_float(vcol[(size_t)(j + 2) * D]);
      a3 += p[j + 3] * to_float(vcol[(size_t)(j + 3) * D]);
    }
    for (; j < n; ++j) a0 += p[j] * to_float(vcol[(size_t)j * D]);
    part_acc[((head0 + g) * n_chunks + c) * D + d] = (a0 + a1) + (a2 + a3);
  }
}

// Merges the chunks of one (slot, query head): one thread per element.
template <typename TQ>
__global__ void decode_combine_kernel(const float* __restrict__ part_acc,
                                      const float* __restrict__ part_ml,
                                      const int* __restrict__ lengths,
                                      TQ* __restrict__ out, int hq, int s_max,
                                      int n_chunks, int head_dim) {
  const int b = blockIdx.y;
  const int e = threadIdx.x;
  const size_t head = (size_t)b * hq + blockIdx.x;
  const int len = min(lengths[b], s_max);
  const int live = len > 0 ? (len + kChunk - 1) / kChunk : 0;
  const float* ml = part_ml + head * n_chunks * 2;
  float mx = kNegInf;
  for (int c = 0; c < live; ++c) mx = fmaxf(mx, ml[2 * c]);
  float denom = 0.f, acc = 0.f;
  for (int c = 0; c < live; ++c) {
    const float w = expf(ml[2 * c] - mx);
    denom += ml[2 * c + 1] * w;
    acc += part_acc[(head * n_chunks + c) * head_dim + e] * w;
  }
  out[head * head_dim + e] = from_float<TQ>(acc / fmaxf(denom, 1e-30f));
}

template <typename TQ, int D>
int launch(const void* q, const void* k_cache, const void* v_cache,
           const void* lengths, void* out, void* part_acc, void* part_ml,
           int layer, int batch, int hq, int hkv, int s_max, float scale,
           cudaStream_t stream) {
  const int n_chunks = (s_max + kChunk - 1) / kChunk;
  const int* lens = static_cast<const int*>(lengths);
  decode_partial_kernel<TQ, D><<<dim3(n_chunks, hkv, batch), kThreads, 0, stream>>>(
      static_cast<const TQ*>(q), static_cast<const __nv_bfloat16*>(k_cache),
      static_cast<const __nv_bfloat16*>(v_cache), lens,
      static_cast<float*>(part_acc), static_cast<float*>(part_ml), layer, hq,
      hkv, s_max, n_chunks, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_combine_kernel<TQ><<<dim3(hq, batch), D, 0, stream>>>(
      static_cast<const float*>(part_acc), static_cast<const float*>(part_ml),
      lens, static_cast<TQ*>(out), hq, s_max, n_chunks, D);
  return (int)cudaGetLastError();
}

// Validates the shapes and dispatches on the query type and head size.
int dispatch(const void* q, const void* k_cache, const void* v_cache,
             const void* lengths, void* out, void* part_acc, void* part_ml,
             int n_layers, int layer, int batch, int hq, int hkv, int s_max,
             int head_dim, float scale, int q_dtype, void* stream) {
  if (batch <= 0 || hkv <= 0 || hq % hkv || hq / hkv > kMaxGroup ||
      hq / hkv < 1 || s_max <= 0 || layer < 0 || layer >= n_layers)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == kF32 && head_dim == 64)
    return launch<float, 64>(q, k_cache, v_cache, lengths, out, part_acc, part_ml, layer, batch, hq, hkv, s_max, scale, s);
  if (q_dtype == kF32 && head_dim == 128)
    return launch<float, 128>(q, k_cache, v_cache, lengths, out, part_acc, part_ml, layer, batch, hq, hkv, s_max, scale, s);
  if (q_dtype == kBF16 && head_dim == 64)
    return launch<__nv_bfloat16, 64>(q, k_cache, v_cache, lengths, out, part_acc, part_ml, layer, batch, hq, hkv, s_max, scale, s);
  if (q_dtype == kBF16 && head_dim == 128)
    return launch<__nv_bfloat16, 128>(q, k_cache, v_cache, lengths, out, part_acc, part_ml, layer, batch, hq, hkv, s_max, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace gvl

// Keys per block of the split: the scratch buffers hold ceil(S_max / this)
// chunks per (slot, query head).
extern "C" int gvl_decode_attention_chunk(void) { return gvl::kChunk; }

// q [B, Hq, D] (q_dtype: 0 f32, 1 bf16), k/v cache [B, Hkv, S_max, D] bf16,
// lengths [B] int32, out [B, Hq, D] of q's type, part_acc [B, Hq, C, D] and
// part_ml [B, Hq, C, 2] f32 scratch with C = ceil(S_max / chunk).  All
// contiguous.  Returns a cudaError_t.
extern "C" int gvl_decode_attention(const void* q, const void* k_cache,
                                    const void* v_cache, const void* lengths,
                                    void* out, void* part_acc, void* part_ml,
                                    int batch, int hq, int hkv, int s_max,
                                    int head_dim, float scale, int q_dtype,
                                    void* stream) {
  return gvl::dispatch(q, k_cache, v_cache, lengths, out, part_acc, part_ml,
                       1, 0, batch, hq, hkv, s_max, head_dim, scale, q_dtype,
                       stream);
}

// As gvl_decode_attention, reading layer `layer` (0 <= layer < n_layers) of
// k/v caches stacked over layers, [n_layers, B, Hkv, S_max, D] bf16.
extern "C" int gvl_decode_attention_stacked(
    const void* q, const void* k_all, const void* v_all, const void* lengths,
    void* out, void* part_acc, void* part_ml, int n_layers, int layer,
    int batch, int hq, int hkv, int s_max, int head_dim, float scale,
    int q_dtype, void* stream) {
  return gvl::dispatch(q, k_all, v_all, lengths, out, part_acc, part_ml,
                       n_layers, layer, batch, hq, hkv, s_max, head_dim, scale,
                       q_dtype, stream);
}
