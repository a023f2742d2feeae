// In-place KV-cache append for Hopper (sm_90a): writes one row per
// (slot, KV head) at positions[slot] of a [B, Hkv, S_max, D] cache, or of
// layer `layer` of a cache stacked over layers, [L, B, Hkv, S_max, D]; one
// launch writes one cache or a (K, V) pair of caches.
//
// Replaces the TPU kernels gvl_tpu/ops/cache_update.py:cache_append (Pallas
// body _append_kernel) and :cache_append_stacked (body _append_kernel_stacked),
// whose outputs alias their cache inputs.  Here the cache is simply written
// where it lies: the Python wrappers hand back the same tensor.  Rows other
// than positions[slot] are neither read nor written, and a position outside
// [0, S_max) writes nothing.  The stacked form adds the layer's offset inside
// the kernel, so no layer is sliced out or copied.
//
// Design and bound.  A decode step writes B * Hkv * D elements per cache, a
// few hundred bytes to a few kilobytes, so the launch itself is the cost:
// one launch writes both caches (grid z picks K or V), and f32 rows go into
// a bf16 cache converted in the kernel, so the model launches no cast.  One
// block per (KV head, slot, cache) copies the row in 16-byte words; a cast
// reads 32 bytes of f32 for each 16-byte word of bf16 it stores.
#include "common.cuh"

namespace gvl {
namespace {

constexpr int kThreads = 32;

// 8 f32 -> 8 bf16 in one 16-byte word.  __float2bfloat16_rn rounds to
// nearest even and keeps NaN a NaN: the conversion PyTorch's own f32 -> bf16
// copy makes on this card, so the plain version's new.to(cache.dtype) gives
// the same bits.
__device__ __forceinline__ uint4 to_bf16x8(float4 lo, float4 hi) {
  Vec16 out;
  const float f[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
  for (int i = 0; i < 8; ++i)
    out.h[i] = __bfloat16_as_ushort(__float2bfloat16_rn(f[i]));
  return out.raw;
}

// kCast: f32 rows into a bf16 cache; else rows of the cache's own type.
// row_vecs: 16-byte words per cache row.
template <bool kCast>
__global__ void cache_append_kernel(uint4* __restrict__ k_cache,
                                    uint4* __restrict__ v_cache,
                                    const uint4* __restrict__ k_rows,
                                    const uint4* __restrict__ v_rows,
                                    const int* __restrict__ positions,
                                    int layer, int hkv, int s_max,
                                    int row_vecs) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int pos = positions[b];
  if (pos < 0 || pos >= s_max) return;
  uint4* cache = blockIdx.z ? v_cache : k_cache;
  const uint4* rows = blockIdx.z ? v_rows : k_rows;
  // layer `layer` of a stacked cache (0 for one layer's cache); the grid's
  // y extent is the batch
  const size_t row = (((size_t)layer * gridDim.y + b) * hkv + h) * s_max + pos;
  uint4* dst = cache + row * row_vecs;
  const size_t src_row = (size_t)b * hkv + h;
  if (kCast) {
    const float4* src = reinterpret_cast<const float4*>(rows) + src_row * row_vecs * 2;
    for (int i = threadIdx.x; i < row_vecs; i += kThreads)
      dst[i] = to_bf16x8(src[2 * i], src[2 * i + 1]);
  } else {
    const uint4* src = rows + src_row * row_vecs;
    for (int i = threadIdx.x; i < row_vecs; i += kThreads) dst[i] = src[i];
  }
}

int launch(void* k_cache, void* v_cache, const void* k_rows,
           const void* v_rows, const void* positions, int n_layers, int layer,
           int batch, int hkv, int s_max, int row_bytes, int cast,
           void* stream) {
  if (batch <= 0 || hkv <= 0 || s_max <= 0 || row_bytes <= 0 ||
      row_bytes % 16 || layer < 0 || layer >= n_layers)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(hkv, batch, v_cache ? 2 : 1);
  const auto kernel = cast ? cache_append_kernel<true> : cache_append_kernel<false>;
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint4*>(k_cache), static_cast<uint4*>(v_cache),
      static_cast<const uint4*>(k_rows), static_cast<const uint4*>(v_rows),
      static_cast<const int*>(positions), layer, hkv, s_max, row_bytes / 16);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace gvl

// k_cache [B, Hkv, S_max, row_bytes / itemsize] and k_rows [B, Hkv, same],
// contiguous and 16-byte aligned, positions [B] int32; row_bytes (the
// cache's) a multiple of 16.  v_cache and v_rows likewise, or both null for
// one cache.  cast 0: rows of the cache's type; 1: f32 rows into a bf16
// cache.  Returns a cudaError_t.
extern "C" int gvl_cache_append(void* k_cache, void* v_cache,
                                const void* k_rows, const void* v_rows,
                                const void* positions, int batch, int hkv,
                                int s_max, int row_bytes, int cast,
                                void* stream) {
  return gvl::launch(k_cache, v_cache, k_rows, v_rows, positions, 1, 0, batch,
                     hkv, s_max, row_bytes, cast, stream);
}

// As gvl_cache_append, into layer `layer` (0 <= layer < n_layers) of caches
// stacked over layers, [n_layers, B, Hkv, S_max, row_bytes / itemsize].
extern "C" int gvl_cache_append_stacked(void* k_cache, void* v_cache,
                                        const void* k_rows, const void* v_rows,
                                        const void* positions, int n_layers,
                                        int layer, int batch, int hkv,
                                        int s_max, int row_bytes, int cast,
                                        void* stream) {
  return gvl::launch(k_cache, v_cache, k_rows, v_rows, positions, n_layers,
                     layer, batch, hkv, s_max, row_bytes, cast, stream);
}
