// In-place KV-cache append for Hopper (sm_90a): writes one row per
// (slot, KV head) at positions[slot] of a [B, Hkv, S_max, D] cache, or of
// layer `layer` of a cache stacked over layers, [L, B, Hkv, S_max, D].
//
// Replaces the TPU kernels gvl_tpu/ops/cache_update.py:cache_append (Pallas
// body _append_kernel) and :cache_append_stacked (body _append_kernel_stacked),
// whose outputs alias their cache inputs.  Here the cache is simply written
// where it lies: the Python wrappers hand back the same tensor.  Rows other
// than positions[slot] are neither read nor written, and a position outside
// [0, S_max) writes nothing.  The stacked form adds the layer's offset inside
// the kernel, so no layer is sliced out or copied.
//
// Design and bound.  One block per (KV head, slot) copies the row in 16-byte
// words: B * Hkv * D elements in and out, a few hundred bytes to a few
// kilobytes per decode step, so the launch itself is the cost.
#include "common.cuh"

namespace gvl {
namespace {

constexpr int kThreads = 32;

__global__ void cache_append_kernel(uint4* __restrict__ cache,
                                    const uint4* __restrict__ rows,
                                    const int* __restrict__ positions,
                                    int layer, int hkv, int s_max,
                                    int row_vecs) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int pos = positions[b];
  if (pos < 0 || pos >= s_max) return;
  // layer `layer` of a stacked cache (0 for one layer's cache); the grid's
  // y extent is the batch
  const size_t row = (((size_t)layer * gridDim.y + b) * hkv + h) * s_max + pos;
  uint4* dst = cache + row * row_vecs;
  const uint4* src = rows + ((size_t)b * hkv + h) * row_vecs;
  for (int i = threadIdx.x; i < row_vecs; i += kThreads) dst[i] = src[i];
}

int launch(void* cache, const void* rows, const void* positions, int n_layers,
           int layer, int batch, int hkv, int s_max, int row_bytes,
           void* stream) {
  if (batch <= 0 || hkv <= 0 || s_max <= 0 || row_bytes <= 0 ||
      row_bytes % 16 || layer < 0 || layer >= n_layers)
    return (int)cudaErrorInvalidValue;
  cache_append_kernel<<<dim3(hkv, batch), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint4*>(cache), static_cast<const uint4*>(rows),
      static_cast<const int*>(positions), layer, hkv, s_max, row_bytes / 16);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace gvl

// cache [B, Hkv, S_max, row_bytes / itemsize] and rows [B, Hkv, same], of one
// type and contiguous, positions [B] int32; row_bytes a multiple of 16.
// Returns a cudaError_t.
extern "C" int gvl_cache_append(void* cache, const void* rows,
                                const void* positions, int batch, int hkv,
                                int s_max, int row_bytes, void* stream) {
  return gvl::launch(cache, rows, positions, 1, 0, batch, hkv, s_max,
                     row_bytes, stream);
}

// As gvl_cache_append, into layer `layer` (0 <= layer < n_layers) of a cache
// stacked over layers, [n_layers, B, Hkv, S_max, row_bytes / itemsize].
extern "C" int gvl_cache_append_stacked(void* cache, const void* rows,
                                        const void* positions, int n_layers,
                                        int layer, int batch, int hkv,
                                        int s_max, int row_bytes,
                                        void* stream) {
  return gvl::launch(cache, rows, positions, n_layers, layer, batch, hkv,
                     s_max, row_bytes, stream);
}
