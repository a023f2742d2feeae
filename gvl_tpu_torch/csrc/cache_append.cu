// In-place KV-cache append for Hopper (sm_90a): writes one row per
// (slot, KV head) at positions[slot] of a [B, Hkv, S_max, D] cache.
//
// Replaces the TPU kernel gvl_tpu/ops/cache_update.py:cache_append (Pallas
// body _append_kernel), whose output aliases its cache input.  Here the cache
// is simply written where it lies: the Python wrapper hands back the same
// tensor.  Rows other than positions[slot] are neither read nor written, and a
// position outside [0, S_max) writes nothing.
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
                                    const int* __restrict__ positions, int hkv,
                                    int s_max, int row_vecs) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int pos = positions[b];
  if (pos < 0 || pos >= s_max) return;
  uint4* dst = cache + (((size_t)b * hkv + h) * s_max + pos) * row_vecs;
  const uint4* src = rows + ((size_t)b * hkv + h) * row_vecs;
  for (int i = threadIdx.x; i < row_vecs; i += kThreads) dst[i] = src[i];
}

}  // namespace
}  // namespace gvl

// cache [B, Hkv, S_max, row_bytes / itemsize] and rows [B, Hkv, same], of one
// type and contiguous, positions [B] int32; row_bytes a multiple of 16.
// Returns a cudaError_t.
extern "C" int gvl_cache_append(void* cache, const void* rows,
                                const void* positions, int batch, int hkv,
                                int s_max, int row_bytes, void* stream) {
  using namespace gvl;
  if (batch <= 0 || hkv <= 0 || s_max <= 0 || row_bytes <= 0 || row_bytes % 16)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cache_append_kernel<<<dim3(hkv, batch), kThreads, 0, s>>>(
      static_cast<uint4*>(cache), static_cast<const uint4*>(rows),
      static_cast<const int*>(positions), hkv, s_max, row_bytes / 16);
  return (int)cudaGetLastError();
}
