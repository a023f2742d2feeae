// Shared helpers for the hand-written Hopper kernels of gvl_tpu_torch.
//
// Every kernel file exports a plain `extern "C"` entry point that takes raw
// pointers, ints and a cudaStream_t (passed from Python with ctypes) and
// returns cudaGetLastError() as an int.  No PyTorch header is included, so
// one nvcc command builds all of csrc/*.cu in seconds.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gvl {

// Masked scores take this value, as in the TPU kernels: exp() of it minus a
// real maximum is exactly 0 in f32, and it never makes a NaN.
constexpr float kNegInf = -1e30f;

// Element types, as the Python wrappers number them.
enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to T's precision and widened again: the `p.astype(v.dtype)` that
// the TPU kernels apply to the softmax weights before the P @ V product.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// 16 bytes of a row, read as f32 or as bf16 bit patterns.
union Vec16 {
  uint4 raw;
  float f[4];
  unsigned short h[8];
};

template <typename T>
__device__ __forceinline__ float vec_elem(const Vec16& v, int i);
template <>
__device__ __forceinline__ float vec_elem<float>(const Vec16& v, int i) { return v.f[i]; }
template <>
__device__ __forceinline__ float vec_elem<__nv_bfloat16>(const Vec16& v, int i) {
  return __uint_as_float(static_cast<unsigned>(v.h[i]) << 16);  // exact
}

// N consecutive elements of T at p (16-byte aligned, N * sizeof(T) a multiple
// of 16), widened to f32 with 16-byte loads.
template <typename T, int N>
__device__ __forceinline__ void load_f32(const T* __restrict__ p, float (&out)[N]) {
  constexpr int kVec = 16 / sizeof(T);
  static_assert(N % kVec == 0, "row slice must be a whole number of 16-byte loads");
#pragma unroll
  for (int c = 0; c < N / kVec; ++c) {
    Vec16 v;
    v.raw = *reinterpret_cast<const uint4*>(p + c * kVec);
#pragma unroll
    for (int i = 0; i < kVec; ++i) out[c * kVec + i] = vec_elem<T>(v, i);
  }
}

}  // namespace gvl
