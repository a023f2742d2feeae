// LayerNorm fused with a static int8 quantize, and the quantize alone, for
// Hopper (sm_90a).
//
// gvl_ln_quant replaces the TPU kernel
// gvl_tpu/ops/quant_matmul.py:ln_quant_pallas (Pallas body _ln_quant_kernel):
// per row of x [M, D] (f32 or bf16), in f32, mu = mean(x), xc = x - mu,
// var = mean(xc * xc), y = xc * rsqrt(var + eps) * gamma + beta, then
// clip(round(y * inv), 127) -> int8.
// gvl_quant_static replaces quant_static_pallas (Pallas body _quant_kernel):
// clip(round(x * inv), 127) -> int8, elementwise.
//
// Design.  ln_quant: one warp per row; the row is read once with 16-byte
// loads into shared memory as f32 (D floats per warp), then the mean, the
// centred variance and the output are three warp passes over it with
// shuffle reductions.  The products and sums use round-to-nearest
// intrinsics (no fused multiply-add), so each step rounds as the JAX body's
// does; rounding is __float2int_rn (half to even, as jnp.round).
// quant_static: each thread converts 8 elements (16- or 32-byte loads, one
// 8-byte store).  D (and the element count) must be multiples of 8.
//
// Bound.  Both move bytes only: at the so400m layer of a batch of 8 frames
// (bf16 [5888, 1152] in, int8 out) 20 MB, 6.1 us at 3.35 TB/s.
#include "common.cuh"

namespace gvl {
namespace {

constexpr int kWarps = 4;  // rows per ln_quant block

__device__ __forceinline__ signed char quant_int8(float x, float inv) {
  const int q = __float2int_rn(__fmul_rn(x, inv));
  return static_cast<signed char>(max(-127, min(127, q)));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ void store8(signed char* dst, const signed char (&q)[8]) {
  uint2 packed;
  unsigned char* b = reinterpret_cast<unsigned char*>(&packed);
#pragma unroll
  for (int e = 0; e < 8; ++e) b[e] = static_cast<unsigned char>(q[e]);
  *reinterpret_cast<uint2*>(dst) = packed;
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
ln_quant_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                const float* __restrict__ beta, signed char* __restrict__ out,
                int rows, int d, float eps, float inv) {
  extern __shared__ float srow[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= rows) return;
  float* r = srow + (size_t)warp * d;
  const T* xr = x + (size_t)row * d;

  float sum = 0.f;
  for (int c = lane * 8; c < d; c += 32 * 8) {
    float v[8];
    load_f32<T, 8>(xr + c, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      r[c + e] = v[e];
      sum = __fadd_rn(sum, v[e]);
    }
  }
  const float mu = __fdiv_rn(warp_sum(sum), (float)d);
  __syncwarp();
  float sq = 0.f;
  for (int c = lane; c < d; c += 32) {
    const float xc = __fsub_rn(r[c], mu);
    sq = __fadd_rn(sq, __fmul_rn(xc, xc));
  }
  const float var = __fdiv_rn(warp_sum(sq), (float)d);
  const float rstd = rsqrtf(__fadd_rn(var, eps));
  signed char* orow = out + (size_t)row * d;
  for (int c = lane * 8; c < d; c += 32 * 8) {
    signed char q[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float xc = __fsub_rn(r[c + e], mu);
      const float y = __fadd_rn(__fmul_rn(__fmul_rn(xc, rstd), gamma[c + e]), beta[c + e]);
      q[e] = quant_int8(y, inv);
    }
    store8(orow + c, q);
  }
}

template <typename T>
__global__ void quant_static_kernel(const T* __restrict__ x,
                                    signed char* __restrict__ out, long n8,
                                    float inv) {
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < n8;
       i += (long)gridDim.x * blockDim.x) {
    float v[8];
    load_f32<T, 8>(x + i * 8, v);
    signed char q[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) q[e] = quant_int8(v[e], inv);
    store8(out + i * 8, q);
  }
}

template <typename T>
int launch_ln(const void* x, const void* gamma, const void* beta, void* out,
              int rows, int d, float eps, float inv, cudaStream_t stream) {
  const size_t smem = (size_t)kWarps * d * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ln_quant_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (rows + kWarps - 1) / kWarps;
  ln_quant_kernel<T><<<blocks, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<signed char*>(out), rows, d,
      eps, inv);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_quant(const void* x, void* out, long n, float inv, cudaStream_t stream) {
  const long n8 = n / 8;
  const int threads = 256;
  const long want = (n8 + threads - 1) / threads;
  const long blocks = want < 132L * 16 ? want : 132L * 16;
  quant_static_kernel<T><<<(int)blocks, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<signed char*>(out), n8, inv);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace gvl

// x [M, D] (x_dtype: 0 f32, 1 bf16), gamma/beta [D] f32, out [M, D] int8.
// All contiguous, D a multiple of 8.  Returns a cudaError_t.
extern "C" int gvl_ln_quant(const void* x, const void* gamma, const void* beta,
                            void* out, int rows, int d, float eps, float inv,
                            int x_dtype, void* stream) {
  using namespace gvl;
  if (rows <= 0 || d <= 0 || d % 8) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == kF32) return launch_ln<float>(x, gamma, beta, out, rows, d, eps, inv, s);
  if (x_dtype == kBF16) return launch_ln<__nv_bfloat16>(x, gamma, beta, out, rows, d, eps, inv, s);
  return (int)cudaErrorInvalidValue;
}

// x of n elements (x_dtype: 0 f32, 1 bf16), out n int8; n a multiple of 8.
extern "C" int gvl_quant_static(const void* x, void* out, long n, float inv,
                                int x_dtype, void* stream) {
  using namespace gvl;
  if (n <= 0 || n % 8) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == kF32) return launch_quant<float>(x, out, n, inv, s);
  if (x_dtype == kBF16) return launch_quant<__nv_bfloat16>(x, out, n, inv, s);
  return (int)cudaErrorInvalidValue;
}
