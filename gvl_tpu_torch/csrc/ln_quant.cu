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
// Bound.  Both move bytes only: at the so400m layer of a batch of 8 frames
// (bf16 [5888, 1152] in, int8 out) 20 MB, 6.1 us at 3.35 TB/s.  So the
// design keeps device memory streaming.
//
// Design.  ln_quant: a grid sized to what the SMs hold at once; each warp
// walks rows (row += all warps of the grid) and owns two row buffers in
// shared memory.  Before it reduces a row it has issued every 16-byte
// cp.async of the next row into the other buffer, so each warp keeps a
// whole row (2.3 KB at D 1152 bf16) in flight while it computes, some
// 70 KB per SM.  gamma and beta are copied into shared memory once per
// block.  The mean, the centred variance and the output are three warp
// passes over the buffered row, 8 elements a lane a step, with shuffle
// reductions; each step stores 8 int8 in one 8-byte store.  The products
// and sums use round-to-nearest intrinsics (no fused multiply-add), so each
// step rounds as the JAX body's does; rounding is __float2int_rn (half to
// even, as jnp.round).  Any D that is a multiple of 8 runs this one path:
// a block holds fewer warps where two rows a warp and gamma, beta would not
// fit its shared memory.
// quant_static: each thread converts 8 elements (16- or 32-byte loads, one
// 8-byte store).  D (and the element count) must be multiples of 8.
#include "mma.cuh"

namespace gvl {
namespace {

constexpr int kMaxWarps = 8;                  // rows in flight per block
constexpr int kSmemLimit = 227 * 1024;        // a block's shared memory on sm_90

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ void store8(signed char* dst, const signed char (&q)[8]) {
  *reinterpret_cast<uint2*>(dst) =
      make_uint2(pack_s8x4(q[0], q[1], q[2], q[3]), pack_s8x4(q[4], q[5], q[6], q[7]));
}

// every 16-byte chunk of one row into a warp's buffer (cp.async, no wait)
template <typename T>
__device__ __forceinline__ void load_row(T* dst, const T* __restrict__ src, int d, int lane) {
  const int chunks = d * (int)sizeof(T) / 16;
  for (int c = lane; c < chunks; c += 32)
    cp_async16(reinterpret_cast<char*>(dst) + c * 16,
               reinterpret_cast<const char*>(src) + c * 16, true);
}

template <typename T>
__global__ void __launch_bounds__(kMaxWarps * 32)
ln_quant_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                const float* __restrict__ beta, signed char* __restrict__ out,
                int rows, int d, float eps, float inv) {
  extern __shared__ __align__(16) float smem[];
  float* sg = smem;
  float* sb = smem + d;
  const int warps = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  T* buf = reinterpret_cast<T*>(smem + 2 * d) + (size_t)2 * warp * d;

  const int stride = gridDim.x * warps;
  int row = blockIdx.x * warps + warp;
  if (row < rows) load_row(buf, x + (size_t)row * d, d, lane);
  cp_async_commit();
  for (int c = threadIdx.x * 4; c < d; c += blockDim.x * 4) {
    *reinterpret_cast<float4*>(sg + c) = *reinterpret_cast<const float4*>(gamma + c);
    *reinterpret_cast<float4*>(sb + c) = *reinterpret_cast<const float4*>(beta + c);
  }
  __syncthreads();

  for (int i = 0; row < rows; row += stride, ++i) {
    const T* r = buf + (size_t)(i & 1) * d;
    const int next = row + stride;
    if (next < rows) load_row(buf + (size_t)((i + 1) & 1) * d, x + (size_t)next * d, d, lane);
    cp_async_commit();
    cp_async_wait<1>();   // this row's copies are done (the next row's may not be)
    __syncwarp();

    float sum = 0.f;
    for (int c = lane * 8; c < d; c += 32 * 8) {
      float v[8];
      load_f32<T, 8>(r + c, v);
#pragma unroll
      for (int e = 0; e < 8; ++e) sum = __fadd_rn(sum, v[e]);
    }
    const float mu = __fdiv_rn(warp_sum(sum), (float)d);
    float sq = 0.f;
    for (int c = lane * 8; c < d; c += 32 * 8) {
      float v[8];
      load_f32<T, 8>(r + c, v);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float xc = __fsub_rn(v[e], mu);
        sq = __fadd_rn(sq, __fmul_rn(xc, xc));
      }
    }
    const float var = __fdiv_rn(warp_sum(sq), (float)d);
    const float rstd = rsqrtf(__fadd_rn(var, eps));
    signed char* orow = out + (size_t)row * d;
    for (int c = lane * 8; c < d; c += 32 * 8) {
      float v[8];
      load_f32<T, 8>(r + c, v);
      float gb[2][8];   // gamma, beta: 16-byte loads (scalar ones conflict on banks)
      load_f32<float, 8>(sg + c, gb[0]);
      load_f32<float, 8>(sb + c, gb[1]);
      signed char q[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float xc = __fsub_rn(v[e], mu);
        const float y = __fadd_rn(__fmul_rn(__fmul_rn(xc, rstd), gb[0][e]), gb[1][e]);
        q[e] = quant_int8(y, inv);
      }
      store8(orow + c, q);
    }
    __syncwarp();   // every lane has read this buffer before it is refilled
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
  // gamma and beta, then two rows a warp
  const size_t fixed = (size_t)2 * d * sizeof(float), per_warp = (size_t)2 * d * sizeof(T);
  int warps = kMaxWarps;
  while (warps > 1 && fixed + warps * per_warp > kSmemLimit) --warps;
  const size_t smem = fixed + warps * per_warp;
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  auto kernel = ln_quant_kernel<T>;
  // the grid: as many blocks as the SMs hold at once (cached for the last shape)
  static int last_d = -1, last_blocks = 0;
  if (d != last_d) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, warps * 32, smem);
    if (err != cudaSuccess) return (int)err;
    last_d = d;
    last_blocks = sms * per_sm;
  }
  const int want = (rows + warps - 1) / warps;
  const int blocks = want < last_blocks ? want : last_blocks;
  kernel<<<blocks, warps * 32, smem, stream>>>(
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
// All contiguous and 16-byte aligned, D a multiple of 8.  Returns a
// cudaError_t.
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
