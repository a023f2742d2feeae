// Encoder self-attention read straight out of a packed QKV projection, for
// Hopper (sm_90a): qkv [B * Sp, 3 * H * dh] (f32 or bf16; q, k, v of head h
// at columns h dh, (H + h) dh, (2H + h) dh), keys at or past kv_len masked,
// out [B * Sp, H * dh] in qkv's type or, with a fused static requantize,
// int8 (clip(round(o * out_inv), 127)).
//
// Replaces three TPU kernels of gvl_tpu/ops/quant_matmul.py, one body:
// - attention_fused_qkv_pallas (Pallas body _padded_attn_kernel): heads
//   padded to dh 128 with zeros, softmax in exp2 form (the scale carries
//   log2 e), optional requantize, optional int8_scores;
// - attention_packed_multihead_pallas (_packed_mh_attn_kernel): the same
//   math on unpadded heads (dh 72 in so400m);
// - attention_qkv_packed_pallas (_packed_attn_kernel): unpadded heads,
//   softmax with exp, output in qkv's type.
// With int8_scores (the padded kernel's option) q is quantized per q block
// of block_q rows, k and v over their whole [Sp, dh] slab (padded rows
// included), each by its own max |x| / 127 (gvl_encoder_slab_amax writes
// those maxima first); the score is the exact integer q8 . k8 times the
// scales, and p is quantized as round(p * 127) against the exact row
// maximum, so that P V is an exact integer sum as in the TPU kernel.
//
// Design.  The TPU kernel holds all Sp keys of an (image, head) in one VMEM
// block; at Sp 736 a K plus a V slab of 736 x 128 bf16 is 377 KB, over the
// 227 KB of shared memory a Hopper block may use.  So the keys are tiled:
// one block per (32-row tile, head, image), a query row on 8 neighbouring
// threads of a warp (16 of the 128 compute columns each, dh zero-padded to
// 128 in registers and shared memory), 32-key K/V tiles staged in shared
// memory as f32 with 16-byte loads from their column offsets in the packed
// buffer (no transpose or pad is materialised), scores reduced with warp
// shuffles.  Two passes over the keys: the first finds each row's maximum,
// the second forms p = exp2(s - max) (or exp), rounds it to v's type (or
// to int8) exactly as the TPU kernel does against its full-row maximum, and
// accumulates P V and the denominator.  An online softmax would round p
// against running maxima, and the int8 requantize would then flip about
// one output in twenty by one step; the second pass costs a QK^T product.
//
// Bound.  At the so400m layer of a batch of 8 frames (B 8, H 16, Sp 736,
// kv_len 729) the work is 4 D flops per live (query, key) pair, 35 GFLOP
// at D 128 (19.8 at dh 72), on CUDA cores in f32: operation-bound.  The
// bound in PERF.md is taken at the bf16 tensor-core peak, which this
// CUDA-core kernel does not use.
#include "common.cuh"

namespace gvl {
namespace {

constexpr int D = 128;        // compute width: heads are zero-padded to it
constexpr int kThreads = 256;
constexpr int kTpr = D / 16;  // threads per query row (8)
constexpr int kRows = kThreads / kTpr;  // query rows per block (32)
constexpr int kChunks = D / 4 / kTpr;   // float4 chunks per thread (4)
constexpr int kBlockK = 32;   // keys per shared-memory tile

__device__ __forceinline__ float quant_int8f(float x, float inv) {
  const int q = __float2int_rn(__fmul_rn(x, inv));
  return (float)max(-127, min(127, q));
}

// keys k0 .. k0 + 31 of one head's slab (column col0 of the packed rows,
// dh wide) into dst [kBlockK][D] as f32, zero past kend and past dh;
// quantized to int8 values by inv when kQuant
template <typename T, bool kQuant>
__device__ __forceinline__ void load_tile(float* __restrict__ dst,
                                          const T* __restrict__ base, int width,
                                          int col0, int k0, int kend, int dh,
                                          float inv) {
  for (int i = threadIdx.x; i < kBlockK * (D / 8); i += kThreads) {
    const int j = i / (D / 8), col = (i % (D / 8)) * 8;
    float x[8];
    if (k0 + j < kend && col < dh) {
      load_f32<T, 8>(base + (size_t)(k0 + j) * width + col0 + col, x);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) dst[j * D + col + e] = kQuant ? quant_int8f(x[e], inv) : x[e];
  }
}

__device__ __forceinline__ float row_dot(const float4 (&qr)[kChunks],
                                         const float4 (*ks)[D / 4], int j, int part) {
  float dot = 0.f;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const float4 kk = ks[j][c * kTpr + part];
    dot += qr[c].x * kk.x + qr[c].y * kk.y + qr[c].z * kk.z + qr[c].w * kk.w;
  }
#pragma unroll
  for (int off = kTpr / 2; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
  return dot;
}

template <typename T, bool kQuantOut, bool kInt8>
__global__ void __launch_bounds__(kThreads)
encoder_attention_kernel(const T* __restrict__ qkv, void* __restrict__ out,
                         const float* __restrict__ amax, int heads, int seq_pad,
                         int kv_len, int dh, float scale, int use_exp2,
                         float out_inv, int block_q, int n_qblocks) {
  __shared__ float4 ks[kBlockK][D / 4];
  __shared__ float4 vs[kBlockK][D / 4];
  float* ks_flat = reinterpret_cast<float*>(&ks[0][0]);
  float* vs_flat = reinterpret_cast<float*>(&vs[0][0]);

  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, part = tid % kTpr;
  const int s = blockIdx.x * kRows + tid / kTpr;
  const bool row_ok = s < seq_pad;
  const int srow = row_ok ? s : 0;
  const int width = 3 * heads * dh;
  const T* base = qkv + (size_t)b * seq_pad * width;
  const int qcol = h * dh, kcol = (heads + h) * dh, vcol = (2 * heads + h) * dh;

  float inv_k = 0.f, inv_v = 0.f, s_scale = scale, v_scale = 1.f, inv_q = 0.f;
  if (kInt8) {
    const float* am = amax + ((size_t)b * heads + h) * (n_qblocks + 2);
    const float aq = am[srow / block_q], ak = am[n_qblocks], av = am[n_qblocks + 1];
    inv_q = __fdiv_rn(127.f, aq);
    inv_k = __fdiv_rn(127.f, ak);
    inv_v = __fdiv_rn(127.f, av);
    s_scale = __fmul_rn(__fmul_rn(__fdiv_rn(aq, 127.f), __fdiv_rn(ak, 127.f)), scale);
    v_scale = __fdiv_rn(__fdiv_rn(av, 127.f), 127.f);
  }

  float4 qr[kChunks], acc[kChunks];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int col = (c * kTpr + part) * 4;
    float e4[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float v = col + e < dh ? to_float(base[(size_t)srow * width + qcol + col + e]) : 0.f;
      e4[e] = kInt8 ? quant_int8f(v, inv_q) : v;
    }
    qr[c] = make_float4(e4[0], e4[1], e4[2], e4[3]);
    acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  // pass 1: each row's maximum score over the live keys
  float m = kNegInf;
  for (int k0 = 0; k0 < kv_len; k0 += kBlockK) {
    __syncthreads();
    load_tile<T, kInt8>(ks_flat, base, width, kcol, k0, kv_len, dh, inv_k);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kBlockK; ++j) {
      const float sc = __fmul_rn(row_dot(qr, ks, j, part), s_scale);
      if (k0 + j < kv_len) m = fmaxf(m, sc);
    }
  }

  // pass 2: p against the row maximum, P V and the denominator
  float l = 0.f;
  for (int k0 = 0; k0 < kv_len; k0 += kBlockK) {
    __syncthreads();
    load_tile<T, kInt8>(ks_flat, base, width, kcol, k0, kv_len, dh, inv_k);
    load_tile<T, kInt8>(vs_flat, base, width, vcol, k0, kv_len, dh, inv_v);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kBlockK; ++j) {
      const float sc = __fmul_rn(row_dot(qr, ks, j, part), s_scale);
      if (k0 + j >= kv_len) continue;
      const float arg = __fsub_rn(sc, m);
      const float p = use_exp2 ? exp2f(arg) : expf(arg);
      l = __fadd_rn(l, p);
      const float pv = kInt8 ? rintf(__fmul_rn(p, 127.f)) : round_to<T>(p);
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const float4 vv = vs[j][c * kTpr + part];
        acc[c].x += pv * vv.x;
        acc[c].y += pv * vv.y;
        acc[c].z += pv * vv.z;
        acc[c].w += pv * vv.w;
      }
    }
  }

  if (!row_ok) return;
  const float denom = fmaxf(l, 1e-30f);
  const size_t orow = ((size_t)b * seq_pad + s) * heads * dh + (size_t)h * dh;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int col = (c * kTpr + part) * 4;
    const float a4[4] = {acc[c].x, acc[c].y, acc[c].z, acc[c].w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (col + e >= dh) continue;
      float o = kInt8 ? __fmul_rn(a4[e], v_scale) : a4[e];
      o = __fdiv_rn(o, denom);
      if (kQuantOut) {
        static_cast<signed char*>(out)[orow + col + e] =
            static_cast<signed char>(quant_int8f(o, out_inv));
      } else {
        static_cast<T*>(out)[orow + col + e] = from_float<T>(o);
      }
    }
  }
}

// max |x| of each q block and of the whole K and V slab of every
// (image, head), at least 1e-8: amax [B, H, n_qblocks + 2]
template <typename T>
__global__ void slab_amax_kernel(const T* __restrict__ qkv, float* __restrict__ amax,
                                 int heads, int seq_pad, int dh, int block_q,
                                 int n_qblocks) {
  __shared__ float warp_max[32];
  const int slot = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int width = 3 * heads * dh;
  int row0 = 0, rows = seq_pad, col0;
  if (slot < n_qblocks) {
    row0 = slot * block_q;
    rows = block_q;
    col0 = h * dh;
  } else {
    col0 = (slot == n_qblocks ? heads + h : 2 * heads + h) * dh;
  }
  const T* base = qkv + ((size_t)b * seq_pad + row0) * width + col0;
  float mx = 0.f;
  for (int i = threadIdx.x; i < rows * dh; i += blockDim.x)
    mx = fmaxf(mx, fabsf(to_float(base[(size_t)(i / dh) * width + i % dh])));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = mx;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < blockDim.x / 32; ++w) mx = fmaxf(mx, warp_max[w]);
    amax[((size_t)b * heads + h) * (n_qblocks + 2) + slot] = fmaxf(mx, 1e-8f);
  }
}

template <typename T, bool kQuantOut, bool kInt8>
int launch(const void* qkv, void* out, const void* amax, int batch, int heads,
           int seq_pad, int kv_len, int dh, float scale, int use_exp2,
           float out_inv, int block_q, cudaStream_t stream) {
  const int n_qblocks = seq_pad / block_q;
  if (kInt8) {
    slab_amax_kernel<T><<<dim3(n_qblocks + 2, heads, batch), 256, 0, stream>>>(
        static_cast<const T*>(qkv), static_cast<float*>(const_cast<void*>(amax)),
        heads, seq_pad, dh, block_q, n_qblocks);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((seq_pad + kRows - 1) / kRows, heads, batch);
  encoder_attention_kernel<T, kQuantOut, kInt8><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(qkv), out, static_cast<const float*>(amax), heads,
      seq_pad, kv_len, dh, scale, use_exp2, out_inv, block_q, n_qblocks);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int quant_out, int int8_scores, const void* qkv, void* out,
             const void* amax, int batch, int heads, int seq_pad, int kv_len,
             int dh, float scale, int use_exp2, float out_inv, int block_q,
             cudaStream_t s) {
  if (quant_out && int8_scores)
    return launch<T, true, true>(qkv, out, amax, batch, heads, seq_pad, kv_len, dh, scale, use_exp2, out_inv, block_q, s);
  if (quant_out)
    return launch<T, true, false>(qkv, out, amax, batch, heads, seq_pad, kv_len, dh, scale, use_exp2, out_inv, block_q, s);
  if (int8_scores)
    return launch<T, false, true>(qkv, out, amax, batch, heads, seq_pad, kv_len, dh, scale, use_exp2, out_inv, block_q, s);
  return launch<T, false, false>(qkv, out, amax, batch, heads, seq_pad, kv_len, dh, scale, use_exp2, out_inv, block_q, s);
}

}  // namespace
}  // namespace gvl

// qkv [B * Sp, 3 * H * dh] (in_dtype: 0 f32, 1 bf16), out [B * Sp, H * dh]
// int8 when quant_out else qkv's type; amax [B, H, Sp / block_q + 2] f32
// scratch, used when int8_scores (block_q divides Sp).  dh <= 128 and a
// multiple of 8; 1 <= kv_len <= Sp.  scale multiplies q . k (it carries
// log2 e when use_exp2).  Returns a cudaError_t.
extern "C" int gvl_encoder_attention(const void* qkv, void* out, void* amax,
                                     int batch, int heads, int seq_pad,
                                     int kv_len, int dh, float scale,
                                     int use_exp2, int quant_out, float out_inv,
                                     int int8_scores, int block_q, int in_dtype,
                                     void* stream) {
  using namespace gvl;
  if (batch <= 0 || heads <= 0 || seq_pad <= 0 || kv_len <= 0 || kv_len > seq_pad ||
      dh <= 0 || dh > D || dh % 8 || (int8_scores && (block_q <= 0 || seq_pad % block_q)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == kF32)
    return dispatch<float>(quant_out, int8_scores, qkv, out, amax, batch, heads, seq_pad, kv_len, dh, scale, use_exp2, out_inv, block_q, s);
  if (in_dtype == kBF16)
    return dispatch<__nv_bfloat16>(quant_out, int8_scores, qkv, out, amax, batch, heads, seq_pad, kv_len, dh, scale, use_exp2, out_inv, block_q, s);
  return (int)cudaErrorInvalidValue;
}
