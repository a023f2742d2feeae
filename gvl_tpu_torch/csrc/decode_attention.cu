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
// layer index in its block index map).  f32 scores; the softmax weights are
// rounded to the cache type before P V, the denominator sums them unrounded;
// a row with length 0 gives 0.
//
// Design: one launch, the merge inside it.  The TPU kernel walks a (slot, KV
// head)'s blocks one after another; on Hopper that would leave most of the
// 132 SMs idle at batch 1.  So each (slot, KV head) takes a thread-block
// cluster of kSplit = 8 blocks (the portable cluster size), and block r of
// the cluster takes keys [r s, (r + 1) s) of the live prefix, s = ceil(len /
// 8): 40 blocks of 384 keys at the QA decode (5 KV heads, 3072 live rows),
// 256 at the 8B scan decode (8 KV heads, 4 slots).  Each K and V row is read
// from memory once for all G query heads of its KV head.
// Inside a block the four warps walk the share independently: warp w takes
// its 16-key tiles (8 at D 128) w, w + 4, ... through its own cp.async ring
// (4 stages at D 64, 3 at D 128; zero-filled past the share, which is never
// read), with its own online softmax over its keys, so no block barrier
// stands in the loop.  A key is 8 lanes, each with 8 (D 64) or 16 elements
// of it, and the lanes that score a key also hold its elements in P V, so p
// never leaves the registers; the query sits in shared memory as f32.  The
// kernel is latency-bound: a walk of 64-key tiles by the whole block, with
// three block barriers a tile, read 0.0116 ms at the QA decode on an H100
// (`device_times`), twice this design's time.  At the end the warps merge
// through shared memory, and each block pushes its partial (max,
// denominator, output) into rank 0's shared memory through the cluster's
// distributed shared memory; one cluster barrier later rank 0 merges the
// eight and writes out.  No second kernel, no scratch in device memory, no
// counter: the launch allocates nothing and is correct on any stream and
// inside a CUDA graph capture.  G is rounded up to 1, 2, 4 or 8 (a template
// parameter): the extra query heads are zero and never written, so no loop
// tests G at run time.  Masked keys are computed and then selected.
//
// Bound.  Reading the live K and V rows is all the work (about one FMA per
// byte): memory-bound, 3.35 TB/s on an H100 SXM; 3.9 MB at the QA decode,
// 1.2 us.  At that size the launch, the serial walk of a warp's tiles (its
// shuffles and exps) and the cluster barrier set the time.
#include <cooperative_groups.h>

#include "mma.cuh"

namespace gvl {
namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kSplit = 8;     // blocks per cluster, each a share of the keys
constexpr int kMaxGroup = 8;  // query heads per KV head
constexpr int kLanesPerKey = 8;
constexpr int kKeysPerPass = 32 / kLanesPerKey;

// keys per warp tile, and stages of each warp's ring
template <int D>
constexpr int kSub = D == 64 ? 16 : 8;
template <int D>
constexpr int kStages = D == 64 ? 4 : 3;

// floats of one partial result: the output of kG heads, then their running
// max and denominator (16 floats, so that partials stay 64-byte aligned)
template <int D, int kG>
constexpr int kPart = kG * D + 16;

// shared memory of one block, in bytes: the warps' K/V rings, the query,
// and the cluster's partials (read in rank 0's block only)
template <int D, int kG>
constexpr int kSmemBytes =
    kWarps * kStages<D> * 2 * kSub<D> * D * 2 + (kG * D + kSplit * kPart<D, kG>) * 4;

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <typename TQ, int D, int kG>
__global__ void __cluster_dims__(kSplit, 1, 1) __launch_bounds__(kThreads)
decode_attention_kernel(const TQ* __restrict__ q, const __nv_bfloat16* __restrict__ kc,
                        const __nv_bfloat16* __restrict__ vc,
                        const int* __restrict__ lengths, TQ* __restrict__ out,
                        int layer, int hq, int hkv, int s_max, float scale) {
  constexpr int kU = D / 64;                  // 16-byte units of a row per lane
  constexpr int kSb = kSub<D>, kSt = kStages<D>;
  constexpr int kPasses = kSb / kKeysPerPass;
  constexpr int kStageElems = 2 * kSb * D;    // a K tile, then a V tile
  constexpr int kP = kPart<D, kG>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* const ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  // the query [kG][D], then the cluster's partials [kSplit][kP] (rank 0's)
  float* const qs = reinterpret_cast<float*>(ring + kWarps * kSt * kStageElems);
  float* const parts = qs + kG * D;

  cluster_arrive_relaxed();  // this block has started (phase 1)
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // lanes 8 i .. 8 i + 7 hold key i of a pass; lane c of them units c, c + 8
  const int c = lane % kLanesPerKey, kq = lane / kLanesPerKey;
  const int group = hq / hkv;
  const int len = max(0, min(lengths[b], s_max));
  const float scale_log2 = scale * kLog2e;  // scores in log2 units: exp is exp2
  const int share = (len + kSplit - 1) / kSplit;
  const int k_begin = min(rank * share, len), k_end = min(k_begin + share, len);
  // warp w takes the block's tiles w, w + kWarps, ...
  const int n_sub = (k_end - k_begin + kSb - 1) / kSb;
  const int n_mine = n_sub > warp ? (n_sub - warp + kWarps - 1) / kWarps : 0;

  // layer `layer` of a cache stacked over layers (0 for one layer's cache);
  // the grid's z extent is the batch
  const size_t row0 = (((size_t)layer * gridDim.z + b) * hkv + h) * s_max;
  const __nv_bfloat16* kbase = kc + row0 * D;
  const __nv_bfloat16* vbase = vc + row0 * D;
  __nv_bfloat16* const wring = ring + warp * kSt * kStageElems;
  auto load = [&](int it, int stage) {
    const int key0 = k_begin + (warp + it * kWarps) * kSb;
    __nv_bfloat16* dst = wring + stage * kStageElems;
#pragma unroll
    for (int i = lane; i < kSb * (D / 8); i += 32) {
      const int j = i / (D / 8), u = (i % (D / 8)) * 8;
      const bool valid = key0 + j < k_end;
      const size_t off = (size_t)(valid ? key0 + j : 0) * D + u;
      cp_async16(dst + j * D + u, kbase + off, valid);
      cp_async16(dst + kSb * D + j * D + u, vbase + off, valid);
    }
  };
#pragma unroll
  for (int st = 0; st < kSt - 1; ++st) {
    if (st < n_mine) load(st, st);
    cp_async_commit();
  }

  const size_t head0 = (size_t)b * hq + (size_t)h * group;  // first q head
  for (int i = tid; i < kG * D; i += kThreads)
    qs[i] = i / D < group ? to_float(q[head0 * D + i]) : 0.f;
  __syncthreads();

  float m[kG], l[kG], acc[kG][8 * kU];
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    m[g] = kNegInf, l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < 8 * kU; ++e) acc[g][e] = 0.f;
  }

  for (int it = 0; it < n_mine; ++it) {
    const int stage = it % kSt;
    cp_async_wait<kSt - 2>();  // this warp's tile it has landed
    __syncwarp();              // ... for every lane; tile it - 1 is consumed
    if (it + kSt - 1 < n_mine) load(it + kSt - 1, (it + kSt - 1) % kSt);
    cp_async_commit();
    const __nv_bfloat16* ks = wring + stage * kStageElems;
    const __nv_bfloat16* vs = ks + kSb * D;
    const int live = k_end - (k_begin + (warp + it * kWarps) * kSb);

    // scores of the tile's keys: key kPerPass p + kq in pass p; the 8 lanes
    // of a key reduce by shuffles, so each of them holds its score
    float s[kPasses][kG];
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      const int j = p * kKeysPerPass + kq;
      float kr[kU][8];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        Vec16 v;
        v.raw = *reinterpret_cast<const uint4*>(ks + j * D + (u * 8 + c) * 8);
#pragma unroll
        for (int e = 0; e < 8; ++e) kr[u][e] = vec_elem<__nv_bfloat16>(v, e);
      }
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const float4* qv = reinterpret_cast<const float4*>(qs + g * D + (u * 8 + c) * 8);
          const float4 a = qv[0], z = qv[1];
          dot += kr[u][0] * a.x + kr[u][1] * a.y + kr[u][2] * a.z + kr[u][3] * a.w +
                 kr[u][4] * z.x + kr[u][5] * z.y + kr[u][6] * z.z + kr[u][7] * z.w;
        }
#pragma unroll
        for (int off = kLanesPerKey / 2; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        s[p][g] = j < live ? dot * scale_log2 : kNegInf;
      }
    }

    // online softmax over the warp's keys, in exp2 form (one MUFU.EX2 a
    // weight): p against the running max, rounded to bf16 for P V; the
    // denominator sums it unrounded
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      float mx = s[0][g];
#pragma unroll
      for (int p = 1; p < kPasses; ++p) mx = fmaxf(mx, s[p][g]);
#pragma unroll
      for (int off = kLanesPerKey; off < 32; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[g], mx);
      const float a = exp2_ftz(m[g] - m_new);
      m[g] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int p = 0; p < kPasses; ++p) {
        const float ex = exp2_ftz(s[p][g] - m_new);
        const float pp = s[p][g] == kNegInf ? 0.f : ex;
        sum += pp;
        s[p][g] = round_to<__nv_bfloat16>(pp);
      }
#pragma unroll
      for (int off = kLanesPerKey; off < 32; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[g] = l[g] * a + sum;
#pragma unroll
      for (int e = 0; e < 8 * kU; ++e) acc[g][e] *= a;
    }

    // P V: each lane its units of its keys
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      const int j = p * kKeysPerPass + kq;
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        Vec16 v;
        v.raw = *reinterpret_cast<const uint4*>(vs + j * D + (u * 8 + c) * 8);
#pragma unroll
        for (int g = 0; g < kG; ++g)
#pragma unroll
          for (int e = 0; e < 8; ++e)
            acc[g][u * 8 + e] += s[p][g] * vec_elem<__nv_bfloat16>(v, e);
      }
    }
  }

  // the warp's output: the sum over the keys of a pass
#pragma unroll
  for (int g = 0; g < kG; ++g)
#pragma unroll
    for (int e = 0; e < 8 * kU; ++e) {
      acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], 8);
      acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], 16);
    }
  // the warps' partials through the (now idle) ring: [kWarps][kP]
  cp_async_wait<0>();
  __syncthreads();
  float* const wpart = reinterpret_cast<float*>(ring);
  static_assert(kWarps * kP * 4 <= kWarps * kStages<D> * 2 * kSub<D> * D * 2,
                "the warps' partials fit the ring");
  if (kq == 0) {
#pragma unroll
    for (int g = 0; g < kG; ++g)
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        float4* dst = reinterpret_cast<float4*>(wpart + warp * kP + g * D + (u * 8 + c) * 8);
        dst[0] = make_float4(acc[g][u * 8], acc[g][u * 8 + 1], acc[g][u * 8 + 2],
                             acc[g][u * 8 + 3]);
        dst[1] = make_float4(acc[g][u * 8 + 4], acc[g][u * 8 + 5], acc[g][u * 8 + 6],
                             acc[g][u * 8 + 7]);
      }
  }
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      wpart[warp * kP + kG * D + g] = m[g];
      wpart[warp * kP + kG * D + kG + g] = l[g];
    }
  }
  __syncthreads();

  // the block's partial (its warps merged by their maxima), pushed into
  // rank 0's parts[rank]; every block of the cluster has started by now
  cluster_wait();
  float* const dst = cluster.map_shared_rank(parts, 0) + rank * kP;
  for (int o = tid; o < kG * D; o += kThreads) {
    const int g = o / D;
    float mw[kWarps], mb = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      mw[w] = wpart[w * kP + kG * D + g];
      mb = fmaxf(mb, mw[w]);
    }
    float sum = 0.f, denom = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float a = exp2_ftz(mw[w] - mb);
      sum += wpart[w * kP + o] * a;
      denom += wpart[w * kP + kG * D + kG + g] * a;
    }
    dst[o] = sum;
    if (o % D == 0) dst[kG * D + g] = mb, dst[kG * D + kG + g] = denom;
  }
  cluster_arrive_release();  // phase 2: the partials are in rank 0
  cluster_wait();
  if (rank != 0) return;
  for (int o = tid; o < group * D; o += kThreads) {
    const int g = o / D;
    float mr[kSplit], mx = kNegInf;
#pragma unroll
    for (int r = 0; r < kSplit; ++r) {
      mr[r] = parts[r * kP + kG * D + g];
      mx = fmaxf(mx, mr[r]);
    }
    float denom = 0.f, sum = 0.f;
#pragma unroll
    for (int r = 0; r < kSplit; ++r) {
      const float w = exp2_ftz(mr[r] - mx);
      denom += parts[r * kP + kG * D + kG + g] * w;
      sum += parts[r * kP + o] * w;
    }
    out[head0 * D + o] = from_float<TQ>(sum / fmaxf(denom, 1e-30f));
  }
}

template <typename TQ, int D, int kG>
int launch(const void* q, const void* k_cache, const void* v_cache,
           const void* lengths, void* out, int layer, int batch, int hq, int hkv,
           int s_max, float scale, cudaStream_t stream) {
  constexpr int kSmem = kSmemBytes<D, kG>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      decode_attention_kernel<TQ, D, kG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (attr != cudaSuccess) return (int)attr;
  decode_attention_kernel<TQ, D, kG><<<dim3(kSplit, hkv, batch), kThreads, kSmem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const __nv_bfloat16*>(k_cache),
      static_cast<const __nv_bfloat16*>(v_cache), static_cast<const int*>(lengths),
      static_cast<TQ*>(out), layer, hq, hkv, s_max, scale);
  return (int)cudaGetLastError();
}

// the query heads per KV head rounded up to 1, 2, 4 or 8
template <typename TQ, int D>
int launch_group(const void* q, const void* k_cache, const void* v_cache,
                 const void* lengths, void* out, int layer, int batch, int hq, int hkv,
                 int s_max, float scale, cudaStream_t stream) {
  const int group = hq / hkv;
  if (group == 1)
    return launch<TQ, D, 1>(q, k_cache, v_cache, lengths, out, layer, batch, hq, hkv, s_max, scale, stream);
  if (group == 2)
    return launch<TQ, D, 2>(q, k_cache, v_cache, lengths, out, layer, batch, hq, hkv, s_max, scale, stream);
  if (group <= 4)
    return launch<TQ, D, 4>(q, k_cache, v_cache, lengths, out, layer, batch, hq, hkv, s_max, scale, stream);
  return launch<TQ, D, 8>(q, k_cache, v_cache, lengths, out, layer, batch, hq, hkv, s_max, scale, stream);
}

// Validates the shapes and dispatches on the query type and head size.
int dispatch(const void* q, const void* k_cache, const void* v_cache,
             const void* lengths, void* out, int n_layers, int layer, int batch,
             int hq, int hkv, int s_max, int head_dim, float scale, int q_dtype,
             void* stream) {
  if (batch <= 0 || batch > 65535 || hkv <= 0 || hkv > 65535 || hq % hkv ||
      hq / hkv > kMaxGroup || hq / hkv < 1 || s_max <= 0 || layer < 0 ||
      layer >= n_layers)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == kF32 && head_dim == 64)
    return launch_group<float, 64>(q, k_cache, v_cache, lengths, out, layer, batch, hq, hkv, s_max, scale, s);
  if (q_dtype == kF32 && head_dim == 128)
    return launch_group<float, 128>(q, k_cache, v_cache, lengths, out, layer, batch, hq, hkv, s_max, scale, s);
  if (q_dtype == kBF16 && head_dim == 64)
    return launch_group<__nv_bfloat16, 64>(q, k_cache, v_cache, lengths, out, layer, batch, hq, hkv, s_max, scale, s);
  if (q_dtype == kBF16 && head_dim == 128)
    return launch_group<__nv_bfloat16, 128>(q, k_cache, v_cache, lengths, out, layer, batch, hq, hkv, s_max, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace gvl

// Blocks per (slot, KV head): block r of a cluster takes keys [r s, (r + 1)
// s) of the live prefix, s = ceil(length / this).
extern "C" int gvl_decode_attention_split(void) { return gvl::kSplit; }

// q [B, Hq, D] (q_dtype: 0 f32, 1 bf16), k/v cache [B, Hkv, S_max, D] bf16,
// lengths [B] int32, out [B, Hq, D] of q's type.  All contiguous.  Returns a
// cudaError_t.
extern "C" int gvl_decode_attention(const void* q, const void* k_cache,
                                    const void* v_cache, const void* lengths,
                                    void* out, int batch, int hq, int hkv,
                                    int s_max, int head_dim, float scale,
                                    int q_dtype, void* stream) {
  return gvl::dispatch(q, k_cache, v_cache, lengths, out, 1, 0, batch, hq, hkv,
                       s_max, head_dim, scale, q_dtype, stream);
}

// As gvl_decode_attention, reading layer `layer` (0 <= layer < n_layers) of
// k/v caches stacked over layers, [n_layers, B, Hkv, S_max, D] bf16.
extern "C" int gvl_decode_attention_stacked(
    const void* q, const void* k_all, const void* v_all, const void* lengths,
    void* out, int n_layers, int layer, int batch, int hq, int hkv, int s_max,
    int head_dim, float scale, int q_dtype, void* stream) {
  return gvl::dispatch(q, k_all, v_all, lengths, out, n_layers, layer, batch,
                       hq, hkv, s_max, head_dim, scale, q_dtype, stream);
}
