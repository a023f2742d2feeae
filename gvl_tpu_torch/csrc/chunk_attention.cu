// Chunk attention over a KV cache for Hopper (sm_90a): f32 or bf16 query,
// bf16 cache, head_dim 64 or 128, any number of query heads per KV head.
//
// Replaces the TPU kernel gvl_tpu/ops/decode_attention.py:chunk_attention
// (Pallas body _chunk_kernel): an S-token chunk already written into the
// cache at per-slot offset start[b] attends over the cached prefix plus its
// own causal part, so chunk row s of slot b sees keys 0 .. start[b] + s.
// With start 0 it is causal attention over the chunk.  It serves speculative
// verification, a session's delta ingest and every admission of the batching
// engine.  Online softmax in exp form; the softmax weights are rounded to the
// cache type (bf16) before P V, the denominator sums them unrounded and is
// at least 1e-30, and the output is in q's type, as in the TPU kernel.
//
// Design.  Tensor cores through mma.sync (csrc/mma.cuh).  The TPU kernel
// holds all S * G query rows of a (slot, KV head) in one VMEM block and so
// refuses S * G > 512.  Here the rows r = s * G + g of one (slot, KV head)
// (s-major, as the TPU kernel orders them) are tiled by 64: one block per
// (row tile, KV head, slot), so the G query heads that share a KV head
// share every K/V tile that is read.  The block has 8 warps in two key
// groups of 4 (16 rows per warp): group 0 takes the even 64-key tiles,
// group 1 the odd ones, each with its own online softmax, and group 1
// hands its running max, denominator and output to group 0 through shared
// memory at the end.  That halves the serial walk of a row tile over its
// keys, which bounds a speculative verify or a session delta (few rows,
// many keys).  The K/V tiles of both groups pass through a cp.async ring
// of 3 stages (2 at D 128) in shared memory (rows D + 8 bf16 wide, an odd
// number of 16-byte units, so ldmatrix reads hit distinct banks); the row
// tiles that see the most keys are scheduled first.  Keys at or past the
// block's last live key are zero-filled on load and tiles past it are
// never read, so a NaN past the slot's live end cannot reach P V.  q k^T
// runs as m16n8k16 bf16 products with f32 sums; the causal mask is applied
// only on tiles that reach past a warp's first row, and a warp skips tiles
// past its last row.  Every exp is computed and then selected, so that no
// lane branches around it.  The score fragments, rounded pairwise to bf16,
// are the A fragments of P V (FlashAttention-2's register reuse); the
// running max, denominator and output stay in registers.
// - bf16 q (the 8B geometry): one product.
// - f32 q (the QA model: f32 weights over a bf16 cache): q is split into
//   bf16 hi + lo and both are multiplied with the exactly-bf16 keys, so the
//   scores carry about 16 bits of q's mantissa (f32-level error against
//   the f32 plain version).
// A speculative verify (5 positions x G 2 = 10 rows) fills one warp of each
// group; the others load tiles and skip the products.
//
// Bound.  At a QA admission (10 heads, a 2048-token chunk at offset 0,
// D 64) the minimal work is 4 D flops per live (row, key) pair, 5.4 GFLOP,
// against ~8 MB of traffic: operation-bound, 0.0054 ms at the bf16
// tensor-core peak (989 TFLOP/s).  The f32 query doubles q k^T, mma.sync
// issued from registers reaches a fraction of that peak, and the causal
// work is uneven: the last row tile walks all 2048 keys in series, with
// the online softmax's scalar work between its products.  A wgmma
// design would run a 64-row warpgroup's products asynchronously from
// shared memory, fed by TMA from a producer warp, and overlap the softmax of
// one tile with the next tile's products.
#include "mma.cuh"

namespace gvl {
namespace {

constexpr int kWarps = 4;            // warps of one key group: 16 rows each
constexpr int kGroups = 2;           // key groups: even and odd key tiles
constexpr int kThreads = 32 * kWarps * kGroups;
constexpr int kRows = 16 * kWarps;  // query rows per block
constexpr int kBK = 64;             // keys per shared-memory tile
static_assert(kRows == kBK, "a Q tile and a K/V tile share one size");

template <int D>
constexpr int kTileElems = kBK * (D + 8);  // bf16 per shared-memory tile
// stages of the ring, each a K and a V tile per key group: the loads run
// kStages - 1 steps ahead of the products
template <int D>
constexpr int kStages = D == 64 ? 3 : 2;

template <typename TQ, int D>
__global__ void __launch_bounds__(kThreads)
chunk_attention_kernel(const TQ* __restrict__ q,
                       const __nv_bfloat16* __restrict__ kc,
                       const __nv_bfloat16* __restrict__ vc,
                       const int* __restrict__ starts, TQ* __restrict__ out,
                       int hq, int hkv, int seq, int s_max, float scale) {
  constexpr int kParts = sizeof(TQ) == 4 ? 2 : 1;  // q as bf16 hi (and lo)
  constexpr int kLd = D + 8;
  constexpr int kSt = kStages<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // tiles: Q part p at p; K of stage s, key group gi at kParts + kGroups s +
  // gi, V at kParts + kGroups (kSt + s) + gi
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  auto tile = [&](int i) { return smem + i * kTileElems<D>; };

  const int group = hq / hkv;
  const int rows = seq * group;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32 % kWarps, kg = threadIdx.x / 32 / kWarps;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, mi = lane / 8, mr = lane % 8;
  // the last row tiles see the most keys: they are scheduled first
  const int r0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int start = max(starts[b], 0);
  // keys the block's last row sees: the end of the key loop
  const int kend = min(start + (min(r0 + kRows, rows) - 1) / group + 1, s_max);
  const int n_tiles = (kend + kBK - 1) / kBK;
  // at step it, key group kg takes tile kGroups it + kg
  const int n_steps = (n_tiles + kGroups - 1) / kGroups;

  // this warp's rows: keys its first row sees (every tile before that end
  // needs no mask) and its last row sees (tiles from there on are skipped)
  const int wr0 = r0 + warp * 16;
  const bool warp_live = wr0 < rows;
  const int w_first_end = min(start + wr0 / group + 1, s_max);
  const int w_last_end = min(start + (min(wr0 + 15, rows - 1)) / group + 1, s_max);
  int row_end[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) row_end[r] = min(start + (wr0 + g + 8 * r) / group + 1, s_max);

  // query rows r0 .. r0 + 63 into the Q tile(s)
  for (int i = threadIdx.x; i < kRows * (D / 8); i += kThreads) {
    const int rr = i / (D / 8), c = (i % (D / 8)) * 8;
    const int r = r0 + rr;
    const bool valid = r < rows;
    const int s = valid ? r / group : 0, h = kvh * group + (valid ? r % group : 0);
    const TQ* src = q + (((size_t)b * hq + h) * seq + s) * D + c;
    if constexpr (kParts == 1) {
      cp_async16(tile(0) + rr * kLd + c, src, valid);
    } else {
      float x[8];
      if (valid) {
        load_f32<TQ, 8>(src, x);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) x[e] = 0.f;
      }
      __align__(16) __nv_bfloat16 hi[8], lo[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) split_bf16(x[e], hi[e], lo[e]);
      *reinterpret_cast<uint4*>(tile(0) + rr * kLd + c) = *reinterpret_cast<const uint4*>(hi);
      *reinterpret_cast<uint4*>(tile(1) + rr * kLd + c) = *reinterpret_cast<const uint4*>(lo);
    }
  }
  const size_t kv_off = ((size_t)b * hkv + kvh) * s_max * D;
  // the key tiles of step it (one per key group) into a stage of the ring
  auto load = [&](int it, int stage) {
    for (int i = threadIdx.x; i < kGroups * kBK * (D / 8); i += kThreads) {
      const int gi = i / (kBK * (D / 8)), j = i / (D / 8) % kBK, c = (i % (D / 8)) * 8;
      const int key = (kGroups * it + gi) * kBK + j;
      const bool valid = key < kend;
      const size_t off = kv_off + (size_t)(valid ? key : 0) * D + c;
      cp_async16(tile(kParts + kGroups * stage + gi) + j * kLd + c, kc + off, valid);
      cp_async16(tile(kParts + kGroups * (kSt + stage) + gi) + j * kLd + c, vc + off,
                 valid);
    }
  };
  // one commit group per step (the first also holds Q), empty past the end
#pragma unroll
  for (int st = 0; st < kSt - 1; ++st) {
    if (st < n_steps) load(st, st);
    cp_async_commit();
  }

  unsigned qf[kParts][D / 16][4];
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int it = 0; it < n_steps; ++it) {
    const int stage = it % kSt, k0 = (kGroups * it + kg) * kBK;
    if (it + kSt - 1 < n_steps) load(it + kSt - 1, (it + kSt - 1) % kSt);
    cp_async_commit();
    cp_async_wait<kSt - 1>();  // step it has landed
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int p = 0; p < kParts; ++p)
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          ldmatrix_x4(qf[p][kk], tile(p) + (warp * 16 + (mi & 1) * 8 + mr) * kLd +
                                     kk * 16 + (mi >> 1) * 8);
    }
    if (warp_live && k0 < w_last_end) {
      float s[kBK / 8][4];
#pragma unroll
      for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
      const __nv_bfloat16* ks = tile(kParts + kGroups * stage + kg);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
        for (int np = 0; np < kBK / 16; ++np) {
          unsigned kb[4];
          ldmatrix_x4(kb, ks + (np * 16 + (mi >> 1) * 8 + mr) * kLd + kk * 16 + (mi & 1) * 8);
          if constexpr (kParts == 2) {
            mma_bf16(s[2 * np], qf[1][kk], kb[0], kb[1]);
            mma_bf16(s[2 * np + 1], qf[1][kk], kb[2], kb[3]);
          }
          mma_bf16(s[2 * np], qf[0][kk], kb[0], kb[1]);
          mma_bf16(s[2 * np + 1], qf[0][kk], kb[2], kb[3]);
        }
      }
      const bool diagonal = k0 + kBK > w_first_end;
      float tile_max[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool live = !diagonal || k0 + n * 8 + 2 * t + (e & 1) < row_end[e >> 1];
          s[n][e] = live ? __fmul_rn(s[n][e], scale) : kNegInf;
          tile_max[e >> 1] = fmaxf(tile_max[e >> 1], s[n][e]);
        }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[r], mx);
        alpha[r] = expf(m[r] - m_new);
        m[r] = m_new;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e >> 1];
      // a masked key adds nothing: exp is taken for every key and then
      // selected, so that no lane branches around it
#pragma unroll
      for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float ex = expf(s[n][e] - m[e >> 1]);
          const float p = s[n][e] == kNegInf ? 0.f : ex;
          l[e >> 1] += p;
          s[n][e] = p;
        }
      const __nv_bfloat16* vs = tile(kParts + kGroups * (kSt + stage) + kg);
#pragma unroll
      for (int j = 0; j < kBK / 16; ++j) {
        const unsigned pa[4] = {pack_bf16x2(s[2 * j][0], s[2 * j][1]),
                                pack_bf16x2(s[2 * j][2], s[2 * j][3]),
                                pack_bf16x2(s[2 * j + 1][0], s[2 * j + 1][1]),
                                pack_bf16x2(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
        for (int np = 0; np < D / 16; ++np) {
          unsigned vb[4];
          ldmatrix_x4_trans(vb, vs + (j * 16 + (mi & 1) * 8 + mr) * kLd + np * 16 +
                                    (mi >> 1) * 8);
          mma_bf16(o[2 * np], pa, vb[0], vb[1]);
          mma_bf16(o[2 * np + 1], pa, vb[2], vb[3]);
        }
      }
    }
    __syncthreads();  // this stage is consumed before it is refilled
  }

  // key group 1 hands its running max, denominator and output to group 0
  // through the (now idle) ring, laid out so that lanes hit distinct banks
  if constexpr (kGroups == 2) {
    constexpr int kVals = 4 + D / 2;
    static_assert(kVals * kWarps * 32 * 4 <= 2 * kGroups * kSt * kTileElems<D> * 2,
                  "the hand-over fits the ring");
    float* xch = reinterpret_cast<float*>(tile(kParts));
    auto slot = [&](int i) { return xch + (i * kWarps + warp) * 32 + lane; };
    __syncthreads();
    if (kg == 1) {
#pragma unroll
      for (int r = 0; r < 2; ++r) *slot(r) = m[r], *slot(2 + r) = l[r];
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) *slot(4 + 4 * n + e) = o[n][e];
    }
    __syncthreads();
    if (kg == 1) return;
    float a0[2], a1[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m1 = *slot(r), m_new = fmaxf(m[r], m1);
      a0[r] = expf(m[r] - m_new);
      a1[r] = expf(m1 - m_new);
      l[r] = l[r] * a0[r] + *slot(2 + r) * a1[r];
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[n][e] = o[n][e] * a0[e >> 1] + *slot(4 + 4 * n + e) * a1[e >> 1];
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wr0 + g + 8 * r;
    float sum = l[r] + __shfl_xor_sync(0xffffffffu, l[r], 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    if (row >= rows) continue;
    const float denom = fmaxf(sum, 1e-30f);
    const int s = row / group, h = kvh * group + row % group;
    TQ* dst = out + (((size_t)b * hq + h) * seq + s) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const float a = o[n][2 * r] / denom, c = o[n][2 * r + 1] / denom;
      if constexpr (kParts == 1) {
        *reinterpret_cast<__nv_bfloat162*>(dst + n * 8) = __floats2bfloat162_rn(a, c);
      } else {
        *reinterpret_cast<float2*>(dst + n * 8) = make_float2(a, c);
      }
    }
  }
}

template <typename TQ, int D>
int launch(const void* q, const void* k_cache, const void* v_cache,
           const void* starts, void* out, int batch, int hq, int hkv, int seq,
           int s_max, float scale, cudaStream_t stream) {
  constexpr int kSmem =
      ((sizeof(TQ) == 4 ? 2 : 1) + 2 * kGroups * kStages<D>) * kTileElems<D> * 2;
  static const cudaError_t attr = cudaFuncSetAttribute(
      chunk_attention_kernel<TQ, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return (int)attr;
  const int rows = seq * (hq / hkv);
  const dim3 grid((rows + kRows - 1) / kRows, hkv, batch);
  chunk_attention_kernel<TQ, D><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const __nv_bfloat16*>(k_cache),
      static_cast<const __nv_bfloat16*>(v_cache),
      static_cast<const int*>(starts), static_cast<TQ*>(out), hq, hkv, seq,
      s_max, scale);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace gvl

// q [B, Hq, S, D] (q_dtype: 0 f32, 1 bf16), k/v cache [B, Hkv, S_max, D] bf16
// holding the chunk at rows start[b] .. start[b] + S - 1, starts [B] int32,
// out [B, Hq, S, D] of q's type.  All contiguous.  Returns a cudaError_t.
extern "C" int gvl_chunk_attention(const void* q, const void* k_cache,
                                   const void* v_cache, const void* starts,
                                   void* out, int batch, int hq, int hkv,
                                   int seq, int s_max, int head_dim,
                                   float scale, int q_dtype, void* stream) {
  using namespace gvl;
  if (batch <= 0 || hq <= 0 || hkv <= 0 || hq % hkv || seq <= 0 || s_max <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == kF32 && head_dim == 64)
    return launch<float, 64>(q, k_cache, v_cache, starts, out, batch, hq, hkv, seq, s_max, scale, s);
  if (q_dtype == kF32 && head_dim == 128)
    return launch<float, 128>(q, k_cache, v_cache, starts, out, batch, hq, hkv, seq, s_max, scale, s);
  if (q_dtype == kBF16 && head_dim == 64)
    return launch<__nv_bfloat16, 64>(q, k_cache, v_cache, starts, out, batch, hq, hkv, seq, s_max, scale, s);
  if (q_dtype == kBF16 && head_dim == 128)
    return launch<__nv_bfloat16, 128>(q, k_cache, v_cache, starts, out, batch, hq, hkv, seq, s_max, scale, s);
  return (int)cudaErrorInvalidValue;
}
